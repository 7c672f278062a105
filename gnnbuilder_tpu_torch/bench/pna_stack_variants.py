"""Variants of the PNA stack kernel (``csrc/pna_block.cu``) on the card.

    python -m gnnbuilder_tpu_torch.bench.pna_stack_variants

Each variant is a patched copy of the kernel's source, built with nvcc
into the build directory and loaded in the wrapper's place, then run on
the canonical PNA model's b1024 block-packed QM9 batch (seeded weights)
in each mode: CUDA-event ms per call beside the kernel as it is (which
runs first and last), how many of five runs give the same output bit for
bit, and the largest error against the plain version as a share of its
largest value.  Each undoes one of the kernel's design choices:

  ieee_branchy     the aggregate's divisions and square roots, and the
                   int8 levels, as plain IEEE operations with their
                   slow-path branches (not div_rcp / sqrt_fast)
  no_proxy_fence   ring stages released without fence.proxy.async
  ring_1, ring_3   one ring stage, or three (not in f32: no room)
  split_in_kernel  f32: the weights' TF32 halves re-split on the card,
                   the work that splitting them on the host saves (both
                   halves are still loaded)
  no_aggregate     timing only: the chunks formed without the gather
  no_mma           timing only: the products without tensor-core
                   instructions

Needs a card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from gnnbuilder_tpu_torch.ops.cuda import _build, pna_block

MODES = ("f32", "bf16", "int8")
RUNS = 5
ITERS = 20


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) < 1:
        raise ValueError(f"variant patch does not apply: {old[:60]!r}")
    return src.replace(old, new)


def _no_mma(src: str) -> str:
    for name, body in (("mma_tf32", "d[0] += __uint_as_float(a[0] ^ b0);"),
                       ("mma_bf16", "d[0] += __uint_as_float(a[0] ^ b0);"),
                       ("mma_s8", "d[0] += (int)(a[0] ^ b0);")):
        start = src.index(f"__device__ __forceinline__ void {name}(")
        open_ = src.index("{\n", start) + 2
        close = src.index("\n}\n", open_)
        src = src[:open_] + f"  {body}" + src[close:]
    return src


VARIANTS = {
    "ieee_branchy": lambda s: _sub(_sub(
        s, "  if (fast)\n    finish8<true>(out, s, sq, mx, mn, u, d);\n"
           "  else\n    finish8<false>(out, s, sq, mx, mn, u, d);",
        "  finish8<false>(out, s, sq, mx, mn, u, d);"),
        "fast(s_ <= 0x1p100f)", "fast(false)"),
    "no_proxy_fence": lambda s: _sub(
        s, '    asm volatile("fence.proxy.async.shared::cta;" ::: '
           '"memory");\n', ""),
    "ring_1": lambda s: _sub(s, "constexpr int stages() {\n  return 2;",
                             "constexpr int stages() {\n  return 1;"),
    "ring_3": lambda s: _sub(s, "constexpr int stages() {\n  return 2;",
                             "constexpr int stages() {\n"
                             "  return MODE == F32 ? 2 : 3;"),
    "split_in_kernel": lambda s: _sub(_sub(
        s, "        const uint4 b = bp[np * (KB / 128)];",
        "        uint4 b = bp[np * (KB / 128)];"),
        "        if constexpr (MODE == F32) bl = bp[np * (KB / 128) + 32];",
        "        if constexpr (MODE == F32) {\n"
        "          const uint4 lo = bp[np * (KB / 128) + 32];\n"
        "          const float w[4] = {\n"
        "              __uint_as_float(b.x) + __uint_as_float(lo.x),\n"
        "              __uint_as_float(b.y) + __uint_as_float(lo.y),\n"
        "              __uint_as_float(b.z) + __uint_as_float(lo.z),\n"
        "              __uint_as_float(b.w) + __uint_as_float(lo.w)};\n"
        "          b = make_uint4(tf32(w[0]), tf32(w[1]), tf32(w[2]),\n"
        "                         tf32(w[3]));\n"
        "          bl = make_uint4(\n"
        "              tf32(w[0] - __uint_as_float(b.x)),\n"
        "              tf32(w[1] - __uint_as_float(b.y)),\n"
        "              tf32(w[2] - __uint_as_float(b.z)),\n"
        "              tf32(w[3] - __uint_as_float(b.w)));\n"
        "        }"),
    "no_aggregate": lambda s: _sub(_sub(
        s, "  aggregate8(out, r, 16 * j + 8 * hh, U, V, nbr, row0, W, "
           "s_deg[r]);",
        "  for (int p = 0; p < 4; ++p)\n    for (int i = 0; i < 8; ++i) "
        "out[p][i] = U[r + p + i];"),
        "        aggregate8(a, r, 16 * j + 8 * hh, H, V, nbr, row0, W, d);",
        "        for (int p = 0; p < 4; ++p)\n          for (int i = 0; "
        "i < 8; ++i) a[p][i] = H[r + p + i];"),
    "no_mma": _no_mma,
}
TIMING_ONLY = ("no_aggregate", "no_mma")


def build_variants(names):
    """{name: loaded library} of the patched copies, built side by side."""
    src = (_build._CSRC / "pna_block.cu").read_text()
    out_dir = _build.build_root() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text(VARIANTS[name](src))
        libs[name] = out_dir / f"{name}.so"
        cmds.append([_build.nvcc(), *_build.FLAGS, "-shared", "-I",
                     str(_build._CSRC), "-o", str(libs[name]), str(cu)])
    for name, (rc, log) in zip(names, _build._run_all(cmds)):
        if rc:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
    return {n: ctypes.CDLL(str(p)) for n, p in libs.items()}


def _case(dev):
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )

    graphs, (b,) = canonical_batches(
        "qm9", n_graphs=1024, batch_size=1024, block_size=128,
        node_multiple=1024, device=dev)
    model = canonical_model("pna", "qm9", graphs=graphs)
    prog = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                   max_graphs=b.num_graphs, block_size=128, device=dev)
    prog.init_params()
    L = model.gnn_num_layers
    x = torch.nn.functional.pad(b.node_feat, (0, 128 - b.feature_dim))
    kw = dict(deltas=[c.delta for c in model.gnn_convs],
              skips=[0 < i < L - 1 for i in range(L)],
              act=model.gnn_activation)
    return (x.contiguous(), b.nbr_nodes, b.in_degree,
            model._kernel_params(128)[0], kw)


def _ms(fn):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def main(names=tuple(VARIANTS)) -> int:
    if not torch.cuda.is_available():
        print("pna_stack_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip()
    print(smi, flush=True)
    torch.set_grad_enabled(False)
    base = _build.load()
    libs = build_variants(list(names))
    x, nbr, deg, stacked, kw = _case(torch.device("cuda"))
    for mode in MODES:
        st, sc = pna_block.prepare_stack(stacked, mode)
        mkw = dict(kw, mode=mode, scales=sc,
                   staged=pna_block.stage_stack(st, mode))
        want = pna_block.pna_block_stack_plain(x, nbr, deg, *st, **kw,
                                               mode=mode, scales=sc)
        scale = float(want.abs().max())
        for name in ("kernel", *names, "kernel"):
            if ((name == "ring_3" and mode == "f32")
                    or (name == "split_in_kernel" and mode != "f32")):
                continue
            _build._lib = base if name == "kernel" else libs[name]
            try:
                fn = lambda: pna_block.fused_pna_block_stack(
                    x, nbr, deg, *st, **mkw)
                outs = [fn().clone() for _ in range(RUNS)]
                same = sum(torch.equal(o, outs[0]) for o in outs)
                err = max(float((o - want).abs().max()) for o in outs)
                ms = _ms(fn)
            finally:
                _build._lib = base
            check = ("timing only" if name in TIMING_ONLY else
                     f"{same}/{RUNS} runs bitwise equal, error "
                     f"{err / scale:.3e} of max")
            print(f"{mode} {name}: {ms:.4f} ms; {check}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

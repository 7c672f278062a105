"""Variants of the mp stack and PNA scatter backward kernels on the card,
and the mp stack's time by phase.

    python -m gnnbuilder_tpu_torch.bench.mp_scatter_variants

Each variant is a patched copy of ``csrc/mp_block.cu`` or
``csrc/scatter_bwd.cu`` (with ``csrc/readout.cu`` for the shared-memory
query the wrappers make), built with nvcc into the build directory and
loaded in the library's place, then run beside the kernel as it is:
rows 3 (gcn, sage) and 3b (gcn, sage) as one launch on the b1024
block-packed batch (the canonical models, seeded weights, synthetic QM9),
row 6 as the six coefficient launches of a canonical PNA train step on
the b1024 standard-packed batch.  Per variant: CUDA-event ms (10 after 2
warm-up calls) and the largest error against the plain version as a
share of its largest value.  Each undoes one design choice:

  mp: act_inline              gelu, sigmoid and tanh inlined in every
                              epilogue beside relu (not out of line)
  mp: no_mma                  timing only: no tensor-core instruction
  scatter: rows_96            96 rows a CTA (5.9 waves at N = 18,688;
                              one of the four SM sub-partitions idles)
  scatter: chains_in_order    each chain's three passes issued back to
                              back (not in turn across the chains)
  scatter: two_ctas_64_rows   64 rows a CTA and two CTAs an SM (ptxas
                              held to 112 registers a thread)
  scatter: no_mma             timing only

Then the phase timelines: copies of the kernels whose thread 0 records
%globaltimer at every consumer barrier (the mp stack) or at the ends of
the prologue, the products and the epilogue (the scatter backward, each
after a consumer barrier), run once per case; they print the median
microseconds of each interval over the CTAs: for the mp stack the
prologue (x, the adjacency), then per layer the product phases and the
aggregation phase (gcn: product, aggregation; sage: aggregation,
product, store), and when the second round of blocks started.  Needs a
card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from gnnbuilder_tpu_torch.ops.cuda import _build, mp_block, pna_layer
from gnnbuilder_tpu_torch.ops.cuda import scatter_bwd

ITERS = 10
NMARK = 96                 # timeline marks kept per block


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"variant patch does not apply: {old[:60]!r}")
    return src.replace(old, new)


def _no_mma_header(h: str) -> str:
    for name, body in (("mma_tf32", "d[0] += __uint_as_float(a[0] ^ b0);"),
                       ("mma_bf16", "d[0] += __uint_as_float(a[0] ^ b0);"),
                       ("mma_s8", "d[0] += (int)(a[0] ^ b0);")):
        start = h.index(f"__device__ __forceinline__ void {name}(")
        open_ = h.index("{\n", start) + 2
        close = h.index("\n}\n", open_)
        h = h[:open_] + f"  {body}" + h[close:]
    return h


_CHAINS_IN_TURN = re.compile(
    r"          // a k-step's four chains from zero.*?"
    r"(?=        }\n      }\n      ring\.release)", re.S)
_CHAINS_IN_ORDER = """#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (!live[mt]) continue;
            float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
            gnnb_mma::mma_3xtf32(p0, ah[mt], al[mt], b.x, b.y, bl.x, bl.y);
            gnnb_mma::mma_3xtf32(p1, ah[mt], al[mt], b.z, b.w, bl.z, bl.w);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[mt][2 * np][i] = __fadd_rn(acc[mt][2 * np][i], p0[i]);
              acc[mt][2 * np + 1][i] =
                  __fadd_rn(acc[mt][2 * np + 1][i], p1[i]);
            }
          }
"""


def _chains_in_order(src: str) -> str:
    out, n = _CHAINS_IN_TURN.subn(_CHAINS_IN_ORDER, src)
    if n != 1:
        raise ValueError("variant patch chains_in_order does not apply")
    return out


MP_VARIANTS = {
    "act_inline": lambda s: _sub(
        s, "  return act == 1 ? fmaxf(x, 0.f) : act == 0 ? x : "
           "act_call(x, act);",
        "  switch (act) {\n"
        "    case 1: return fmaxf(x, 0.f);\n"
        "    case 2: return 0.5f * x * (1.f + erff(x * "
        "0.70710678118654752f));\n"
        "    case 3: return 1.f / (1.f + expf(-x));\n"
        "    case 4: return tanhf(x);\n"
        "    default: return x;\n  }"),
    "no_mma": lambda s: s,
}
SCATTER_VARIANTS = {
    "rows_96": lambda s: _sub(s, "  for (int R = RMAX; R >= RSTEP; "
                                 "R -= RSTEP)\n",
                              "  for (int R = 96; R >= RSTEP; R -= RSTEP)\n"),
    "chains_in_order": _chains_in_order,
    "two_ctas_64_rows": lambda s: _sub(_sub(
        s, "__global__ void __launch_bounds__(THREADS, 1)",
        "__global__ void __launch_bounds__(THREADS, 2)"),
        "  for (int R = RMAX; R >= RSTEP; R -= RSTEP)\n",
        "  for (int R = 64; R >= RSTEP; R -= RSTEP)\n"),
    "no_mma": lambda s: s,
}
TIMING_ONLY = ("no_mma",)


def _timeline(src: str) -> str:
    """The mp stack with %globaltimer marks at kernel start, at the
    consumers' start and after every consumer barrier, and an entry that
    copies them out."""
    src = _sub(src, """__device__ __forceinline__ void cbar() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}""", f"""__device__ unsigned long long g_marks[256 * {NMARK}];
__shared__ int s_mark;
__device__ __forceinline__ void mark() {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (s_mark < {NMARK} && blockIdx.x < 256)
      g_marks[blockIdx.x * {NMARK} + s_mark] = t;
    ++s_mark;
  }}
}}
__device__ __forceinline__ void cbar() {{
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
  mark();
}}""")
    src = _sub(src, "  const size_t row0 = (size_t)blockIdx.x * BB;\n",
               "  const size_t row0 = (size_t)blockIdx.x * BB;\n"
               "  if (threadIdx.x == 0) s_mark = 0;\n  mark();\n")
    src = _sub(src, "  const int wr = warp & 3, wc = warp >> 2;\n"
                    "  Ring<MODE> ring",
               "  mark();\n  const int wr = warp & 3, wc = warp >> 2;\n"
               "  Ring<MODE> ring")
    return _sub(src, '}  // extern "C"', f"""int gnnb_marks(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, g_marks,
                                   sizeof(unsigned long long) * 256 *
                                   {NMARK});
}}
}}  // extern "C\"""")


_MARK = f"""__device__ unsigned long long g_marks[256 * {NMARK}];
__shared__ int s_mark;
__device__ __forceinline__ void mark() {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (s_mark < {NMARK} && blockIdx.x + 146 * blockIdx.y < 256)
      g_marks[(blockIdx.x + 146 * blockIdx.y) * {NMARK} + s_mark] = t;
    ++s_mark;
  }}
}}
"""
_MARKS_ENTRY = f"""int gnnb_marks(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, g_marks,
                                   sizeof(unsigned long long) * 256 *
                                   {NMARK});
}}
}}  // extern "C\""""


def _scatter_timeline(src: str) -> str:
    """The scatter backward with %globaltimer marks (CTAs of the first
    column groups): start, prologue, products, epilogue."""
    cons = '  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");\n'
    src = _sub(src, "using Ring = gnnb_mma::Ring<STAGES, TB>;\n",
               "using Ring = gnnb_mma::Ring<STAGES, TB>;\n" + _MARK)
    src = _sub(src, "  const int row0 = blockIdx.x * R, cg = blockIdx.y;\n",
               "  const int row0 = blockIdx.x * R, cg = blockIdx.y;\n"
               "  if (threadIdx.x == 0) s_mark = 0;\n  mark();\n")
    src = _sub(src, "  __syncthreads();\n\n  if (warp == CWARPS) {",
               "  __syncthreads();\n  mark();\n\n  if (warp == CWARPS) {")
    src = _sub(src, "  // the coefficients, each (row, feature) from this",
               cons + "  mark();\n"
               "  // the coefficients, each (row, feature) from this")
    src = _sub(src, "        st2(6, c_mn[0], c_mn[1]);\n      }\n    }\n}\n",
               "        st2(6, c_mn[0], c_mn[1]);\n      }\n    }\n"
               + cons + "  mark();\n}\n")
    return _sub(src, '}  // extern "C"', _MARKS_ENTRY)


def build_variants():
    """{(kernel, name): loaded library} of every patched copy."""
    csrc = _build._CSRC
    out = _build.build_root() / "mp_scatter_variants"
    nomma = out / "no_mma"
    nomma.mkdir(parents=True, exist_ok=True)
    (nomma / "mma_ring.cuh").write_text(
        _no_mma_header((csrc / "mma_ring.cuh").read_text()))
    jobs = [("mp_block", n, f) for n, f in MP_VARIANTS.items()]
    jobs += [("scatter_bwd", n, f) for n, f in SCATTER_VARIANTS.items()]
    jobs.append(("mp_block", "timeline", _timeline))
    jobs.append(("scatter_bwd", "timeline", _scatter_timeline))
    cmds, libs = [], {}
    for src, name, patch in jobs:
        cu = out / f"{src}_{name}.cu"
        cu.write_text(patch((csrc / f"{src}.cu").read_text()))
        so = out / f"{src}_{name}.so"
        inc = ["-I", str(nomma)] if name == "no_mma" else []
        cmds.append([_build.nvcc(), *_build.FLAGS, "-shared", *inc, "-I",
                     str(csrc), "-o", str(so), str(cu),
                     str(csrc / "readout.cu")])
        libs[(src, name)] = so
    for (key, so), (rc, log) in zip(libs.items(), _build._run_all(cmds)):
        if rc:
            raise RuntimeError(f"variant {key} did not build:\n{log}")
    return {k: ctypes.CDLL(str(p)) for k, p in libs.items()}


def _ms(fn):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def _cases(dev):
    """(mp cases {name: (args, kw)}, the six scatter calls, the rows of
    the block batch)."""
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )

    graphs, (blk, *_) = canonical_batches(
        "qm9", n_graphs=3072, batch_size=1024, block_size=128,
        node_multiple=1024, device=dev)
    x = torch.nn.functional.pad(blk.node_feat,
                                (0, 128 - blk.feature_dim)).contiguous()
    mp = {}
    for conv in ("gcn", "sage"):
        model = canonical_model(conv, "qm9", graphs=graphs)
        Program(model, device=dev, seed=41).init_params()
        stacked = model._kernel_params(128)[0]
        L = model.gnn_num_layers
        for mode in ("f32", "bf16"):
            st, sc = mp_block.prepare_mp_stack(stacked, mode)
            kw = dict(conv=conv, epss=[0.0] * L,
                      skips=[0 < i < L - 1 for i in range(L)], act="relu",
                      mode=mode, scales=sc,
                      staged=mp_block.stage_mp_stack(st, mode))
            mp[f"{conv} {mode}"] = ((x, blk.block_adj, blk.in_degree, *st),
                                    kw)
    graphs, (std,) = canonical_batches("qm9", n_graphs=1100,
                                       batch_size=1024, node_multiple=256,
                                       device=dev)
    model = canonical_model("pna", "qm9", graphs=graphs)
    Program(model, device=dev, seed=31).init_params()
    gen = torch.Generator(device="cpu").manual_seed(5)
    h, calls = std.node_feat, []
    L = model.gnn_num_layers
    for i, c in enumerate(model.gnn_convs):
        skip = h if 0 < i < L - 1 else None
        ops = pna_layer.pad_operands(
            h, c.pre_nn.weight.t(), c.pre_nn.bias, c.post_nn.weight.t(),
            c.post_nn.bias, c.lin.weight.t(), c.lin.bias, skip)
        ops = [None if t is None else t.detach().contiguous() for t in ops]
        out, _, agg_cat, aux, _ = pna_layer.fused_pna_layer(
            ops[0], std.nbr_nodes, std.in_degree, *ops[1:7], c.delta,
            skip=ops[7], act=model.gnn_activation, save_res=True)
        ks_t = pna_layer.scaler_blocks(ops[3], ops[0].shape[1],
                                       ops[1].shape[1]).t().contiguous()
        d_mid = torch.randn(std.num_nodes, ops[5].shape[0],
                            generator=gen).to(dev)
        calls.append((d_mid, aux, agg_cat, std.in_degree, ks_t, c.delta))
        h = out[:, :c.out_channels]
    return mp, calls, blk.num_nodes // 128


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("mp_scatter_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip(),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    base = _build.load()
    libs = build_variants()
    mp, calls, blocks = _cases(dev)
    plain6 = [scatter_bwd.pna_scatter_cstk_plain(*a) for a in calls]
    plain_mp = {k: mp_block.mp_stack_plain(
        *a, **{n: v for n, v in kw.items() if n != "staged"})
        for k, (a, kw) in mp.items()}
    try:
        for (src, name), lib in [(("both", "kernel"), base),
                                 *libs.items()]:
            if name == "timeline":
                continue
            _build._lib = lib
            if src in ("both", "scatter_bwd"):
                err = max(_rel(scatter_bwd.fused_pna_scatter_cstk(*a), w)
                          for a, w in zip(calls, plain6))
                ms = _ms(lambda: [scatter_bwd.fused_pna_scatter_cstk(*a)
                                  for a in calls])
                note = " (timing only)" if name in TIMING_ONLY else ""
                print(f"scatter {name}: row 6 six launches {ms:.4f} ms, "
                      f"{err:.2e} of max{note}", flush=True)
            if src in ("both", "mp_block"):
                for key, (a, kw) in mp.items():
                    err = _rel(mp_block.fused_mp_block_stack(*a, **kw),
                               plain_mp[key])
                    ms = _ms(lambda: mp_block.fused_mp_block_stack(*a, **kw))
                    note = " (timing only)" if name in TIMING_ONLY else ""
                    print(f"mp {name}: row 3 {key} {ms:.4f} ms, "
                          f"{err:.2e} of max{note}", flush=True)
        lib = libs[("mp_block", "timeline")]
        _build._lib = lib
        lib.gnnb_marks.restype = ctypes.c_int
        for key, (a, kw) in mp.items():
            for _ in range(3):
                mp_block.fused_mp_block_stack(*a, **kw)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (256 * NMARK))()
            if lib.gnnb_marks(buf) != 0:
                raise RuntimeError("reading the timeline marks failed")
            t = np.frombuffer(buf, dtype=np.uint64).reshape(256, NMARK)
            t = t[:blocks].astype(np.int64)
            t = t[:, :int((t[0] > 0).sum())]
            starts = np.sort(t[:, 0] - t[:, 0].min()) / 1e3
            d = np.median(np.diff(t, axis=1), axis=0) / 1e3
            print(f"timeline {key}: intervals (us) "
                  + " ".join(f"{v:.2f}" for v in d)
                  + f"; per block {np.median(t[:, -1] - t[:, 0]) / 1e3:.1f}"
                  f" us; the second round of blocks started at "
                  f"{starts[min(132, blocks - 1)]:.1f} us", flush=True)
        lib = libs[("scatter_bwd", "timeline")]
        _build._lib = lib
        lib.gnnb_marks.restype = ctypes.c_int
        for _ in range(3):
            scatter_bwd.fused_pna_scatter_cstk(*calls[1])
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (256 * NMARK))()
        if lib.gnnb_marks(buf) != 0:
            raise RuntimeError("reading the timeline marks failed")
        t = np.frombuffer(buf, dtype=np.uint64).reshape(256, NMARK)
        t = t[:, :4].astype(np.int64)
        t = t[(t > 0).all(axis=1)]
        d = np.median(np.diff(t, axis=1), axis=0) / 1e3
        print(f"timeline scatter (layer 1, {len(t)} CTAs): prologue "
              f"{d[0]:.2f} us, products {d[1]:.2f}, epilogue {d[2]:.2f}",
              flush=True)
    finally:
        _build._lib = base
    return 0


if __name__ == "__main__":
    sys.exit(main())

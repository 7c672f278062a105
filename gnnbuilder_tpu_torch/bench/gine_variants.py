"""Variants of the GINE layer kernel (row 12) on the card, and its time by
phase.

    python -m gnnbuilder_tpu_torch.bench.gine_variants

Each variant is a patched copy of ``csrc/gine_layer.cu`` (with
``csrc/readout.cu`` for the shared-memory query the wrapper makes) or of
a header it includes, built with nvcc into the build directory and
loaded in the library's place, then run beside the kernel as it is on
the six launches of a standard-packed GINE forward on the b1024 train
batch (N = 18,688; the canonical model, seeded weights, each layer on the
per-layer plain path's input) in f32, bf16 and int8, on the Ring (the
layout of ``layer_operands``) and on the caller's weights (the Stream).
Per variant: the kernel's device ms (torch.profiler over 5 calls after a
warm-up; CUDA events around the six launches measure the host's launch
rate at this size) and the largest error against the plain version as a
share of its largest value.

  one_cta     launch bounds of one CTA an SM (255 registers a thread,
              where two or three CTAs an SM cap them at 128 or 85)
  no_mma      timing only: no tensor-core instruction
  no_gather   timing only: the neighbour and edge loads skipped (s = 0)
  ring128     the Ring at 128 rows a CTA and two CTAs an SM (two stages
              in f32, three in int8): 146 CTAs on the train batch leave
              118 SMs one CTA
  two_ctas    the Ring at 64 rows, two CTAs an SM and up to six stages
              in f32 and int8, against three CTAs and two stages (f32) or
              three (int8)
  slots4      the gather issues four slots' loads of both rows before
              their adds, against two

Then the phase timelines of the interior layer (128 in, hidden, out; its
skip) in f32 and int8 on each path: a copy whose thread 0 records
%globaltimer at kernel start, after the gather, at the end of every
weight chunk, after Z's epilogue and at the end; it prints the median
microseconds of each interval over the CTAs, the median CTA's span and
when the last CTA started.  Needs a card and nvcc; prints the card's name
and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from gnnbuilder_tpu_torch.bench.gine_gather_rows import _device_split, _part
from gnnbuilder_tpu_torch.bench.mp_edge_variants import _MARK, _MARKS_ENTRY
from gnnbuilder_tpu_torch.bench.mp_scatter_variants import (
    _no_mma_header,
    _sub,
)
from gnnbuilder_tpu_torch.ops.cuda import _build, gine_layer, mp_layer

NMARK, NCTA = 48, 512      # as bench/mp_edge_variants.py's marks


def _timeline_header(h: str) -> str:
    h = _sub(h, "constexpr int THREADS = 256;\n",
             "constexpr int THREADS = 256;\n" + _MARK)
    h = _sub(h, """        ch.store(stage(cur));
      }
      __syncthreads();
""", """        ch.store(stage(cur));
      }
      __syncthreads();
      mark();
""")
    h = _sub(h, """      step(kc, wbuf + s * chunk_bytes(MODE));
""", """      step(kc, wbuf + s * chunk_bytes(MODE));
      mark();
""")
    return h


def _timeline_src(src: str) -> str:
    src = _sub(src, "  const int row0 = blockIdx.x * R;\n  const int rows = "
                    "min(R, a.n_rows - row0);\n  const int kF",
               "  if (threadIdx.x == 0) tc::s_mark = 0;\n  tc::mark();\n"
               "  const int row0 = blockIdx.x * R;\n  const int rows = "
               "min(R, a.n_rows - row0);\n  const int kF")
    src = _sub(src, """  if constexpr (!RING) ws.stage_prefetched();
  __syncthreads();
""", """  if constexpr (!RING) ws.stage_prefetched();
  __syncthreads();
  tc::mark();
""")
    src = _sub(src, """  __syncthreads();
  if constexpr (MODE == INT8) {   // QT is free: Z's levels
    tc::quantize_rows<R>(Z, ldZ, kH, QT, ldqZ, sT);""",
               """  __syncthreads();
  tc::mark();
  if constexpr (MODE == INT8) {   // QT is free: Z's levels
    tc::quantize_rows<R>(Z, ldZ, kH, QT, ldqZ, sT);""")
    src = _sub(src, """                    L.ldqZ, sT);
}""", """                    L.ldqZ, sT);
  __syncthreads();
  tc::mark();
}""")
    return _sub(src, '}  // extern "C"', _MARKS_ENTRY)


def _no_gather(src: str) -> str:
    return _sub(src, "      d[q] = i0 + q < rows ? __ldg(a.deg + row0 + i0 + q) "
                     ": 0;\n", "      d[q] = 0;\n")


def _two_ctas(src: str) -> str:
    return _sub(src, "    for (int ctas : {3, 2}) {", "    for (int ctas : {2}) {")


def _ring128(src: str) -> str:
    """The Ring at 128 rows a CTA and two CTAs an SM where its stages fit
    (f32: five; int8: three), the first design."""
    src = _sub(src, "  if (staged) {\n", """  if (staged && mode != BF16)
    for (int st = RING_MAX; st >= RING_MIN; --st)
      if ((size_t)gine_layout(F, H, mode, true, st, 128).bytes <= fit(2))
        return {128, 2, st, true};
  if (staged) {
""")
    return _sub(src, """  if (sh.ring) {
    if constexpr (MODE != BF16)""", """  if (sh.ring) {
    if constexpr (MODE != BF16)
      if (sh.R == 128)
        return (const void*)gine_layer_kernel<MODE, 128, true, 2>;
    if constexpr (MODE != BF16)""")


def _slots4(src: str) -> str:
    return _sub(src, "  constexpr int RB = 2, G = 2;",
                "  constexpr int RB = 2, G = 4;")


def _one_cta(src: str) -> str:
    return _sub(src, "__launch_bounds__(tc::THREADS, CTAS)",
                "__launch_bounds__(tc::THREADS, 1)")


VARIANTS = {
    "one_cta": (None, None, _one_cta),
    "no_mma": ("mma_ring.cuh", _no_mma_header, None),
    "no_gather": (None, None, _no_gather),
    "ring128": (None, None, _ring128),
    "two_ctas": (None, None, _two_ctas),
    "slots4": (None, None, _slots4),
    "timeline": ("tc_rows.cuh", _timeline_header, _timeline_src),
}
TIMING_ONLY = ("no_mma", "no_gather")


def build_variants():
    """{name: loaded library} of every patched copy."""
    csrc = _build._CSRC
    out = _build.build_root() / "gine_variants"
    cmds, libs = [], {}
    for name, (hdr, hpatch, patch) in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        if hdr:
            (d / hdr).write_text(hpatch((csrc / hdr).read_text()))
        text = (csrc / "gine_layer.cu").read_text()
        (d / "gine_layer.cu").write_text(patch(text) if patch else text)
        so = d / "libvariant.so"
        cmds.append([_build.nvcc(), *_build.FLAGS, "-shared", "-I", str(d),
                     "-I", str(csrc), "-o", str(so), str(d / "gine_layer.cu"),
                     str(csrc / "readout.cu")])
        libs[name] = so
    for (name, so), (rc, log) in zip(libs.items(), _build._run_all(cmds)):
        if rc:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
    return {k: ctypes.CDLL(str(p)) for k, p in libs.items()}


def _ms(fn):
    """Device ms of the GINE kernel's launches per call of fn."""
    split, _ = _device_split(fn, _part)
    return split.get("gine_layer", 0.0)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _cases(dev):
    """{name: (fn, plain, interior)}: the six launches of each mode and
    path, and the interior layer's launch alone."""
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.bench.gine_gather_rows import _layer_inputs, _t

    tgraphs, (std,) = canonical_batches("qm9", n_graphs=1100,
                                        batch_size=1024, node_multiple=256,
                                        device=dev)
    gine = canonical_model("gine", "qm9", graphs=tgraphs)
    Program(gine, device=dev, seed=41).init_params()
    lays = [((h.contiguous(), c.lin_edge(std.edge_feat).contiguous(),
              std.nbr_nodes, std.nbr_edges, std.in_degree),
             dict(b0=c.lin0.bias.detach(), b1=c.lin1.bias.detach(),
                  eps=c.eps, skip=sk, act=gine.gnn_activation),
             (_t(c.lin0.weight), _t(c.lin1.weight)))
            for c, h, sk in _layer_inputs(gine, std)]
    cases = {}
    for mode in ("f32", "bf16", "int8"):
        for path in ("ring", "stream"):
            def calls(mode=mode, path=path):
                ops = gine_layer.layer_operands([w for *_, w in lays], mode)
                out = []
                for (a, kw, _), (w0, w1, s0, s1, st) in zip(lays, ops):
                    k = dict(kw, w0=w0, w1=w1, mode=mode, s0=s0, s1=s1,
                             staged=st if path == "ring" else None)
                    out.append((a, k))
                return out

            cases[f"{mode} {path}"] = calls
    return cases, std.num_nodes


def main() -> int:
    if not torch.cuda.is_available():
        print("gine_variants: no CUDA device", file=sys.stderr)
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
    cases, n = _cases(dev)
    plain = {}
    try:
        for name, lib in [("kernel", base), *libs.items()]:
            _build._lib = lib
            for key, make in cases.items():
                calls = make()   # the layout as this library lays it out

                def six(calls=calls):
                    return torch.cat([gine_layer.fused_gine_layer(*a, **k)
                                      .flatten() for a, k in calls])

                if key not in plain:
                    plain[key] = torch.cat([
                        gine_layer.gine_layer_plain(
                            *a, **{x: y for x, y in k.items()
                                   if x != "staged"}).flatten()
                        for a, k in calls])
                if name == "timeline":
                    continue
                err = _rel(six(), plain[key])
                ms = _ms(six)
                note = " (timing only)" if name in TIMING_ONLY else ""
                print(f"{name}: {key} six {ms:.4f} ms, {err:.2e} of "
                      f"max{note}", flush=True)
        lib = libs["timeline"]
        _build._lib = lib
        for key in ("f32 ring", "f32 stream", "int8 ring", "int8 stream",
                    "bf16 ring"):
            a, k = cases[key]()[2]   # the interior layer

            def one(a=a, k=k):
                return gine_layer.fused_gine_layer(*a, **k)

            for _ in range(2):
                one()
            torch.cuda.synchronize()
            lib.gnnb_clear_marks()
            one()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (NCTA * NMARK))()
            if lib.gnnb_marks(buf) != 0:
                raise RuntimeError("reading the timeline marks failed")
            rows = 64 if "ring" in key or key.startswith("bf16") else 128
            ctas = min((n + rows - 1) // rows, NCTA)
            t = np.frombuffer(buf, dtype=np.uint64).reshape(NCTA, NMARK)
            t = t[:ctas].astype(np.int64)
            t = t[:, :int((t[0] > 0).sum())]
            starts = np.sort(t[:, 0] - t[:, 0].min()) / 1e3
            d = np.median(np.diff(t, axis=1), axis=0) / 1e3
            print(f"timeline {key} interior layer (us: gather, each chunk, "
                  f"Z epilogue, chunks, out epilogues): "
                  + " ".join(f"{v:.2f}" for v in d)
                  + f"; per CTA {np.median(t[:, -1] - t[:, 0]) / 1e3:.1f} "
                  f"us; {ctas} CTAs, the last started at {starts[-1]:.1f} "
                  "us", flush=True)
    finally:
        _build._lib = base
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Variants of the tensor-core mp layer (gin / sage) and EdgeConv kernels
on the card, and their time by phase.

    python -m gnnbuilder_tpu_torch.bench.mp_edge_variants

Each variant is a patched copy of ``csrc/mp_layer.cu`` and
``csrc/edge_block.cu`` (with ``csrc/readout.cu`` for the shared-memory
query the wrappers make) or of a header they include, built with nvcc
into the build directory and loaded in the library's place, then run
beside the kernels as they are: row 4 gin and sage (f32, bf16, int8) as one
ELL launch at the interior shape on the b1024 standard-packed train
batch (N = 18,688; 128 wide, skip, relu), row 13 max (f32) as the six
launches of an EdgeConv block forward on the first b1024 block batch
(the canonical model, seeded weights).  Per variant: CUDA-event ms (10
after 2 warm-up calls) and the largest error against the plain version
as a share of its largest value.

  one_cta       launch bounds of one CTA an SM (255 registers a thread,
                where two CTAs an SM cap them at 128)
  no_mma        timing only: no tensor-core instruction
  no_gather     timing only: row 4's neighbour loads skipped (s = 0)
  no_wload      timing only: no weight loads (a value of the address)
  rot_loads     timing only: each CTA loads its weight chunks in an order
                rotated by its index (the products take other weights)
  slot_tiles    row 13 max over slots, not over the valid (row, slot)
                pairs: per slot the 64 receiver rows' t (the 64-row
                product), the 16-row m-tiles past the CTA's last row with
                that slot skipped

Then the phase timelines of row 4 gin f32, gin int8 and sage f32: a copy
whose thread 0 records %globaltimer at kernel start, after the gather,
at the end of every weight chunk and after the epilogues; it prints the
median microseconds of each interval over the CTAs and when the last CTA
started.  Needs a
card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from gnnbuilder_tpu_torch.bench.mp_scatter_variants import (
    _no_mma_header,
    _sub,
)
from gnnbuilder_tpu_torch.ops.cuda import _build, edge_block, mp_layer

ITERS = 10
NMARK = 48                 # timeline marks kept per CTA
NCTA = 512                 # CTAs whose marks are kept

_MARK = f"""static __device__ unsigned long long g_marks[{NCTA} * {NMARK}];
static __shared__ int s_mark;
__device__ __forceinline__ void mark() {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (s_mark < {NMARK} && blockIdx.x < {NCTA})
      g_marks[blockIdx.x * {NMARK} + s_mark] = t;
    ++s_mark;
  }}
}}
"""
_MARKS_ENTRY = f"""int gnnb_marks(void* host) {{
  return (int)cudaMemcpyFromSymbol(host, gnnb_tc::g_marks,
                                   sizeof(unsigned long long) * {NCTA} *
                                   {NMARK});
}}
int gnnb_clear_marks() {{
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, gnnb_tc::g_marks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(p, 0, sizeof(unsigned long long) * {NCTA} * {NMARK});
}}
}}  // extern "C\""""


def _timeline_header(h: str) -> str:
    h = _sub(h, "constexpr int THREADS = 256;\n",
             "constexpr int THREADS = 256;\n" + _MARK)
    return _sub(h, """        ch.store(stage(cur));
      }
      __syncthreads();
""", """        ch.store(stage(cur));
      }
      __syncthreads();
      mark();
""")


def _timeline_mp(src: str) -> str:
    src = _sub(src, "  const int row0 = blockIdx.x * R;\n  const int rows = "
                    "min(R, a.n_rows - row0);\n  const int kF",
               "  if (threadIdx.x == 0) tc::s_mark = 0;\n  tc::mark();\n"
               "  const int row0 = blockIdx.x * R;\n  const int rows = "
               "min(R, a.n_rows - row0);\n  const int kF")
    src = _sub(src, """  ws.stage_prefetched();
  __syncthreads();
  if (BLOCK""", """  ws.stage_prefetched();
  __syncthreads();
  tc::mark();
  if (BLOCK""")
    src = _sub(src, """    __syncthreads();
    if constexpr (MODE == INT8) {   // QT is free: Z's levels""",
               """    __syncthreads();
    tc::mark();
    if constexpr (MODE == INT8) {   // QT is free: Z's levels""")
    src = _sub(src, "      });\n    }\n    return;\n  }\n",
               "      });\n    }\n    __syncthreads();\n    tc::mark();\n"
               "    return;\n  }\n")
    return _sub(src, '}  // extern "C"', _MARKS_ENTRY)


def _no_gather(src: str) -> str:
    return _sub(src, "        d[q] = ok ? s_deg[i_[q]] : 0;\n",
                "        d[q] = 0;\n")


_SLOT_LOOP_START = "  // max: lin1 on the valid (row, slot) pairs, PR a chunk"
_SLOT_TILES = """  // max per slot over every row, empty m-tiles skipped (variant)
  __syncthreads();
  int smax = 0;
  for (int i = 0; i < RR; ++i) smax = max(smax, s_deg[i]);
  const int E = s_off[RR];
  const int col = tid % NC, rq = tid / NC;
  bool first = true;
  for (int n0 = 0; n0 < Fout; n0 += NC) {
    const bool cok = n0 + col < Fout;
    const float b = cok ? __ldg(a.b1 + n0 + col) : 0.f;
    float mx[RR / 2];
#pragma unroll
    for (int q = 0; q < RR / 2; ++q) mx[q] = -INFINITY;
    for (int s = 0; s < smax; ++s) {
      if (!first) ws.prefetch(pass(n0));
      int live = 0;   // the rows of the m-tiles that hold the slot
      for (int i = 0; i < RR; ++i)
        if (s < s_deg[i]) live = i + 1;
      for (int e = tid; e < RR * (kF / VW); e += tc::THREADS) {
        const int i = e / (kF / VW), c = VW * (e % (kF / VW)), r = row0 + i;
        float t[VW] = {};
        if (i < rows && c < F && s < s_deg[i]) {
          const int j = a.nbr[(size_t)r * a.W + s];
          float wi[VW], x[VW];
          load_cols<VW>(wi, a.w, (size_t)r * F + c);
          load_cols<VW>(x, a.v, (size_t)j * F + c);
#pragma unroll
          for (int k = 0; k < VW; ++k)
            t[k] = fmaxf(wi[k] + (BF16 ? bf16r(x[k]) : x[k]), 0.f);
        }
        store_cols<VW, BF16>(T + (size_t)i * L.ldT + c, t);
      }
      if (first) ws.ch = wm.ch;   // the kernel prefetched into wm
      ws.stage_prefetched();
      first = false;
      __syncthreads();
      {
        tc::Acc<MODE, RR> acc;
        tc::zero<MODE, RR>(acc);
        ws.run(acc, T, L.ldT, pass(n0), live, pass(n0), false);
        tc::each_pair<RR>([&](int mt, int j, int hh, int r, int cc) {
          *reinterpret_cast<float2*>(Y + (size_t)r * tc::LDY + cc) =
              make_float2(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
        });
      }
      __syncthreads();
      if (cok) {
#pragma unroll
        for (int q = 0; q < RR / 2; ++q) {
          const int i = rq + 2 * q;
          if (s < s_deg[i])
            mx[q] = fmaxf(mx[q], Y[(size_t)i * tc::LDY + col]);
        }
      }
      __syncthreads();
    }
    if (cok) {
#pragma unroll
      for (int q = 0; q < RR / 2; ++q) {
        const int i = rq + 2 * q;
        if (i >= rows) continue;
        const size_t oi = (size_t)(row0 + i) * Fout + n0 + col;
        float o = s_deg[i] > 0 ? __fadd_rn(mx[q], b) : 0.f;
        if (a.skip != nullptr) o = __fadd_rn(o, a.skip[oi]);
        a.out[oi] = tc::act(o, a.act);
      }
    }
"""


def _slot_tiles(src: str) -> str:
    start = src.index(_SLOT_LOOP_START)
    end = src.index("    if (E == 0 && cok) {")
    return src[:start] + _SLOT_TILES + src[end:]


def _no_wload(h: str) -> str:
    """Chunk loads replaced by a value of the address (timing only)."""
    h = _sub(h, "__float_as_uint(__ldg(W + (size_t)k * p.ldw + n))",
             "(uint32_t)(k * 131 + n)")
    return h.replace("(uint32_t)__ldg(W + (size_t)k * p.ldw + n)",
                     "(uint32_t)((k + n) & 0x3f)")


def _rot_loads(h: str) -> str:
    """Each CTA loads its chunks in an order rotated by its index (timing
    only: the products then take another chunk's weights)."""
    return _sub(h, "      const int k0 = kc * 2 * KS + ks * KS;\n",
                "      const int nkc = (p.K + 2 * KS - 1) / (2 * KS);\n"
                "      const int k0 = (kc + blockIdx.x) % nkc * 2 * KS"
                " + ks * KS;\n")


def _one_cta(src: str) -> str:
    """Launch bounds of one CTA an SM (255 registers a thread)."""
    return src.replace("__launch_bounds__(tc::THREADS, 2)",
                       "__launch_bounds__(tc::THREADS, 1)")


VARIANTS = {
    "one_cta": (None, None, _one_cta, _one_cta),
    "no_wload": ("tc_rows.cuh", _no_wload, None, None),
    "rot_loads": ("tc_rows.cuh", _rot_loads, None, None),
    "no_mma": ("mma_ring.cuh", _no_mma_header, None, None),
    "no_gather": (None, None, _no_gather, None),
    "slot_tiles": (None, None, None, _slot_tiles),
    "timeline": ("tc_rows.cuh", _timeline_header, _timeline_mp, None),
}
TIMING_ONLY = ("no_mma", "no_gather", "no_wload", "rot_loads")


def build_variants():
    """{name: loaded library} of every patched copy."""
    csrc = _build._CSRC
    out = _build.build_root() / "mp_edge_variants"
    cmds, libs = [], {}
    for name, (hdr, hpatch, mpatch, epatch) in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        if hdr:
            (d / hdr).write_text(hpatch((csrc / hdr).read_text()))
        srcs = []
        for src, patch in (("mp_layer", mpatch), ("edge_block", epatch)):
            text = (csrc / f"{src}.cu").read_text()
            (d / f"{src}.cu").write_text(patch(text) if patch else text)
            srcs.append(str(d / f"{src}.cu"))
        so = d / "libvariant.so"
        cmds.append([_build.nvcc(), *_build.FLAGS, "-shared", "-I", str(d),
                     "-I", str(csrc), "-o", str(so), *srcs,
                     str(csrc / "readout.cu")])
        libs[name] = so
    for (name, so), (rc, log) in zip(libs.items(), _build._run_all(cmds)):
        if rc:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
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


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _cases(dev):
    """({name: (fn, plain)}: the row-4 launches and the row-13 six."""
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.bench.mp_edge_rows import _layer_inputs, _t

    _, (std,) = canonical_batches("qm9", n_graphs=1100, batch_size=1024,
                                  node_multiple=256, device=dev)
    gen = torch.Generator(device=dev).manual_seed(29)

    def r(*shape, sc=None):
        sc = 1.0 / shape[0] ** 0.5 if sc is None else sc
        return torch.randn(*shape, generator=gen, device=dev) * sc

    x, skip = r(std.num_nodes, 128, sc=1.0), r(std.num_nodes, 128, sc=1.0)
    ops = {"gin": dict(w0=r(128, 128), b0=r(128, sc=.1), w1=r(128, 128),
                       b1=r(128, sc=.1), eps=0.2),
           "sage": dict(w0=r(128, 128), b0=r(128, sc=.1), w1=r(128, 128))}
    cases = {}
    for conv, kw in ops.items():
        for mode in ("f32", "bf16", "int8"):
            mkw = dict(kw, skip=skip, act="relu", mode=mode)
            if mode != "f32":
                w0, w1, s0, s1 = mp_layer.prepare_layer(kw["w0"], kw["w1"],
                                                        mode)
                mkw.update(w0=w0, w1=w1, s0=s0, s1=s1)
            args = (x, std.nbr_nodes, std.in_degree, conv)
            cases[f"row 4 {conv} {mode}"] = (
                lambda a=args, k=mkw: mp_layer.fused_mp_layer(*a, **k),
                lambda a=args, k=mkw: mp_layer.mp_layer_plain(*a, **k))
    bgraphs, (blk, *_) = canonical_batches("qm9", n_graphs=3072,
                                           batch_size=1024, block_size=128,
                                           node_multiple=1024, device=dev)
    edge = canonical_model("edge", "qm9", graphs=bgraphs)
    Program(edge, device=dev, seed=41).init_params()
    lays = [((h.contiguous(), blk.nbr_nodes, blk.in_degree),
             dict(w_pair=_t(c.lin0.weight), b0=c.lin0.bias.detach(),
                  w1=_t(c.lin1.weight), b1=c.lin1.bias.detach(),
                  aggregation="max", skip=sk, act=edge.gnn_activation))
            for c, h, sk in _layer_inputs(edge, blk)]
    a2, k2 = lays[1]
    cases["row 13 max layer 2"] = (
        lambda: edge_block.fused_edge_block_layer(*a2, **k2),
        lambda: edge_block.edge_block_layer_plain(*a2, **k2))
    cases["row 13 max six"] = (
        lambda: torch.cat([edge_block.fused_edge_block_layer(*a, **k)
                           .flatten() for a, k in lays]),
        lambda: torch.cat([edge_block.edge_block_layer_plain(*a, **k)
                           .flatten() for a, k in lays]))
    return cases, std.num_nodes


def main() -> int:
    if not torch.cuda.is_available():
        print("mp_edge_variants: no CUDA device", file=sys.stderr)
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
    plain = {k: p() for k, (_, p) in cases.items()}
    try:
        for name, lib in [("kernel", base), *libs.items()]:
            if name == "timeline":
                continue
            _build._lib = lib
            for key, (fn, _) in cases.items():
                if name == "slot_tiles" and "row 13" not in key:
                    continue
                if name == "no_gather" and "row 4" not in key:
                    continue
                err = _rel(fn(), plain[key])
                ms = _ms(fn)
                note = " (timing only)" if name in TIMING_ONLY else ""
                print(f"{name}: {key} {ms:.4f} ms, {err:.2e} of max{note}",
                      flush=True)
        lib = libs["timeline"]
        _build._lib = lib
        lib.gnnb_marks.restype = ctypes.c_int
        for key in ("row 4 gin f32", "row 4 gin int8", "row 4 sage f32"):
            fn = cases[key][0]
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            lib.gnnb_clear_marks()
            fn()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (NCTA * NMARK))()
            if lib.gnnb_marks(buf) != 0:
                raise RuntimeError("reading the timeline marks failed")
            ctas = (n + 127) // 128
            t = np.frombuffer(buf, dtype=np.uint64).reshape(NCTA, NMARK)
            t = t[:ctas].astype(np.int64)
            t = t[:, :int((t[0] > 0).sum())]
            starts = np.sort(t[:, 0] - t[:, 0].min()) / 1e3
            d = np.median(np.diff(t, axis=1), axis=0) / 1e3
            print(f"timeline {key} (us, start, gather, each chunk, "
                  f"epilogues): " + " ".join(f"{v:.2f}" for v in d)
                  + f"; per CTA {np.median(t[:, -1] - t[:, 0]) / 1e3:.1f} "
                  f"us; {ctas} CTAs, the last started at {starts[-1]:.1f} "
                  "us", flush=True)
    finally:
        _build._lib = base
    return 0


if __name__ == "__main__":
    sys.exit(main())

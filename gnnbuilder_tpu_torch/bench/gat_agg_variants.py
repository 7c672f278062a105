"""Variants of the GAT softmax backward (row 11) and of the multi-aggregate
(rows 8, 8b) on the card.

    python -m gnnbuilder_tpu_torch.bench.gat_agg_variants [--timeline]

Each variant is a patched copy of ``csrc/gat_bwd.cu`` or of
``csrc/ell_agg.cu``, built alone with nvcc into the build directory and
loaded in the library's place, then run beside the kernel as it is on
the inputs of ``bench/gat_agg_rows.py``: row 11's six launches of a GAT
train step over the reverse table and over the reverse CSR (b1024 train
batch), row 8's max launch and the six of Simple max, PNA5 with u and
PNA5 block.  Per variant: the kernel's device ms (torch.profiler over 5
calls after a warm-up) and, for row 11, the largest error against the
plain version as a share of its largest value; for row 8 whether the
outputs are the kernel's bits.

  gat recv / send N units M ctas
                the receiver or the sender pass at N float4 chunks a lane
                a work unit and launch bounds of M CTAs an SM (against 2
                and 2 for the receiver, 2 and 3 for the sender)
  gat su2       the sender pass loads two reverse slots' rows at a time,
                against four
  gat rx_nogather, rx_noexp, tx_nodz
                timing only: the receiver pass without its neighbours' h
                rows or without its exps; the sender pass without its dz
                rows
  agg u2        two slots' loads in flight, against four
  agg u8        eight
  agg plain_st  the outputs stored without the streaming hint
                (st.global.cs)
  agg u_cs      u loaded with the streaming hint (ld.global.cs)
  agg ctas6     launch bounds of six CTAs an SM (40 registers a thread)

With ``--timeline``, a copy of both row-11 passes whose lane 0 of every
warp records %globaltimer at the start and the end of each work item (a
(row, unit) pair): per pass of an interior layer (C = 128) and of the
last (C = 64), the pass's span and the median and 90th-percentile
microseconds of a work item.  Needs a card and nvcc;
prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from gnnbuilder_tpu_torch.bench.gat_agg_rows import (
    REV_MODES,
    _part,
    agg_sets,
    gat_calls,
    rev_kw,
    setup,
)
from gnnbuilder_tpu_torch.bench.gine_gather_rows import _device_split, _sha
from gnnbuilder_tpu_torch.ops.cuda import _build, ell_agg, gat_bwd
from gnnbuilder_tpu_torch.ops.ell import reverse_csr


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"variant patch does not apply: {old[:60]!r}")
    return src.replace(old, new)


def _shape(recv=None, send=None):
    """The row instances with (chunks a unit, CTAs an SM) of each pass."""
    def patch(s):
        for name, shape in (("RECV", recv), ("SEND", send)):
            if shape is None:
                continue
            nu, ctas = shape
            line = next(ln for ln in s.splitlines()
                        if ln.startswith(f"constexpr int {name}_NU32"))
            s = _sub(s, line, f"constexpr int {name}_NU32 = {nu}, "
                              f"{name}_NU16 = {min(nu, 2)}, "
                              f"{name}_CTAS = {ctas};")
        return s
    return patch


GAT_VARIANTS = {
    "recv 1 unit 3 ctas": _shape(recv=(1, 3)),
    "recv 1 unit 4 ctas": _shape(recv=(1, 4)),
    "recv 2 units 3 ctas": _shape(recv=(2, 3)),
    "recv 4 units 2 ctas": _shape(recv=(4, 2)),
    "send 4 units 2 ctas": _shape(send=(4, 2)),
    "send 1 unit 4 ctas": _shape(send=(1, 4)),
    "send 2 units 2 ctas": _shape(send=(2, 2)),
    "su2": lambda s: _sub(s, "constexpr int SU = 4;", "constexpr int SU = 2;"),
}

# timing only: a part of the work left out
_ZERO4 = "make_float4(0.f, 0.f, 0.f, 0.f)"
GAT_PROBES = {
    "rx_nogather": lambda s: _sub(
        s, "      row_chunks(a.h, js[u], HC, ch, hv[u]);\n",
        f"      hv[u][0] = hv[u][NU - 1] = {_ZERO4};\n"),
    "rx_noexp": lambda s: _sub(
        s, "          e[u][k] = expf(lrelu(pre[u][k], ns) - mx[k]);",
        "          e[u][k] = lrelu(pre[u][k], ns) - mx[k];"),
    "tx_nodz": lambda s: _sub(
        s, "            row_chunks(a.dz, i, HC, ch, dzv[u]);\n",
        f"            dzv[u][0] = dzv[u][NU - 1] = {_ZERO4};\n"),
}
_CS_V4 = """          __stcs(reinterpret_cast<float4*>(o + k * F),
                 make_float4(val[0], val[1], val[2], val[3]));"""
_ST_V4 = """          *reinterpret_cast<float4*>(o + k * F) =
              make_float4(val[0], val[1], val[2], val[3]);"""
_U_LOAD = "        const Cols<V> t = ld_cols<V>(a.u + r * F + c);"
_U_CS = """        Cols<V> t;
#pragma unroll
        for (int k = 0; k < V; ++k) t.c[k] = __ldcs(a.u + r * F + c + k);"""
AGG_VARIANTS = {
    "u2": lambda s: _sub(s, "constexpr int U = 4;", "constexpr int U = 2;"),
    "u8": lambda s: _sub(s, "constexpr int U = 4;", "constexpr int U = 8;"),
    "plain_st": lambda s: _sub(_sub(s, _CS_V4, _ST_V4),
                               "          __stcs(o + k * F, val[0]);",
                               "          o[k * F] = val[0];"),
    "u_cs": lambda s: _sub(s, _U_LOAD, _U_CS),
    "ctas6": lambda s: _sub(s, "__global__ void __launch_bounds__(THREADS) "
                               "ell_agg_kernel",
                            "__global__ void __launch_bounds__(THREADS, 6) "
                            "ell_agg_kernel"),
}

NMARK = 1 << 17   # work items marked per pass
NPH = 4           # marks a work item

_MARKS = """
__device__ unsigned long long g_marks[2][%d][%d];
__device__ __forceinline__ void mark_item(int pass, int ph, int t) {
  if ((threadIdx.x & 31) == 0 && t < %d) {
    unsigned long long ns;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(ns));
    g_marks[pass][ph][t] = ns;
  }
}
""" % (NPH, NMARK, NMARK)

_MARKS_ENTRY = """
extern "C" int gnnb_gat_marks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks));
}
extern "C" int gnnb_gat_clear_marks() {
  void* ptr;
  cudaError_t err = cudaGetSymbolAddress(&ptr, g_marks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(ptr, 0, sizeof(g_marks));
}
"""


def _timeline(src: str) -> str:
    """Marks in every work item of both row-instance passes.  Receiver:
    at its start, once its first group's loads have landed and their dots
    are reduced, after its last group (the exps and den), at its end.
    Sender: at its start, after its reverse list, after its stores."""
    src = _sub(src, "constexpr unsigned FULL = 0xffffffffu;\n",
               "constexpr unsigned FULL = 0xffffffffu;\n" + _MARKS)
    src = _sub(src, """    const int i = t / units;
    const Chunks<CPH, NU> ch(lane, H, t - i * units);""",
               """    const int i = t / units;
    mark_item(0, 0, t);
    const Chunks<CPH, NU> ch(lane, H, t - i * units);""")
    src = _sub(src, """      seg_sum<CPH>(p);
      if (CSR) {""", """      seg_sum<CPH>(p);
      if (k0 == 0) mark_item(0, 1, t);
      if (CSR) {""")
    src = _sub(src, "    if (d > RU) __syncwarp();\n    float dc[NU]",
               "    if (d > RU) __syncwarp();\n    mark_item(0, 2, t);\n"
               "    float dc[NU]")
    src = _sub(src, """        a.den[o] = den[k];
      }
    }
  }
}""", """        a.den[o] = den[k];
      }
    }
    mark_item(0, 3, t);
  }
}""")
    src = _sub(src, """    const int j = t / units;
    const Chunks<CPH, NU> ch(lane, H, t - j * units);""",
               """    const int j = t / units;
    mark_item(1, 0, t);
    const Chunks<CPH, NU> ch(lane, H, t - j * units);""")
    out = "    float* out = a.dh_val + j * HC + 4 * (ch.q0 + lane);\n"
    src = _sub(src, out, "    mark_item(1, 1, t);\n" + out)
    src = _sub(src, """      if (ch.lead) a.da_src[j * H + ch.hd[k]] = dacc[k];
    }
""", """      if (ch.lead) a.da_src[j * H + ch.hd[k]] = dacc[k];
    }
    mark_item(1, 2, t);
    mark_item(1, 3, t);
""")
    return src + _MARKS_ENTRY


PHASES = (("first loads and dots", "the rest of the slots", "the tail"),
          ("the reverse list", "the stores", "-"))


def _print_resources(key, log):
    """Registers and spills of a variant's row-instance kernels (ptxas)."""
    lines = log.splitlines()
    for n, line in enumerate(lines):
        m = re.search(r"Compiling entry function .*?(gat_bwd_recv_rows_kernel|"
                      r"gat_bwd_send_rows_kernel|ell_agg_kernel)I(.*?)EEv",
                      line)
        if not m:
            continue
        tail = " ".join(x.strip() for x in lines[n + 1:n + 4])
        regs = re.search(r"Used (\d+) registers", tail)
        spill = re.search(r"(\d+) bytes spill stores", tail)
        print(f"{key[0]} {key[1]}: {m.group(1)}<{m.group(2)}> "
              f"{regs.group(1) if regs else '?'} registers, "
              f"{spill.group(1) if spill else '?'} bytes spilled",
              flush=True)


def build_variants(timeline):
    """{(row, name): loaded library} of every patched copy."""
    csrc = _build._CSRC
    out = _build.build_root() / "gat_agg_variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = [("gat_bwd", n, f) for n, f in {**GAT_VARIANTS,
                                           **GAT_PROBES}.items()]
    jobs += [("ell_agg", n, f) for n, f in AGG_VARIANTS.items()]
    if timeline:
        jobs.append(("gat_bwd", "timeline", _timeline))
    cmds, libs = [], {}
    for src, name, patch in jobs:
        cu = out / f"{src}_{name}.cu"
        cu.write_text(patch((csrc / f"{src}.cu").read_text()))
        so = out / f"{src}_{name}.so"
        cmds.append([_build.nvcc(), *_build.FLAGS, "-shared", "-I",
                     str(csrc), "-o", str(so), str(cu)])
        libs[(src, name)] = so
    for (key, so), (rc, log) in zip(libs.items(), _build._run_all(cmds)):
        if rc:
            raise RuntimeError(f"variant {key} did not build:\n{log}")
        _print_resources(key, log)
    return {k: ctypes.CDLL(str(p)) for k, p in libs.items()}


def _ms(fn, part):
    for _ in range(3):   # a profiler run now and then records no launch
        ms = _device_split(fn, _part)[0].get(part, 0.0)
        if ms > 0:
            return ms
    return ms


def _rel(got, want):
    return max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
               for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeline", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gat_agg_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip(),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    base = _build.load()
    libs = build_variants(args.timeline)
    _, std, std128, blk, models, _ = setup(dev)
    calls, _ = gat_calls(models["gat"], std)
    plain = [t for a in calls
             for t in gat_bwd.gat_scatter_backward_plain(*a)]
    sets = agg_sets(std128, std, blk, models)
    agg_keys = [("max layer 1", "f32"), ("simple_max", "f32"),
                ("pna5_std", "f32"), ("pna5_block", "f32"),
                ("pna5_std", "bf16")]
    ref_sha = {}
    try:
        for name, lib in [(("both", "kernel"), base), *libs.items()]:
            if name[1] == "timeline":
                continue
            _build._lib = lib
            if name[0] in ("both", "gat_bwd"):
                for mode in REV_MODES:
                    def six(mode=mode):
                        rkw = rev_kw(std, mode)
                        if mode == "csr":   # once a step
                            rkw["rev_csr"] = reverse_csr(
                                std.nbr_nodes, std.in_degree, positions=True)
                        return [t for a in calls for t in
                                gat_bwd.fused_gat_scatter_backward(*a, **rkw)]

                    one, two = six(), six()
                    same = all(torch.equal(x, y) for x, y in zip(one, two))
                    print(f"row 11 {name[1]}: {mode} six "
                          f"{_ms(six, 'gat_bwd'):.4f} ms, "
                          f"{_rel(one, plain):.2e} of max, bitwise on two "
                          f"runs: {same}", flush=True)
            if name[0] in ("both", "ell_agg"):
                for key, mode in agg_keys:
                    ls = sets[key][1]

                    def run(ls=ls, mode=mode):
                        return [ell_agg.fused_ell_aggregate(*a, mode=mode,
                                                            **kw)
                                for a, kw in ls]

                    sha = _sha(torch.cat([o.flatten() for o in run()]))
                    ref_sha.setdefault((key, mode), sha)
                    print(f"row {'8' if mode == 'f32' else '8b'} "
                          f"{name[1]}: {key} ({len(ls)} launches) "
                          f"{_ms(run, 'ell_agg'):.4f} ms, the kernel's "
                          f"bits: {sha == ref_sha[(key, mode)]}", flush=True)
        if args.timeline:
            lib = libs[("gat_bwd", "timeline")]
            _build._lib = lib
            lib.gnnb_gat_marks.restype = ctypes.c_int
            lib.gnnb_gat_clear_marks.restype = ctypes.c_int
            for li in (2, 5):   # an interior layer (C = 128), the last (64)
                a = calls[li]
                for mode in REV_MODES:
                    def one(a=a, rkw=rev_kw(std, mode)):
                        return gat_bwd.fused_gat_scatter_backward(*a, **rkw)

                    for _ in range(2):
                        one()
                    torch.cuda.synchronize()
                    if lib.gnnb_gat_clear_marks():
                        raise RuntimeError("clearing the marks failed")
                    one()
                    torch.cuda.synchronize()
                    buf = (ctypes.c_ulonglong * (2 * NPH * NMARK))()
                    if lib.gnnb_gat_marks(buf):
                        raise RuntimeError("reading the marks failed")
                    t = np.frombuffer(buf, dtype=np.uint64).reshape(
                        2, NPH, NMARK).astype(np.int64)
                    for p, pname in enumerate(("receiver", "sender")):
                        on = (t[p] > 0).all(axis=0)
                        m = t[p][:, on]
                        span = (m[-1].max() - m[0].min()) / 1e3
                        ph = np.median(np.diff(m, axis=0), axis=1) / 1e3
                        item = (m[-1] - m[0]) / 1e3
                        print(f"timeline layer {li} {mode} {pname}: "
                              f"{on.sum()} work items over {span:.1f} us; "
                              f"an item {np.median(item):.2f} us median "
                              f"({np.percentile(item, 90):.2f} at the 90th "
                              f"percentile): " + ", ".join(
                                  f"{n} {v:.2f}" for n, v in
                                  zip(PHASES[p], ph)), flush=True)
    finally:
        _build._lib = base
    return 0


if __name__ == "__main__":
    sys.exit(main())

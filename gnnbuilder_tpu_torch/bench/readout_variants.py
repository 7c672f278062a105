"""Variants of the readout kernel (rows 2, 2b, 2i) on the card.

    python -m gnnbuilder_tpu_torch.bench.readout_variants [--timeline]

Each variant is a patched copy of ``csrc/readout.cu``, built alone with
nvcc into the build directory and loaded in the library's place, then run
beside the kernel as it is on the inputs of ``bench/readout_rows.py``
(the first b1024 block batch, the canonical head packed as the model
packs it) in f32, bf16 and int8: the kernel's device ms (torch.profiler
over 5 calls after a warm-up, up to three tries) and whether the outputs
are the kernel's bits.

  round16           a pooling lane loads 16 rows before adding them,
                    against 32 (QM9's graphs hold up to 29)
  gt1, rc4          a thread owns 1 graph x 2 columns or 2 x 4 of a
                    Linear, against 2 x 2
  tg16              16 graphs a CTA (65 CTAs for b1024), against 8 (129)
  dev_head          the head read from device memory (L2), not staged
  no_head, no_pool  timing only: without the Linears, or without the
                    pooling's loads

With ``--timeline``, a copy whose thread 0 of every CTA records
%globaltimer at the kernel's start, once the pooled rows are in shared
memory, once the staged head has landed, after each Linear, and at the
end (the output activation): the median microseconds of each phase over
the CTAs, per mode, of the kernel and of the tg16 variant.  Needs a card
and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from gnnbuilder_tpu_torch import Program
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.bench.gine_gather_rows import _device_split, _sha
from gnnbuilder_tpu_torch.ops import segment
from gnnbuilder_tpu_torch.ops.cuda import _build, readout


def _sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"variant patch does not apply: {old[:60]!r}")
    return src.replace(old, new)


_POOL_ADD = "          for (int k = 0; k < V; ++k) s[k] += row[i].c[k];"
_LINEAR = ("    linear<MODE>(a, P, l, in, nxt, s_row, last, last && "
           "!a.out_act, g0);")

VARIANTS = {
    "round16": lambda s: _sub(s, "constexpr int ROUND = 32;",
                              "constexpr int ROUND = 16;"),
    "gt1": lambda s: _sub(s, "constexpr int HEAD_GT = 2;",
                          "constexpr int HEAD_GT = 1;"),
    "rc4": lambda s: _sub(s, "constexpr int HEAD_RC = 2;",
                          "constexpr int HEAD_RC = 4;"),
    "tg16": lambda s: _sub(s, "constexpr int TG = 8;",
                           "constexpr int TG = 16;"),
    "dev_head": lambda s: _sub(
        s, "const bool in_smem = buffers + staged * 4 <= cap;",
        "const bool in_smem = false;"),
    "no_head": lambda s: _sub(s, _LINEAR, "    (void)last;"),
    "no_pool": lambda s: _sub(s, _POOL_ADD,
                              "          for (int k = 0; k < V; ++k) "
                              "s[k] += (float)i;"),
}
PROBES = ("no_head", "no_pool")

NMARK = 2048   # CTAs marked
NPH = 12       # marks a CTA: start, pooled, staged, 8 Linears, end

_MARKS = """
__device__ unsigned long long g_marks[%d][%d];
__device__ __forceinline__ void mark(int ph) {
  if (threadIdx.x == 0 && blockIdx.x < %d) {
    unsigned long long ns;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(ns));
    g_marks[ph][blockIdx.x] = ns;
  }
}
""" % (NPH, NMARK, NMARK)

_MARKS_ENTRY = """
extern "C" int gnnb_readout_marks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks));
}
extern "C" int gnnb_readout_clear_marks() {
  void* ptr;
  cudaError_t err = cudaGetSymbolAddress(&ptr, g_marks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(ptr, 0, sizeof(g_marks));
}
"""


def _timeline(src: str) -> str:
    src = _sub(src, "constexpr unsigned FULL = 0xffffffffu;\n",
               "constexpr unsigned FULL = 0xffffffffu;\n" + _MARKS)
    src = _sub(src, "  const uint32_t b = gnnb_mma::smem_addr(&bar);\n",
               "  const uint32_t b = gnnb_mma::smem_addr(&bar);\n  mark(0);\n")
    src = _sub(src, """  pool<V>(a, g0, B0);
  __syncthreads();
  if (SMEM && a.hd.padded) gnnb_mma::mbar_wait(b, 0);
""", """  pool<V>(a, g0, B0);
  __syncthreads();
  mark(1);
  if (SMEM && a.hd.padded) gnnb_mma::mbar_wait(b, 0);
  mark(2);
""")
    src = _sub(src, """    __syncthreads();
    float* tmp = in;""", """    __syncthreads();
    mark(3 + l);
    float* tmp = in;""")
    src = _sub(src, "  if (!a.out_act) return;\n",
               "  mark(11);\n  if (!a.out_act) return;\n")
    return src + _MARKS_ENTRY


def _print_resources(name, log):
    lines = log.splitlines()
    for n, line in enumerate(lines):
        m = re.search(r"Compiling entry function .*?readout_kernelIL"
                      r"i(\d+)ELb(\d)ELi(\d)E", line)
        if not m or m.group(2) != "1":
            continue
        tail = " ".join(x.strip() for x in lines[n + 1:n + 4])
        regs = re.search(r"Used (\d+) registers", tail)
        spill = re.search(r"(\d+) bytes spill stores", tail)
        print(f"{name}: mode {m.group(1)} V {m.group(3)} "
              f"{regs.group(1) if regs else '?'} registers, "
              f"{spill.group(1) if spill else '?'} bytes spilled",
              flush=True)


def build_variants(timeline):
    """{name: loaded library} of every patched copy."""
    csrc = _build._CSRC
    out = _build.build_root() / "readout_variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = dict(VARIANTS)
    if timeline:
        jobs["timeline"] = _timeline
        jobs["timeline tg16"] = lambda s: _timeline(VARIANTS["tg16"](s))
    cmds, libs = [], {}
    src = (csrc / "readout.cu").read_text()
    for name, patch in jobs.items():
        cu = out / f"readout_{name.replace(' ', '_')}.cu"
        cu.write_text(patch(src))
        so = out / f"readout_{name.replace(' ', '_')}.so"
        cmds.append([_build.nvcc(), *_build.FLAGS, "-shared", "-I",
                     str(csrc), "-o", str(so), str(cu)])
        libs[name] = so
    for (name, so), (rc, log) in zip(libs.items(), _build._run_all(cmds)):
        if rc:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        _print_resources(name, log)
    return {k: ctypes.CDLL(str(p)) for k, p in libs.items()}


def _ms(fn):
    for _ in range(3):   # a profiler run now and then records no launch
        split = _device_split(fn, lambda n: "readout" if "readout" in n
                              else "other")[0]
        if split.get("readout", 0.0) > 0:
            return split["readout"]
    return 0.0


PHASES = ("pooling", "staging wait") + tuple(
    f"Linear {i + 1}" for i in range(8))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeline", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readout_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip(),
          flush=True)
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    base = _build.load()
    libs = build_variants(args.timeline)
    graphs, (b0, *_) = canonical_batches(
        "qm9", n_graphs=3072, batch_size=1024, block_size=128,
        node_multiple=1024, device=dev)
    model = canonical_model("pna", "qm9", graphs=graphs)
    Program(model, max_nodes=b0.num_nodes, max_edges=b0.num_edges,
            max_graphs=b0.num_graphs, block_size=128, device=dev,
            seed=41).init_params()
    gen = torch.Generator(device=dev).manual_seed(31)
    h = torch.randn(b0.num_nodes, model.gnn_output_dim, generator=gen,
                    device=dev)
    mx = segment.contiguous_segment_max(h, b0.graph_starts, b0.n_node,
                                        b0.max_graph_nodes_static)
    heads = {m: model._readout_head(m) for m in ("f32", "bf16", "int8")}

    def call(mode):
        return lambda: readout.fused_readout(
            h, b0.n_node, heads[mode], aggrs=model.pooling_aggrs, mx=mx,
            act=model.mlp_activation, out_act=model.output_activation,
            starts=b0.graph_starts, mode=mode)

    ref = {}
    try:
        for name, lib in [("kernel", base), *libs.items()]:
            if name.startswith("timeline"):
                continue
            _build._lib = lib
            for mode in heads:
                fn = call(mode)
                sha = _sha(fn())
                ref.setdefault(mode, sha)
                bits = ("timing only" if name in PROBES else
                        f"the kernel's bits: {sha == ref[mode]}")
                print(f"{name} {mode}: {_ms(fn):.4f} ms, {bits}", flush=True)
        L = len(heads["f32"].dims) - 1
        for name in ("timeline", "timeline tg16") if args.timeline else ():
            lib = libs[name]
            _build._lib = lib
            lib.gnnb_readout_marks.restype = ctypes.c_int
            lib.gnnb_readout_clear_marks.restype = ctypes.c_int
            for mode in heads:
                fn = call(mode)
                for _ in range(2):
                    fn()
                torch.cuda.synchronize()
                if lib.gnnb_readout_clear_marks():
                    raise RuntimeError("clearing the marks failed")
                fn()
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * (NPH * NMARK))()
                if lib.gnnb_readout_marks(buf):
                    raise RuntimeError("reading the marks failed")
                t = np.frombuffer(buf, dtype=np.uint64).reshape(
                    NPH, NMARK).astype(np.int64)
                idx = [0, 1, 2] + [3 + i for i in range(L)]
                on = (t[idx] > 0).all(axis=0)
                m = t[idx][:, on]
                span = (m[-1].max() - m[0].min()) / 1e3
                ph = np.median(np.diff(m, axis=0), axis=1) / 1e3
                first = (m[0] - m[0].min()) / 1e3
                print(f"{name} {mode}: {on.sum()} CTAs over {span:.2f} us "
                      f"(the last CTA starts at {first.max():.2f}); a CTA's "
                      "phases, median us: " + ", ".join(
                          f"{n} {v:.2f}" for n, v in zip(PHASES, ph)),
                      flush=True)
    finally:
        _build._lib = base
    return 0


if __name__ == "__main__":
    sys.exit(main())

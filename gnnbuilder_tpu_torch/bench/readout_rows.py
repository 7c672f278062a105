"""The readout kernel's rows (2, 2b, 2i) on the card.

* ``fused_readout`` (``ops/cuda/readout.py``) on the first b1024
  block-packed QM9 batch of ``chip_smoke.py`` (N = 20,480, F = 64, G =
  1,025) with the canonical PNA model's head (192-64-64-64-64-1, seeded
  weights) and its add / mean / max pooling, in f32, bf16 and int8:
  - called with (w, b) pairs, the same call on every tree;
  - called as the model calls it under inference: this tree with the head
    ``GNNModel._readout_head`` packs once, an older tree with the pairs
    its model caches;
  each by CUDA events over back-to-back calls and by device ms of the
  readout kernel under torch.profiler, with the SHA-256 of the output;
  the plain ``contiguous_segment_max`` before it.
* ``Program.forward`` of the canonical PNA model on that batch under f32,
  bf16 and int8: events, device busy time by part (readout kernel, PNA
  stack, max pooling and other torch).
* This tree's instances: registers, shared memory and CTAs an SM
  (``gnnb_readout_info``), and the spills of ptxas's report where this
  process built the library.

    python gnnbuilder_tpu_torch/bench/readout_rows.py [--root DIR]

``--root`` imports ``gnnbuilder_tpu_torch`` from DIR (default: this
file's tree), so one call can time an older tree beside this one (a
``git archive`` of the parent commit) through the same public wrappers.
Rows: CUDA-event ms (50 after 2 warm-up calls) and device ms under the
profiler (5 rounds, retaken up to three times when it records no readout
launch).  Prints the card's name and power limit, then one JSON line.
Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import subprocess
import sys

# the shared helpers; run as a script, this file's directory is on
# sys.path and the package is imported later, from --root
if __package__:
    from .gine_gather_rows import _device_split, _events, _sha
else:
    from gine_gather_rows import _device_split, _events, _sha

ROWS = {"2": "f32", "2b": "bf16", "2i": "int8"}
EVENT_ITERS = 50


def _part(name):
    for key in ("readout", "pna_block", "segment", "max"):
        if key in name:
            return {"max": "max pooling", "segment": "max pooling"}.get(
                key, key)
    return "other torch"


def _timed(fn, part="readout"):
    for _ in range(3):   # a profiler run now and then records no launch
        split, count = _device_split(fn, _part)
        if split.get(part, 0.0) > 0:
            break
    return dict(ms=_events(fn, iters=EVENT_ITERS),
                device_ms=split.get(part, 0.0),
                busy_ms=sum(split.values()), split=split, launches=count)


def _spills(log):
    """{kernel: (registers, spill stores + loads)} of ptxas's report for
    the readout and elementwise mp layer instances."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        if cur and ("readout_kernel" in cur or "mp_layer_ew" in cur):
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
            if sp:
                out.setdefault(cur, {})["spill_bytes"] = (
                    int(sp.group(1)) + int(sp.group(2)))
            rg = re.search(r"Used (\d+) registers", line)
            if rg:
                out.setdefault(cur, {})["registers"] = int(rg.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__)
                                          .resolve().parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import ctypes

    import torch

    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.ops import segment
    from gnnbuilder_tpu_torch.ops.cuda import _build, readout

    if not torch.cuda.is_available():
        print("readout_rows: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    lib = _build.load()
    report = {"root": os.path.abspath(args.root), "smi": smi,
              "device": torch.cuda.get_device_name(0), "rows": {},
              "sha256": {}, "forward": {}}
    torch.set_grad_enabled(False)

    graphs, (b0, *_) = canonical_batches(
        "qm9", n_graphs=3072, batch_size=1024, block_size=128,
        node_multiple=1024, device=dev)
    model = canonical_model("pna", "qm9", graphs=graphs)
    prog = Program(model, max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                   max_graphs=b0.num_graphs, block_size=128, device=dev,
                   seed=41)
    prog.init_params()
    gen = torch.Generator(device=dev).manual_seed(31)
    F = model.gnn_output_dim
    h = torch.randn(b0.num_nodes, F, generator=gen, device=dev)
    aggrs = model.pooling_aggrs
    mx = segment.contiguous_segment_max(h, b0.graph_starts, b0.n_node,
                                        b0.max_graph_nodes_static)
    report.update(N=b0.num_nodes, F=F, G=b0.num_graphs)
    pairs = model._kernel_params(model._stack_width())[1]
    packs = hasattr(readout, "pack_head")
    for row, mode in ROWS.items():
        head, scales = readout.prepare_head(pairs, mode)
        kw = dict(aggrs=aggrs, mx=mx, act=model.mlp_activation,
                  out_act=model.output_activation, starts=b0.graph_starts,
                  mode=mode)
        calls = {"pairs": lambda: readout.fused_readout(
            h, b0.n_node, head, scales=scales, **kw)}
        if packs:
            packed = model._readout_head(mode)
            calls["model"] = lambda: readout.fused_readout(
                h, b0.n_node, packed, **kw)
        else:
            mh, msc = ((pairs, None) if mode == "f32" else
                       model._mode_params(model._stack_width(), mode)[1])
            calls["model"] = lambda: readout.fused_readout(
                h, b0.n_node, mh, scales=msc, **kw)
        for how, fn in calls.items():
            key = f"{row} {how}"
            res = _timed(fn)
            report["rows"][key] = res
            report["sha256"][key] = _sha(fn())
            print(f"row {key}: {res['ms']:.4f} ms (events), device "
                  f"{res['device_ms']:.4f}", flush=True)
    sm = _timed(lambda: segment.contiguous_segment_max(
        h, b0.graph_starts, b0.n_node, b0.max_graph_nodes_static),
        part="other torch")
    report["segment_max"] = dict(ms=sm["ms"], device_ms=sm["busy_ms"])
    print(f"contiguous_segment_max: {sm['ms']:.4f} ms (events), device "
          f"{sm['busy_ms']:.4f}", flush=True)

    for precision in ("f32", "bf16", "int8"):
        p = Program(canonical_model("pna", "qm9", graphs=graphs),
                    max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                    max_graphs=b0.num_graphs, block_size=128,
                    precision=precision, device=dev, seed=41)
        p.set_params({k: v.to(dev) for k, v in model.state_dict().items()})
        fn = lambda: p.forward(b0)
        split, _ = _device_split(fn, _part)
        report["forward"][precision] = dict(
            ms=_events(fn, iters=20, warmup=3), busy_ms=sum(split.values()),
            split=split)
        print(f"Program.forward pna {precision}: "
              f"{report['forward'][precision]['ms']:.4f} ms (events), busy "
              f"{sum(split.values()):.4f}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split.items()), flush=True)

    if hasattr(lib, "gnnb_readout_info"):
        info = lib.gnnb_readout_info
        info.restype = ctypes.c_int
        packed = model._readout_head("f32")
        res = {}
        for mode in ("f32", "bf16", "int8"):
            vals = [ctypes.c_int() for _ in range(3)]
            err = info(readout.MODES[mode], 1, packed.desc(tuple(aggrs)),
                       packed.params.numel(), 0, *map(ctypes.byref, vals))
            if err:
                raise RuntimeError(f"gnnb_readout_info: cudaError {err}")
            res[mode] = dict(registers=vals[0].value,
                             shared_bytes=vals[1].value,
                             ctas_per_sm=vals[2].value)
        report["instances"] = res
        report["ptxas"] = _spills(_build.build_log)
        print("readout instances (registers, shared bytes, CTAs an SM): "
              + "; ".join(f"{k} {v['registers']}, {v['shared_bytes']}, "
                          f"{v['ctas_per_sm']}" for k, v in res.items()),
              flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

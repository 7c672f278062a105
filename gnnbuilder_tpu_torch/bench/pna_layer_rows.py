"""The PNA layer kernel's rows on the card: rows 5 (f32, with the
residuals a train step saves), 5b (bf16) and 5i (int8) of
``ops/cuda/pna_layer.py``, each as the six launches of one canonical PNA
train step's forward or standard-packed forward (6 layers, 11 -> 128 ...
128 -> 64 zero-padded to 128, skips, seeded weights, synthetic QM9) on
the b1024 standard-packed train batch (N = 18,688).

    python gnnbuilder_tpu_torch/bench/pna_layer_rows.py [--root DIR]

``--root`` imports ``gnnbuilder_tpu_torch`` from DIR (default: this
file's tree), so one call can time an older tree beside this one (e.g.
a ``git archive`` of the parent commit) through the same public
wrappers.  Per row: CUDA-event ms per six launches (10 after 2 warm-up
rounds) and the device ms of each CUDA kernel by name under
torch.profiler (5 rounds), split by launch: the v launch and the layer
launch of a tree that has them, or v's float64 launch (f32, int8), the
x products (u and x K0, and v under bf16), the aggregate with its
product (and the final Linear where the tree fuses it), the row
quantization (int8) and the final Linear (where it is a launch of its
own) of one whose projection and aggregate are separate kernels.
Where the tree has ``stage_layer``, the rows run on weights laid out
beforehand, as the model's inference cache gives them, and the operands
of the six layers' live f32 weights that a train step makes on each call
are timed too, as the layout alone (``stage_layers`` of the padded
weights) and as the operands a train step makes (``layer_operands`` with
a gradient: padded and laid out): events, device and host ms.
Prints the card's name and power limit, then one JSON line.  Needs a
card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ITERS, WARMUP, PROF_ITERS = 10, 2, 5


def _events(fn):
    import torch

    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def _launch_part(name, after_agg):
    """The part of the layer a CUDA kernel of this name is; a projection
    launch right after an aggregate is the final Linear where the layer
    has one of its own (``after_agg``)."""
    low = name.lower()
    if "pna_layer_v_kernel" in low:
        return "v launch"
    if "pna_v_kernel" in low:
        return "v (float64)"
    if "pna_layer_kernel" in low:
        return "layer launch"
    if "pna_agg" in low:
        return "aggregate and Ks"
    if "quantize_rows" in low:
        return "mid quantization"
    if "pna_proj" in low:
        return "final Linear" if after_agg else "x products"
    return "other"


def _timed(fn):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ms = _events(fn)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROF_ITERS):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.time_range.start)
    n_proj = sum("pna_proj" in e.name for e in kernels)
    n_agg = sum("pna_agg" in e.name for e in kernels)
    own_linear = n_proj > n_agg   # a projection launch per final Linear
    split, after_agg = {}, False
    for e in kernels:
        part = _launch_part(e.name, after_agg)
        if part == "aggregate and Ks":
            after_agg = own_linear
        elif part in ("final Linear", "x products"):
            after_agg = False
        us = e.time_range.end - e.time_range.start
        split[part] = split.get(part, 0.0) + us / 1e3 / PROF_ITERS
    return dict(ms=ms, device_ms=sum(split.values()), split=split)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__)
                                          .resolve().parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.ops.cuda import _build, pna_layer

    if not torch.cuda.is_available():
        print("pna_layer_rows: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    _build.load()
    staged_api = hasattr(pna_layer, "stage_layer")

    graphs, (std,) = canonical_batches("qm9", n_graphs=1100,
                                       batch_size=1024, node_multiple=256,
                                       device=dev)
    model = canonical_model("pna", "qm9", graphs=graphs)
    Program(model, device=dev, seed=31).init_params()
    L = model.gnn_num_layers
    h, base = std.node_feat, []
    for i, c in enumerate(model.gnn_convs):
        skip = h if model.gnn_skip_connection and 0 < i < L - 1 else None
        ops = pna_layer.pad_operands(
            h, c.pre_nn.weight.t(), c.pre_nn.bias, c.post_nn.weight.t(),
            c.post_nn.bias, c.lin.weight.t(), c.lin.bias, skip)
        ops = [None if t is None else t.detach().contiguous() for t in ops]
        base.append((ops, c.delta))
        h = pna_layer.pna_layer_plain(
            ops[0], std.nbr_nodes, std.in_degree, *ops[1:7], c.delta,
            skip=ops[7], act=model.gnn_activation)[:, :c.out_channels]

    def in_mode(mode):
        """((args), kw) per layer as the kernel takes them in ``mode``."""
        res = []
        for ops, delta in base:
            w_pre, k_post, w_lin, s_lin = pna_layer.prepare_layer(
                ops[1], ops[3], ops[5], mode)
            a = (ops[0], std.nbr_nodes, std.in_degree, w_pre, ops[2],
                 k_post, ops[4], w_lin, ops[6], delta)
            kw = dict(skip=ops[7], act=model.gnn_activation)
            if mode == "f32":
                kw["save_res"] = True
            else:
                kw.update(mode=mode, s_lin=s_lin)
            if staged_api:
                kw["staged"] = pna_layer.stage_layer(w_pre, k_post, w_lin,
                                                     mode)
            res.append((a, kw))
        return res

    report = {"root": os.path.abspath(args.root), "smi": smi,
              "device": torch.cuda.get_device_name(0),
              "n_rows": std.num_nodes, "staged_weights": staged_api,
              "rows": {}}
    for name, mode in (("5", "f32"), ("5b", "bf16"), ("5i", "int8")):
        lays = in_mode(mode)

        def run(lays=lays):
            for a, kw in lays:
                pna_layer.fused_pna_layer(*a, **kw)

        report["rows"][name] = _timed(run)
        r = report["rows"][name]
        print(f"row {name}: {r['ms']:.4f} ms (events), device "
              f"{r['device_ms']:.4f}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in r["split"].items() if v),
              flush=True)
    if staged_api:
        live = [c._weights() for c in model.gnn_convs]
        with torch.enable_grad():
            padded = [pna_layer._pad_weights(*w) for w in live]
        parts = {
            # the layout alone, of the padded weights
            "layout_f32_six_layers": lambda: pna_layer.stage_layers(
                [(w[0], w[2], w[4]) for w in padded], "f32"),
            # what a train step calls: the padding too
            "operands_f32_six_layers": lambda: pna_layer.layer_operands(
                live, "f32")}
        for key, fn in parts.items():
            def call(fn=fn):
                with torch.enable_grad():
                    fn()

            lay = _timed(call)
            host = []
            for _ in range(ITERS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                call()
                host.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            lay["host_ms"] = sorted(host)[len(host) // 2]
            report[key] = lay
            print(f"{key}: {lay['ms']:.4f} ms (events), device "
                  f"{lay['device_ms']:.4f}, host {lay['host_ms']:.4f}",
                  flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

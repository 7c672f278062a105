"""The GAT kernels' rows on the card: rows 9, 9b, 9e, 9eb (the block
kernel, ``ops/cuda/gat_block.py``) and 10, 10b, 10i, 10e, 10eb, 10ei (the
layer kernel, ``ops/cuda/gat_layer.py``), each as the six launches of one
canonical GAT forward (heads 4; 11 -> 4 x 128, 4 x (512 -> 4 x 128),
512 -> 4 x 64; seeded weights, synthetic QM9): row 9 on the b1024
block-packed batch (N = 20,480), 9e on the same graphs with repeated
pairs dropped, row 10 on the b1024 standard-packed train batch (N =
18,688).

    python gnnbuilder_tpu_torch/bench/gat_rows.py [--root DIR]

``--root`` imports ``gnnbuilder_tpu_torch`` from DIR (default: this
file's tree), so one call can time an older tree beside this one (e.g.
a ``git archive`` of the parent commit) through the same public
wrappers.  Per row: CUDA-event ms per forward's six launches (10 after 2
warm-up forwards) and the device ms of each CUDA kernel by name under
torch.profiler (5 forwards): the projection (a name with "proj"), the
attention ("attn"), the block kernel ("gat_block").  Where the tree has
``stage_projection``, the rows run on weights staged beforehand, as the
model's inference cache gives them, and the staging of the six layers'
f32 weights (what a train step pays on each call) is timed too.  Prints
the card's name and power limit, then one JSON line.  Needs a card and
nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ITERS, WARMUP, PROF_ITERS = 10, 2, 5


def _timed(fn):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / ITERS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROF_ITERS):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            parts[e.key] = parts.get(e.key, 0.0) + us / 1e3 / PROF_ITERS
    split = {"projection": 0.0, "attention": 0.0, "block": 0.0,
             "other": 0.0}
    for name, v in parts.items():
        low = name.lower()
        key = ("projection" if "proj" in low else "attention"
               if "attn" in low else "block" if "gat_block" in low
               else "other")
        split[key] += v
    return dict(ms=ms, device_ms=sum(parts.values()), split=split,
                kernels={k: v for k, v in parts.items() if v > 0})


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
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.data.datasets import drop_repeated_edges
    from gnnbuilder_tpu_torch.ops import ell
    from gnnbuilder_tpu_torch.ops.cuda import _build, gat_block, gat_layer

    if not torch.cuda.is_available():
        print("gat_rows: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    _build.load()
    staged_api = hasattr(gat_layer, "stage_projection")

    graphs, (blk,) = canonical_batches(
        "qm9", n_graphs=1024, batch_size=1024, block_size=128,
        node_multiple=1024, device=dev)
    _, (std,) = canonical_batches("qm9", n_graphs=1100, batch_size=1024,
                                  node_multiple=256, device=dev)
    simple = build_graph_batch(drop_repeated_edges(graphs), block_size=128,
                               node_multiple=1024, device=dev)

    def layers(edge, g, block):
        """((x, table, w, att_src, att_dst, bias, heads), kw) per layer,
        the hidden state advanced through the plain version."""
        kw_conv = dict(heads=4, **({"edge_dim": 4} if edge else {}))
        model = canonical_model("gat", "qm9", graphs=graphs,
                                conv_kwargs=kw_conv)
        Program(model, device=dev, seed=31).init_params()
        h, out = g.node_feat, []
        L = model.gnn_num_layers
        for i, c in enumerate(model.gnn_convs):
            skip = h if model.gnn_skip_connection and 0 < i < L - 1 else None
            ops = [t.detach().contiguous() for t in (
                h, c.lin.weight.t(), c.att_src, c.att_dst, c.bias)]
            table = (g.block_adj,) if block else (g.nbr_nodes, g.in_degree)
            a = (ops[0], *table, *ops[1:], c.heads)
            kw = dict(neg_slope=c.negative_slope,
                      self_loops=c.add_self_loops, skip=skip,
                      act=model.gnn_activation)
            if edge:
                a_edge, a_self = c._edge_logits(g)
                if block:
                    kw.update(edge_table=gat_block.build_block_edge_logits(
                        g.senders, g.receivers, g.edge_mask, a_edge,
                        g.num_nodes, g.block_size_static),
                        self_extra=a_self)
                else:
                    kw.update(edge_logits=ell.ell_gather_valid(
                        a_edge, g.nbr_edges, g.in_degree),
                        self_edge_logit=a_self)
            if block:
                kw["concat"] = c.concat
                h = gat_block.gat_block_layer_plain(*a, **kw)
            else:
                h = gat_layer.gat_layer_plain(*a, **kw)
            out.append((a, kw))
        return out

    def in_mode(lays, block, mode):
        """The layers' operands as the kernel takes them in ``mode``."""
        res = []
        for a, kw in lays:
            a, kw = list(a), dict(kw, mode=mode)
            w, heads = a[-5], a[-1]
            if block:
                wm, wa_s, wa_d = gat_block.prepare_block(w, a[-4], a[-3],
                                                         mode)
                kw.update(wa_src=wa_s, wa_dst=wa_d)
                if staged_api:
                    kw["staged"] = gat_layer.stage_projection(
                        wm, heads, mode, wa_s, wa_d)
            else:
                wm, sw = gat_layer.prepare_layer(w, mode)
                kw["sw"] = sw
                if staged_api:
                    kw["staged"] = gat_layer.stage_projection(wm, heads, mode)
            a[-5] = wm
            res.append((tuple(a), kw))
        return res

    rows = {"9": (False, blk, True, "f32"), "9b": (False, blk, True, "bf16"),
            "9e": (True, simple, True, "f32"),
            "9eb": (True, simple, True, "bf16"),
            "10": (False, std, False, "f32"),
            "10b": (False, std, False, "bf16"),
            "10i": (False, std, False, "int8"),
            "10e": (True, std, False, "f32"),
            "10eb": (True, std, False, "bf16"),
            "10ei": (True, std, False, "int8")}
    report = {"root": os.path.abspath(args.root), "smi": smi,
              "device": torch.cuda.get_device_name(0),
              "staged_weights": staged_api, "rows": {}}
    base = {}
    for name, (edge, g, block, mode) in rows.items():
        key = (edge, block)
        if key not in base:
            base[key] = layers(edge, g, block)
        lays = in_mode(base[key], block, mode)
        fn = (gat_block.fused_gat_block_layer if block
              else gat_layer.fused_gat_layer)

        def run(lays=lays, fn=fn):
            for a, kw in lays:
                fn(*a, **kw)

        report["rows"][name] = _timed(run)
        r = report["rows"][name]
        print(f"row {name}: {r['ms']:.4f} ms (events), device "
              f"{r['device_ms']:.4f}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in r["split"].items() if v),
              flush=True)
    if staged_api:
        ws = [(a[-5], a[-1]) for a, _ in base[(False, False)]]

        def stage():
            for w, heads in ws:
                gat_layer.stage_projection(w, heads, "f32")

        report["staging_f32_six_layers"] = _timed(stage)
        print(f"staging six layers' f32 weights: "
              f"{report['staging_f32_six_layers']['ms']:.4f} ms", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

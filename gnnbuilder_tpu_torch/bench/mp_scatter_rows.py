"""The mp stack kernel's rows and the PNA scatter backward on the card.

* Rows 3 (f32), 3b (bf16) and 3i (int8) of ``ops/cuda/mp_block.py``,
  gcn, gin and sage: one launch on the b1024 block-packed batch (N =
  20,480 rows, 160 blocks), the canonical model of each conv (6 layers,
  11 -> 128 ... 128 -> 64 zero-padded to 128, skips, seeded weights,
  synthetic QM9), and the same launch on the batch's first 132 blocks
  (one block per SM of the H100): the tail of the 28 blocks past them.
* Row 6 of ``ops/cuda/scatter_bwd.py``: the six ``fused_pna_scatter_cstk``
  launches of one canonical PNA train step on the b1024 standard-packed
  train batch (N = 18,688), on the residuals of the kernel forward and a
  seeded d_mid, and (where the tree has ``stage_ks_t``) the six layers'
  ks_t staging alone.
* ``Program.forward`` of block-packed b1024 GCN and SAGE under the f32,
  bf16 and int8 policies, and the canonical PNA train step (Adam 1e-3)
  with its device time by part.

    python gnnbuilder_tpu_torch/bench/mp_scatter_rows.py [--root DIR]

``--root`` imports ``gnnbuilder_tpu_torch`` from DIR (default: this
file's tree), so one call can time an older tree beside this one (e.g.
a ``git archive`` of the parent commit) through the same public
wrappers.  Kernel rows: CUDA-event ms (10 after 2 warm-up rounds) and
the device ms by kernel under torch.profiler (5 rounds); the stack runs
on weights laid out beforehand where the tree has ``stage_mp_stack`` (as
the model's inference cache gives them).  Forwards: events over 10 after
3.  Train step: events over 10 steps after 3, then the profiler over 5.
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

# the shared timing helpers; run as a script, this file's directory is
# on sys.path and the package is imported later, from --root
if __package__:
    from .timing import _device_split, _events
else:
    from timing import _device_split, _events

CONVS = ("gcn", "gin", "sage")
MODES = {"3": "f32", "3b": "bf16", "3i": "int8"}


def _timed(fn, part_of):
    split, _ = _device_split(fn, part_of)
    return dict(ms=_events(fn), device_ms=sum(split.values()), split=split)


def _step_part(name):
    if any(k in name for k in ("pna_layer", "pna_proj", "pna_agg",
                               "pna_v_kernel")):
        return "pna_layer kernels"
    if "scatter_bwd" in name:
        return "pna_scatter_bwd kernel"
    if "ell_gather_bwd" in name:
        return "ell_gather_bwd kernel"
    if "readout_kernel" in name:
        return "readout kernel"
    if "adam" in name or "multi_tensor" in name:
        return "Adam"
    if any(t in name for t in ("gemm", "cutlass", "xmma", "gemv")):
        return "torch matmul"
    return "other torch kernels"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__)
                                          .resolve().parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from gnnbuilder_tpu_torch import Program, train
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.ops.cuda import (
        _build,
        mp_block,
        pna_layer,
        scatter_bwd,
    )

    if not torch.cuda.is_available():
        print("mp_scatter_rows: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.load()
    staged_api = hasattr(mp_block, "stage_mp_stack")
    report = {"root": os.path.abspath(args.root), "smi": smi,
              "device": torch.cuda.get_device_name(0),
              "staged_weights": staged_api, "rows": {}, "forward_ms": {}}

    # rows 3, 3b, 3i: one launch of the whole stack
    torch.set_grad_enabled(False)
    # the first of the smoke's three b1024 block batches (one bucket)
    graphs, (blk, *_) = canonical_batches("qm9", n_graphs=3072,
                                          batch_size=1024, block_size=128,
                                          node_multiple=1024, device=dev)
    x = torch.nn.functional.pad(blk.node_feat,
                                (0, 128 - blk.feature_dim)).contiguous()
    n132 = 132 * 128
    report["block_rows"] = blk.num_nodes
    models = {}
    for conv in CONVS:
        model = canonical_model(conv, "qm9", graphs=graphs)
        Program(model, device=dev, seed=41).init_params()
        models[conv] = model
        stacked = model._kernel_params(128)[0]
        L = model.gnn_num_layers
        kw = dict(conv=conv,
                  epss=[getattr(c, "eps", 0.0) for c in model.gnn_convs],
                  skips=[0 < i < L - 1 for i in range(L)],
                  act=model.gnn_activation)
        for name, mode in MODES.items():
            st, sc = mp_block.prepare_mp_stack(stacked, mode)
            mkw = dict(kw, mode=mode, scales=sc)
            if staged_api:
                mkw["staged"] = mp_block.stage_mp_stack(st, mode)

            def run(n=blk.num_nodes, st=st, mkw=mkw):
                mp_block.fused_mp_block_stack(
                    x[:n], blk.block_adj[:n // 128], blk.in_degree[:n],
                    *st, **mkw)

            key = f"{name} {conv}"
            r = _timed(run, lambda k: "stack" if "mp_block" in k
                       else "other")
            r["ms_132_blocks"] = _events(lambda: run(n132))
            report["rows"][key] = r
            print(f"row {key}: {r['ms']:.4f} ms (events), device "
                  f"{r['device_ms']:.4f}; 132 blocks "
                  f"{r['ms_132_blocks']:.4f}", flush=True)

    # Program.forward of block GCN and SAGE under each policy
    for conv in ("gcn", "sage"):
        for precision in ("f32", "bf16", "int8"):
            prog = Program(canonical_model(conv, "qm9", graphs=graphs),
                           max_nodes=blk.num_nodes,
                           max_edges=blk.num_edges,
                           max_graphs=blk.num_graphs, block_size=128,
                           precision=precision, device=dev, seed=41)
            prog.set_params({k: v.to(dev) for k, v in
                             models[conv].state_dict().items()})
            ms = _events(lambda: prog.forward(blk), warmup=3)
            report["forward_ms"][f"{conv} {precision}"] = ms
            print(f"Program.forward {conv} {precision}: {ms:.4f} ms",
                  flush=True)

    # row 6: the six coefficient launches of a PNA train step
    graphs, (std,) = canonical_batches("qm9", n_graphs=1100,
                                       batch_size=1024, node_multiple=256,
                                       device=dev)
    model = canonical_model("pna", "qm9", graphs=graphs)
    Program(model, device=dev, seed=31).init_params()
    L = model.gnn_num_layers
    g = torch.Generator(device="cpu").manual_seed(5)
    h, calls = std.node_feat, []
    for i, c in enumerate(model.gnn_convs):
        skip = h if model.gnn_skip_connection and 0 < i < L - 1 else None
        ops = pna_layer.pad_operands(
            h, c.pre_nn.weight.t(), c.pre_nn.bias, c.post_nn.weight.t(),
            c.post_nn.bias, c.lin.weight.t(), c.lin.bias, skip)
        ops = [None if t is None else t.detach().contiguous() for t in ops]
        out, _, agg_cat, aux, _ = pna_layer.fused_pna_layer(
            ops[0], std.nbr_nodes, std.in_degree, *ops[1:7], c.delta,
            skip=ops[7], act=model.gnn_activation, save_res=True)
        F = ops[1].shape[1]
        ks_t = pna_layer.scaler_blocks(ops[3], ops[0].shape[1],
                                       F).t().contiguous()
        d_mid = torch.randn(std.num_nodes, ops[5].shape[0],
                            generator=g).to(dev)
        calls.append((d_mid, aux, agg_cat, std.in_degree, ks_t, c.delta))
        h = out[:, :c.out_channels]
    report["train_rows"] = std.num_nodes

    def six():
        for a in calls:
            scatter_bwd.fused_pna_scatter_cstk(*a)

    r = _timed(six, lambda k: "scatter kernel" if "scatter_bwd" in k
               else "ks_t staging")
    report["rows"]["6"] = r
    print(f"row 6 (six launches): {r['ms']:.4f} ms (events), device "
          f"{r['device_ms']:.4f}: " + ", ".join(
              f"{k} {v:.4f}" for k, v in r["split"].items()), flush=True)
    if hasattr(scatter_bwd, "stage_ks_t"):
        def stage():
            for a in calls:
                scatter_bwd.stage_ks_t(a[4])

        r = _timed(stage, lambda k: "staging")
        report["ks_t_staging_six"] = r
        print(f"ks_t staging, six layers: {r['ms']:.4f} ms (events), "
              f"device {r['device_ms']:.4f}", flush=True)

    # the PNA train step
    torch.set_grad_enabled(True)
    # the batch holds the first 1024 graphs (and the ghost graph)
    target = train.stack_targets(graphs[:1024], std.num_graphs, device=dev)
    step = train.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3))
    ms = _events(lambda: step(std, target), warmup=3)
    split, _ = _device_split(lambda: step(std, target), _step_part)
    report["pna_step"] = dict(ms=ms, device_ms=sum(split.values()),
                              split=split)
    print(f"PNA train step: {ms:.4f} ms (events), device busy "
          f"{sum(split.values()):.4f}: " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

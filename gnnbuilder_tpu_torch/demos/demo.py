"""End-to-end demo: a 6-layer GraphSAGE on HIV-like molecular graphs (the
JAX package's ``demos/demo.py``): declare the model, train a few epochs,
evaluate ROC-AUC, verify golden parity against the serialized outputs,
and benchmark.

    python -m gnnbuilder_tpu_torch.demos.demo [--device cpu] [--graphs 256]
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

import gnnbuilder_tpu_torch as gnnb
from gnnbuilder_tpu_torch.data.datasets import load_dataset
from gnnbuilder_tpu_torch.demos import bench_line, load_params
from gnnbuilder_tpu_torch.train import (
    make_train_step,
    masked_bce_logits_loss,
    roc_auc,
    stack_targets,
)
from gnnbuilder_tpu_torch.utils.stats import (
    compute_average_nodes_and_edges,
    compute_max_nodes_and_edges,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--graphs", type=int, default=256)
    ap.add_argument("--train-graphs", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--parity-graphs", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--params", default=None,
                    help="a state dict (torch.save) to start from")
    args = ap.parse_args(argv)

    graphs = load_dataset("hiv", n=args.graphs)
    max_n, max_e = compute_max_nodes_and_edges(graphs)
    avg_n, avg_e = compute_average_nodes_and_edges(graphs)
    print(f"dataset: {len(graphs)} graphs, max {max_n}n/{max_e}e, "
          f"avg {avg_n:.1f}n/{avg_e:.1f}e")

    model = gnnb.GNNModel(
        graph_input_feature_dim=graphs[0].x.shape[1],
        gnn_hidden_dim=args.hidden,
        gnn_num_layers=args.layers,
        gnn_output_dim=args.hidden,
        gnn_conv="sage",
        gnn_skip_connection=True,
        pooling_aggrs=("add", "mean", "max"),
        mlp_hidden_dim=args.hidden,
        mlp_hidden_layers=2,
        mlp_out_dim=1,  # binary classification logit
    )

    # --- train a few epochs ---
    bs = args.batch
    prog = gnnb.Program(
        model,
        max_nodes=bs * (max_n + 1),
        max_edges=bs * (max_e + 1),
        max_graphs=bs + 1,
        device=args.device,
    )
    spans = range(0, args.train_graphs, bs)
    batches = [prog.batch(graphs[i: i + bs]) for i in spans]
    targets = [stack_targets(graphs[i: i + bs], bs + 1, device=prog.device)
               for i in spans]
    prog.init_params(batches[0])
    if args.params:
        load_params(prog, args.params)
    opt = torch.optim.Adam(prog.model.parameters(), lr=1e-3)
    step = make_train_step(prog.model, opt, loss_fn=masked_bce_logits_loss)
    epoch_losses = []
    for epoch in range(args.epochs):
        losses = [float(step(b, t)) for b, t in zip(batches, targets)]
        epoch_losses.append(float(np.mean(losses)))
        print(f"epoch {epoch}: loss {epoch_losses[-1]:.4f}")

    # --- eval ROC-AUC ---
    scores, labels = [], []
    for b, t in zip(batches, targets):
        out = prog.forward(b).detach().cpu().numpy()
        m = b.graph_mask.cpu().numpy()
        scores.extend(out[m, 0].tolist())
        labels.extend(t.cpu().numpy()[m, 0].tolist())
    auc = roc_auc(np.array(scores), np.array(labels))
    print(f"train ROC-AUC: {auc:.3f}")

    # --- golden serialization + parity ---
    with tempfile.TemporaryDirectory() as d:
        prog.gen_testbench_data(graphs[: args.parity_graphs], d)
        report = prog.run_parity_check(graphs[: args.parity_graphs], d)
        print(f"parity MAE: {report['model_output_mae']:.2e}")

    # --- benchmark ---
    bench = bench_line(prog, batches[0], args.iters)
    print(f"benchmark: {bench['graphs_per_s']:,.0f} graphs/s "
          f"({bench['latency_s'] * 1e3:.2f} ms/batch of {bs})")
    return {"losses": epoch_losses, "auc": auc, "scores": np.array(scores),
            "parity": report, "bench": bench}


if __name__ == "__main__":
    main()

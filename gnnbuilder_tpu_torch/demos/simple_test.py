"""Smoke demo: the whole flow on a fake dataset (the JAX package's
``demos/simple_test.py``): model spec -> Program -> golden-data
serialization -> parity check -> benchmark -> cost analysis, on
synthetic graphs.

    python -m gnnbuilder_tpu_torch.demos.simple_test [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile

import gnnbuilder_tpu_torch as gnnb
from gnnbuilder_tpu_torch.demos import bench_line, load_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--params", default=None,
                    help="a state dict (torch.save) to start from")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    graphs = gnnb.FakeDataset(num_graphs=16, avg_num_nodes=20, node_dim=8,
                              seed=0)
    model = gnnb.GNNModel(
        graph_input_feature_dim=8,
        gnn_hidden_dim=16,
        gnn_num_layers=2,
        gnn_output_dim=8,
        gnn_conv="gcn",
        gnn_activation="relu",
        pooling_aggrs=("add", "mean", "max"),
        mlp_hidden_dim=16,
        mlp_hidden_layers=2,
        mlp_out_dim=1,
    )

    prog = gnnb.Program(model, max_nodes=512, max_edges=1024, max_graphs=17,
                        device=args.device)
    batch = prog.batch(graphs)
    prog.init_params(batch)
    if args.params:
        load_params(prog, args.params)

    out = prog.forward(batch)
    print(f"forward: {tuple(out.shape)} (last row is the ghost graph)")

    with tempfile.TemporaryDirectory() as d:
        prog.gen_testbench_data(graphs, d)
        report = prog.run_parity_check(graphs, d)
        print(f"parity: MAE={report['model_output_mae']:.2e} "
              f"over {report['num_graphs']} graphs")

    bench = bench_line(prog, batch, args.iters)
    print(f"benchmark: {bench['latency_s'] * 1e6:.1f} us/batch, "
          f"{bench['graphs_per_s']:,.0f} graphs/s")

    cost = prog.cost_analysis(batch)
    print(f"cost analysis: {cost.get('flops', 0) / 1e6:.1f} MFLOP, "
          f"{cost.get('bytes accessed', 0) / 1e6:.1f} MB accessed")
    return {"out": out.detach().cpu().numpy(), "parity": report,
            "bench": bench, "cost": cost}


if __name__ == "__main__":
    main()

"""Serving demo: export an artifact, reload it without the model
definition, stream requests through the micro-batching server and
report p50 / p90 / p99 (the JAX package's ``demos/serve_demo.py``).

    python -m gnnbuilder_tpu_torch.demos.serve_demo [--requests 400]
        [--dataset esol] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--dataset", default="esol")
    ap.add_argument("--batch", type=int, default=32, help="max micro-batch")
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="offered load, requests/s")
    ap.add_argument("--precision", default="f32",
                    choices=["f32", "bf16", "int8"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--params", default=None,
                    help="a state dict (torch.save) to start from")
    args = ap.parse_args(argv)

    import torch

    import gnnbuilder_tpu_torch as gnnb
    from gnnbuilder_tpu_torch.data.datasets import load_dataset
    from gnnbuilder_tpu_torch.demos import load_params
    from gnnbuilder_tpu_torch.serve import GNNServer

    graphs = load_dataset(args.dataset, n=max(args.requests, 200))
    model = gnnb.GNNModel(
        graph_input_feature_dim=graphs[0].x.shape[1],
        gnn_hidden_dim=64, gnn_num_layers=3, gnn_output_dim=32,
        gnn_conv="gcn", pooling_aggrs=("add", "mean", "max"),
        mlp_hidden_dim=64, mlp_hidden_layers=2, mlp_out_dim=1,
    )
    prog = gnnb.Program.from_dataset(
        model, graphs, batch_size=args.batch, precision=args.precision,
        device=args.device,
    )
    dev = prog.device
    print(f"backend: "
          f"{torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")
    example = prog.batch(graphs[: args.batch])
    prog.init_params(example)
    if args.params:
        load_params(prog, args.params)
    if args.precision == "int8":
        print("calibrating static int8 activation scales...")
        prog.calibrate_int8([example])

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "serve_artifact.json")
        t0 = time.perf_counter()
        prog.export(path, example)
        print(f"exported artifact: {os.path.getsize(path) / 1e6:.1f} MB "
              f"in {time.perf_counter() - t0:.1f}s -> {path}")
        # reload cold, as a deployment would (no model definition needed)
        server = GNNServer.from_artifact(
            path, prog.params, max_batch=args.batch, max_wait_ms=2.0,
            device=dev)
    try:
        # warm the forward through the server before timing
        server.predict(graphs[:2])
        print(f"streaming {args.requests} requests at ~{args.rate:.0f}/s ...")
        rng = np.random.default_rng(0)
        futs = []
        t0 = time.perf_counter()
        for i in range(args.requests):
            futs.append(server.submit(graphs[i % len(graphs)]))
            time.sleep(float(rng.exponential(1.0 / args.rate)))
        preds = np.stack([f.result(timeout=120.0) for f in futs])
        wall = time.perf_counter() - t0
        s = server.stats()
    finally:
        server.close()
    print(
        f"served {s['served']} requests in {wall:.2f}s "
        f"({s['served'] / wall:.0f}/s sustained), "
        f"{s['batches']} device batches (avg {s['avg_batch']:.1f} graphs)"
    )
    print(
        f"request latency: p50 {s['p50_ms']:.2f} ms, "
        f"p90 {s['p90_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms"
    )
    return {"predictions": preds, "stats": s}


if __name__ == "__main__":
    main()

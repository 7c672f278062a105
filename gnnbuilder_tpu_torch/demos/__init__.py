"""The port's demos (the JAX package's ``demos/``): ``demo`` (train, eval,
golden parity, benchmark of a 6-layer SAGE on HIV-like graphs),
``simple_test`` (the whole flow on a fake dataset) and ``serve_demo``
(export, serve a request stream, report latencies).  Each runs with
``python -m gnnbuilder_tpu_torch.demos.<name>``, on the card unless
``--device cpu`` asks for the CPU, and uses only the port's public
surface."""


def bench_line(prog, batch, iters: int) -> dict:
    """``prog.benchmark`` (CUDA events) on the card; on the CPU, the
    marginal host time per forward (``bench.timing.marginal_time``), in
    the same keys."""
    if prog.device.type == "cuda":
        return prog.benchmark(batch, iters=iters)
    from gnnbuilder_tpu_torch.bench.timing import marginal_time

    dt = marginal_time(prog.forward, batch, n_lo=max(1, iters // 3),
                       n_hi=iters, warmup=1, repeats=1)
    return {"latency_s": dt,
            "graphs_per_s": int(batch.graph_mask.sum()) / dt,
            "edges_per_s": int(batch.edge_mask.sum()) / dt,
            "device": "cpu"}


def load_params(prog, path):
    """Load a state dict saved with ``torch.save`` into ``prog``."""
    import torch

    prog.set_params(torch.load(path, map_location="cpu", weights_only=True))

"""Scaling efficiency of the sharded train step over dp widths (the JAX
package's ``parallel/scaling.py``).

Times the sharded train step at increasing dp widths over the ranks of
the process group, each width on a submesh of the first dp * tp ranks,
with ``bench.timing.marginal_time``, and reports efficiency against
linear scaling from the first width.  Every rank of the world calls it;
the ranks outside a width's submesh wait for it.  On CPU ranks (gloo) it
checks the mechanics only; the efficiency of several cards needs a
machine with several cards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["measure_scaling"]


def measure_scaling(
    model,
    graphs,
    batch_size: int = 32,
    dp_widths: Optional[Sequence[int]] = None,
    tp: int = 1,
    iters: int = 10,
    seed: int = 0,
    device_type: str = "cuda",
) -> list[dict]:
    """Throughput of the sharded train step at each dp width: rows {dp,
    latency_s, graphs_per_s, efficiency}, the same on every rank (the
    slowest member's latency).  ``seed`` seeds the model's weights, drawn
    on every rank alike; ``device_type`` as ``make_mesh`` takes it."""
    from gnnbuilder_tpu_torch.bench.timing import marginal_time
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.parallel.mesh import make_mesh
    from gnnbuilder_tpu_torch.parallel.sharding import shard_batch
    from gnnbuilder_tpu_torch.parallel.train import make_sharded_train_step
    from gnnbuilder_tpu_torch.train import stack_targets

    n_ranks = dist.get_world_size()
    if dp_widths is None:
        dp_widths = [w for w in (1, 2, 4, 8, 16) if w * tp <= n_ranks]

    chunk = graphs[:batch_size]
    # node and edge rows split evenly over every width
    mult = int(np.lcm.reduce([w * 8 for w in dp_widths]))
    batch = build_graph_batch(chunk, node_multiple=mult, edge_multiple=mult,
                              device="cpu")
    target = stack_targets(chunk, batch.num_graphs, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, p in model.state_dict().items():
        bound = 1.0 / np.sqrt(p.shape[-1]) if p.dim() > 1 else 0.1
        params[name] = (2.0 * torch.rand(p.shape, generator=gen) - 1.0) * bound

    rows = []
    base = None
    for dp in dp_widths:
        mesh = make_mesh(dp=dp, tp=tp, device_type=device_type)
        dt = 0.0
        if mesh.member:
            sbatch = shard_batch(mesh, batch)
            starget = target.to(mesh.device)
            step, init = make_sharded_train_step(
                model, lambda ps: torch.optim.Adam(ps, lr=1e-3), mesh, batch)
            p, o = init(params)

            def timed(p, o, b, t):
                return step(p, o, b, t)[2]

            dt = marginal_time(timed, p, o, sbatch, starget,
                               n_lo=max(2, iters // 3), n_hi=iters,
                               warmup=2, repeats=1)
        # NCCL reduces device tensors only, gloo host ones
        slowest = torch.tensor([dt], dtype=torch.float64, device=(
            mesh.device if mesh.backend == "nccl" else "cpu"))
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        dt = float(slowest[0])
        tput = batch_size / dt
        if base is None:
            base = tput / dp
        rows.append(dict(dp=dp, latency_s=dt, graphs_per_s=tput,
                         efficiency=tput / (base * dp)))
    return rows

"""Graph-level readout: concatenated multi-aggregation global pooling
(the reference's MultiAggregation cat mode).  Pad nodes all live in the
ghost graph, so the ghost's output row is garbage and masked downstream.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gnnbuilder_tpu_torch.core.graph import GraphBatch
from gnnbuilder_tpu_torch.ops import segment

SUPPORTED_GLOBAL_POOLING_AGGRS = ("add", "max", "mean")

__all__ = ["GlobalPooling", "SUPPORTED_GLOBAL_POOLING_AGGRS"]


class GlobalPooling(torch.nn.Module):
    """``aggrs`` is an ordered subset of {"add", "max", "mean"}; the output
    is [G, len(aggrs) * F], aggregations concatenated in that order."""

    def __init__(self, aggrs: Sequence[str] = ("add",)):
        super().__init__()
        if not aggrs:
            raise ValueError("Aggregation list is empty.")
        for a in aggrs:
            if a not in SUPPORTED_GLOBAL_POOLING_AGGRS:
                raise NotImplementedError(
                    f"Aggregation {a} is not supported. Supported: "
                    f"{SUPPORTED_GLOBAL_POOLING_AGGRS}."
                )
        self.aggrs = tuple(aggrs)

    @property
    def num_of_aggrs(self) -> int:
        return len(self.aggrs)

    def forward(self, g: GraphBatch, x):
        from gnnbuilder_tpu_torch.parallel.halo import active_scope

        scope = active_scope()
        if scope is not None:
            return self._sharded(g, x, scope)
        G = g.num_graphs
        seg = g.node_graph
        count = g.n_node.to(x.dtype)[:, None]
        s = None
        if "add" in self.aggrs or "mean" in self.aggrs:
            s = segment.segment_sum(x, seg, G)
        outs = []
        for a in self.aggrs:
            if a == "add":
                outs.append(s)
            elif a == "mean":
                outs.append(s / count.clamp(min=1.0))
            elif (g.graph_starts is not None and g.max_graph_nodes_static
                  and G * g.max_graph_nodes_static <= 4 * g.num_nodes):
                # graphs are contiguous row ranges: a [G, maxg] window max
                # unless one large graph makes the window outgrow the batch
                outs.append(segment.contiguous_segment_max(
                    x, g.graph_starts, g.n_node, g.max_graph_nodes_static))
            else:
                outs.append(segment.segment_max(x, seg, G, count=count))
        return torch.cat(outs, dim=-1)

    def _sharded(self, g: GraphBatch, x, scope):
        """Pooling of a rank's node rows in a sharded forward (the JAX
        package's pooling under halo): add and mean sum the per-graph
        partials over dp; max all-gathers each rank's per-graph max (-3e38
        where the rank holds none of a graph's rows) and takes the max,
        so its gradient goes to the rank, and row, that achieved it (split
        evenly over ties, as the JAX max); an empty graph gives 0."""
        from gnnbuilder_tpu_torch.parallel import _comm

        mesh, axis = scope.mesh, scope.axis
        G = g.num_graphs
        seg = g.node_graph.long()
        count = g.n_node.to(x.dtype)[:, None]
        s = None
        if "add" in self.aggrs or "mean" in self.aggrs:
            s = _comm.all_reduce_sum(segment.segment_sum(x, seg, G), mesh,
                                     axis)
        outs = []
        for a in self.aggrs:
            if a == "add":
                outs.append(s)
            elif a == "mean":
                outs.append(s / count.clamp(min=1.0))
            else:
                m = x.new_full((G,) + tuple(x.shape[1:]), float("-inf"))
                m = m.scatter_reduce(0, seg[:, None].expand_as(x), x,
                                     reduce="amax", include_self=True)
                m = torch.where(torch.isfinite(m), m, m.new_full((), -3e38))
                every = _comm.all_gather(m, mesh, axis)
                m = every.view((mesh.shape[axis], G) + tuple(x.shape[1:]))
                m = m.amax(dim=0)
                outs.append(torch.where(count > 0, m, m.new_zeros(())))
        return torch.cat(outs, dim=-1)

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

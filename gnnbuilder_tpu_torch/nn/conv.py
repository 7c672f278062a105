"""Message-passing convs: GCN, GIN, SAGE and PNA (the JAX package's
``nn/conv.py``, PyG semantics).  Each takes ``(g, x, act, skip)`` and
returns ``[N, out_channels]``; the skip is added before the activation.

GCN, GIN and SAGE aggregate with the block-diagonal product on a
block-packed batch (``dispatch.block_cfg``), else over the ELL table, else
over the edge list.  On a block-packed batch under inference scope the
model runs GCN and SAGE stacks through the mp stack kernel instead
(``nn/model.py``); these per-layer paths are plain torch.

GCN: self loops added analytically, ``dis = rsqrt(in_degree + 1)``, the
normalised sum ``dis_i sum_j dis_j h_j + dis_i^2 h_i``; ``lin`` has no
bias, ``bias`` is added after aggregation; the transform runs first only
when ``out_channels <= in_channels``.  GIN: ``lin1(relu(lin0((1 + eps) x
+ sum_j x_j)))``.  SAGE: ``lin_l(mean_j x_j) + lin_r(x)``, the mean over
max(deg, 1); ``lin_l`` has a bias, ``lin_r`` none.

PNA with towers=1, divide_input=False, one pre and one post layer (PyG
semantics, the JAX package's ``nn/conv.py`` PNAConv): message
``pre_nn([x_i || x_j])``; aggregate with max/min/mean/std over the ELL
table; scale the concat by identity, log(d+1)/delta and delta/log(d+1)
with d clamped to >= 1; ``post_nn([x_i || scaled])``; then ``lin``.

With the default aggregators and scalers, and when ``dispatch.pna_layer_cfg``
allows, the layer runs through ``ops.cuda.pna_layer.fused_pna_layer_auto``
(the CUDA kernel on the card, differentiable through its hand-written
backward); otherwise through the plain torch ops below: over the ELL table, or over the edge list on
a batch that ships none (an in-degree over 64, or ``ell_width=0``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from gnnbuilder_tpu_torch.core.graph import GraphBatch
from gnnbuilder_tpu_torch.nn.linear import BlockScaledLinear, PairLinear
from gnnbuilder_tpu_torch.ops import block, dispatch, ell, segment
from gnnbuilder_tpu_torch.ops.activations import get_activation

__all__ = ["GCNConv", "GINConv", "SAGEConv", "PNAConv", "PNA_AGGREGATORS",
           "PNA_SCALERS", "SUPPORTED_GNN_CONVS"]

PNA_AGGREGATORS = ("max", "min", "mean", "std")
PNA_SCALERS = ("identity", "amplification", "attenuation")


def _finish(out, act, skip):
    """Skip add (before the activation), then the activation."""
    if skip is not None:
        out = out + skip
    if act is not None:
        out = get_activation(act)(out)
    return out


def _sum(g: GraphBatch, x):
    """Sum of each node's incoming neighbour rows: block product, ELL
    table or edge list, in that order of preference."""
    if dispatch.block_cfg(g) is not None:
        return block.block_sum(x, g.block_adj)
    if g.nbr_nodes is not None:
        return ell.ell_sum(x, g.nbr_nodes, g.in_degree)
    return segment.segment_sum(x[g.senders.long()], g.receivers,
                               g.num_nodes)


class GCNConv(torch.nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.lin = torch.nn.Linear(in_channels, out_channels, bias=False)
        self.bias = torch.nn.Parameter(torch.zeros(out_channels))

    def forward(self, g: GraphBatch, x, act=None, skip=None):
        dis = torch.rsqrt(g.in_degree.to(x.dtype) + 1.0)[:, None]
        transform_first = self.out_channels <= self.in_channels
        h = self.lin(x) if transform_first else x
        # separable norm 1/sqrt((1+d_i)(1+d_j)) = dis_i dis_j: scale once
        # per sender, sum, scale once per receiver
        agg = dis * _sum(g, h * dis)
        agg = agg + h * (dis * dis)        # self loop: norm_ii = 1/deg_i
        out = agg if transform_first else self.lin(agg)
        return _finish(out + self.bias, act, skip)


class GINConv(torch.nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 eps: float = 0.0):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.eps = float(eps)
        self.lin0 = torch.nn.Linear(in_channels, out_channels)
        self.lin1 = torch.nn.Linear(out_channels, out_channels)

    def forward(self, g: GraphBatch, x, act=None, skip=None):
        h = (1.0 + self.eps) * x + _sum(g, x)
        return _finish(self.lin1(torch.relu(self.lin0(h))), act, skip)


class SAGEConv(torch.nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.lin_l = torch.nn.Linear(in_channels, out_channels)
        self.lin_r = torch.nn.Linear(in_channels, out_channels, bias=False)

    def forward(self, g: GraphBatch, x, act=None, skip=None):
        deg = g.in_degree.to(x.dtype)[:, None]
        agg = _sum(g, x) / deg.clamp(min=1.0)
        return _finish(self.lin_l(agg) + self.lin_r(x), act, skip)


class PNAConv(torch.nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 delta: float = 1.0,
                 aggregators: Sequence[str] = PNA_AGGREGATORS,
                 scalers: Sequence[str] = PNA_SCALERS):
        super().__init__()
        for a in aggregators:
            if a not in ("sum", "mean", "std", "max", "min"):
                raise ValueError(f"unknown aggregator {a}")
        for s in scalers:
            if s not in PNA_SCALERS:
                raise ValueError(f"unknown scaler {s}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.delta = float(delta)
        self.aggregators = tuple(aggregators)
        self.scalers = tuple(scalers)
        F = in_channels
        self.pre_nn = PairLinear(2 * F, F)
        self.post_nn = BlockScaledLinear(
            F + len(self.aggregators) * len(self.scalers) * F, out_channels)
        self.lin = torch.nn.Linear(out_channels, out_channels)

    def forward(self, g: GraphBatch, x, act=None, skip=None):
        if (self.aggregators == PNA_AGGREGATORS
                and self.scalers == PNA_SCALERS):
            if dispatch.pna_layer_cfg(g, act) is not None:
                from gnnbuilder_tpu_torch.ops.cuda.pna_layer import (
                    fused_pna_layer_auto,
                )

                return fused_pna_layer_auto(
                    x, g.nbr_nodes, g.in_degree, self.pre_nn.weight.t(),
                    self.pre_nn.bias, self.post_nn.weight.t(),
                    self.post_nn.bias, self.lin.weight.t(), self.lin.bias,
                    self.delta, skip=skip, act=act,
                    rev_nbr_nodes=g.rev_nbr_nodes, out_degree=g.out_degree)
        u, v = self.pre_nn(x, x)
        if g.nbr_nodes is not None:
            table = u[:, None, :] + ell.ell_gather(v, g.nbr_nodes)
            mask = ell.ell_mask(g.nbr_nodes, g.in_degree)
            aggs = ell.ell_multi_table(table, g.in_degree, self.aggregators,
                                       mask)
        else:
            h_edge = u[g.receivers.long()] + v[g.senders.long()]
            aggs = segment.segment_multi(
                h_edge, g.receivers, g.num_nodes, self.aggregators,
                count=g.in_degree.to(x.dtype)[:, None])
        agg_cat = torch.cat([aggs[a] for a in self.aggregators], dim=-1)
        deg = g.in_degree.to(x.dtype).clamp(min=1.0)[:, None]
        log_deg = torch.log(deg + 1.0)
        scales = []
        for s in self.scalers:
            if s == "identity":
                scales.append(None)
            elif s == "amplification":
                scales.append(log_deg / self.delta)
            else:
                scales.append(self.delta / log_deg)
        out = self.post_nn(x, agg_cat, scales)
        return _finish(self.lin(out), act, skip)


SUPPORTED_GNN_CONVS = {"gcn": GCNConv, "gin": GINConv, "sage": SAGEConv,
                       "pna": PNAConv}

"""PNAConv — the per-layer plain path of the slice.

PNA with towers=1, divide_input=False, one pre and one post layer (PyG
semantics, the JAX package's ``nn/conv.py`` PNAConv): message
``pre_nn([x_i || x_j])``; aggregate with max/min/mean/std over the ELL
table; scale the concat by identity, log(d+1)/delta and delta/log(d+1)
with d clamped to >= 1; ``post_nn([x_i || scaled])``; then ``lin``.

With the default aggregators and scalers, and when ``dispatch.pna_layer_cfg``
allows, the layer runs through ``ops.cuda.pna_layer.fused_pna_layer_auto``
(the CUDA kernel on the card, differentiable through its hand-written
backward); otherwise through the plain torch ops below.
"""

from __future__ import annotations

from typing import Sequence

import torch

from gnnbuilder_tpu_torch.core.graph import GraphBatch
from gnnbuilder_tpu_torch.nn.linear import BlockScaledLinear, PairLinear
from gnnbuilder_tpu_torch.ops import ell
from gnnbuilder_tpu_torch.ops.activations import get_activation

__all__ = ["PNAConv", "PNA_AGGREGATORS", "PNA_SCALERS",
           "SUPPORTED_GNN_CONVS"]

PNA_AGGREGATORS = ("max", "min", "mean", "std")
PNA_SCALERS = ("identity", "amplification", "attenuation")


def _finish(out, act, skip):
    """Skip add (before the activation), then the activation."""
    if skip is not None:
        out = out + skip
    if act is not None:
        out = get_activation(act)(out)
    return out


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
        if g.nbr_nodes is None:
            raise ValueError("PNAConv needs the batch's ELL table "
                             "(build_graph_batch with ell_width != 0)")
        if (self.aggregators == PNA_AGGREGATORS
                and self.scalers == PNA_SCALERS):
            from gnnbuilder_tpu_torch.ops import dispatch

            if dispatch.pna_layer_cfg(g, act) is not None:
                from gnnbuilder_tpu_torch.ops.cuda.pna_layer import (
                    fused_pna_layer_auto,
                )

                return fused_pna_layer_auto(
                    x, g.nbr_nodes, g.in_degree, self.pre_nn.weight.t(),
                    self.pre_nn.bias, self.post_nn.weight.t(),
                    self.post_nn.bias, self.lin.weight.t(), self.lin.bias,
                    self.delta, skip=skip, act=act)
        u, v = self.pre_nn(x, x)
        table = u[:, None, :] + ell.ell_gather(v, g.nbr_nodes)
        mask = ell.ell_mask(g.nbr_nodes, g.in_degree)
        aggs = ell.ell_multi_table(table, g.in_degree, self.aggregators,
                                   mask)
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


SUPPORTED_GNN_CONVS = {"pna": PNAConv}

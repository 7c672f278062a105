"""ELL (padded neighbour table) aggregation: the plain aggregation of
every conv on a batch that carries the table.

Each node's incoming neighbours sit in a dense [N, W] table (slot d valid
iff d < in_degree[n]), so every aggregation is a dense row gather and a
masked reduce over the width axis.  Numerics follow the JAX package's
``ops/ell.py``: empty rows give 0 for sum/mean/max/min, and
std = sqrt(relu(E[x^2] - E[x]^2) + 1e-5), which is sqrt(1e-5) on an empty
row.
"""

from __future__ import annotations

import torch

__all__ = ["ell_gather", "ell_mask", "ell_sum", "ell_mean",
           "ell_multi_table", "_STD_EPS"]

_STD_EPS = 1e-5  # PyG StdAggregation epsilon


def ell_mask(nbr_nodes, in_degree):
    """[N, W] bool validity mask: slot d of node n is real iff d < deg[n]."""
    W = nbr_nodes.shape[1]
    slot = torch.arange(W, device=nbr_nodes.device)[None, :]
    return slot < in_degree[:, None]


def ell_gather(values, table):
    """Gather rows of ``values`` [M, F] by an ELL id table [N, W] -> [N, W, F]."""
    return values[table.long()]


def ell_sum(x, nbr_nodes, in_degree, mask=None):
    """Sum of each node's incoming neighbour rows of x [M, F] -> [N, F]."""
    g = ell_gather(x, nbr_nodes)
    m = ell_mask(nbr_nodes, in_degree) if mask is None else mask
    return torch.where(m[..., None], g, torch.zeros((), dtype=x.dtype,
                                                    device=x.device)).sum(1)


def ell_mean(x, nbr_nodes, in_degree, mask=None):
    """Mean over max(in_degree, 1) neighbours (0 on an empty row)."""
    s = ell_sum(x, nbr_nodes, in_degree, mask)
    return s / in_degree.to(x.dtype).clamp(min=1.0)[:, None]


def ell_multi_table(g, in_degree, aggregators, mask):
    """Multi-aggregate a message table [N, W, F] (e.g. PNA's per-slot
    pre_nn output) with validity ``mask`` [N, W].  Returns {name: [N, F]}."""
    m = mask[..., None]
    deg = in_degree.to(g.dtype)[:, None]
    denom = deg.clamp(min=1.0)
    nonempty = deg > 0
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    out = {}
    need_mean = "mean" in aggregators or "std" in aggregators
    s = None
    if "sum" in aggregators or need_mean:
        s = torch.where(m, g, zero).sum(dim=1)
    if "sum" in aggregators:
        out["sum"] = s
    if need_mean:
        mean = s / denom
        if "mean" in aggregators:
            out["mean"] = mean
        if "std" in aggregators:
            mean_sq = torch.where(m, g * g, zero).sum(dim=1) / denom
            var = torch.relu(mean_sq - mean * mean)
            out["std"] = torch.sqrt(var + _STD_EPS)
    if "max" in aggregators:
        r = torch.where(m, g, float("-inf")).amax(dim=1)
        out["max"] = torch.where(nonempty, r, zero)
    if "min" in aggregators:
        r = torch.where(m, g, float("inf")).amin(dim=1)
        out["min"] = torch.where(nonempty, r, zero)
    return out

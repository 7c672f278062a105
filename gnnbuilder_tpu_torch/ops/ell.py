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

__all__ = ["ell_gather", "ell_mask", "ell_sum", "ell_mean", "ell_max",
           "ell_min", "ell_std", "ell_multi", "ell_multi_table",
           "ell_softmax_sum", "ell_own_pads", "ell_gather_valid",
           "reverse_csr", "_STD_EPS"]

_STD_EPS = 1e-5  # PyG StdAggregation epsilon


def ell_mask(nbr_nodes, in_degree):
    """[N, W] bool validity mask: slot d of node n is real iff d < deg[n]."""
    W = nbr_nodes.shape[1]
    slot = torch.arange(W, device=nbr_nodes.device)[None, :]
    return slot < in_degree[:, None]


def ell_gather(values, table, node_rows: bool = True):
    """Gather rows of ``values`` [M, F] by an ELL id table [N, W] -> [N, W, F].

    Under a sharded forward's scope (``parallel.halo``: ``halo_scope`` or
    ``allgather_scope``) ``values`` holds this rank's rows and ``table``
    global ids: the gather reads the ring-exchanged [halo | local | halo]
    window, out-of-window (ghost and pad) ids clamped to its edge and
    masked by degree downstream, or the rows all-gathered over dp.
    ``node_rows=False`` marks an edge-indexed gather (GINE's edge slots):
    under halo the edge arrays replicate, so the ids are taken as they
    are (the JAX package's ``ell_gather``)."""
    from gnnbuilder_tpu_torch.parallel.halo import active_scope, scoped_gather

    scope = active_scope()
    if scope is not None:
        return scoped_gather(scope, values, table, node_rows)
    return values[table.long()]


def ell_own_pads(nbr_nodes, in_degree):
    """The table with each pad slot pointing at its own row in place of
    the ghost.  The masked reductions above give the same values over
    either table; through this one, autograd of a gather accumulates each
    row's pad slots into that row, where all of them would otherwise
    accumulate into the ghost row one after another (hundreds of ms on
    the card at b1024)."""
    rows = torch.arange(nbr_nodes.shape[0], device=nbr_nodes.device,
                        dtype=nbr_nodes.dtype)[:, None]
    return torch.where(ell_mask(nbr_nodes, in_degree), nbr_nodes, rows)


def ell_gather_valid(values, table, in_degree):
    """``ell_gather`` with 0 at the pad slots, which read another row each
    (slot index mod the rows of ``values``): the valid slots give the
    same values, and autograd of the gather spreads the pad slots' zero
    gradients over the rows instead of accumulating all of them into the
    one row every pad slot names (the last pad edge of ``nbr_edges``)."""
    mask = ell_mask(table, in_degree)
    spread = torch.arange(table.numel(), device=table.device).view(
        table.shape) % values.shape[0]
    g = ell_gather(values, torch.where(mask, table.long(), spread))
    return torch.where(mask.view(mask.shape + (1,) * (values.dim() - 1)),
                       g, g.new_zeros(()))


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


def _ell_extremum(x, nbr_nodes, in_degree, mask, fill, reduce):
    g = ell_gather(x, nbr_nodes)
    m = ell_mask(nbr_nodes, in_degree) if mask is None else mask
    r = reduce(torch.where(m[..., None], g, fill), dim=1)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(in_degree[:, None] > 0, r, zero)


def ell_max(x, nbr_nodes, in_degree, mask=None):
    """Max over each node's incoming neighbour rows (0 on an empty row)."""
    return _ell_extremum(x, nbr_nodes, in_degree, mask, float("-inf"),
                         torch.amax)


def ell_min(x, nbr_nodes, in_degree, mask=None):
    """Min over each node's incoming neighbour rows (0 on an empty row)."""
    return _ell_extremum(x, nbr_nodes, in_degree, mask, float("inf"),
                         torch.amin)


def ell_std(x, nbr_nodes, in_degree, mask=None):
    """sqrt(relu(E[x^2] - E[x]^2) + 1e-5) over each node's incoming
    neighbour rows, the means over max(in_degree, 1)."""
    return ell_multi(x, nbr_nodes, in_degree, ("std",), mask)["std"]


def ell_multi(x, nbr_nodes, in_degree, aggregators, mask=None):
    """Every aggregator of ``aggregators`` (sum, mean, max, min, std) from
    one gather of the neighbour rows.  Returns {name: [N, F]}."""
    m = ell_mask(nbr_nodes, in_degree) if mask is None else mask
    return ell_multi_table(ell_gather(x, nbr_nodes), in_degree, aggregators,
                           m)


def reverse_csr(nbr_nodes, in_degree, positions: bool = False):
    """The transpose of the forward ELL table as a CSR, built on the
    table's device: (rev_ptr [N + 1] int32, rev_idx [E] int32), where
    ``rev_idx[rev_ptr[j]:rev_ptr[j + 1]]`` are the receivers i of sender j
    over the valid slots (i, w), w < in_degree[i], in row-major slot order
    (a stable sort by sender).  Every edge of a batch that carries the
    ELL table is in it, so this serves batches whose reverse table was
    not built (an out-degree over 64, or ``rev_ell_width=0``).  With
    ``positions``, also rev_pos [N, W] int32: the CSR position of each
    valid forward slot (-1 on the others)."""
    N, W = nbr_nodes.shape
    m = ell_mask(nbr_nodes, in_degree)
    recv = torch.arange(N, device=nbr_nodes.device)[:, None].expand(N, W)
    send, order = torch.sort(nbr_nodes[m].long(), stable=True)
    rev_idx = recv[m][order].to(torch.int32)
    bounds = torch.arange(N + 1, device=nbr_nodes.device)
    rev_ptr = torch.searchsorted(send, bounds).to(torch.int32)
    if not positions:
        return rev_ptr, rev_idx
    slot = torch.arange(N * W, device=nbr_nodes.device).view(N, W)[m]
    rev_pos = torch.full((N * W,), -1, dtype=torch.int32,
                         device=nbr_nodes.device)
    rev_pos[slot[order]] = torch.arange(order.shape[0], dtype=torch.int32,
                                        device=nbr_nodes.device)
    return rev_ptr, rev_idx, rev_pos.view(N, W)


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


def ell_softmax_sum(logits_table, values_table, valid_mask, extra_logit=None,
                    extra_value=None):
    """Masked softmax over each row's W slots (and an optional extra slot),
    then the softmax-weighted sum of the values: the GAT attention reduce.

    ``logits_table`` [N, W, H], ``values_table`` [N, W, H, C],
    ``valid_mask`` [N, W]; ``extra_logit`` [N, H] and ``extra_value`` [N,
    H, C] are the analytic self-loop slot.  Invalid slots mask with -inf;
    a row max that is not finite (an empty row without the extra slot)
    counts as 0, and the denominator is clamped at 1e-16, so an empty row
    gives 0.  Returns [N, H, C]."""
    m = valid_mask[..., None]
    z = torch.where(m, logits_table, float("-inf"))
    row_max = z.amax(dim=1)                                   # [N, H]
    if extra_logit is not None:
        row_max = torch.maximum(row_max, extra_logit)
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    zero = logits_table.new_zeros(())
    e = torch.where(m, torch.exp(torch.where(
        m, logits_table - row_max[:, None, :], zero)), zero)
    denom = e.sum(dim=1)                                      # [N, H]
    num = (e[..., None] * values_table).sum(dim=1)            # [N, H, C]
    if extra_logit is not None:
        e_self = torch.exp(extra_logit - row_max)
        denom = denom + e_self
        num = num + e_self[..., None] * extra_value
    return num / denom.clamp(min=1e-16)[..., None]

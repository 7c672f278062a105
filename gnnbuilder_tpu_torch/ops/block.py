"""Block-diagonal dense aggregation on block-packed batches (the JAX
package's ``ops/block.py``).

A block-packed batch ships ``block_adj [T, B, B]`` with ``A[t, i, j]`` the
number of edges (t*B + j) -> (t*B + i), so a neighbour sum is one batched
product ``A @ v.reshape(T, B, F)``.  The counts are small integers, exact
in float32, so one float32 product gives the sums the JAX package's
precision modes approximate with bf16 passes on the TPU.  ``mm="bf16"``
(the bf16 policy, ``dispatch.block_cfg``) rounds the dense operand to
bf16 first, as the JAX package's bf16 mode does; the sums stay float32.
Empty rows give 0 (mean divides by max(deg, 1)).
"""

from __future__ import annotations

import torch

from gnnbuilder_tpu_torch.ops.activations import leaky_relu
from gnnbuilder_tpu_torch.ops.ell import _STD_EPS
from gnnbuilder_tpu_torch.ops.quant import to_bf16

__all__ = ["block_spmm", "block_sum", "block_mean", "block_std",
           "block_multi", "block_gat_attention", "BIG"]

BIG = 3e38  # the finite -inf of the JAX package's block attention


def block_spmm(block_adj, v, transpose: bool = False, mm=None):
    """out[i] = sum_j A[i, j] v[j] over each row's block; with
    ``transpose`` the receiver index is contracted instead:
    out[j] = sum_i A[i, j] v[i].  ``v`` is [N, F] with N = T * B;
    ``mm="bf16"`` rounds it to bf16 first."""
    T, B, _ = block_adj.shape
    N, F = v.shape
    if N != T * B:
        raise ValueError(f"v has {N} rows; block_adj covers {T} x {B}")
    if mm == "bf16":
        v = v.to(torch.bfloat16).to(v.dtype)
    elif mm is not None:
        raise ValueError(f"unknown mm {mm!r}")
    a = block_adj.to(v.dtype)
    if transpose:
        a = a.transpose(1, 2)
    return torch.bmm(a, v.reshape(T, B, F)).reshape(N, F)


def block_sum(x, block_adj, mm=None):
    return block_spmm(block_adj, x, mm=mm)


def block_mean(x, block_adj, in_degree, mm=None):
    d = in_degree.to(x.dtype).clamp(min=1.0)
    return block_spmm(block_adj, x, mm=mm) / d[:, None]


def block_std(x, block_adj, in_degree, mm=None):
    return block_multi(x, block_adj, in_degree, ("std",), mm=mm)["std"]


def block_multi(x, block_adj, in_degree, aggregators, mm=None):
    """sum, mean and std in one batched product over ``[x | x^2]``; max
    and min have no product form and come from the ELL table.  Returns
    {name: [N, F]}; std = sqrt(relu(E[x^2] - E[x]^2) + 1e-5)."""
    bad = set(aggregators) - {"sum", "mean", "std"}
    if bad:
        raise ValueError(f"no block form for aggregators {sorted(bad)}")
    F = x.shape[1]
    need_sq = "std" in aggregators
    both = block_spmm(block_adj, torch.cat([x, x * x], dim=-1)
                      if need_sq else x, mm=mm)
    s = both[:, :F]
    d = in_degree.to(x.dtype).clamp(min=1.0)[:, None]
    out = {}
    if "sum" in aggregators:
        out["sum"] = s
    mean = s / d
    if "mean" in aggregators:
        out["mean"] = mean
    if need_sq:
        var = torch.relu(both[:, F:] / d - mean * mean)
        out["std"] = torch.sqrt(var + _STD_EPS)
    return out


def block_gat_attention(block_adj, h, a_src, a_dst, neg_slope: float = 0.2,
                        self_loops: bool = True, bf16_sum: bool = False):
    """GAT attention as dense masked attention per block (PyG semantics):
    logits leaky_relu(a_src_j + a_dst_i) over each receiver's incoming
    edges (and the analytic self loop), softmax, weighted sum of h.

    ``block_adj`` [T, B, B] holds edge counts, so k parallel edges give k
    identical softmax terms: the weights are A * exp(raw - m).  Non-edges
    mask with -BIG before the row max.  ``h`` [N, H, C], ``a_src`` and
    ``a_dst`` [N, H]; returns [N, H, C].  ``bf16_sum`` rounds the weights
    and h to bf16 in the neighbours' weighted sum (the GAT block kernel's
    bf16 mode); the denominator and the self term stay float32."""
    T, B, _ = block_adj.shape
    N, H, C = h.shape
    if N != T * B:
        raise ValueError(f"h has {N} rows; block_adj covers {T} x {B}")
    A = block_adj.to(h.dtype).reshape(T, 1, B, B)
    mask = A > 0
    asrc = a_src.reshape(T, B, H).transpose(1, 2)             # [T, H, B] j
    adst = a_dst.reshape(T, B, H).transpose(1, 2)             # [T, H, B] i
    raw = leaky_relu(
        adst[..., :, None] + asrc[..., None, :], neg_slope)    # [T,H,Bi,Bj]
    m = torch.where(mask, raw, -BIG).amax(dim=-1)             # [T, H, Bi]
    if self_loops:
        self_logit = leaky_relu(
            (a_src + a_dst).reshape(T, B, H).transpose(1, 2), neg_slope)
        m = torch.maximum(m, self_logit)
    # exp only where an edge is, so no masked entry overflows
    w = A * torch.exp(torch.where(mask, raw - m[..., None], -float("inf")))
    denom = w.sum(dim=-1)                                     # [T, H, Bi]
    hb = h.reshape(T, B, H, C).transpose(1, 2)                # [T, H, B, C]
    num = (torch.matmul(to_bf16(w), to_bf16(hb)) if bf16_sum
           else torch.matmul(w, hb))
    if self_loops:
        es = torch.exp(self_logit - m)
        denom = denom + es
        num = num + es[..., None] * hb
    out = num / denom.clamp(min=1e-16)[..., None]
    return out.transpose(1, 2).reshape(N, H, C)

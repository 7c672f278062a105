"""Block-diagonal dense aggregation on block-packed batches (the JAX
package's ``ops/block.py``).

A block-packed batch ships ``block_adj [T, B, B]`` with ``A[t, i, j]`` the
number of edges (t*B + j) -> (t*B + i), so a neighbour sum is one batched
product ``A @ v.reshape(T, B, F)``.  The counts are small integers, exact
in float32, so one float32 product gives the sums the JAX package's
precision modes approximate with bf16 passes on the TPU; there is no
``mm`` argument.  Empty rows give 0 (mean divides by max(deg, 1)).
"""

from __future__ import annotations

import torch

__all__ = ["block_spmm", "block_sum", "block_mean"]


def block_spmm(block_adj, v, transpose: bool = False):
    """out[i] = sum_j A[i, j] v[j] over each row's block; with
    ``transpose`` the receiver index is contracted instead:
    out[j] = sum_i A[i, j] v[i].  ``v`` is [N, F] with N = T * B."""
    T, B, _ = block_adj.shape
    N, F = v.shape
    if N != T * B:
        raise ValueError(f"v has {N} rows; block_adj covers {T} x {B}")
    a = block_adj.to(v.dtype)
    if transpose:
        a = a.transpose(1, 2)
    return torch.bmm(a, v.reshape(T, B, F)).reshape(N, F)


def block_sum(x, block_adj):
    return block_spmm(block_adj, x)


def block_mean(x, block_adj, in_degree):
    d = in_degree.to(x.dtype).clamp(min=1.0)
    return block_spmm(block_adj, x) / d[:, None]

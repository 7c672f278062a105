"""Segment (per-receiver or per-graph) reductions: the edge-list path of
every aggregation, used where a batch carries no ELL table.

Numerics follow the JAX package's ``ops/segment.py`` (PyG aggregation
semantics): empty segments give 0 for every aggregator, and
std = sqrt(relu(E[x^2] - E[x]^2) + 1e-5).

``segment_sum`` accumulates with ``index_put_(accumulate=True)``, which
on a CUDA tensor sorts the ids first and so sums in a fixed order: the
same inputs give the same bits on every run (``index_add_`` adds with
atomics in whatever order they land).
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum", "segment_count", "segment_mean", "segment_max",
           "segment_min", "segment_std", "segment_multi",
           "contiguous_segment_max"]

_STD_EPS = 1e-5  # PyG StdAggregation epsilon


def segment_sum(data, segment_ids, num_segments):
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_put_((segment_ids.long(),), data, accumulate=True)


def segment_count(segment_ids, num_segments, dtype=torch.float32):
    ones = torch.ones(segment_ids.shape + (1,), dtype=dtype,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data, segment_ids, num_segments, count=None):
    s = segment_sum(data, segment_ids, num_segments)
    if count is None:
        count = segment_count(segment_ids, num_segments, data.dtype)
    return s / count.clamp(min=1.0)


def _segment_extremum(data, segment_ids, num_segments, count, reduce):
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), fill)
    idx = segment_ids.long().view(-1, *([1] * (data.dim() - 1)))
    out = out.scatter_reduce(0, idx.expand_as(data), data, reduce=reduce,
                             include_self=True)
    if count is None:
        count = segment_count(segment_ids, num_segments, data.dtype)
    return torch.where(count > 0, out, torch.zeros_like(out))


def segment_max(data, segment_ids, num_segments, count=None):
    """Per-segment max; empty segments give 0 (PyG convention)."""
    return _segment_extremum(data, segment_ids, num_segments, count, "amax")


def segment_min(data, segment_ids, num_segments, count=None):
    """Per-segment min; empty segments give 0 (PyG convention)."""
    return _segment_extremum(data, segment_ids, num_segments, count, "amin")


def segment_std(data, segment_ids, num_segments, count=None):
    if count is None:
        count = segment_count(segment_ids, num_segments, data.dtype)
    denom = count.clamp(min=1.0)
    mean = segment_sum(data, segment_ids, num_segments) / denom
    mean_sq = segment_sum(data * data, segment_ids, num_segments) / denom
    var = torch.relu(mean_sq - mean * mean)
    return torch.sqrt(var + _STD_EPS)


def segment_multi(data, segment_ids, num_segments, aggregators, count=None):
    """Several aggregations of the same messages, sharing the sum and the
    count between mean and std.  Returns {name: [num_segments, F]}."""
    if count is None:
        count = segment_count(segment_ids, num_segments, data.dtype)
    out = {}
    need_mean = "mean" in aggregators or "std" in aggregators
    s = None
    if "sum" in aggregators or need_mean:
        s = segment_sum(data, segment_ids, num_segments)
    if "sum" in aggregators:
        out["sum"] = s
    if need_mean:
        denom = count.clamp(min=1.0)
        mean = s / denom
        if "mean" in aggregators:
            out["mean"] = mean
        if "std" in aggregators:
            mean_sq = segment_sum(data * data, segment_ids,
                                  num_segments) / denom
            var = torch.relu(mean_sq - mean * mean)
            out["std"] = torch.sqrt(var + _STD_EPS)
    if "max" in aggregators:
        out["max"] = segment_max(data, segment_ids, num_segments, count)
    if "min" in aggregators:
        out["min"] = segment_min(data, segment_ids, num_segments, count)
    return out


def contiguous_segment_max(data, starts, counts, max_rows: int):
    """Per-segment max when segments are CONTIGUOUS row ranges
    ``[starts[g], starts[g] + counts[g])``, from a [G, max_rows] window.

    Exact for every segment with count <= max_rows (every real graph).
    Longer segments (only the ghost graph's pad tail) reduce their first
    max_rows rows: finite garbage, masked downstream.  Empty segments give
    0.  Invalid slots mask with -inf, so the result equals
    ``segment_max`` for any finite input."""
    n = data.shape[0]
    pos = torch.arange(max_rows, device=data.device, dtype=torch.int64)
    rows = (starts.long()[:, None] + pos[None, :]).clamp(0, n - 1)
    win = data[rows].float()                           # [G, max_rows, F]
    cnt = counts.long()
    valid = pos[None, :] < cnt[:, None]                # [G, max_rows]
    win = win.masked_fill(~valid[:, :, None], float("-inf"))
    m = win.amax(dim=1)
    return torch.where((cnt > 0)[:, None], m,
                       torch.zeros_like(m)).to(data.dtype)

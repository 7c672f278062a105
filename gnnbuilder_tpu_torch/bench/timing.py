"""Device timing on the card (the JAX package's ``bench/timing.py``).

CUDA launches are asynchronous: a call returns to the host when its
kernels are queued on the stream, not when they have run, so a host
clock read right after a call measures the enqueue.  ``timed_fence``
reads the sum of a call's output back to the host, which waits until
the card has finished every kernel queued before it on the stream.
``marginal_time`` times two call counts, each ended by one fence, and
returns the per-call difference: the fence's own cost (a reduction, a
copy of four bytes, the host's wake-up) and the time to fill the queue
appear in both windows and cancel.

MEASUREMENT PROTOCOL (the JAX package's, kept as it is):
  * chained calls (x = fn(x)) so consecutive calls depend on each other
    and the card runs them one after another — ``chained_marginal_time``;
  * median over ``repeats`` marginal estimates (host-clock noise has
    heavy positive outliers, from scheduling and other work on the
    host's cores; a min would bias low);
  * resolution guard: an estimate whose total timed window is below
    ``_MIN_WINDOW_S`` is UNRESOLVED — ``strict=True`` raises
    ``MeasurementUnresolved`` instead of returning a meaningless clamp.

``_events`` and ``_device_split`` are the kernel-timing helpers of the
``bench/*_rows.py`` scripts: CUDA events around back-to-back calls, and
device time by kernel name under ``torch.profiler``.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = [
    "marginal_time",
    "chained_marginal_time",
    "timed_fence",
    "MeasurementUnresolved",
]

# total timed-window seconds below which a marginal estimate is not told
# apart from the host clock's jitter between two fenced windows
_MIN_WINDOW_S = 2e-3


class MeasurementUnresolved(RuntimeError):
    """The timed window was too small to resolve the per-call marginal;
    widen n_hi - n_lo or chain more work per call."""


def timed_fence(out) -> float:
    """Wait for a call's output: the host reads the sum of its first
    tensor (the first leaf of a tuple, list or dict), which waits for the
    card to finish the kernels that made it; returns that checksum so the
    read cannot be elided."""
    leaf = out
    while isinstance(leaf, (tuple, list, dict)):
        leaf = (
            next(iter(leaf.values())) if isinstance(leaf, dict) else leaf[0]
        )
    return float(leaf.float().sum())


def marginal_time(
    fn, *args, n_lo: int = 5, n_hi: int = 25, warmup: int = 3,
    repeats: int = 2, strict: bool = False,
) -> float:
    """Marginal seconds per ``fn(*args)`` call, the fence's cost
    cancelled.

    ``strict=True`` raises :class:`MeasurementUnresolved` when the
    estimate is below the measurement resolution (estimate * call gap <
    ``_MIN_WINDOW_S``) instead of returning the clamped floor."""
    if n_hi <= n_lo:  # keep a measurable gap for any caller-supplied iters
        n_lo = max(1, n_hi // 2)
        n_hi = max(n_lo + 1, n_hi)
    for _ in range(warmup):
        timed_fence(fn(*args))

    def run(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)
        timed_fence(out)
        return time.perf_counter() - t0

    estimates = []
    for _ in range(repeats):
        t_lo = run(n_lo)
        t_hi = run(n_hi)
        estimates.append((t_hi - t_lo) / (n_hi - n_lo))
    est = float(np.median(estimates))
    if strict and est * (n_hi - n_lo) < _MIN_WINDOW_S:
        raise MeasurementUnresolved(
            f"marginal estimate {est*1e6:.3f} us over a {n_hi - n_lo}-call "
            f"gap is below the {_MIN_WINDOW_S*1e3:.0f} ms host-clock "
            "resolution; widen the call-count gap"
        )
    return max(est, 1e-9)


def chained_marginal_time(
    fn, x0, n_lo: int = 10, n_hi: int = 50, repeats: int = 5,
    strict: bool = False,
) -> float:
    """marginal_time over a CHAINED call sequence: the closure feeds each
    output back as the next input (x = fn(x)), so each call waits for the
    one before it on the card.  ``fn`` must map its output shape to its
    input shape."""
    st = {"x": x0}

    def one():
        st["x"] = fn(st["x"])
        return st["x"]

    return marginal_time(
        one, n_lo=n_lo, n_hi=n_hi, repeats=repeats, strict=strict
    )


def _events(fn, iters=10, warmup=2):
    """CUDA-event ms per call of ``fn`` over ``iters`` back-to-back calls
    after ``warmup`` untimed ones."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_split(fn, part_of, n=5):
    """(device ms, kernel launches) per call of ``fn`` by part
    (``part_of(kernel name)``), from torch.profiler over ``n`` calls after
    one untimed call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split, count = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        part = part_of(e.name.lower())
        us = e.time_range.end - e.time_range.start
        split[part] = split.get(part, 0.0) + us / 1e3 / n
        count[part] = count.get(part, 0) + 1 / n
    return split, count

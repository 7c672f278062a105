"""Profiling utilities — torch.profiler integration + per-call accounting
(the JAX package's ``utils/profiling.py``).

* ``trace(dir)``      — context manager around torch.profiler (CPU and
                        CUDA activity) writing a Chrome trace of the card's
                        kernels into ``dir`` (Perfetto or TensorBoard);
* ``profile_program`` — one-stop report for a Program on a batch:
                        latency, FLOPs / bytes from ``cost_analysis``,
                        roofline fractions, edges/s.
"""

from __future__ import annotations

import contextlib

__all__ = ["trace", "profile_program"]


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block, CPU and CUDA activity; on exit the
    trace goes to ``log_dir`` as ``<host>_<pid>.<ms>.pt.trace.json``.
    Yields the profiler.  Raises RuntimeError where the profiler cannot
    trace the card (a build without CUDA): a trace without the device
    would hide it."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        supported_activities,
        tensorboard_trace_handler,
    )

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    missing = [a for a in acts if a not in supported_activities()]
    if missing:
        raise RuntimeError(f"torch.profiler cannot trace {missing} in this "
                           "build of torch")
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def profile_program(program, batch, iters: int = 20) -> dict:
    """Latency + cost + roofline in one dict (the csynth-report analog with
    measured instead of estimated cycles)."""
    from gnnbuilder_tpu_torch.bench.roofline import (
        program_min_bytes,
        roofline_report,
    )

    bench = program.benchmark(batch, iters=iters)
    cost = program.cost_analysis(batch)
    real_edges = int(batch.edge_mask.sum())
    roof = roofline_report(
        bench["latency_s"],
        flops=float(cost.get("flops", 0.0)),
        min_bytes=program_min_bytes(program, batch),
        xla_bytes=float(cost.get("bytes accessed", 0.0)),
        num_edges=real_edges,
        device=program.device,
    )
    return {**bench, **roof}

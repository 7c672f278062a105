"""Energy accounting — the RAPL / nvidia-smi analog (the JAX package's
``bench/energy.py``).

The reference measures CPU package energy via Intel RAPL
(/sys/class/powercap, build_base_benchmarks.py:188-213) and GPU power by
sampling ``nvidia-smi dmon`` (:280-348).  A forward of a few
milliseconds is far shorter than nvidia-smi's sampling period, so what
is stated here is an UPPER BOUND: energy/graph <= the card's power limit
x latency/graph.  The limit is the one the card enforces
(``nvidia-smi --query-gpu=power.limit``, ``card_tdp_w``); a card set
below its maximum draws at most that.  Overrides: ``GNNB_GPU_TDP_W``,
``GNNB_CPU_TDP_W``.  If RAPL is present (bare-metal hosts),
``cpu_energy_j`` measures the real package counter delta around a
callable.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
import time
from typing import Callable, Optional

__all__ = [
    "rapl_available",
    "cpu_energy_j",
    "energy_bound_j_per_graph",
    "card_tdp_w",
    "CPU_TDP_W",
]

# single pinned CPU core + its share of uncore; reference measured
# ~12.6 W package on its 1-core runs (results_testing/energy_pyg_cpu_*)
CPU_TDP_W = float(os.environ.get("GNNB_CPU_TDP_W", 15.0))

_RAPL_GLOB = "/sys/class/powercap/intel-rapl:*/energy_uj"
_SMI_TIMEOUT_S = 30


def rapl_available() -> bool:
    return bool(glob.glob(_RAPL_GLOB))


def _read_rapl_uj() -> int:
    return sum(int(open(p).read()) for p in glob.glob(_RAPL_GLOB))


def cpu_energy_j(fn: Callable, *args, **kw) -> Optional[tuple]:
    """Measured package energy around ``fn(*args, **kw)`` via RAPL, or
    None when the counters are not exposed (VMs).
    Returns (result, joules, seconds)."""
    if not rapl_available():
        return None
    e0, t0 = _read_rapl_uj(), time.perf_counter()
    out = fn(*args, **kw)
    e1, t1 = _read_rapl_uj(), time.perf_counter()
    return out, (e1 - e0) / 1e6, t1 - t0


def card_tdp_w(index: int = 0) -> float:
    """The power limit in watts of card ``index``, as ``nvidia-smi
    --query-gpu=power.limit`` reports it (``GNNB_GPU_TDP_W`` overrides).
    Raises RuntimeError when there is no ``nvidia-smi``."""
    override = os.environ.get("GNNB_GPU_TDP_W")
    if override is not None:
        return float(override)
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("no nvidia-smi on PATH: the card's power limit "
                           "cannot be read (set GNNB_GPU_TDP_W)")
    out = subprocess.run(
        [smi, f"--id={index}", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=_SMI_TIMEOUT_S, check=True,
    ).stdout
    return float(out.strip().splitlines()[0])


def energy_bound_j_per_graph(
    latency_s_per_graph: float, tdp_w: float
) -> float:
    """Upper bound: a device drawing at most ``tdp_w`` for the per-graph
    latency spends at most this many joules per graph."""
    return tdp_w * latency_s_per_graph

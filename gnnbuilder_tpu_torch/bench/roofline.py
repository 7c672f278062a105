"""Roofline accounting — edges/s and %-of-peak reporting (the JAX
package's ``bench/roofline.py``).

How close does a measured forward run to the card's compute or bandwidth
bound, whichever binds.  Peak numbers are NVIDIA's data-sheet values for
the card at its full power limit (a card set below it runs slower under
load: report its ``power.limit`` beside every share).  "min_bytes" is the
information-theoretic traffic (inputs + params + outputs once), the
fused-kernel target; ``Program.cost_analysis``'s "bytes accessed" (the
traffic of each layer read once and written once) shows how much more an
unfused forward moves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["chip_peaks", "roofline_report", "program_min_bytes",
           "PEAK_F32_FLOPS", "PEAK_TF32_FLOPS", "PEAK_BF16_FLOPS",
           "PEAK_INT8_OPS", "PEAK_BYTES_PER_S"]

# one H100 SXM (NVIDIA data sheet, dense, 700 W): f32 outside the tensor
# cores, TF32, bf16 and int8 on them, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12

# card name (lower case, a part of torch.cuda.get_device_name) ->
# (dense bf16 tensor-core FLOP/s, HBM bytes/s): the JAX package's
# convention, a matmul unit's bf16 rate and the memory rate
_PEAKS = {
    "h100 80gb hbm3": (PEAK_BF16_FLOPS, PEAK_BYTES_PER_S),
    "h100 sxm": (PEAK_BF16_FLOPS, PEAK_BYTES_PER_S),
}


def chip_peaks(device=None) -> tuple[float, float]:
    """(peak_flops, peak_bytes_per_s) of the card ``device`` (None: the
    current one), by its ``torch.cuda.get_device_name``.  Raises
    ValueError for a card that is not in the table: no default fits
    another card."""
    name = torch.cuda.get_device_name(device)
    kind = name.lower()
    for key, peaks in _PEAKS.items():
        if key in kind:
            return peaks
    raise ValueError(f"no peak rates for the card {name!r}; known: "
                     f"{sorted(_PEAKS)}")


def roofline_report(
    measured_latency_s: float,
    flops: float,
    min_bytes: float,
    xla_bytes: Optional[float] = None,
    num_edges: Optional[int] = None,
    device=None,
) -> dict:
    """Bound the forward by compute and bandwidth; report % of roofline.

    ``min_bytes`` should be the minimal HBM traffic (read inputs + params,
    write outputs, once each).  roofline_latency = max(compute, bandwidth)
    bound; fraction_of_roofline = roofline_latency / measured (1.0 = at the
    roofline, >1 impossible, smaller = headroom remains).  ``xla_bytes``:
    ``cost_analysis``'s "bytes accessed" (the JAX package's name, kept)."""
    peak_flops, peak_bw = chip_peaks(device)
    t_compute = flops / peak_flops
    t_memory = min_bytes / peak_bw
    t_min = max(t_compute, t_memory)
    rep = {
        "measured_latency_s": measured_latency_s,
        "compute_bound_s": t_compute,
        "memory_bound_s": t_memory,
        "roofline_latency_s": t_min,
        "fraction_of_roofline": t_min / max(measured_latency_s, 1e-12),
        "bound": "compute" if t_compute >= t_memory else "memory",
        "peak_flops": peak_flops,
        "peak_bytes_per_s": peak_bw,
        "achieved_flops": flops / max(measured_latency_s, 1e-12),
    }
    if xla_bytes is not None:
        rep["xla_bytes_accessed"] = xla_bytes
        rep["traffic_amplification"] = xla_bytes / max(min_bytes, 1.0)
    if num_edges is not None:
        rep["edges_per_s"] = num_edges / max(measured_latency_s, 1e-12)
        rep["roofline_edges_per_s"] = num_edges / max(t_min, 1e-12)
    return rep


def batch_nbytes(batch) -> dict:
    """{field: bytes} of every tensor a ``GraphBatch`` holds."""
    return {f.name: v.numel() * v.element_size()
            for f in dataclasses.fields(batch)
            if isinstance(v := getattr(batch, f.name), torch.Tensor)}


def program_min_bytes(program, batch) -> float:
    """Minimal traffic for one forward: node/edge features + tables read
    once, parameters read once, output written once."""
    n_bytes = sum(batch_nbytes(batch).values())
    p_bytes = sum(p.numel() * p.element_size()
                  for p in program.params.values())
    out_bytes = batch.num_graphs * 4 * getattr(
        program.model, "mlp_out_dim", 1
    )
    return float(n_bytes + p_bytes + out_bytes)

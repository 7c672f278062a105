"""Int8 quantized products (the JAX package's ``ops/quant.py``), and the
bf16 rounding of the bf16 policy's products (``to_bf16``).

Symmetric scales, the same formulas as the JAX package:

* weights [in, out]: one scale per output column,
  ``s = max(max |w| / 127, 1e-12)``;
* activations: one scale per row (dynamic), or one static scale per site
  recorded from representative batches (``calibration``);
* values ``q = clip(round(x / s), -127, 127)``, ``round`` half to even;
* the product sums the int8 values exactly, then ``y * s_x * s_w``.

The exact sum is taken in float64 (exact for any |sum| < 2^53; a float32
product of int8 values is not exact once a sum passes 2^24, and
127^2 * 512 is already 8.3e6), then converted to float32 as the JAX
package converts its int32 sum.  Every division is a true float32
division (``true_div``).

A contextvar carries the calibration state, so the quantized call sites
(``nn/linear.Linear``) need no extra arguments; sites are keyed by the
module's name in the model (``gnn_convs.0.lin``, the JAX package's
``gnn_convs_0/lin``; ``port.site_to_jax`` maps them).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

__all__ = ["quantize_weight", "quantize_rows", "int8_matmul",
           "int8_matmul_static", "int8_linear", "qdot", "to_bf16",
           "true_div", "calibration", "active_calibration",
           "scales_from_record"]

_EPS = 1e-12


def true_div(a, b):
    """a / b as one correctly rounded float32 division, either operand a
    float: PyTorch computes ``float / tensor`` as ``reciprocal(tensor) *
    float``, and on CUDA ``tensor / float`` as a product with the
    divisor's reciprocal, each a rounding more than the JAX package's
    division and the kernels' (an ulp moves an int8 level at a rounding
    boundary)."""
    if not torch.is_tensor(a):
        a = _scalar(a, b.device)
    if not torch.is_tensor(b):
        b = _scalar(b, a.device)
    return a / b


def _scalar(v: float, device):
    """``v`` as a 0-d float32 tensor on ``device``, filled there (a copy
    from the host would wait for the card)."""
    return torch.full((), v, dtype=torch.float32, device=device)



def _levels(x, s):
    return torch.round(true_div(x, s)).clamp(-127, 127).to(torch.int8)


def quantize_weight(w):
    """(q [in, out] int8, scale [out] float32) with w ~ q * scale."""
    s = true_div(w.abs().amax(dim=0), 127.0).clamp(min=_EPS)
    return _levels(w, s), s


def quantize_rows(x):
    """(q int8, scale [..., 1] float32): one symmetric scale per row."""
    s = true_div(x.abs().amax(dim=-1, keepdim=True), 127.0).clamp(min=_EPS)
    return _levels(x, s), s


def _exact(xq, wq):
    """The int8 product, summed exactly, as float32."""
    return torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(
        torch.float32)


def qdot(a, wq, sw):
    """The int8 product of float32 ``a`` (quantized per row here) with
    already quantized weights ``wq`` [in, out] int8 and their column
    scales ``sw`` [out]: the JAX package's in-kernel ``_qdot``."""
    aq, sa = quantize_rows(a)
    return _exact(aq, wq) * sa * sw


def to_bf16(x):
    """x rounded to bf16 (nearest, ties to even), kept in float32: a
    product of two such tensors in float32 is the bf16 product with a
    float32 sum."""
    return x.to(torch.bfloat16).to(torch.float32)


def int8_matmul(x, w):
    """float32 in, float32 out: (x_q @ w_q) * s_x * s_w with per-row
    activation scales and per-column weight scales."""
    xq, sx = quantize_rows(x)
    wq, sw = quantize_weight(w)
    return _exact(xq, wq) * sx * sw


def int8_matmul_static(x, w, s_x: float):
    """``int8_matmul`` with a static activation scale ``s_x``."""
    wq, sw = quantize_weight(w)
    s = _scalar(s_x, x.device)
    # values past the calibrated range saturate at +-127
    return _exact(_levels(x, s), wq) * s * sw


def int8_linear(x, w, bias, site: Optional[str]):
    """A Linear's product under the int8 policy, by the JAX package's
    ``Linear.__call__`` routes: under a recording calibration the site's
    max |x| is recorded first; a site with a static scale takes it, any
    other the per-row dynamic scales.  ``w`` is [in, out]."""
    calib = active_calibration()
    if calib is not None and calib.record is not None:
        m = float(x.abs().max())
        calib.record[site] = max(calib.record.get(site, 0.0), m)
    if (calib is not None and calib.scales is not None
            and site in calib.scales):
        y = int8_matmul_static(x, w, calib.scales[site])
    else:
        y = int8_matmul(x, w)
    return y if bias is None else y + bias


_CALIB: contextvars.ContextVar = contextvars.ContextVar(
    "gnnb_torch_int8_calibration", default=None
)


class _CalibState:
    __slots__ = ("record", "scales")

    def __init__(self, record: Optional[dict], scales: Optional[dict]):
        self.record = record    # site -> running max |x| (recording)
        self.scales = scales    # site -> static activation scale


@contextlib.contextmanager
def calibration(record: Optional[dict] = None,
                scales: Optional[dict] = None):
    """``record={}``: each quantized site updates ``record[site]`` with
    its max |activation|.  ``scales={site: s}``: those sites take the
    static scale instead of the per-row one.  While either is active the
    kernel gates decline (``ops/dispatch.py``): the plain path owns the
    per-site state, as in the JAX package."""
    tok = _CALIB.set(_CalibState(record, scales))
    try:
        yield
    finally:
        _CALIB.reset(tok)


def active_calibration() -> Optional[_CalibState]:
    return _CALIB.get()


def scales_from_record(record: dict) -> dict:
    """max-abs record -> static symmetric scale per site."""
    return {k: max(float(v), _EPS) / 127.0 for k, v in record.items()}

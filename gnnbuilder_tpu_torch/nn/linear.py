"""Linear layers (the JAX package's ``nn/linear.py``).

``Linear`` is ``torch.nn.Linear`` (same state-dict keys) whose product
follows the precision policy: under int8 it takes the JAX package's
dynamic, static or recording route (``ops.quant.int8_linear``), keyed by
``site``, the module's name in the model (``GNNModel`` sets it).

``PairLinear`` and ``BlockScaledLinear`` are ``torch.nn.Linear`` over the
full concat (weight [out, in], the default torch init
U(+-1/sqrt(fan_in))), evaluated blockwise so the concat never exists in
memory.  Parameter shapes match the JAX package's ``PairLinear`` /
``BlockScaledLinear`` transposed, so weights port 1:1.  As in the JAX
package, the int8 policy leaves them unquantized.
"""

from __future__ import annotations

from typing import Optional

import torch

from gnnbuilder_tpu_torch.compile.precision import active_precision
from gnnbuilder_tpu_torch.ops.quant import int8_linear

__all__ = ["Linear", "PairLinear", "BlockScaledLinear"]


class Linear(torch.nn.Linear):
    """``torch.nn.Linear`` whose product is quantized under the int8
    policy (per-row or static activation scales, per-column weight
    scales, an exact int8 sum); float32 otherwise.  ``site`` names the
    calibration entry."""

    site: Optional[str] = None

    def forward(self, x):
        prec = active_precision()
        if prec is None or prec.name != "int8":
            return super().forward(x)
        return int8_linear(x, self.weight.t(), self.bias, self.site)


class PairLinear(torch.nn.Linear):
    """Linear over ``[a || b]`` split in two: returns ``u = a W_a^T + bias``
    and ``v = b W_b^T``, so a per-edge message ``u_i + v_j`` costs two node
    products instead of one edge product."""

    def forward(self, a, b):
        Fa = a.shape[-1]
        u = a @ self.weight[:, :Fa].t() + self.bias
        v = b @ self.weight[:, Fa:].t()
        return u, v


class BlockScaledLinear(torch.nn.Linear):
    """Linear over ``[x || A*c_1 || ... || A*c_S]`` with per-row scales c_s
    (None = 1), evaluated as ``x K_0 + bias + sum_s c_s * (A K_s)``: per-row
    scaling commutes with the product, so the wide concat is never built."""

    def forward(self, x, a, scales):
        Fx, Fa = x.shape[-1], a.shape[-1]
        out = x @ self.weight[:, :Fx].t() + self.bias
        ks = self.weight[:, Fx:].t()                   # [S*Fa, out]
        S = len(scales)
        ks = torch.cat([ks[i * Fa:(i + 1) * Fa] for i in range(S)], dim=1)
        y = a @ ks                                     # [N, S*out]
        n = self.out_features
        for i, c in enumerate(scales):
            blk = y[:, i * n:(i + 1) * n]
            out = out + (blk if c is None else c * blk)
        return out

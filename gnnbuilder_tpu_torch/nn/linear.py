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

In the all-gather strategy of a sharded forward
(``parallel.train.make_sharded_forward(halo=False)``) a Linear whose
weight is sharded over tp (``tp_scope``) holds this rank's block of
output features: it computes those output columns, with its bias's
block, and all-gathers the columns over tp.  Under int8 the block takes
the int8 route too: a block holds whole output columns, the per-row
activation scales read the whole (replicated) row and the weight scales
are per column, so the gathered blocks are the unsharded int8 product
exactly; a static scale is the site's, the same on every rank.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from gnnbuilder_tpu_torch.compile.precision import active_precision
from gnnbuilder_tpu_torch.ops.quant import int8_linear

__all__ = ["Linear", "PairLinear", "BlockScaledLinear", "tp_scope"]

# (mesh, ids of the modules whose weight is a tp block) in a sharded
# forward's all-gather strategy
_TP: contextvars.ContextVar = contextvars.ContextVar("gnnb_torch_tp",
                                                     default=None)


@contextlib.contextmanager
def tp_scope(mesh, modules):
    """Within: each of ``modules`` holds this rank's tp block of its
    weight's output features and computes those columns."""
    tok = _TP.set((mesh, frozenset(id(m) for m in modules)))
    try:
        yield
    finally:
        _TP.reset(tok)


def _tp_block(mod):
    """(mesh, this rank's bias block or None) when ``mod``'s weight is a
    tp block, else None."""
    s = _TP.get()
    if s is None or id(mod) not in s[1]:
        return None
    mesh = s[0]
    k = mod.weight.shape[0]
    i = mesh.index("tp")
    bias = None if mod.bias is None else mod.bias[i * k:(i + 1) * k]
    return mesh, bias


def _gather_cols(y, mesh):
    from gnnbuilder_tpu_torch.parallel._comm import all_gather

    return all_gather(y, mesh, "tp", dim=-1)


class Linear(torch.nn.Linear):
    """``torch.nn.Linear`` whose product is quantized under the int8
    policy (per-row or static activation scales, per-column weight
    scales, an exact int8 sum); float32 otherwise.  ``site`` names the
    calibration entry."""

    site: Optional[str] = None

    def forward(self, x):
        prec = active_precision()
        int8 = prec is not None and prec.name == "int8"
        tp = _tp_block(self)
        if tp is not None:
            mesh, bias = tp
            y = (int8_linear(x, self.weight.t(), bias, self.site) if int8
                 else torch.nn.functional.linear(x, self.weight, bias))
            return _gather_cols(y, mesh)
        if not int8:
            return super().forward(x)
        return int8_linear(x, self.weight.t(), self.bias, self.site)


class PairLinear(torch.nn.Linear):
    """Linear over ``[a || b]`` split in two: returns ``u = a W_a^T + bias``
    and ``v = b W_b^T``, so a per-edge message ``u_i + v_j`` costs two node
    products instead of one edge product."""

    def forward(self, a, b):
        Fa = a.shape[-1]
        tp = _tp_block(self)
        bias = self.bias if tp is None else tp[1]
        u = a @ self.weight[:, :Fa].t() + bias
        v = b @ self.weight[:, Fa:].t()
        if tp is not None:
            u, v = _gather_cols(u, tp[0]), _gather_cols(v, tp[0])
        return u, v


class BlockScaledLinear(torch.nn.Linear):
    """Linear over ``[x || A*c_1 || ... || A*c_S]`` with per-row scales c_s
    (None = 1), evaluated as ``x K_0 + bias + sum_s c_s * (A K_s)``: per-row
    scaling commutes with the product, so the wide concat is never built."""

    def forward(self, x, a, scales):
        Fx, Fa = x.shape[-1], a.shape[-1]
        tp = _tp_block(self)
        out = x @ self.weight[:, :Fx].t() + (
            self.bias if tp is None else tp[1])
        ks = self.weight[:, Fx:].t()                   # [S*Fa, out]
        S = len(scales)
        ks = torch.cat([ks[i * Fa:(i + 1) * Fa] for i in range(S)], dim=1)
        y = a @ ks                                     # [N, S*out]
        n = self.weight.shape[0]
        for i, c in enumerate(scales):
            blk = y[:, i * n:(i + 1) * n]
            out = out + (blk if c is None else c * blk)
        return out if tp is None else _gather_cols(out, tp[0])

"""Precision policy (the JAX package's ``compile/precision.py``).

A policy names the parameter storage, compute and accumulation types of
a forward:

* ``Precision.f32()``  — float32 everywhere
* ``Precision.bf16()`` — bf16 parameters and features, bf16 operands at
  every product, float32 sums
* ``Precision.int8()`` — int8 products with symmetric scales (weights per
  output column, activations per row or from a calibration), int32 sums;
  the parameters stay float32 (``ops/quant.py``)

``Program`` enters ``activate()`` around its forward, so the layers
(``nn/linear.py``) and the kernel gates (``ops/dispatch.py``) read the
policy from a contextvar instead of a flag through every signature.
Training stays float32: the policies are inference policies.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch

__all__ = ["Precision", "active_precision", "PRECISIONS"]

PRECISIONS = ("f32", "bf16", "int8")

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "gnnb_torch_precision", default=None
)


def active_precision():
    """The Precision activated by the enclosing Program, or None."""
    return _ACTIVE.get()


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    accum_dtype: torch.dtype

    @staticmethod
    def f32() -> "Precision":
        return Precision("f32", torch.float32, torch.float32, torch.float32)

    @staticmethod
    def bf16() -> "Precision":
        return Precision("bf16", torch.bfloat16, torch.bfloat16,
                         torch.float32)

    @staticmethod
    def int8() -> "Precision":
        return Precision("int8", torch.int8, torch.int8, torch.int32)

    @staticmethod
    def from_name(name: str) -> "Precision":
        if name not in PRECISIONS:
            raise ValueError(f"unknown precision {name!r}; options: "
                             f"{PRECISIONS}")
        return getattr(Precision, name)()

    @contextlib.contextmanager
    def activate(self):
        tok = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(tok)

    def cast_params(self, params: dict) -> dict:
        """The state dict as the policy stores it: under bf16 every
        float32 tensor becomes bfloat16 (round to nearest even), other
        tensors stay; f32 and int8 keep the float32 masters (int8
        quantizes per product)."""
        if self.name in ("f32", "int8"):
            return params
        return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
                for k, v in params.items()}

    def __str__(self) -> str:
        return self.name

"""The activation table, in torch, with the JAX package's numerics.

Names and formulas follow the JAX package's ``ops/activations.py`` (the
reference's 13 scalar activations, PyTorch semantics): ``gelu`` is the
exact erf form, ``gelu_approx_tanh`` the tanh approximation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "OUTPUT_ACTIVATIONS",
           "SUPPORTED_MODEL_ACTIVATIONS", "get_activation", "leaky_relu"]


def identity(x):
    return x


ACTIVATIONS = {
    "identity": identity,
    "relu": torch.relu,
    "elu": F.elu,
    "hardtanh": F.hardtanh,
    "leakyrelu": F.leaky_relu,
    "gelu": F.gelu,
    "gelu_approx_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "tanh": torch.tanh,
    "softsign": F.softsign,
    "sin": torch.sin,
    "cos": torch.cos,
}

# activations accepted by the model container (reference models.py:360)
SUPPORTED_MODEL_ACTIVATIONS = ("relu", "gelu", "sigmoid", "tanh")

# output activations, applied over the last axis
OUTPUT_ACTIVATIONS = {
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "log_softmax": lambda x: torch.log_softmax(x, dim=-1),
}


def leaky_relu(z, negative_slope: float):
    """``jax.nn.leaky_relu``: z where z >= 0, else negative_slope * z.  Its
    derivative at 0 is 1 (``F.leaky_relu``'s is the slope), as in the JAX
    package's GAT and its kernels: GAT logits are exactly 0 where a row's
    features are all 0 (after a relu), so the convention shows in the
    gradients."""
    return torch.where(z >= 0, z, negative_slope * z)


def get_activation(name):
    if callable(name):
        return name
    if name is None:
        return identity
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; supported: {sorted(ACTIVATIONS)}"
        ) from None

"""MLP head: ``hidden_layers`` Linear + activation stages and one output
Linear (a single Linear when hidden_layers == 0), as the reference's MLP
(models.py:365-450)."""

from __future__ import annotations

import torch

from gnnbuilder_tpu_torch.nn.linear import Linear
from gnnbuilder_tpu_torch.ops.activations import get_activation

__all__ = ["MLP"]


class MLP(torch.nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 64,
                 hidden_layers: int = 2, activation: str = "relu"):
        super().__init__()
        if hidden_layers < 0:
            raise ValueError("hidden_layers must be >= 0")
        dims = [in_dim] + [hidden_dim] * hidden_layers + [out_dim]
        self.linear_layers = torch.nn.ModuleList(
            Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.activation = activation
        self.act = get_activation(activation)

    def forward(self, x):
        for i, lin in enumerate(self.linear_layers):
            x = lin(x)
            if i < len(self.linear_layers) - 1:
                x = self.act(x)
        return x

    @property
    def num_of_layers(self) -> int:
        return len(self.linear_layers)

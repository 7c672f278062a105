"""MLP head: ``hidden_layers`` Linear + activation stages and one output
Linear (a single Linear when hidden_layers == 0), as the reference's MLP
(models.py:365-450).  ``p_in`` / ``p_hidden`` / ``p_out`` are the
reference's parallelism factors, carried as metadata (``p_factors`` per
Linear stage, models.py:432-446); they change no computation."""

from __future__ import annotations

import torch

from gnnbuilder_tpu_torch.nn.linear import Linear
from gnnbuilder_tpu_torch.ops.activations import get_activation

__all__ = ["MLP"]


class MLP(torch.nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 64,
                 hidden_layers: int = 2, activation: str = "relu",
                 p_in: int = 1, p_hidden: int = 1, p_out: int = 1):
        super().__init__()
        if hidden_layers < 0:
            raise ValueError("hidden_layers must be >= 0")
        dims = [in_dim] + [hidden_dim] * hidden_layers + [out_dim]
        self.linear_layers = torch.nn.ModuleList(
            Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.activation = activation
        self.hidden_layers = hidden_layers
        self.p_in, self.p_hidden, self.p_out = p_in, p_hidden, p_out
        self.act = get_activation(activation)

    def forward(self, x):
        for i, lin in enumerate(self.linear_layers):
            x = lin(x)
            if i < len(self.linear_layers) - 1:
                x = self.act(x)
        return x

    @property
    def p_factors(self):
        """(p_in, p_out) of each Linear stage."""
        if self.hidden_layers == 0:
            return [(self.p_in, self.p_out)]
        return ([(self.p_in if i == 0 else self.p_hidden, self.p_hidden)
                 for i in range(self.hidden_layers)]
                + [(self.p_hidden, self.p_out)])

    @property
    def num_of_layers(self) -> int:
        return len(self.linear_layers)

"""Training utilities: masked losses, metrics, the train step and
checkpoints (the JAX package's ``train.py``).

Losses mask the ghost graph (core/graph.py padding) so padding never
leaks into gradients.  ``make_train_step`` runs the model's forward, the
loss, ``loss.backward()`` and the optimizer.  On a standard-packed batch
each PNA layer runs through the CUDA layer kernel (``PNALayerFunction``)
and each GCN, GIN, SAGE, LG and Simple (sum, mean) layer through the mp
layer kernel (``MPLayerFunction``), each with its hand-written backward;
the readout through ``ReadoutFunction``.  ``torch.optim.Adam``'s defaults (betas 0.9 / 0.999, eps 1e-8)
are ``optax.adam``'s.  Checkpoints are ``torch.save`` of the model's and
the optimizer's state dicts; ``TrainState`` holds the same in memory.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gnnbuilder_tpu_torch.core.graph import GraphBatch, resolve_device

__all__ = [
    "masked_mse_loss",
    "masked_mae",
    "masked_bce_logits_loss",
    "roc_auc",
    "make_train_step",
    "TrainState",
    "stack_targets",
    "save_checkpoint",
    "load_checkpoint",
]


def _weights(pred, graph_mask):
    return graph_mask.to(pred.dtype)[:, None]


def masked_mse_loss(pred, target, graph_mask):
    """Mean squared error over real graphs only.  pred/target [G, T]."""
    w = _weights(pred, graph_mask)
    se = (pred - target) ** 2 * w
    return se.sum() / torch.clamp(w.sum() * pred.shape[-1], min=1.0)


def masked_mae(pred, target, graph_mask):
    w = _weights(pred, graph_mask)
    ae = (pred - target).abs() * w
    return ae.sum() / torch.clamp(w.sum() * pred.shape[-1], min=1.0)


def masked_bce_logits_loss(logits, target, graph_mask):
    """Binary cross-entropy with logits over real graphs (HIV-style)."""
    w = _weights(logits, graph_mask)
    per = F.binary_cross_entropy_with_logits(logits, target,
                                             reduction="none") * w
    return per.sum() / torch.clamp(w.sum() * logits.shape[-1], min=1.0)


def roc_auc(scores, labels) -> float:
    """Host-side ROC-AUC (rank statistic, ties take their average rank)."""
    scores = np.asarray(scores).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    pos = scores[labels > 0.5]
    neg = scores[labels <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    allv = np.concatenate([pos, neg])
    order = np.argsort(allv, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    sortv = allv[order]
    i = 0
    while i < len(sortv):
        j = i
        while j + 1 < len(sortv) and sortv[j + 1] == sortv[i]:
            j += 1
        if j > i:
            ranks[order[i: j + 1]] = ranks[order[i: j + 1]].mean()
        i = j + 1
    r_pos = ranks[: len(pos)].sum()
    n_p, n_n = len(pos), len(neg)
    return float((r_pos - n_p * (n_p + 1) / 2) / (n_p * n_n))


class TrainState:
    """The train state of the JAX package's ``TrainState``: ``params``
    (the model's state dict, the form of ``Program.params``),
    ``opt_state`` (``optimizer.state_dict()``) and ``step``.  ``capture``
    copies them out of a model and its optimizer; ``restore`` loads them
    back, so the steps after a restore repeat those after the capture."""

    def __init__(self, params, opt_state, step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step

    @classmethod
    def capture(cls, model: torch.nn.Module,
                optimizer: torch.optim.Optimizer,
                step: int = 0) -> "TrainState":
        """A copy of ``model``'s parameters and ``optimizer``'s state (the
        optimizer updates its state tensors in place)."""
        params = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
        return cls(params, copy.deepcopy(optimizer.state_dict()), int(step))

    def restore(self, model: torch.nn.Module,
                optimizer: torch.optim.Optimizer) -> int:
        """Load the state into ``model`` and ``optimizer``; returns the
        step."""
        model.load_state_dict(self.params)
        optimizer.load_state_dict(copy.deepcopy(self.opt_state))
        return self.step


def make_train_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    loss_fn: Callable = masked_mse_loss):
    """``step(batch, target) -> loss``: zero the gradients, forward, loss
    over the real graphs, backward, optimizer step.  Updates the model's
    parameters in place; returns the loss before the update (a 0-d
    tensor on the model's device)."""

    def step(batch: GraphBatch, target):
        optimizer.zero_grad(set_to_none=True)
        pred = model(batch)
        loss = loss_fn(pred, target, batch.graph_mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def stack_targets(graphs, num_graphs_padded: int, target_dim: int = 1,
                  device=None):
    """Per-graph targets packed into a padded [G, T] float32 tensor (ghost
    rows zero) on ``device`` (None = the CUDA card, which raises without
    one)."""
    device = resolve_device(device)
    out = np.zeros((num_graphs_padded, target_dim), dtype=np.float32)
    for i, g in enumerate(graphs):
        if g.y is not None:
            out[i] = np.asarray(g.y, dtype=np.float32).reshape(-1)[:target_dim]
    return torch.from_numpy(out).to(device)


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    step: int = 0) -> str:
    """Write the model's (and optimizer's) state dict and the step to
    ``path`` with ``torch.save``.  Returns the absolute path."""
    path = os.path.abspath(path)
    payload = {"model": model.state_dict(), "step": int(step)}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    torch.save(payload, path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Restore ``save_checkpoint``'s state into ``model`` (and
    ``optimizer``), onto the devices their tensors live on.  Returns the
    step."""
    payload = torch.load(os.path.abspath(path), map_location="cpu",
                         weights_only=True)
    model.load_state_dict(payload["model"])
    if optimizer is not None and "optimizer" in payload:
        optimizer.load_state_dict(payload["optimizer"])
    return int(payload["step"])

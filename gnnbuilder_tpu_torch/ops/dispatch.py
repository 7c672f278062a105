"""Kernel dispatch policy: when the model takes the whole-stack, the
per-layer PNA and the readout kernels instead of the plain path.

The gates decide on the batch and the model alone; which implementation a
kernel function then runs is decided by the tensors' device inside it (a
CUDA tensor launches the kernel, a CPU tensor runs its plain version).

Modes (``set_fused_mode``):
* "auto"  — the kernel functions whenever their preconditions hold
* "never" — the per-layer plain path only (PNAConv loop, GlobalPooling,
            MLP), so a test can pin it
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

__all__ = ["set_fused_mode", "inference_mode",
           "inference_on", "pna_stack_cfg", "pna_layer_cfg",
           "readout_config"]

_MODE = "auto"

# inference scope: the stack kernel has no backward, so the model takes it
# only here; Program.forward enters it
_INFERENCE: contextvars.ContextVar = contextvars.ContextVar(
    "gnnb_torch_inference", default=False
)


@contextlib.contextmanager
def inference_mode():
    tok = _INFERENCE.set(True)
    try:
        yield
    finally:
        _INFERENCE.reset(tok)


def inference_on() -> bool:
    return _INFERENCE.get()


def set_fused_mode(mode: str) -> None:
    global _MODE
    if mode not in ("auto", "never"):
        raise ValueError(f"unknown fused mode {mode!r}")
    _MODE = mode


def pna_stack_cfg(g) -> Optional[dict]:
    """{"block_size": ...} when the whole-stack PNA kernel applies to batch
    ``g``, else None (the model runs the per-layer loop).

    Preconditions: inference scope and a block-packed batch (every
    neighbour id inside its row's block) with its ELL table, at a block
    size that is a multiple of 128.  Width and block size beyond that are
    the kernel's to check: the CUDA wrapper raises on what it does not
    take rather than giving way to the plain version."""
    if _MODE == "never" or not inference_on():
        return None
    if g.nbr_nodes is None or g.block_adj is None:
        return None
    if g.block_size_static % 128:
        return None
    return {"block_size": g.block_size_static}


def pna_layer_cfg(g, act) -> Optional[dict]:
    """{} when the per-layer PNA kernel (``ops.cuda.pna_layer``) applies to
    batch ``g`` with epilogue activation ``act``, else None (PNAConv runs
    its plain path).  The caller checks the default aggregators and
    scalers.  Needs the batch's ELL table, graph-contiguous packing with
    a known largest graph, and an activation the kernel has; in or out of
    inference scope, since the layer has a backward.  Widths are the
    kernel's to check: the CUDA wrapper raises on what it does not
    take."""
    from gnnbuilder_tpu_torch.ops.cuda.pna_layer import LAYER_ACTS

    if _MODE == "never" or g.nbr_nodes is None:
        return None
    if g.max_graph_nodes_static <= 0 or g.graph_starts is None:
        return None
    if act not in LAYER_ACTS:
        return None
    return {}


def readout_config(g, aggrs, act, out_act) -> Optional[dict]:
    """{"starts": ...} when the fused readout kernel applies, else None
    (the model runs GlobalPooling + MLP).  Needs an add or mean
    aggregator (pure max pooling would make the kernel dead
    work), activations the kernel has, and the per-graph row starts and
    largest graph of the max window.  Whether the head fits the kernel is
    the CUDA wrapper's to check: it raises on what it does not take."""
    from gnnbuilder_tpu_torch.ops.cuda.readout import (
        READOUT_ACTS,
        READOUT_OUT_ACTS,
    )

    if _MODE == "never":
        return None
    if not ({"add", "mean"} & set(aggrs)):
        return None
    if act not in READOUT_ACTS or out_act not in READOUT_OUT_ACTS:
        return None
    if g.max_graph_nodes_static <= 0 or g.graph_starts is None:
        return None
    return {"starts": g.graph_starts}

"""Kernel dispatch policy: when the model takes the whole-stack, the
per-layer PNA and the readout kernels instead of the plain path, and
which plain aggregation a conv runs on a block-packed batch.

The gates decide on the batch and the model alone; which implementation a
kernel function then runs is decided by the tensors' device inside it (a
CUDA tensor launches the kernel, a CPU tensor runs its plain version).

Modes (``set_fused_mode``):
* "auto"  — the kernel functions whenever their preconditions hold
* "never" — the per-layer plain path only (conv loop over the ELL table
            or the edge list, GlobalPooling, MLP), so a test can pin it
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

__all__ = ["set_fused_mode", "inference_mode",
           "inference_on", "block_cfg", "pna_stack_cfg", "mp_stack_cfg",
           "pna_layer_cfg", "readout_config"]

# convs whose whole stack runs in the mp stack kernel under "auto": the JAX
# package's A/B on its TPU kept GIN on the per-layer path
# (``gnnbuilder_tpu/ops/dispatch.py`` ``_MP_STACK_CONVS``); the kernel
# itself also takes "gin"
MP_STACK_CONVS = ("gcn", "sage")

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


def block_cfg(g) -> Optional[dict]:
    """{} when a conv's plain aggregation takes the block-diagonal product
    (``ops.block``) on batch ``g``, else None (the ELL table or the edge
    list).  Needs a block-packed batch; "never" pins the ELL / edge-list
    paths, as in the JAX package."""
    if _MODE == "never" or g.block_adj is None:
        return None
    return {}


def mp_stack_cfg(g, conv: str) -> Optional[dict]:
    """{"block_size": ...} when the whole-stack GCN / SAGE kernel
    (``ops.cuda.mp_block``) applies to batch ``g``, else None (the model
    runs the per-layer loop; GIN always does under "auto").

    Preconditions: inference scope and a block-packed batch at a block
    size that is a multiple of 128.  Unlike the PNA stack it needs no ELL
    table: the kernel aggregates from ``block_adj``.  A standard-packed
    batch runs the per-layer plain path: the per-layer mp kernel is not
    ported yet."""
    if conv not in MP_STACK_CONVS:
        return None
    if _MODE == "never" or not inference_on():
        return None
    if g.block_adj is None or g.block_size_static % 128:
        return None
    return {"block_size": g.block_size_static}


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
    inference scope, since the layer has a backward.  A batch with no ELL
    table (an in-degree over 64, or ``ell_width=0``) gets None, as in the
    JAX package: PNAConv then runs its edge-list path.  Widths are the
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

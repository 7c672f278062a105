"""Kernel dispatch policy: when the model takes the whole-stack, the
per-layer PNA, mp, GAT, GINE and EdgeConv, the multi-aggregate and the
readout kernels instead of the plain path, and which plain aggregation a
conv runs on a block-packed batch.

The gates decide on the batch and the model alone; which implementation a
kernel function then runs is decided by the tensors' device inside it (a
CUDA tensor launches the kernel, a CPU tensor runs its plain version).

Modes (``set_fused_mode``):
* "auto"  — the kernel functions whenever their preconditions hold
* "never" — the per-layer plain path only (conv loop over the ELL table
            or the edge list, GlobalPooling, MLP), so a test can pin it

Precision policies (``compile.precision``, activated by ``Program``):
a gate whose kernel has the JAX package's mode under the active policy
returns it in ``cfg["mode"]`` ("bf16" or "int8"; absent under f32), as
the JAX gates set ``quant`` / ``int8`` and the bf16 gather and products:
the PNA stack and layer, the readout, the mp stack, the GINE layer and
GAT's layer in both policies; the mp layer in bf16 for every conv and in
int8 for GIN and SAGE; the multi-aggregate, EdgeConv's and GAT's block
layers in bf16.  The rest copies the JAX package's decisions: GCN's,
LG's and Simple's mp layer and the multi-aggregate keep their float32
kernels under int8 (the JAX convs drop int8 there as numerics-neutral:
no Linear runs inside those kernels), even under an int8 calibration,
and GAT's and EdgeConv's block layers decline under int8
(``INT8_DECLINED``), where GAT takes its layer kernel in int8.
Under an active int8 calibration every gate that would give a kernel
the int8 mode declines: the plain path owns the per-site state.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

__all__ = ["set_fused_mode", "inference_mode", "policy", "inference_on",
           "block_cfg", "pna_stack_cfg", "mp_stack_cfg", "mp_layer_cfg",
           "pna_layer_cfg", "gat_block_cfg", "gat_layer_cfg", "agg_cfg",
           "gine_layer_cfg", "edge_block_cfg", "readout_config"]

# convs whose whole stack runs in the mp stack kernel under "auto": the JAX
# package's A/B on its TPU kept GIN on the per-layer path
# (``gnnbuilder_tpu/ops/dispatch.py`` ``_MP_STACK_CONVS``); the kernel
# itself also takes "gin"
MP_STACK_CONVS = ("gcn", "sage")

# convs whose layer takes the mp layer kernel's block mode on a
# block-packed batch (the JAX package's ``_BLOCK_KERNEL_CONVS``: its TPU
# A/B kept GIN and SAGE on the plain block product there)
BLOCK_LAYER_CONVS = ("gcn", "lg", "simple")

_MODE = "auto"

# kernels whose gate declines under int8 in the JAX package itself (its
# ``_r4_block_cfg`` without ``int8_ok``): the plain path quantizes
INT8_DECLINED = ("gat_block", "edge_block")
# convs whose mp layer kernel runs no Linear: int8 leaves it in float32
INT8_NEUTRAL_CONVS = ("gcn", "lg", "simple")

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


def policy() -> str:
    """The active precision policy's name ("f32" when none is active)."""
    from gnnbuilder_tpu_torch.compile.precision import active_precision

    prec = active_precision()
    return "f32" if prec is None else prec.name


def _calibrating() -> bool:
    from gnnbuilder_tpu_torch.ops.quant import active_calibration

    return active_calibration() is not None


def _with_mode(cfg: dict) -> Optional[dict]:
    """``cfg`` for a kernel with all three modes (rows 1, 2, 3, 5, 10, 12;
    row 4 for GIN and SAGE): with "mode" set to the active policy's when that
    is not "f32"; None under an active int8 calibration."""
    name = policy()
    if name == "int8" and _calibrating():
        return None
    if name != "f32":
        cfg["mode"] = name
    return cfg


def _int8_declined(kernel: str) -> bool:
    """Whether ``kernel`` declines under the active policy: the JAX
    package's own int8 decline."""
    return kernel in INT8_DECLINED and policy() == "int8"


def set_fused_mode(mode: str) -> None:
    global _MODE
    if mode not in ("auto", "never"):
        raise ValueError(f"unknown fused mode {mode!r}")
    _MODE = mode


def block_cfg(g) -> Optional[dict]:
    """{} when a conv's plain aggregation takes the block-diagonal product
    (``ops.block``) on batch ``g``, else None (the ELL table or the edge
    list); {"mm": "bf16"} under the bf16 policy, whose product rounds its
    dense operand to bf16 (the JAX package's ``block_cfg``).  Needs a
    block-packed batch; "never" pins the ELL / edge-list paths, as in the
    JAX package."""
    if _MODE == "never" or g.block_adj is None:
        return None
    return {"mm": "bf16"} if policy() == "bf16" else {}


def mp_stack_cfg(g, conv: str) -> Optional[dict]:
    """{"block_size": ...[, "mode": ...]} when the whole-stack GCN / SAGE
    kernel (``ops.cuda.mp_block``) applies to batch ``g``, else None (the
    model runs the per-layer loop; GIN always does under "auto").

    Preconditions: inference scope and a block-packed batch at a block
    size that is a multiple of 128, and no active int8 calibration.
    Unlike the PNA stack it needs no ELL table: the kernel aggregates
    from ``block_adj``.  The mode is the policy's ("int8" quantizes every
    product, "bf16" rounds the gathered rows and the products' operands:
    the JAX package's ``quant`` and bf16 gather).  Elsewhere each layer
    takes ``mp_layer_cfg``'s route."""
    if conv not in MP_STACK_CONVS:
        return None
    if _MODE == "never" or not inference_on():
        return None
    if g.block_adj is None or g.block_size_static % 128:
        return None
    return _with_mode({"block_size": g.block_size_static})


def mp_layer_cfg(g, conv: str) -> Optional[dict]:
    """The per-layer mp kernel's route (``ops.cuda.mp_layer``) for a
    ``conv`` layer ("gcn", "gin", "sage", "lg" or "simple") on batch
    ``g``: {"block": True} (block mode) on a block-packed batch at a
    block size that is a multiple of 128 for gcn, lg and simple; {} (ELL
    mode) on a standard-packed batch with an ELL table; else None (the
    conv's plain path: the block product for GIN and SAGE and other block
    sizes on block batches, the edge list without a table).  In or
    out of inference scope, since the layer has a backward.  Under bf16
    every conv's route carries "mode": "bf16"; under int8 gin and sage
    carry "mode": "int8" (their epilogue products quantize) and decline
    under an active calibration, while gcn, lg and simple keep the
    float32 kernel, calibration or not (no Linear runs inside it: the
    JAX convs pop ``int8`` there).  The JAX package's alignment and
    batch-size gates are left out: they weighed the TPU's 128-lane
    padding and grid steps, which this kernel does not have."""
    if _MODE == "never":
        return None
    name = policy()
    quant = name == "int8" and conv not in INT8_NEUTRAL_CONVS
    if quant and _calibrating():
        return None
    if g.block_adj is not None:
        if conv not in BLOCK_LAYER_CONVS or g.block_size_static % 128:
            return None
        cfg = {"block": True}
    elif g.nbr_nodes is not None:
        cfg = {}
    else:
        return None
    if name == "bf16" or quant:
        cfg["mode"] = name
    return cfg


def pna_stack_cfg(g) -> Optional[dict]:
    """{"block_size": ...[, "mode": ...]} when the whole-stack PNA kernel
    applies to batch ``g``, else None (the model runs the per-layer loop).

    Preconditions: inference scope and a block-packed batch (every
    neighbour id inside its row's block) with its ELL table, at a block
    size that is a multiple of 128, and no active int8 calibration.  The
    mode is the policy's: "int8" quantizes every Linear product of the
    stack, "bf16" rounds the products' operands and the gathered rows (the
    JAX package's ``quant=True`` and ``gather_mode="bf16"``).  Width and
    block size beyond that are the kernel's to check: the CUDA wrapper
    raises on what it does not take rather than giving way to the plain
    version."""
    if _MODE == "never" or not inference_on():
        return None
    if g.nbr_nodes is None or g.block_adj is None:
        return None
    if g.block_size_static % 128:
        return None
    return _with_mode({"block_size": g.block_size_static})


def pna_layer_cfg(g, act) -> Optional[dict]:
    """{} ({"mode": ...} under a policy) when the per-layer PNA kernel
    (``ops.cuda.pna_layer``) applies to batch ``g`` with epilogue
    activation ``act``, else None (PNAConv runs its plain path).  The
    mode is the policy's: "int8" quantizes the final Linear only, "bf16"
    rounds the products' operands and the gathered rows; an active int8
    calibration declines.  The caller checks the default aggregators and
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
    return _with_mode({})


def gat_block_cfg(g, act) -> Optional[dict]:
    """{} ({"mode": "bf16"} under bf16) when GAT's block attention kernel
    (``ops.cuda.gat_block``) applies to batch ``g`` with epilogue
    activation ``act``, else None (GATConv tries the layer kernel, then
    its plain paths).  The JAX package's ``gat_block_cfg``: inference
    scope (the kernel has no backward) and a block-packed batch at a
    block size that is a multiple of 128, not under int8 (GAT's layer
    kernel takes the int8 policy); here also an activation the kernel
    has.  The block size beyond that is the kernel's to check: the CUDA
    wrapper raises on what it does not take."""
    from gnnbuilder_tpu_torch.ops.cuda.gat_layer import GAT_ACTS

    if _MODE == "never" or not inference_on() or _int8_declined("gat_block"):
        return None
    if g.block_adj is None or g.block_size_static % 128:
        return None
    if act not in GAT_ACTS:
        return None
    return {"mode": "bf16"} if policy() == "bf16" else {}


def gat_layer_cfg(g, act) -> Optional[dict]:
    """{} ({"mode": ...} under a policy) when the windowed GAT layer
    kernel (``ops.cuda.gat_layer``) applies to batch ``g`` with epilogue
    activation ``act``, else None (GATConv's plain paths).  The mode is
    the policy's: "int8" quantizes the projection (the JAX kernel's
    ``quant``, the serving precision), "bf16" rounds the projection's
    operands; an active int8 calibration declines, as the JAX conv's
    ``_quant_ok`` does.  The caller checks concat mode.  Needs the
    batch's ELL table and an activation the kernel has; in or out of
    inference scope, since the layer has a backward (float32 only), and
    on block-packed batches too outside inference scope or under int8
    (training keeps this kernel there, as in the JAX package).  The JAX
    package's alignment and batch-size gates are left out: they weighed
    the TPU's 128-lane padding, which this kernel does not have."""
    from gnnbuilder_tpu_torch.ops.cuda.gat_layer import GAT_ACTS

    if _MODE == "never" or g.nbr_nodes is None or act not in GAT_ACTS:
        return None
    return _with_mode({})


def agg_cfg(g) -> Optional[dict]:
    """{} ({"mode": "bf16"} under bf16) when the multi-aggregate kernel
    (``ops.cuda.ell_agg``) applies to batch ``g``, else None (the
    caller's plain path).  The JAX package's ``fused_config(kind="agg")``:
    the batch's ELL table and graph-contiguous packing with a known
    largest graph; the bf16 gather under bf16, the float32 kernel under
    int8 (calibration or not: it runs no product).  Like that gate it
    does not weigh block packing: ``nn.conv._fused_multi`` gives way to
    the block product on a block-packed batch, while PNA's block path
    takes the kernel for max and min.  The TPU's lane, VMEM and tile
    gates are left out: this kernel takes any width and row count."""
    if _MODE == "never" or g.nbr_nodes is None:
        return None
    if g.max_graph_nodes_static <= 0:
        return None
    return {"mode": "bf16"} if policy() == "bf16" else {}


def gine_layer_cfg(g, act) -> Optional[dict]:
    """{} ({"mode": ...} under a policy) when the GINE layer kernel
    (``ops.cuda.gine_layer``) applies to batch ``g`` with epilogue
    activation ``act``, else None (GINEConv's plain paths).  The mode is
    the policy's: "int8" quantizes both MLP products, "bf16" rounds the
    gathered rows and the products' operands; an active int8 calibration
    declines.  Needs the batch's ELL table with its edge slots
    (``nbr_edges``) and an activation the kernel has; in or out of
    inference scope, since the layer has a backward, and on block-packed
    batches too (GINE has no block kernel, so the windowed one outranks
    the block product, as in the JAX package).  The JAX package's
    staging, alignment and batch-size gates are left out: they weighed
    the TPU's hardware verification and 128-lane padding."""
    from gnnbuilder_tpu_torch.ops.cuda.mp_layer import LAYER_ACTS

    if _MODE == "never" or g.nbr_nodes is None or g.nbr_edges is None:
        return None
    if act not in LAYER_ACTS:
        return None
    return _with_mode({})


def edge_block_cfg(g, act) -> Optional[dict]:
    """{} ({"mode": "bf16"} under bf16) when the EdgeConv block kernel
    (``ops.cuda.edge_block``) applies to batch ``g`` with epilogue
    activation ``act``, else None (EdgeConv's plain paths).  The JAX
    package's ``edge_block_cfg``: inference scope (the JAX kernel's
    backward is a recompute and training keeps the ELL path), a
    block-packed batch at a block size that is a multiple of 128, and its
    ELL table, not under int8; here also an activation the kernel has."""
    from gnnbuilder_tpu_torch.ops.cuda.mp_layer import LAYER_ACTS

    if _MODE == "never" or not inference_on() or _int8_declined("edge_block"):
        return None
    if g.block_adj is None or g.block_size_static % 128:
        return None
    if g.nbr_nodes is None or act not in LAYER_ACTS:
        return None
    return {"mode": "bf16"} if policy() == "bf16" else {}


def readout_config(g, aggrs, act, out_act) -> Optional[dict]:
    """{"starts": ...[, "mode": ...]} when the fused readout kernel
    applies, else None (the model runs GlobalPooling + MLP).  The mode is the
    policy's: "int8" quantizes every MLP Linear, "bf16" rounds their
    operands; the pooling stays exact; an active int8 calibration
    declines.  Needs an add or mean
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
    return _with_mode({"starts": g.graph_starts})

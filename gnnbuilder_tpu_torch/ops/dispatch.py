"""Kernel dispatch policy: when the model takes the whole-stack, the
per-layer PNA, mp, GAT, GINE and EdgeConv, the multi-aggregate and the
readout kernels instead of the plain path, and which plain aggregation a
conv runs on a block-packed batch.

The gates decide on the batch and the model alone; which implementation a
kernel function then runs is decided by the tensors' device inside it (a
CUDA tensor launches the kernel, a CPU tensor runs its plain version).

Modes (``set_fused_mode``, read back by ``get_fused_mode``):
* "auto"  — the kernel functions whenever their preconditions hold
* "never" — the per-layer plain path only (conv loop over the ELL table
            or the edge list, GlobalPooling, MLP), so a test can pin it

``no_fused()`` is a context (a contextvar, so per thread and task) in
which every kernel gate declines whatever the mode, as the JAX package's
``no_fused``: a caller that runs the model where no kernel may run asks
for the plain path with it.  Like the JAX context it leaves ``block_cfg``
alone: the block product is a plain aggregation, not a kernel.

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
(``INT8_DECLINED``), where GAT takes its layer kernel in int8, unless
the conv has edge features: then the layer kernel declines too.
Under an active int8 calibration every gate that would give a kernel
the int8 mode declines: the plain path owns the per-site state.

``set_kernel_overrides`` is the DSE's handle on the knobs, with the JAX
package's signature: ``ell_width`` sets the packing-time default
(``core.graph.set_default_ell_width``); ``block_mode="off"`` makes
``block_cfg``, the block stacks', GAT's and EdgeConv's block gates and
the mp layer's block mode decline, as the JAX ``_BLOCK == "off"`` does
(the convs then take the ELL table or the edge list).  The JAX package's
other knobs schedule its Pallas kernels on the TPU (tile heights, window
DMAs, the one-hot gather's precision, the block product's MXU
precision); the card's kernels have no such schedule, so only ``None``,
their one policy, is taken.

Under a halo scope (``parallel.halo.halo_scope``: a model run on one
rank's node rows) the gates follow the JAX package's: the block product,
the stack kernels, GAT's and EdgeConv's block kernels, the
multi-aggregate and the readout decline (their layouts span the whole
batch); the per-layer mp, PNA and GAT kernels take the rank's rows, and
their wrappers run them on its [halo | local | halo] window
(``parallel.halo.halo_wrap_layer``); the mp layer takes its ELL mode
there, never the block mode.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

__all__ = ["set_fused_mode", "get_fused_mode", "no_fused",
           "set_kernel_overrides",
           "inference_mode", "policy", "inference_on",
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

# ``set_kernel_overrides(block_mode=)``: None, or "off" (no block route)
_BLOCK: Optional[str] = None

# the JAX package's knobs that schedule its Pallas kernels on the TPU and
# have no counterpart in the card's kernels: knob -> what it sets there
TPU_SCHEDULE_KNOBS = {
    "tile_rows": "the Pallas node tile height",
    "gather_mode": "the one-hot MXU gather's precision",
    "sub_rows": "the window gather's sub-tile height",
    "window_mode": "the window DMA schedule",
}
# block_mode values of the JAX package that are TPU A/B handles: "fused"
# ranks the windowed kernels over the block route, the others pin the
# block product's MXU precision
BLOCK_AB_MODES = ("fused", "split2", "bf16", "highest")

# kernels whose gate declines under int8 in the JAX package itself (its
# ``_r4_block_cfg`` without ``int8_ok``): the plain path quantizes
INT8_DECLINED = ("gat_block", "edge_block")
# convs whose mp layer kernel runs no Linear: int8 leaves it in float32
INT8_NEUTRAL_CONVS = ("gcn", "lg", "simple")

# the caller's explicit request for the plain path (``no_fused``)
_SUPPRESSED: contextvars.ContextVar = contextvars.ContextVar(
    "gnnb_torch_fused_suppressed", default=False
)


@contextlib.contextmanager
def no_fused():
    """Every kernel gate declines inside: the model runs its plain
    path."""
    tok = _SUPPRESSED.set(True)
    try:
        yield
    finally:
        _SUPPRESSED.reset(tok)


def _off() -> bool:
    """Whether the kernel gates decline: mode "never" or ``no_fused``."""
    return _MODE == "never" or _SUPPRESSED.get()


def _halo_on() -> bool:
    """Whether a halo scope is active (``parallel.halo``)."""
    from gnnbuilder_tpu_torch.parallel.halo import active_halo

    return active_halo() is not None


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


def get_fused_mode() -> str:
    return _MODE


_KEEP = object()  # sentinel: "leave this knob untouched"


def set_kernel_overrides(
    tile_rows=_KEEP, gather_mode=_KEEP, ell_width=_KEEP, sub_rows=_KEEP,
    window_mode=_KEEP, block_mode=_KEEP,
) -> None:
    """Pin the kernel knobs a DSE design point selects (the JAX package's
    signature).  Explicit ``None`` restores a knob's policy; an omitted
    knob is left untouched.

    ``ell_width`` is a packing-time layout knob: it sets the default of
    ``build_graph_batch(ell_width=None)`` and so reaches only batches
    packed after the call.  ``block_mode`` takes None or "off" (no block
    route); the JAX package's A/B values raise.  ``tile_rows``,
    ``gather_mode``, ``sub_rows`` and ``window_mode`` take None only:
    they schedule the JAX package's Pallas kernels on the TPU, and the
    card's kernels have no such schedule.  Every value is checked before
    any is set."""
    global _BLOCK
    for knob, value in (("tile_rows", tile_rows),
                        ("gather_mode", gather_mode),
                        ("sub_rows", sub_rows),
                        ("window_mode", window_mode)):
        if value is not _KEEP and value is not None:
            raise ValueError(
                f"{knob}={value!r}: {knob} sets "
                f"{TPU_SCHEDULE_KNOBS[knob]}, a Pallas/Mosaic schedule "
                f"knob of the TPU kernels that the card's kernels lack; "
                f"only None is taken")
    if block_mode is not _KEEP:
        if block_mode in BLOCK_AB_MODES:
            raise ValueError(
                f"block_mode={block_mode!r} is a TPU A/B handle of the JAX "
                f"package (block route precedence or MXU precision) that "
                f"is not ported; None or \"off\" is taken")
        if block_mode not in (None, "off"):
            raise ValueError(f"unknown block_mode {block_mode!r}")
        _BLOCK = block_mode
    if ell_width is not _KEEP:
        from gnnbuilder_tpu_torch.core import graph

        graph.set_default_ell_width(ell_width)


def _block_off() -> bool:
    """Whether ``set_kernel_overrides(block_mode="off")`` is in force."""
    return _BLOCK == "off"


def block_cfg(g) -> Optional[dict]:
    """{} when a conv's plain aggregation takes the block-diagonal product
    (``ops.block``) on batch ``g``, else None (the ELL table or the edge
    list); {"mm": "bf16"} under the bf16 policy, whose product rounds its
    dense operand to bf16 (the JAX package's ``block_cfg``).  Needs a
    block-packed batch; "never" pins the ELL / edge-list paths, as in the
    JAX package, and so does ``block_mode="off"``."""
    if (_MODE == "never" or _block_off() or g.block_adj is None
            or _halo_on()):
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
    if _off() or _block_off() or not inference_on() or _halo_on():
        return None
    if g.block_adj is None or g.block_size_static % 128:
        return None
    return _with_mode({"block_size": g.block_size_static})


def mp_layer_cfg(g, conv: str) -> Optional[dict]:
    """The per-layer mp kernel's route (``ops.cuda.mp_layer``) for a
    ``conv`` layer ("gcn", "gin", "sage", "lg" or "simple") on batch
    ``g``: {"block": True} (block mode) on a block-packed batch at a
    block size that is a multiple of 128 for gcn, lg and simple; {} (ELL
    mode) on a standard-packed batch with an ELL table, and on a
    block-packed one under ``block_mode="off"``; else None (the
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
    if _off():
        return None
    name = policy()
    quant = name == "int8" and conv not in INT8_NEUTRAL_CONVS
    if quant and _calibrating():
        return None
    if g.block_adj is not None and not _halo_on() and not _block_off():
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
    if _off() or _block_off() or not inference_on() or _halo_on():
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

    if _off() or g.nbr_nodes is None:
        return None
    if g.max_graph_nodes_static <= 0 or g.graph_starts is None:
        return None
    if act not in LAYER_ACTS:
        return None
    return _with_mode({})


def gat_block_cfg(g, act, edge: bool = False) -> Optional[dict]:
    """{} ({"mode": "bf16"} under bf16) when GAT's block attention kernel
    (``ops.cuda.gat_block``) applies to batch ``g`` with epilogue
    activation ``act``, else None (GATConv tries the layer kernel, then
    its plain paths).  The JAX package's ``gat_block_cfg``: inference
    scope (the kernel has no backward) and a block-packed batch at a
    block size that is a multiple of 128, not under int8 (GAT's layer
    kernel takes the int8 policy); here also an activation the kernel
    has.  For a conv with edge features (``edge``) the batch must carry
    them and repeat no (sender, receiver) pair, as the JAX conv checks
    (``multigraph_static``): the kernel's per-pair edge term cannot hold
    two parallel edges' terms.  The block size beyond that is the
    kernel's to check: the CUDA wrapper raises on what it does not
    take."""
    from gnnbuilder_tpu_torch.ops.cuda.gat_layer import GAT_ACTS

    if (_off() or _block_off() or not inference_on()
            or _int8_declined("gat_block") or _halo_on()):
        return None
    if g.block_adj is None or g.block_size_static % 128:
        return None
    if edge and (g.edge_feat is None or g.multigraph_static):
        return None
    if act not in GAT_ACTS:
        return None
    return {"mode": "bf16"} if policy() == "bf16" else {}


def gat_layer_cfg(g, act, edge: bool = False) -> Optional[dict]:
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
    (training keeps this kernel there, as in the JAX package).  A conv
    with edge features (``edge``) also needs the table's edge slots
    (``nbr_edges``), and declines under int8: the JAX conv gives its
    kernel ``int8_ok`` only without ``edge_dim``, so the plain path
    quantizes (the kernel's edge mode takes int8 all the same).  The JAX
    package's alignment and batch-size gates are left out: they weighed
    the TPU's 128-lane padding, which this kernel does not have."""
    from gnnbuilder_tpu_torch.ops.cuda.gat_layer import GAT_ACTS

    if _off() or g.nbr_nodes is None or act not in GAT_ACTS:
        return None
    if edge and (g.nbr_edges is None or g.edge_feat is None
                 or policy() == "int8"):
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
    if _off() or g.nbr_nodes is None or _halo_on():
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

    if _off() or g.nbr_nodes is None or g.nbr_edges is None:
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

    if (_off() or _block_off() or not inference_on()
            or _int8_declined("edge_block") or _halo_on()):
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

    if _off() or _halo_on():
        return None
    if not ({"add", "mean"} & set(aggrs)):
        return None
    if act not in READOUT_ACTS or out_act not in READOUT_OUT_ACTS:
        return None
    if g.max_graph_nodes_static <= 0 or g.graph_starts is None:
        return None
    return _with_mode({"starts": g.graph_starts})

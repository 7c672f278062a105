"""One EdgeConv layer (``fused_edge_block_layer``), its backward
(``EdgeBlockFunction``) and the entry EdgeConv calls
(``fused_edge_block_layer_auto``).

``fused_edge_block_layer`` launches ``csrc/edge_block.cu`` for CUDA
tensors and runs ``edge_block_layer_plain``, the same function in plain
torch, for CPU tensors.  It replaces the TPU kernel ``gnnbuilder_tpu/ops/
pallas/edge_block.py`` ``fused_edge_block_layer``; the plain version is
that file's ``edge_block_reference`` (EdgeConv's ELL path): with the
PairLinear split of ``w_pair`` [2 Fin, F] (self rows first)

    u = x w_pair[:Fin] + b0,  v = x w_pair[Fin:],  w = u - v
    y_s = relu(w_i + v[nbr_nodes[i, s]]) w1 + b1   per slot s
    out = act(aggr_{s < deg} y_s [+ skip])

for aggr max, sum or mean ("add" is sum), an empty row giving 0.  The
kernel sums the relu rows before lin1 for sum and mean (``deg * b1``
for sum), as the TPU kernel does.  The backward recomputes the plain
version under torch autograd (over ``ops.ell.ell_own_pads`` of the
table), as the JAX package's ``_make_vjp_fn`` recomputes its
reference.  EdgeConv takes the kernel under inference scope on
block-packed batches only (``dispatch.edge_block_cfg``), as the JAX
package does; the kernel itself reads neighbour rows with indexed loads
and needs no block locality.

What bounds the kernel on the H100: operations, run on the tensor cores
(3 x TF32 or bf16 ``mma.sync`` on the caller's weights as they are;
for max only over the valid slots); see the source.  The plain
version's float32 products go through ``_f32_dot``, the seam through
which the CPU tests put the kernel's chain order.
Operands are in the JAX package's [in, out] layout: w_pair [2 Fin, F],
b0 [F], w1 [F, Fout], b1 [Fout].

The bf16 mode (``mode="bf16"``; the JAX kernel's ``gather_mode="bf16"``
with ``mm="bf16"``, inference only: no backward) takes bfloat16 ``w_pair``
and ``w1``, rounds x at the two projections, each gathered v_j, and the
relu rows (or their sum, or mean) at the lin1 product; sums stay
float32.  There is no int8 mode: the JAX package's gate declines under
int8, and so does this package's.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.cuda.mp_layer import LAYER_ACTS
from gnnbuilder_tpu_torch.ops.ell import (
    ell_gather,
    ell_mask,
    ell_multi_table,
    ell_own_pads,
)
from gnnbuilder_tpu_torch.ops.quant import to_bf16

__all__ = ["fused_edge_block_layer", "edge_block_layer_plain",
           "EdgeBlockFunction", "fused_edge_block_layer_auto", "EDGE_AGGRS",
           "MODES"]

# the aggregations the kernel takes, with their codes in the source
EDGE_AGGRS = {"max": 0, "sum": 1, "mean": 2}
# kernel modes, with their codes in the source
MODES = {"f32": 0, "bf16": 1}


def _aggr(aggregation: str) -> str:
    name = "sum" if aggregation == "add" else aggregation
    if name not in EDGE_AGGRS:
        raise ValueError(f"unknown aggregation {aggregation}")
    return name


def _f32_dot(a, w):
    """The f32 mode's product in the plain version."""
    return a @ w


def edge_block_layer_plain(x, nbr_nodes, in_degree, w_pair, b0, w1, b1,
                           aggregation: str = "max", skip=None,
                           act: Optional[str] = None, mode: str = "f32"):
    """The layer in plain torch (``edge_block_reference``); in the bf16
    mode with the TPU kernel's roundings and its order for sum and mean
    (the relu rows summed before lin1, ``deg * b1`` for sum)."""
    name = _aggr(aggregation)
    Fin = x.shape[1]
    if mode == "bf16":
        xr, wp, w1f = to_bf16(x), w_pair.float(), w1.float()
        v = xr @ wp[Fin:]
        w = (xr @ wp[:Fin] + b0) - v
        table = torch.relu(w[:, None, :]
                           + ell_gather(to_bf16(v), nbr_nodes))
        mask = ell_mask(nbr_nodes, in_degree)
        deg = in_degree.to(x.dtype)[:, None]
        nonempty = deg > 0
        zero = x.new_zeros(())
        if name == "max":
            y = to_bf16(table) @ w1f                      # [N, W, Fout]
            mx = torch.where(mask[..., None], y, float("-inf")).amax(1)
            out = torch.where(nonempty, mx + b1, zero)
        else:
            t_sum = torch.where(mask[..., None], table, zero).sum(1)
            if name == "sum":
                out = to_bf16(t_sum) @ w1f + deg * b1
            else:
                y = to_bf16(t_sum / deg.clamp(min=1.0)) @ w1f
                out = torch.where(nonempty, y + b1, zero)
    else:
        u = _f32_dot(x, w_pair[:Fin]) + b0
        v = _f32_dot(x, w_pair[Fin:])
        table = torch.relu((u - v)[:, None, :] + ell_gather(v, nbr_nodes))
        y = _f32_dot(table.reshape(-1, table.shape[-1]), w1).view(
            *table.shape[:2], -1) + b1                    # [N, W, Fout]
        out = ell_multi_table(y, in_degree, (name,),
                              ell_mask(nbr_nodes, in_degree))[name]
    if skip is not None:
        out = out + skip
    return out if act is None else ACTIVATIONS[act](out)


def _check(x, nbr_nodes, in_degree, w_pair, b0, w1, b1, skip, act, mode):
    if act not in LAYER_ACTS:
        raise ValueError(f"unsupported EdgeConv activation {act!r}")
    if mode not in MODES:
        raise ValueError(f"the EdgeConv layer has modes {tuple(MODES)} (no "
                         f"int8 mode, as in the JAX package), got {mode!r}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, Fin] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    N, Fin = x.shape
    F, Fout = w_pair.shape[-1], w1.shape[-1]
    wdt = torch.bfloat16 if mode == "bf16" else torch.float32
    for name, t, shape in (("w_pair", w_pair, (2 * Fin, F)),
                           ("b0", b0, (F,)), ("w1", w1, (F, Fout)),
                           ("b1", b1, (Fout,)), ("skip", skip, (N, Fout))):
        dt = wdt if name[0] == "w" else torch.float32
        if t is not None and (tuple(t.shape) != shape or t.dtype != dt):
            raise ValueError(f"{name} must be {shape} {dt} in mode "
                             f"{mode!r}, got {tuple(t.shape)} {t.dtype}")
    if nbr_nodes is None or nbr_nodes.dim() != 2 or nbr_nodes.shape[0] != N:
        raise ValueError(f"nbr_nodes must be [{N}, W]")
    if tuple(in_degree.shape) != (N,):
        raise ValueError(f"in_degree must be [{N}]")
    devs = {t.device for t in (x, nbr_nodes, in_degree, w_pair, b0, w1, b1,
                               skip) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, nbr_nodes, in_degree, w_pair, b0, w1, b1, name, skip, act,
            mode):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, Fin = x.shape
    F, Fout = w_pair.shape[1], w1.shape[1]
    dev = x.device
    smem = lib.gnnb_edge_block_smem_bytes(Fin, F, MODES[mode])
    smem_max = lib.gnnb_smem_per_block_optin(dev.index or 0)
    if smem > smem_max:
        raise ValueError(f"the CUDA EdgeConv layer takes widths within "
                         f"{smem_max} bytes of shared memory; got Fin={Fin} "
                         f"F={F} ({smem} bytes)")
    if nbr_nodes.dtype != torch.int32 or in_degree.dtype != torch.int32:
        raise ValueError("nbr_nodes and in_degree must be int32")
    ops = [t for t in (x, nbr_nodes, in_degree, w_pair, b0, w1, b1, skip)
           if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("all inputs must be contiguous")
    fn = lib.gnnb_edge_block
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 3 + [I] * 5 + [P] * 5 + [I, I, I] + [P] * 4 + [I]
    f = torch.float32
    v = torch.empty((N, F), dtype=f, device=dev)
    w = torch.empty((N, F), dtype=f, device=dev)
    out = torch.empty((N, Fout), dtype=f, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), nbr_nodes.data_ptr(), in_degree.data_ptr(), N,
             nbr_nodes.shape[1], Fin, F, Fout, w_pair.data_ptr(),
             b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
             None if skip is None else skip.data_ptr(), EDGE_AGGRS[name],
             LAYER_ACTS[act], MODES[mode], v.data_ptr(), w.data_ptr(),
             out.data_ptr(), stream, dev.index or 0)
    if err != 0:
        raise RuntimeError(f"edge_block launch failed: cudaError {err}")
    fused_edge_block_layer.launches += 1
    fused_edge_block_layer.mode_launches[mode] += 1
    return out


def fused_edge_block_layer(x, nbr_nodes, in_degree, w_pair, b0, w1, b1,
                           aggregation: str = "max", skip=None,
                           act: Optional[str] = None, mode: str = "f32"):
    """One EdgeConv layer (module docstring) on x [N, Fin] float32 over the
    ELL table ``nbr_nodes`` [N, W] / ``in_degree`` [N] (int32), with
    bfloat16 ``w_pair`` / ``w1`` in the bf16 mode.  A CUDA ``x`` launches
    the kernel, which takes any width within shared memory and raises on
    what it does not take; a CPU ``x`` runs the plain version."""
    name = _aggr(aggregation)
    _check(x, nbr_nodes, in_degree, w_pair, b0, w1, b1, skip, act, mode)
    if x.device.type == "cuda":
        return _launch(x, nbr_nodes, in_degree, w_pair, b0, w1, b1, name,
                       skip, act, mode)
    if x.device.type != "cpu":
        raise ValueError(f"no EdgeConv layer for device {x.device}")
    return edge_block_layer_plain(x, nbr_nodes, in_degree, w_pair, b0, w1,
                                  b1, name, skip, act, mode)


fused_edge_block_layer.launches = 0
fused_edge_block_layer.mode_launches = dict.fromkeys(MODES, 0)


class EdgeBlockFunction(torch.autograd.Function):
    """``fused_edge_block_layer`` with the JAX package's backward: torch
    autograd of ``edge_block_layer_plain`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, nbr_nodes, in_degree, skip, w_pair, b0, w1, b1,
                aggregation, act):
        ctx.save_for_backward(x, nbr_nodes, in_degree, skip, w_pair, b0, w1,
                              b1)
        ctx.aggregation, ctx.act = aggregation, act
        return fused_edge_block_layer(x, nbr_nodes, in_degree, w_pair, b0,
                                      w1, b1, aggregation, skip, act)

    @staticmethod
    def backward(ctx, ct):
        x, nbr, deg, skip, *ws = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_()
                      for t in (x, skip, *ws)]
            lx, lskip, *lw = leaves
            o = edge_block_layer_plain(lx, ell_own_pads(nbr, deg), deg,
                                       *lw, ctx.aggregation, lskip, ctx.act)
            got = iter(torch.autograd.grad(
                o, [t for t in leaves if t is not None], ct))
        dx, dskip, *dw = [None if t is None else next(got) for t in leaves]
        return (dx, None, None, dskip, *dw, None, None)


def fused_edge_block_layer_auto(x, nbr_nodes, in_degree, w_pair, b0, w1, b1,
                                aggregation: str = "max", skip=None,
                                act: Optional[str] = None,
                                mode: str = "f32"):
    """The layer as EdgeConv calls it: through ``EdgeBlockFunction`` when
    grad mode is on and an input needs a gradient (mode "f32" only: the
    bf16 mode raises there), else the kernel alone, with float32 weights
    rounded to bfloat16 here in the bf16 mode.  The kernel takes any
    width, so nothing is padded."""
    ops = [None if t is None else t.contiguous()
           for t in (x, skip, w_pair, b0, w1, b1)]
    x, skip, w_pair, b0, w1, b1 = ops
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ops):
        if mode != "f32":
            raise ValueError(f"mode {mode!r} is an inference mode: no "
                             f"backward")
        return EdgeBlockFunction.apply(x, nbr_nodes, in_degree, skip, w_pair,
                                       b0, w1, b1, aggregation, act)
    if mode == "f32":
        return fused_edge_block_layer(x, nbr_nodes, in_degree, w_pair, b0,
                                      w1, b1, aggregation, skip, act)
    return fused_edge_block_layer(
        x, nbr_nodes, in_degree, w_pair.to(torch.bfloat16), b0,
        w1.to(torch.bfloat16), b1, aggregation, skip, act, mode=mode)

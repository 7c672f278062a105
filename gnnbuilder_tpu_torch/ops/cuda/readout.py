"""Fused readout: add/mean pooling + [add|mean|max] concat + MLP head +
output activation, in one kernel.

``fused_readout`` launches ``csrc/readout.cu`` for CUDA tensors and runs
``readout_plain``, the same function in plain torch, for CPU tensors.  It
replaces the TPU kernel ``gnnbuilder_tpu/ops/pallas/readout.py``
``fused_readout``.  Max pooling is an input (``mx``), computed by
``ops.segment.contiguous_segment_max`` as the JAX model does.

What bounds it on the H100: bytes (one read of the node rows; the MLP is
~25 k MACs per graph), and at this size launch latency.  A CTA loads the
MLP weights into shared memory once for 8 graphs.

``ReadoutFunction`` makes it differentiable as the JAX package's
``fused_readout_vjp`` does: the kernel forward, and a backward that
recomputes ``readout_plain`` under autograd (the JAX package has no
backward kernel for the readout either).

The ghost graph's row is finite garbage on both versions (they clip its
row range differently); compare only rows where ``graph_mask`` is true.

Modes (``mode``; the JAX kernel's ``mm`` and ``quant``): "f32"; "bf16",
whose weights are bfloat16 and whose products round their input rows to
bf16 and sum in float32; "int8", whose weights are int8 with per-column
scales (``prepare_head``) and whose products quantize their input rows
and sum exactly (``ops.quant``).  The pooling is exact in every mode and
the biases stay float32.  Only "f32" has a backward.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.quant import qdot, quantize_weight, to_bf16
from gnnbuilder_tpu_torch.ops.segment import segment_sum

__all__ = ["fused_readout", "readout_plain", "ReadoutFunction",
           "fused_readout_vjp", "prepare_head", "READOUT_ACTS",
           "READOUT_OUT_ACTS", "MODES"]

READOUT_ACTS = {None: 0, "relu": 1, "gelu": 2, "sigmoid": 3, "tanh": 4}
READOUT_OUT_ACTS = {None: 0, "softmax": 1, "log_softmax": 2}
_AGGR_CODES = {"add": 0, "mean": 1, "max": 2}
# kernel modes, with their codes in the source, and the weights' type
MODES = {"f32": 0, "bf16": 1, "int8": 2}
_WEIGHT_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}


def prepare_head(weights, mode: str):
    """(w [in, out], b) pairs as ``mode`` takes them: (pairs, scales or
    None).  "bf16" rounds each w to bfloat16; "int8" quantizes each w
    with per-column scales.  Biases stay float32."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    if mode == "f32":
        return tuple(weights), None
    if mode == "bf16":
        return tuple((w.to(torch.bfloat16), b) for w, b in weights), None
    qs = [quantize_weight(w) for w, _ in weights]
    return (tuple((q, b) for (q, _), (_, b) in zip(qs, weights)),
            tuple(s for _, s in qs))


def _starts_of(n_node):
    return (torch.cumsum(n_node, 0) - n_node).to(torch.int32)


def readout_plain(x, n_node, starts, weights, aggrs=("add",), mx=None,
                  act="relu", out_act=None, mode: str = "f32", scales=None):
    """The readout in plain torch.  Rows outside every graph's
    [start, start + n) range (padding between blocks) go to the ghost.
    ``mode`` and ``scales`` as for ``fused_readout``."""
    N = x.shape[0]
    G = n_node.shape[0]
    rows = torch.arange(N, device=x.device)
    st = starts.long()
    idx = (torch.searchsorted(st, rows, right=True) - 1).clamp(0, G - 1)
    inside = rows < st[idx] + n_node.long()[idx]
    seg = torch.where(inside, idx, torch.full_like(idx, G - 1))
    s = segment_sum(x, seg, G)
    cnt = n_node.to(x.dtype)[:, None]
    blocks = []
    for a in aggrs:
        if a == "add":
            blocks.append(s)
        elif a == "mean":
            blocks.append(s / cnt.clamp(min=1.0))
        else:
            blocks.append(mx)
    h = torch.cat(blocks, dim=-1)
    f = (lambda t: t) if act is None else ACTIVATIONS[act]
    for i, (w, b) in enumerate(weights):
        if mode == "f32":
            h = h @ w + b
        elif mode == "bf16":
            h = to_bf16(h) @ w.float() + b
        else:
            h = qdot(h, w, scales[i]) + b
        if i < len(weights) - 1:
            h = f(h)
    if out_act == "softmax":
        h = torch.softmax(h, dim=-1)
    elif out_act == "log_softmax":
        h = torch.log_softmax(h, dim=-1)
    return h


def _launch(x, n_node, starts, weights, aggrs, mx, act, out_act, mode,
            scales):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    N, F = x.shape
    G = n_node.shape[0]
    if n_node.dtype != torch.int32 or starts.dtype != torch.int32:
        raise ValueError("n_node and starts must be int32")
    # one float32 buffer: bf16 and int8 weight values are exact in it
    flat = [t.reshape(-1).float() for wb in weights for t in wb]
    flat += list(scales or ())
    params = torch.cat(flat)
    dims = [len(aggrs) * F] + [w.shape[1] for w, _ in weights]
    w_off, b_off, off = [], [], 0
    for w, b in weights:
        w_off.append(off)
        off += w.numel()
        b_off.append(off)
        off += b.numel()
    s_off = []
    for sc in scales or ():
        s_off.append(off)
        off += sc.numel()
    width = max(dims)
    tensors = [x, n_node, starts, params] + ([mx] if mx is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    lib = load()
    max_lin = lib.gnnb_readout_max_linears()
    max_aggr = lib.gnnb_readout_max_aggregators()
    smem = lib.gnnb_readout_smem_bytes(params.numel(), width)
    smem_max = lib.gnnb_smem_per_block_optin(x.device.index or 0)
    if len(weights) > max_lin or len(aggrs) > max_aggr or smem > smem_max:
        raise ValueError(
            f"the CUDA readout takes at most {max_lin} Linears and "
            f"{max_aggr} aggregators in {smem_max} bytes of shared memory; "
            f"got {len(weights)} Linears, {len(aggrs)} aggregators, "
            f"{smem} bytes")
    fn = lib.gnnb_readout
    fn.restype = ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ip, ip, ip, ip, ctypes.c_int, ip,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]

    def ints(v):
        return (ctypes.c_int * len(v))(*v)

    out = torch.empty((G, dims[-1]), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), N, F, starts.data_ptr(), n_node.data_ptr(), G,
             mx.data_ptr() if mx is not None else None, params.data_ptr(),
             params.numel(), len(weights), ints(dims), ints(w_off),
             ints(b_off), ints(s_off or [0]), len(aggrs),
             ints([_AGGR_CODES[a] for a in aggrs]), width, READOUT_ACTS[act],
             READOUT_OUT_ACTS[out_act], MODES[mode], out.data_ptr(), stream,
             x.device.index or 0)
    if err != 0:
        raise RuntimeError(f"readout launch failed: cudaError {err}")
    fused_readout.launches += 1
    fused_readout.mode_launches[mode] += 1
    return out


def fused_readout(x, n_node, weights, aggrs: Sequence[str] = ("add",),
                  mx=None, act: Optional[str] = "relu",
                  out_act: Optional[str] = None, starts=None,
                  mode: str = "f32", scales=None):
    """Pool x [N, F] per graph, run the MLP head and the output activation.

    n_node [G] int32 (ghost last); ``starts`` [G] int32 first row per graph
    (None = contiguous packing, the exclusive cumsum of n_node); weights:
    (w [in, out], b [out]) pairs in MLP order, w float32, bfloat16 or int8
    by ``mode`` and b float32; ``scales`` (mode "int8" only) the [out]
    column scales of each w; ``mx`` [G, F] is required exactly when "max"
    is in ``aggrs``.  A CUDA ``x`` launches the kernel, a CPU ``x`` runs
    the plain version.  Returns [G, out] float32."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    if (scales is not None) != (mode == "int8") or (
            scales is not None and len(scales) != len(weights)):
        raise ValueError("mode 'int8' takes one scale vector per Linear, "
                         "the other modes none")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("x must be [N, F] float32")
    if ("max" in aggrs) != (mx is not None):
        raise ValueError("mx must be given exactly when 'max' in aggrs")
    if any(a not in _AGGR_CODES for a in aggrs):
        raise ValueError(f"unknown pooling aggregators {aggrs}")
    if act not in READOUT_ACTS or out_act not in READOUT_OUT_ACTS:
        raise ValueError(f"unsupported activation {act!r}/{out_act!r}")
    F = x.shape[1]
    G = n_node.shape[0]
    if mx is not None and (tuple(mx.shape) != (G, F)
                           or mx.dtype != torch.float32):
        raise ValueError("mx must be [G, F] float32")
    din = len(aggrs) * F
    wdt = _WEIGHT_DTYPE[mode]
    for i, (w, b) in enumerate(weights):
        if (w.dim() != 2 or w.shape[0] != din or tuple(b.shape) != (w.shape[1],)
                or w.dtype != wdt or b.dtype != torch.float32):
            raise ValueError(f"weights must chain [in, out] {wdt} with "
                             f"[out] float32 biases in mode {mode!r}")
        if scales is not None and (tuple(scales[i].shape) != (w.shape[1],)
                                   or scales[i].dtype != torch.float32):
            raise ValueError("each scale vector must be [out] float32")
        din = w.shape[1]
    if starts is None:
        starts = _starts_of(n_node)
    tensors = [x, n_node, starts] + [t for wb in weights for t in wb] + (
        [mx] if mx is not None else []) + list(scales or ())
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if x.device.type == "cuda":
        return _launch(x, n_node, starts, weights, tuple(aggrs), mx, act,
                       out_act, mode, scales)
    if x.device.type != "cpu":
        raise ValueError(f"no readout for device {x.device}")
    return readout_plain(x, n_node, starts, weights, aggrs, mx, act, out_act,
                         mode, scales)


fused_readout.launches = 0
fused_readout.mode_launches = dict.fromkeys(MODES, 0)


def _pairs(flat):
    return tuple((flat[i], flat[i + 1]) for i in range(0, len(flat), 2))


class ReadoutFunction(torch.autograd.Function):
    """``fused_readout`` forward; the backward recomputes ``readout_plain``
    under autograd and returns the gradients of x, mx and every weight."""

    @staticmethod
    def forward(ctx, x, mx, n_node, starts, aggrs, act, out_act, *flat_w):
        ctx.save_for_backward(x, mx, n_node, starts, *flat_w)
        ctx.cfg = (aggrs, act, out_act)
        return fused_readout(x, n_node, _pairs(flat_w), aggrs=aggrs, mx=mx,
                             act=act, out_act=out_act, starts=starts)

    @staticmethod
    def backward(ctx, ct):
        x, mx, n_node, starts, *flat_w = ctx.saved_tensors
        aggrs, act, out_act = ctx.cfg
        with torch.enable_grad():
            xs = x.detach().requires_grad_()
            mxs = None if mx is None else mx.detach().requires_grad_()
            ws = [w.detach().requires_grad_() for w in flat_w]
            out = readout_plain(xs, n_node, starts, _pairs(ws), aggrs, mxs,
                                act, out_act)
            inputs = [xs] + ([] if mxs is None else [mxs]) + ws
            grads = list(torch.autograd.grad(out, inputs, ct))
        dx = grads.pop(0)
        dmx = None if mx is None else grads.pop(0)
        return (dx, dmx, None, None, None, None, None, *grads)


def fused_readout_vjp(x, n_node, weights, aggrs: Sequence[str] = ("add",),
                      mx=None, act: Optional[str] = "relu",
                      out_act: Optional[str] = None, starts=None):
    """Differentiable ``fused_readout`` (same arguments)."""
    if starts is None:
        starts = _starts_of(n_node)
    flat = [t for wb in weights for t in wb]
    return ReadoutFunction.apply(x, mx, n_node, starts, tuple(aggrs), act,
                                 out_act, *flat)

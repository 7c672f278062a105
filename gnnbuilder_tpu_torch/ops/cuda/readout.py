"""Fused readout: add/mean pooling + [add|mean|max] concat + MLP head +
output activation, in one kernel.

``fused_readout`` launches ``csrc/readout.cu`` for CUDA tensors and runs
``readout_plain``, the same function in plain torch, for CPU tensors.  It
replaces the TPU kernel ``gnnbuilder_tpu/ops/pallas/readout.py``
``fused_readout``.  Max pooling is an input (``mx``), computed by
``ops.segment.contiguous_segment_max`` as the JAX model does.

What bounds it on the H100: bytes (one read of the node rows; the MLP is
~25 k MACs per graph), and at this size latency.  The kernel takes the
head packed (``pack_head``: one float32 buffer, each Linear's weight in
nn.Linear's [out, in] layout with rows padded to a bank-conflict-free
stride, then the biases and int8 scales, at 16-byte aligned offsets) and
stages it into shared memory with one bulk copy that overlaps the
pooling.  ``GNNModel`` packs its head once per weights and mode for
inference; ``fused_readout`` packs the pairs it is given on every call
without the row padding (the kernel copies those rows to their stride
itself), which for the live weights of a train step (``lin.weight.t()``,
whose transpose is the parameter itself) is one concatenation of views.

``ReadoutFunction`` makes it differentiable as the JAX package's
``fused_readout_vjp`` does: the kernel forward, in any mode, and a
backward that recomputes the float32 ``readout_plain`` under autograd
(the JAX package has no backward kernel for the readout either; under
"int8" that is its straight-through estimator).  Its plain twin
(``plain=True``) runs ``readout_plain`` in the mode forward.

The ghost graph's row is finite garbage on both versions (they clip its
row range differently); compare only rows where ``graph_mask`` is true.

Modes (``mode``; the JAX kernel's ``mm`` and ``quant``): "f32"; "bf16",
whose weights are bfloat16 and whose products round their input rows to
bf16 and sum in float32; "int8", whose weights are int8 with per-column
scales (``prepare_head``) and whose products quantize their input rows
and sum exactly (``ops.quant``).  The pooling is exact in every mode and
the biases stay float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.quant import qdot, quantize_weight, to_bf16
from gnnbuilder_tpu_torch.ops.segment import segment_sum

__all__ = ["fused_readout", "readout_plain", "ReadoutFunction",
           "fused_readout_vjp", "prepare_head", "pack_head", "row_stride",
           "PackedHead", "READOUT_ACTS", "READOUT_OUT_ACTS", "MODES",
           "MAX_LINEARS"]

READOUT_ACTS = {None: 0, "relu": 1, "gelu": 2, "sigmoid": 3, "tanh": 4}
READOUT_OUT_ACTS = {None: 0, "softmax": 1, "log_softmax": 2}
_AGGR_CODES = {"add": 0, "mean": 1, "max": 2}
# kernel modes, with their codes in the source, and the weights' type
MODES = {"f32": 0, "bf16": 1, "int8": 2}
_WEIGHT_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}
# the packed head's layout (csrc/readout.cu gnnb_readout's desc)
MAX_LINEARS, _MAX_AGGR = 8, 3


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


def _check_head(weights, scales, mode, din=None):
    """The wrapper's checks of (w [in, out], b) pairs and scales in
    ``mode``; din, the pooled width, when known."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    if (scales is not None) != (mode == "int8") or (
            scales is not None and len(scales) != len(weights)):
        raise ValueError("mode 'int8' takes one scale vector per Linear, "
                         "the other modes none")
    if not weights:
        raise ValueError("the head needs at least one Linear")
    wdt = _WEIGHT_DTYPE[mode]
    din = weights[0][0].shape[0] if din is None else din
    for i, (w, b) in enumerate(weights):
        if (w.dim() != 2 or w.shape[0] != din or tuple(b.shape) != (w.shape[1],)
                or w.dtype != wdt or b.dtype != torch.float32):
            raise ValueError(f"weights must chain [in, out] {wdt} with "
                             f"[out] float32 biases in mode {mode!r}")
        if scales is not None and (tuple(scales[i].shape) != (w.shape[1],)
                                   or scales[i].dtype != torch.float32):
            raise ValueError("each scale vector must be [out] float32")
        din = w.shape[1]


class PackedHead:
    """A head packed for the kernel (``pack_head``): ``params`` the float32
    buffer, ``w_off`` / ``b_off`` / ``s_off`` each Linear's pieces (float
    offsets, multiples of 4; the weights' rows padded to a multiple of 4),
    ``dims`` the widths [in, out1, ...];
    ``weights`` and ``scales`` as given (the plain version runs them), in
    ``mode``."""

    def __init__(self, weights, scales, mode, params, dims, w_off, b_off,
                 s_off, padded):
        self.weights, self.scales, self.mode = weights, scales, mode
        self.params, self.dims, self.padded = params, dims, padded
        self.w_off, self.b_off, self.s_off = w_off, b_off, s_off
        self._desc = {}

    def desc(self, aggrs):
        """The kernel's host descriptor for ``aggrs`` (kept per aggrs)."""
        d = self._desc.get(aggrs)
        if d is None:
            pad = lambda v, n: list(v) + [0] * (n - len(v))
            vals = ([len(self.dims) - 1, len(aggrs)]
                    + pad(self.dims, MAX_LINEARS + 1)
                    + pad(self.w_off, MAX_LINEARS)
                    + pad(self.b_off, MAX_LINEARS)
                    + pad(self.s_off, MAX_LINEARS)
                    + pad([_AGGR_CODES[a] for a in aggrs], _MAX_AGGR)
                    + [int(self.padded)])
            d = self._desc[aggrs] = (ctypes.c_int * len(vals))(*vals)
        return d


_zeros = {}


def _zero_pad(n, device):
    """A view of n (< 4) zeros on ``device`` (no op per call)."""
    z = _zeros.get(device)
    if z is None:
        z = _zeros[device] = torch.zeros(4, device=device)
    return z[:n]


def row_stride(din: int, padded: bool) -> int:
    """A packed weight's row stride (floats): din rounded up to 4, and
    (``padded``) 4 more where that leaves (stride / 4) even: the kernel's
    shared-memory stride, at which eight consecutive rows' float4 reads
    fall in distinct bank groups (csrc/readout.cu ``w_ld_smem``)."""
    d4 = -(-din // 4) * 4
    return d4 + 4 if padded and (d4 // 4) % 2 == 0 else d4


def pack_head(weights, scales=None, mode: str = "f32",
              padded: bool = True) -> PackedHead:
    """The head as the kernel takes it: one float32 buffer holding each
    Linear's w [in, out] as [out, in] rows (nn.Linear's layout), each row
    padded with zeros to ``row_stride``, one Linear after another; then
    every bias, then (int8) every column-scale vector; each piece at a
    16-byte aligned offset (bf16 and int8 weight values are exact in
    float32).  ``padded`` rows the kernel stages with one bulk copy (the
    model's cached head); unpadded rows it copies to their stride itself,
    and for a train step's live weights (``lin.weight.t()`` at widths
    that are multiples of 4) the packing is one concatenation of views of
    the parameters."""
    weights = tuple(weights)
    scales = None if scales is None else tuple(scales)
    _check_head(weights, scales, mode)
    dev = weights[0][0].device
    pieces, off = [], 0
    w_off, b_off, s_off = [], [], []

    def put(t, offs):
        nonlocal off
        offs.append(off)
        pieces.append(t.reshape(-1))
        off += t.numel()
        if off % 4:
            pieces.append(_zero_pad(4 - off % 4, dev))
            off += 4 - off % 4

    for w, _ in weights:
        rows = w.t()
        extra = row_stride(rows.shape[1], padded) - rows.shape[1]
        if extra:
            rows = torch.nn.functional.pad(rows, (0, extra))
        put(rows, w_off)
    for _, b in weights:
        put(b, b_off)
    for sc in scales or ():
        put(sc, s_off)
    params = torch.cat(pieces).float()
    dims = [weights[0][0].shape[0]] + [w.shape[1] for w, _ in weights]
    return PackedHead(weights, scales, mode, params, dims, w_off, b_off,
                      s_off, padded)


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


_fn = (None, None)


def _kernel_fn():
    """The library's launcher, its argument types set once per library."""
    global _fn
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    if _fn[0] is not lib:
        fn = lib.gnnb_readout
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.restype = I
        fn.argtypes = ([P, I, I, P, P, I, P, P, I, ctypes.POINTER(I)]
                       + [I] * 3 + [P, P, I])
        _fn = (lib, fn)
    return _fn[1]


def _launch(x, n_node, starts, head: PackedHead, aggrs, mx, act, out_act):
    N, F = x.shape
    G = n_node.shape[0]
    if n_node.dtype != torch.int32 or starts.dtype != torch.int32:
        raise ValueError("n_node and starts must be int32")
    tensors = [x, n_node, starts] + ([mx] if mx is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    fn, lib = _kernel_fn(), load()
    dev = x.device.index or 0
    smem = lib.gnnb_readout_smem_bytes(max(head.dims))
    smem_max = lib.gnnb_smem_per_block_optin(dev)   # read once per device
    if (len(head.dims) - 1 > MAX_LINEARS or len(aggrs) > _MAX_AGGR
            or smem > smem_max):
        raise ValueError(
            f"the CUDA readout takes at most {MAX_LINEARS} Linears and "
            f"{_MAX_AGGR} aggregators in {smem_max} bytes of shared memory; "
            f"got {len(head.dims) - 1} Linears, {len(aggrs)} aggregators, "
            f"{smem} bytes")
    out = torch.empty((G, head.dims[-1]), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), N, F, starts.data_ptr(), n_node.data_ptr(), G,
             mx.data_ptr() if mx is not None else None,
             head.params.data_ptr(), head.params.numel(), head.desc(aggrs),
             READOUT_ACTS[act], READOUT_OUT_ACTS[out_act], MODES[head.mode],
             out.data_ptr(), stream, dev)
    if err != 0:
        raise RuntimeError(f"readout launch failed: cudaError {err}")
    fused_readout.launches += 1
    fused_readout.mode_launches[head.mode] += 1
    return out


def fused_readout(x, n_node, weights, aggrs: Sequence[str] = ("add",),
                  mx=None, act: Optional[str] = "relu",
                  out_act: Optional[str] = None, starts=None,
                  mode: str = "f32", scales=None):
    """Pool x [N, F] per graph, run the MLP head and the output activation.

    n_node [G] int32 (ghost last); ``starts`` [G] int32 first row per graph
    (None = contiguous packing, the exclusive cumsum of n_node); weights:
    (w [in, out], b [out]) pairs in MLP order, w float32, bfloat16 or int8
    by ``mode`` and b float32, or a ``PackedHead`` of them in ``mode``
    (``pack_head``: then ``scales`` is None, the head holds its own);
    ``scales`` (mode "int8" only) the [out] column scales of each w;
    ``mx`` [G, F] is required exactly when "max" is in ``aggrs``.  A CUDA
    ``x`` launches the kernel, a CPU ``x`` runs the plain version.
    Returns [G, out] float32."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    packed = weights if isinstance(weights, PackedHead) else None
    if packed is not None:
        if packed.mode != mode or scales is not None:
            raise ValueError(f"a head packed in mode {packed.mode!r} takes "
                             f"mode {packed.mode!r} and no scales")
        weights, scales = packed.weights, packed.scales
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
    if packed is None:
        _check_head(tuple(weights), scales, mode, len(aggrs) * F)
    elif packed.dims[0] != len(aggrs) * F:
        raise ValueError(f"the packed head takes {packed.dims[0]} pooled "
                         f"features; got {len(aggrs)} x {F}")
    if starts is None:
        starts = _starts_of(n_node)
    head_t = ([packed.params] if packed is not None else
              [t for wb in weights for t in wb] + list(scales or ()))
    tensors = [x, n_node, starts] + head_t + ([mx] if mx is not None else [])
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    if x.device.type == "cuda":
        if packed is None:
            packed = pack_head(weights, scales, mode, padded=False)
        return _launch(x, n_node, starts, packed, tuple(aggrs), mx, act,
                       out_act)
    if x.device.type != "cpu":
        raise ValueError(f"no readout for device {x.device}")
    return readout_plain(x, n_node, starts, weights, aggrs, mx, act, out_act,
                         mode, scales)


fused_readout.launches = 0
fused_readout.mode_launches = dict.fromkeys(MODES, 0)


def _pairs(flat):
    return tuple((flat[i], flat[i + 1]) for i in range(0, len(flat), 2))


class ReadoutFunction(torch.autograd.Function):
    """``fused_readout`` forward (in ``mode``, on ``prepare_head`` of the
    float32 weights, or ``readout_plain`` when ``plain``: the twin); the
    backward recomputes the float32 ``readout_plain`` under autograd and
    returns the gradients of x, mx and every float32 weight."""

    @staticmethod
    def forward(ctx, x, mx, n_node, starts, aggrs, act, out_act, mode,
                plain, *flat_w):
        ctx.save_for_backward(x, mx, n_node, starts, *flat_w)
        ctx.cfg = (aggrs, act, out_act)
        weights, scales = prepare_head(
            _pairs([w.detach() for w in flat_w]), mode)
        if plain:
            return readout_plain(x, n_node, starts, weights, aggrs, mx, act,
                                 out_act, mode, scales)
        return fused_readout(x, n_node, weights, aggrs=aggrs, mx=mx,
                             act=act, out_act=out_act, starts=starts,
                             mode=mode, scales=scales)

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
        return (dx, dmx, None, None, None, None, None, None, None, *grads)


def fused_readout_vjp(x, n_node, weights, aggrs: Sequence[str] = ("add",),
                      mx=None, act: Optional[str] = "relu",
                      out_act: Optional[str] = None, starts=None,
                      mode: str = "f32", plain: bool = False):
    """Differentiable ``fused_readout`` (same arguments, float32
    ``weights``): the kernel forward in ``mode`` and the float32
    backward; ``plain``: the plain twin."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    if starts is None:
        starts = _starts_of(n_node)
    flat = [t for wb in weights for t in wb]
    return ReadoutFunction.apply(x, mx, n_node, starts, tuple(aggrs), act,
                                 out_act, mode, bool(plain), *flat)

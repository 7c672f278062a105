"""Whole GCN, GIN or SAGE conv stack in one kernel, on block-packed
batches.

``fused_mp_block_stack`` launches ``csrc/mp_block.cu`` for CUDA tensors
and runs ``mp_stack_plain``, the same function in plain torch, for CPU
tensors.  It replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/mp_block.py`` ``mp_block_stack``; the plain
version is that file's ``mp_stack_reference``.  The kernel aggregates
from the block adjacency ``block_adj``, not the ELL table, so it takes
every block-packed batch, a hub over the ELL width included.

What bounds it on the H100: operations (1 or 2 F x F products per row and
layer).  They run on the tensor cores (split TF32 in three passes for
"f32", bf16 and int8 for the modes), with the weights streamed into
shared memory once per block and layer; see the source for the layout.

The kernel reads the weights in its own layout (``stage_mp_stack``): per
layer w0 then w1, each cut into 128-column tiles and k-steps in the order
of the tensor cores' B fragments.  ``Program``'s model caches it per mode
beside its other kernel operands; a direct call without ``staged`` lays
the weights out on the call.

Weights use the JAX package's [in, out] layout, stacked over layers and
zero-padded to one width F (``stack_mp_params``): per conv ``(w0, b0, w1,
b1)`` = gcn ``(lin, bias, 0, 0)``, gin ``(lin0, lin0.b, lin1, lin1.b)``,
sage ``(lin_l, lin_l.b, lin_r, 0)``.  Biases are [L, F].

Inference modes (``mode``; the JAX kernel's ``gather_mode="bf16"`` with
``mm="bf16"``, and ``quant``): "bf16" takes bfloat16 weights, rounds each
layer's aggregation source to bf16 as it is gathered (the sum float32)
and rounds every product's operands; "int8" quantizes every product
(gcn's ``h w0``, both of gin's and of sage's: ``ops.quant.qdot``, int8
weights with per-column scales) and keeps the adjacency sum exact.
``prepare_mp_stack`` brings ``stack_mp_params``' operands to a mode.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.block import block_spmm
from gnnbuilder_tpu_torch.ops.cuda.mp_layer import weight_dtype
from gnnbuilder_tpu_torch.ops.cuda.pna_block import (
    _PER_REG,
    _fragment_index,
    _pad2,
    split_tf32,
)
from gnnbuilder_tpu_torch.ops.quant import qdot, quantize_weight, to_bf16

__all__ = ["fused_mp_block_stack", "mp_stack_plain", "mp_block_stack_auto",
           "stack_mp_params", "prepare_mp_stack", "stage_mp_stack",
           "unstage_mp_stack", "CONV_CODES", "STACK_ACTS", "BLOCK_ROWS",
           "MODES"]

# the convs the kernel takes, with their codes in the source
CONV_CODES = {"gcn": 0, "gin": 1, "sage": 2}
# epilogue activations the kernel takes, with their codes in the source
STACK_ACTS = {None: 0, "relu": 1, "gelu": 2, "sigmoid": 3, "tanh": 4}
# the rows of one block the kernel takes (``csrc/mp_block.cu``
# ``gnnb_mp_block_rows``), for the gate, which loads no library: a batch
# packed at another block size runs per layer (``dispatch.mp_stack_cfg``)
BLOCK_ROWS = 128
# kernel modes, with their codes in the source
MODES = {"f32": 0, "bf16": 1, "int8": 2}
# (mode, L, F, device) -> the device's copy of _stream_order(mode, L, F)
_ORDERS = {}


def _act(name):
    return (lambda t: t) if name is None else ACTIVATIONS[name]


def _f32_dot(a, w):
    """The f32 mode's product in the plain version."""
    return a @ w


def mp_stack_plain(x, block_adj, in_degree, w0, b0, w1, b1, conv, epss,
                   skips, act=None, mode: str = "f32", scales=None):
    """The stack in plain torch: the per-layer math of the convs'
    block-aggregation paths, iterated (the JAX ``mp_stack_reference``), in
    ``mode`` (``scales`` = (s0, s1) [L, F] in "int8").  sage's two
    products are one product of [mean | h] with [w0; w1] outside "int8",
    as the kernel sums them."""
    degf = in_degree.to(x.dtype)[:, None]
    f = _act(act)
    rnd = to_bf16 if mode == "bf16" else (lambda t: t)

    def dot(a, w, sw):
        if mode == "int8":
            return qdot(a, w, sw)
        if mode == "f32":
            return _f32_dot(a, w)
        return rnd(a) @ w.float()

    s0, s1 = scales if mode == "int8" else ([None] * w0.shape[0],) * 2
    h = x
    for l in range(w0.shape[0]):
        if conv == "gcn":
            dis = torch.rsqrt(degf + 1.0)
            p = dot(h, w0[l], s0[l]) * dis
            o = dis * (block_spmm(block_adj, rnd(p)) + p) + b0[l]
        elif conv == "gin":
            hh = (1.0 + epss[l]) * h + block_spmm(block_adj, rnd(h))
            o = dot(torch.relu(dot(hh, w0[l], s0[l]) + b0[l]), w1[l],
                    s1[l]) + b1[l]
        else:
            mean = block_spmm(block_adj, rnd(h)) / degf.clamp(min=1.0)
            if mode == "int8":
                o = dot(mean, w0[l], s0[l]) + b0[l] + dot(h, w1[l], s1[l])
            else:
                o = dot(torch.cat([mean, h], 1),
                        torch.cat([w0[l], w1[l]], 0), None) + b0[l]
        if skips[l]:
            o = o + h
        h = f(o)
    return h


def _stream_order(mode: str, L: int, F: int):
    """(index, half): the positions of the stream ``stage_mp_stack``
    makes, as indices into w0 and w1 interleaved per layer (flat [L, 2, F,
    F]), and for "f32" the TF32 half each holds (0 hi, 1 lo: a pair of n8
    tiles' 128 hi values, then its 128 lo values).  Per layer w0 then
    w1; per matrix its 128-column tiles in order, each in
    ``_fragment_index`` order (k-steps of the mode's mma depth)."""
    frag = _fragment_index(F, 128, _PER_REG[mode])
    k, n = frag // 128, frag % 128
    mat = torch.cat([k * F + n0 + n for n0 in range(0, F, 128)])
    index = torch.cat([lm * F * F + mat for lm in range(2 * L)])
    if mode != "f32":
        return index, torch.zeros_like(index)
    pairs = index.numel() // 128
    index = index.view(pairs, 1, 128).expand(pairs, 2, 128).reshape(-1)
    half = torch.arange(2).view(1, 2, 1).expand(pairs, 2, 128).reshape(-1)
    return index, half


def _order(mode: str, L: int, F: int, device):
    key = (mode, L, F, str(device))
    if key not in _ORDERS:
        _ORDERS[key] = tuple(t.to(device) for t in _stream_order(mode, L, F))
    return _ORDERS[key]


def stage_mp_stack(stacked, mode: str):
    """w0 and w1 of ``stacked`` (as ``prepare_mp_stack`` gives them for
    ``mode``) in the layout the kernel streams (``_stream_order``): one
    flat tensor of the weights' type, 2 F^2 values a layer, in "f32" 4 F^2
    (each weight's ``split_tf32`` halves)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    w0, _, w1, _ = stacked
    L, F = w0.shape[0], w0.shape[2]
    index, half = _order(mode, L, F, w0.device)
    flat = torch.stack([w0, w1], 1).reshape(-1)
    if mode == "f32":
        return torch.stack(split_tf32(flat))[half, index]
    return flat[index]


def unstage_mp_stack(staged, mode: str, L: int, F: int):
    """(w0, w1) back from ``stage_mp_stack``'s layout; in "f32" each with a
    leading dimension of 2, its TF32 halves (hi, lo)."""
    index, half = _order(mode, L, F, staged.device)
    flat = staged.new_empty((2 if mode == "f32" else 1, 2 * L * F * F))
    flat[half, index] = staged
    both = flat.view(-1, L, 2, F, F)
    w0, w1 = both[:, :, 0], both[:, :, 1]
    return (w0, w1) if mode == "f32" else (w0[0], w1[0])


def _check(x, block_adj, in_degree, w0, b0, w1, b1, conv, epss, skips, act,
           block_size, mode, scales):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, F] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    N, F = x.shape
    L = w0.shape[0]
    wdt = weight_dtype(mode)
    for name, t, shape, dt in (("w0", w0, (L, F, F), wdt),
                               ("b0", b0, (L, F), torch.float32),
                               ("w1", w1, (L, F, F), wdt),
                               ("b1", b1, (L, F), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {shape} {dt} in mode "
                             f"{mode!r}, got {tuple(t.shape)} {t.dtype}")
    if mode != "int8":
        if scales is not None:
            raise ValueError(f"mode {mode!r} takes no scales")
    elif (scales is None or len(scales) != 2 or any(
            tuple(t.shape) != (L, F) or t.dtype != torch.float32
            for t in scales)):
        raise ValueError(f"mode 'int8' takes scales (s0, s1), each ({L}, "
                         f"{F}) float32")
    if block_size < 1 or N % block_size:
        raise ValueError(f"N={N} is not a multiple of block_size="
                         f"{block_size}")
    if tuple(block_adj.shape) != (N // block_size, block_size, block_size):
        raise ValueError(f"block_adj must be [{N // block_size}, "
                         f"{block_size}, {block_size}]")
    if tuple(in_degree.shape) != (N,):
        raise ValueError("in_degree must be [N]")
    if conv not in CONV_CODES:
        raise ValueError(f"unsupported stack conv {conv!r}; options: "
                         f"{sorted(CONV_CODES)}")
    if len(epss) != L or len(skips) != L:
        raise ValueError("need one eps and one skip flag per layer")
    if act not in STACK_ACTS:
        raise ValueError(f"unsupported stack activation {act!r}")
    devs = {t.device for t in (x, block_adj, in_degree, w0, b0, w1, b1,
                               *(scales or ()))}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, block_adj, in_degree, w0, b0, w1, b1, conv, epss, skips, act,
            block_size, mode, scales, staged):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    rows = lib.gnnb_mp_block_rows()
    mult = lib.gnnb_mp_block_width_multiple()
    max_layers = lib.gnnb_mp_block_max_layers()
    N, F = x.shape
    L = w0.shape[0]
    dev = x.device.index or 0
    smem = lib.gnnb_mp_block_smem_bytes(F, MODES[mode])
    smem_max = lib.gnnb_smem_per_block_optin(dev)
    if (block_size != rows or F % mult or L > max_layers
            or smem > smem_max):
        raise ValueError(
            f"the CUDA mp stack takes block_size={rows}, widths that are "
            f"multiples of {mult} within {smem_max} bytes of shared memory "
            f"and at most {max_layers} layers; got block_size={block_size} "
            f"F={F} ({smem} bytes) L={L}")
    if in_degree.dtype != torch.int32 or block_adj.dtype != torch.float32:
        raise ValueError("in_degree must be int32 and block_adj float32")
    if staged is None:
        staged = stage_mp_stack((w0, b0, w1, b1), mode)
    n = L * 2 * F * F * (2 if mode == "f32" else 1)
    if (tuple(staged.shape) != (n,) or staged.dtype != w0.dtype
            or staged.device != x.device):
        raise ValueError(f"staged must be stage_mp_stack's layout of the "
                         f"weights: ({n},) {w0.dtype} on {x.device}")
    tensors = (x, block_adj, in_degree, staged, b0, b1, *(scales or ()))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")
    fn = lib.gnnb_mp_block_stack
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 3 + [I] * 2 + [P] * 4 + [I] * 2
                   + [ctypes.POINTER(ctypes.c_float),
                      ctypes.POINTER(ctypes.c_int), I, I, P, P, P, P, P, I,
                      P, ctypes.c_longlong])
    wb = lib.gnnb_mp_block_work_bytes
    wb.restype = ctypes.c_longlong
    work_bytes = wb(N, F, MODES[mode], dev)
    if work_bytes < 0:
        raise RuntimeError("mp_block_stack: no shared-memory limit for "
                           f"device {dev}")
    out = torch.empty_like(x)
    # wider widths keep T, Z and the int8 levels in device memory
    work = (torch.empty(work_bytes, dtype=torch.uint8, device=x.device)
            if work_bytes else None)
    s0, s1 = scales if mode == "int8" else (None, None)
    c_eps = (ctypes.c_float * L)(*[float(e) for e in epss])
    c_skips = (ctypes.c_int * L)(*[int(bool(s)) for s in skips])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), block_adj.data_ptr(), in_degree.data_ptr(), N, F,
             w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), L,
             CONV_CODES[conv], c_eps, c_skips, STACK_ACTS[act], MODES[mode],
             None if s0 is None else s0.data_ptr(),
             None if s1 is None else s1.data_ptr(),
             out.data_ptr(), None if work is None else work.data_ptr(),
             stream, dev, staged.data_ptr(),
             staged.numel() * staged.element_size())
    if err != 0:
        raise RuntimeError(f"mp_block_stack launch failed: cudaError {err}")
    fused_mp_block_stack.launches += 1
    fused_mp_block_stack.mode_launches[mode] += 1
    return out


def fused_mp_block_stack(x, block_adj, in_degree, w0, b0, w1, b1, conv: str,
                         epss: Sequence[float], skips: Sequence[bool],
                         act: Optional[str] = None, block_size: int = 128,
                         mode: str = "f32", scales=None, staged=None):
    """Run the whole L-layer GCN, GIN or SAGE stack.

    x [N, F] float32; block_adj [N / block_size, block_size, block_size]
    float32 edge counts; in_degree [N] int32; w0, w1 [L, F, F] (float32,
    or as ``prepare_mp_stack`` gives them for ``mode``, with ``scales``
    in "int8"); b0, b1 [L, F]; one eps (GIN) and one skip flag per layer.
    A CUDA ``x`` launches the kernel, which takes 128-row blocks and F a
    multiple of 128 and raises on anything else; a CPU ``x`` runs the
    plain version.  ``staged``: ``stage_mp_stack``'s layout of the same
    weights, which the kernel reads (made on the call when None; unused on
    the CPU).  Returns h [N, F]."""
    _check(x, block_adj, in_degree, w0, b0, w1, b1, conv, epss, skips, act,
           block_size, mode, scales)
    if x.device.type == "cuda":
        return _launch(x, block_adj, in_degree, w0, b0, w1, b1, conv, epss,
                       skips, act, block_size, mode, scales, staged)
    if x.device.type != "cpu":
        raise ValueError(f"no mp stack for device {x.device}")
    return mp_stack_plain(x, block_adj, in_degree, w0, b0, w1, b1, conv,
                          epss, skips, act, mode, scales)


fused_mp_block_stack.launches = 0
fused_mp_block_stack.mode_launches = dict.fromkeys(MODES, 0)


def stack_mp_params(layers, F_p: int):
    """Per-layer ``(w0, b0, w1, b1)`` in [in, out] layout, any widths, None
    for an operand the conv lacks, into uniform zero-padded stacked
    operands (w0 [L, F_p, F_p], b0 [L, F_p], w1, b1).  Pad lanes are inert:
    padded weight ROWS are zero, so whatever pad lanes of h carry adds
    nothing to real lanes, and pad output columns are sliced off by the
    caller."""
    out = [[] for _ in range(4)]
    for layer in layers:
        for k, t in enumerate(layer):
            if t is None:
                shape = (F_p, F_p) if k % 2 == 0 else (F_p,)
                ref = next(u for u in layer if u is not None)
                out[k].append(ref.new_zeros(shape))
            elif t.dim() == 2:
                out[k].append(_pad2(t, F_p, F_p))
            else:
                out[k].append(torch.nn.functional.pad(t, (0, F_p - len(t))))
    return tuple(torch.stack(xs).contiguous() for xs in out)


def prepare_mp_stack(stacked, mode: str):
    """``stack_mp_params``' operands as ``mode`` takes them: (the four
    operands, the scales (s0, s1) or None).  "bf16" rounds w0 and w1 to
    bfloat16; "int8" quantizes each layer of each with per-column scales
    (``ops.quant.quantize_weight``) on the padded matrices, as the JAX
    wrapper does (a zero w1 quantizes to zeros).  Biases stay float32."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    w0, b0, w1, b1 = stacked
    if mode == "f32":
        return stacked, None
    if mode == "bf16":
        return (w0.to(torch.bfloat16), b0, w1.to(torch.bfloat16), b1), None
    qs = [[quantize_weight(m[l]) for l in range(m.shape[0])]
          for m in (w0, w1)]
    (q0, q1), scales = zip(*[(torch.stack([q for q, _ in ql]),
                              torch.stack([s for _, s in ql])) for ql in qs])
    return (q0, b0, q1, b1), tuple(scales)


def mp_block_stack_auto(x, block_adj, in_degree, conv, stacked, epss, skips,
                        act=None, out_dim: Optional[int] = None,
                        block_size: int = 128, mode: str = "f32",
                        scales=None, staged=None):
    """``fused_mp_block_stack`` on ``x`` of any width <= F: zero-pads x to
    the stacked width F and returns the first ``out_dim`` columns.
    ``stacked`` and ``scales`` as ``prepare_mp_stack`` gives them for
    ``mode``, ``staged`` as ``stage_mp_stack`` gives it."""
    F_p = stacked[0].shape[2]
    xp = torch.nn.functional.pad(x, (0, F_p - x.shape[1])).contiguous()
    out = fused_mp_block_stack(xp, block_adj, in_degree, *stacked, conv=conv,
                               epss=epss, skips=skips, act=act,
                               block_size=block_size, mode=mode,
                               scales=scales, staged=staged)
    return out if out_dim is None else out[:, :out_dim]

"""Whole PNA conv stack in one kernel, on block-packed batches.

``fused_pna_block_stack`` launches ``csrc/pna_block.cu`` for CUDA tensors
and runs ``pna_block_stack_plain``, the same function in plain torch, for
CPU tensors.  It replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/pna_block.py`` ``fused_pna_block_stack``.

What bounds it on the H100: operations (2*(4F^2 + 12F^2) flops per row
per layer against ~2 KB of row traffic).  The kernel keeps each 128-row
block's hidden state in shared memory for all layers and runs the dots as
f32 FMAs; see the source for the layout.

Weights use the JAX package's layout: ``[in, out]`` matrices stacked over
layers and zero-padded to one width F (``stack_params``), so
``h @ W`` is the product.  Biases are ``[L, F]``.

Modes (``mode``; the JAX kernel's ``mm``, ``gather_mode`` and ``quant``):
"f32"; "bf16", whose five weight stacks are bfloat16 and whose products
round their operands (and the gathered v) to bf16 and sum in float32;
"int8", whose five weight stacks are int8 with per-layer per-column
scales (``prepare_stack`` quantizes the padded, regrouped stacks, as the
JAX wrapper does) and whose every Linear product quantizes its rows and
sums exactly (``ops.quant``).  Biases stay float32 in every mode.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.ell import _STD_EPS, ell_mask
from gnnbuilder_tpu_torch.ops.quant import (
    qdot,
    quantize_weight,
    to_bf16,
    true_div,
)

__all__ = ["fused_pna_block_stack", "pna_block_stack_plain",
           "pna_block_stack_auto", "stack_params", "prepare_stack",
           "STACK_ACTS", "MODES"]

# epilogue activations the kernel takes, with their codes in the source
STACK_ACTS = {None: 0, "relu": 1, "gelu": 2, "sigmoid": 3, "tanh": 4}
# kernel modes, with their codes in the source, and the weights' type
MODES = {"f32": 0, "bf16": 1, "int8": 2}
_WEIGHT_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}
_MATS = ("wi", "wj", "k0", "ks", "w_lin")


def _act(name):
    return (lambda t: t) if name is None else ACTIVATIONS[name]


def pna_block_stack_plain(x, nbr_nodes, in_degree, wi, wj, b_pre, k0, ks,
                          b_post, w_lin, b_lin, deltas, skips, act=None,
                          mode: str = "f32", scales=None):
    """The stack in plain torch, with the kernel's arithmetic: the receiver
    term u comes outside the reduce (max(u + v_j) = u + max v_j, and the
    std of u + v_j is the std of v_j).  ``mode`` and ``scales`` as for
    ``fused_pna_block_stack``."""
    mats = dict(zip(_MATS, (wi, wj, k0, ks, w_lin)))
    sc = dict(zip(_MATS, scales)) if mode == "int8" else None

    def dot(a, name, l):
        w = mats[name][l]
        if mode == "f32":
            return a @ w
        if mode == "bf16":
            return to_bf16(a) @ w.float()
        return qdot(a, w, sc[name][l])

    gathered = to_bf16 if mode == "bf16" else (lambda t: t)
    L = wi.shape[0]
    F = wi.shape[2]
    m = ell_mask(nbr_nodes, in_degree)[..., None]
    degf = in_degree.to(x.dtype)[:, None]
    denom = degf.clamp(min=1.0)
    nonempty = degf > 0
    log_deg = torch.log(denom + 1.0)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    idx = nbr_nodes.long()
    f = _act(act)
    h = x
    for l in range(L):
        v = gathered(dot(h, "wj", l))
        u = dot(h, "wi", l) + b_pre[l]
        g = v[idx]                                        # [N, W, F]
        s = torch.where(m, g, zero).sum(1)
        sq = torch.where(m, g * g, zero).sum(1)
        mx = torch.where(m, g, float("-inf")).amax(1)
        mn = torch.where(m, g, float("inf")).amin(1)
        mean = s / denom
        var = torch.relu(sq / denom - mean * mean)
        agg = torch.cat([
            torch.where(nonempty, u + mx, zero),
            torch.where(nonempty, u + mn, zero),
            torch.where(nonempty, u + mean, zero),
            torch.sqrt(var + _STD_EPS),
        ], dim=1)
        y = dot(agg, "ks", l)
        amp = true_div(log_deg, deltas[l])
        att = true_div(deltas[l], log_deg)
        mid = (dot(h, "k0", l) + b_post[l] + y[:, :F] + amp * y[:, F:2 * F]
               + att * y[:, 2 * F:])
        o = dot(mid, "w_lin", l) + b_lin[l]
        if skips[l]:
            o = o + h
        h = f(o)
    return h


def _check(x, nbr_nodes, in_degree, mats, biases, deltas, skips, act,
           block_size, mode, scales):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, F] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    N, F = x.shape
    wi = mats[0]
    L = wi.shape[0]
    shapes = [(L, F, F), (L, F, F), (L, F, F), (L, 4 * F, 3 * F), (L, F, F)]
    wdt = _WEIGHT_DTYPE[mode]
    for name, t, shape in zip(_MATS, mats, shapes):
        if tuple(t.shape) != shape or t.dtype != wdt:
            raise ValueError(f"{name} must be {shape} {wdt} in mode "
                             f"{mode!r}, got {tuple(t.shape)} {t.dtype}")
    if mode == "int8":
        if scales is None or len(scales) != 5:
            raise ValueError("mode 'int8' needs the five weight scales")
        for name, t, shape in zip(_MATS, scales, shapes):
            if (tuple(t.shape) != (L, shape[2])
                    or t.dtype != torch.float32):
                raise ValueError(f"the scales of {name} must be "
                                 f"({L}, {shape[2]}) float32")
    elif scales is not None:
        raise ValueError(f"mode {mode!r} takes no scales")
    for name, t in zip(("b_pre", "b_post", "b_lin"), biases):
        if tuple(t.shape) != (L, F) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({L}, {F}) float32")
    if nbr_nodes.dim() != 2 or nbr_nodes.shape[0] != N:
        raise ValueError("nbr_nodes must be [N, W]")
    if tuple(in_degree.shape) != (N,):
        raise ValueError("in_degree must be [N]")
    if len(deltas) != L or len(skips) != L:
        raise ValueError("need one delta and one skip flag per layer")
    if act not in STACK_ACTS:
        raise ValueError(f"unsupported stack activation {act!r}")
    if block_size < 1 or N % block_size:
        raise ValueError(f"N={N} is not a multiple of block_size="
                         f"{block_size}")
    devs = {t.device for t in (x, nbr_nodes, in_degree, *mats, *biases,
                               *(scales or ()))}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, nbr_nodes, in_degree, mats, biases, deltas, skips, act,
            block_size, mode, scales):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    width = lib.gnnb_pna_block_feature_width()
    rows = lib.gnnb_pna_block_rows()
    max_layers = lib.gnnb_pna_block_max_layers()
    N, F = x.shape
    L = mats[0].shape[0]
    if F != width or block_size != rows or L > max_layers:
        raise ValueError(
            f"the CUDA PNA stack takes F={width}, block_size={rows} and at "
            f"most {max_layers} layers; got F={F} block_size={block_size} "
            f"L={L}")
    if nbr_nodes.dtype != torch.int32 or in_degree.dtype != torch.int32:
        raise ValueError("nbr_nodes and in_degree must be int32")
    tensors = (x, nbr_nodes, in_degree, *mats, *biases, *(scales or ()))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")
    fn = lib.gnnb_pna_block_stack
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
        + [ctypes.c_int, ctypes.POINTER(ctypes.c_float),
           ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 5
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    )
    wi, wj, k0, ks, w_lin = mats
    b_pre, b_post, b_lin = biases
    out = torch.empty_like(x)
    W = nbr_nodes.shape[1]
    c_deltas = (ctypes.c_float * L)(*[float(d) for d in deltas])
    c_skips = (ctypes.c_int * L)(*[int(bool(s)) for s in skips])
    scale_ptrs = ([None] * 5 if scales is None
                  else [t.data_ptr() for t in scales])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), nbr_nodes.data_ptr(), in_degree.data_ptr(), N, W,
             wi.data_ptr(), wj.data_ptr(), b_pre.data_ptr(), k0.data_ptr(),
             ks.data_ptr(), b_post.data_ptr(), w_lin.data_ptr(),
             b_lin.data_ptr(), L, c_deltas, c_skips, STACK_ACTS[act],
             MODES[mode], *scale_ptrs, out.data_ptr(), stream,
             x.device.index or 0)
    if err != 0:
        raise RuntimeError(f"pna_block_stack launch failed: cudaError {err}")
    fused_pna_block_stack.launches += 1
    fused_pna_block_stack.mode_launches[mode] += 1
    return out


def fused_pna_block_stack(x, nbr_nodes, in_degree, wi, wj, b_pre, k0, ks,
                          b_post, w_lin, b_lin, deltas: Sequence[float],
                          skips: Sequence[bool], act: Optional[str] = None,
                          block_size: int = 128, mode: str = "f32",
                          scales=None):
    """Run the whole L-layer PNA stack.

    x [N, F] float32; nbr_nodes [N, W] int32, every neighbour inside its
    row's ``block_size``-row block (block packing); in_degree [N] int32;
    wi, wj, k0, w_lin [L, F, F]; ks [L, 4F, 3F] (float32, bfloat16 or
    int8 by ``mode``); b_pre, b_post, b_lin [L, F] float32; ``scales``
    (mode "int8" only) the five stacks' per-column scales, [L, F] and for
    ks [L, 3F].  A CUDA ``x`` launches the kernel, which takes F = 128
    and 128-row blocks and raises on anything else; a CPU ``x`` runs the
    plain version.  Returns h [N, F] float32."""
    mats = (wi, wj, k0, ks, w_lin)
    biases = (b_pre, b_post, b_lin)
    _check(x, nbr_nodes, in_degree, mats, biases, deltas, skips, act,
           block_size, mode, scales)
    if x.device.type == "cuda":
        return _launch(x, nbr_nodes, in_degree, mats, biases, deltas, skips,
                       act, block_size, mode, scales)
    if x.device.type != "cpu":
        raise ValueError(f"no PNA stack for device {x.device}")
    return pna_block_stack_plain(x, nbr_nodes, in_degree, wi, wj, b_pre, k0,
                                 ks, b_post, w_lin, b_lin, deltas, skips,
                                 act, mode, scales)


fused_pna_block_stack.launches = 0
fused_pna_block_stack.mode_launches = dict.fromkeys(MODES, 0)


def _pad2(a, rows, cols):
    return torch.nn.functional.pad(a, (0, cols - a.shape[1],
                                       0, rows - a.shape[0]))


def _pad1(a, n):
    return torch.nn.functional.pad(a, (0, n - a.shape[0]))


def stack_params(layers, F_p: int):
    """Per-layer (w_pre, b_pre, k_post, b_post, w_lin, b_lin), in the JAX
    package's [in, out] layout and any (Fin, F, Fout) per layer, into
    uniform zero-padded stacked operands (wi, wj, b_pre, k0, ks, b_post,
    w_lin, b_lin).  Pad lanes are inert: padded weight ROWS are zero, so
    whatever pad lanes of h carry adds nothing to real lanes, and pad
    output columns are sliced off by the caller."""
    out = [[] for _ in range(8)]
    for w_pre, b_pre, k_post, b_post, w_lin, b_lin in layers:
        Fin = w_pre.shape[0] // 2
        F = w_pre.shape[1]
        out[0].append(_pad2(w_pre[:Fin], F_p, F_p))
        out[1].append(_pad2(w_pre[Fin:], F_p, F_p))
        out[2].append(_pad1(b_pre, F_p))
        out[3].append(_pad2(k_post[:Fin], F_p, F_p))
        groups = []
        for i in range(3):
            lo = Fin + i * 4 * F
            blk = torch.cat(
                [_pad2(k_post[lo + j * F: lo + (j + 1) * F], F_p,
                       k_post.shape[1]) for j in range(4)], dim=0)
            groups.append(_pad2(blk, 4 * F_p, F_p))
        out[4].append(torch.cat(groups, dim=1))             # [4F_p, 3F_p]
        out[5].append(_pad1(b_post, F_p))
        out[6].append(_pad2(w_lin, F_p, F_p))
        out[7].append(_pad1(b_lin, F_p))
    return tuple(torch.stack(xs).contiguous() for xs in out)


def prepare_stack(stacked, mode: str):
    """``stack_params``' operands as ``mode`` takes them: (the eight
    operands, the five scales or None).  "bf16" rounds the five weight
    stacks to bfloat16; "int8" quantizes each layer of each stack with
    per-column scales (``ops.quant.quantize_weight``) on the padded,
    regrouped matrices, as the JAX wrapper does.  Biases stay float32."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    wi, wj, b_pre, k0, ks, b_post, w_lin, b_lin = stacked
    mats = (wi, wj, k0, ks, w_lin)
    scales = None
    if mode == "bf16":
        mats = tuple(m.to(torch.bfloat16) for m in mats)
    elif mode == "int8":
        qs = [[quantize_weight(m[l]) for l in range(m.shape[0])]
              for m in mats]
        mats = tuple(torch.stack([q for q, _ in ql]) for ql in qs)
        scales = tuple(torch.stack([s for _, s in ql]) for ql in qs)
    wi, wj, k0, ks, w_lin = mats
    return (wi, wj, b_pre, k0, ks, b_post, w_lin, b_lin), scales


def pna_block_stack_auto(x, nbr_nodes, in_degree, stacked, deltas, skips,
                         act=None, out_dim: Optional[int] = None,
                         block_size: int = 128, mode: str = "f32",
                         scales=None):
    """``fused_pna_block_stack`` on ``x`` of any width <= F: zero-pads x to
    the stacked width F and returns the first ``out_dim`` columns.
    ``stacked`` and ``scales`` as ``prepare_stack`` gives them for
    ``mode``."""
    F_p = stacked[0].shape[2]
    xp = torch.nn.functional.pad(x, (0, F_p - x.shape[1])).contiguous()
    out = fused_pna_block_stack(xp, nbr_nodes, in_degree, *stacked,
                                deltas=deltas, skips=skips, act=act,
                                block_size=block_size, mode=mode,
                                scales=scales)
    return out if out_dim is None else out[:, :out_dim]

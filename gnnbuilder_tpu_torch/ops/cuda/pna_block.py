"""Whole PNA conv stack in one kernel, on block-packed batches.

``fused_pna_block_stack`` launches ``csrc/pna_block.cu`` for CUDA tensors
and runs ``pna_block_stack_plain``, the same function in plain torch, for
CPU tensors.  It replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/pna_block.py`` ``fused_pna_block_stack``.

What bounds it on the H100: operations (2*(4F^2 + 12F^2) flops per row
per layer against ~2 KB of row traffic).  The kernel keeps each 128-row
block's hidden state in shared memory for all layers and runs the
products on the tensor cores (split TF32 in three passes for "f32", bf16
and int8 for the modes), with the weights streamed into shared memory
once per block and layer; see the source for the layout.

The kernel reads the weights in its own layout (``stage_stack``): each
layer's five matrices in the order it multiplies them, each cut into
k-steps in the order of the tensor cores' B fragments.  ``Program``'s
model caches it per mode beside its other kernel operands; a direct call
without ``staged`` lays the weights out on the call.

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
           "stage_stack", "unstage_stack", "split_tf32", "STACK_ACTS",
           "STACK_WIDTH", "BLOCK_ROWS", "MODES"]

# epilogue activations the kernel takes, with their codes in the source
STACK_ACTS = {None: 0, "relu": 1, "gelu": 2, "sigmoid": 3, "tanh": 4}
# the kernel's feature width (``csrc/pna_block.cu`` F): a stack whose
# widths pad to more runs per layer (``GNNModel._fused_gnn_stack``)
STACK_WIDTH = 128
# the rows of one block the kernel takes (``csrc/pna_block.cu``
# ``gnnb_pna_block_rows``), for the gate, which loads no library: a batch
# packed at another block size runs per layer (``dispatch.pna_stack_cfg``)
BLOCK_ROWS = 128
# kernel modes, with their codes in the source, and the weights' type
MODES = {"f32": 0, "bf16": 1, "int8": 2}
_WEIGHT_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "int8": torch.int8}
_MATS = ("wi", "wj", "k0", "ks", "w_lin")
# weight values per 32-bit register of the mode's tensor-core fragments
_PER_REG = {"f32": 1, "bf16": 2, "int8": 4}


def _act(name):
    return (lambda t: t) if name is None else ACTIVATIONS[name]


def _f32_dot(a, w):
    """The f32 mode's product in the plain version."""
    return a @ w


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
            return _f32_dot(a, w)
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


def split_tf32(a):
    """(hi, lo): hi = ``a`` rounded to TF32 (10 mantissa bits, to nearest,
    ties away from zero: ``cvt.rna.tf32.f32``), lo = the TF32 rounding of
    a - hi.  The f32 mode's products are hi*hi + hi*lo + lo*hi of their
    operands summed in f32: ``stage_stack`` splits the weights with this,
    the kernel its activations with the same rounding (and the tests
    emulate the products with it).

    Why three passes: over the canonical six layers at F = 128
    (``tests/test_torch_pna_block_tc.py``, emulated on the CPU), one TF32
    pass hi*hi lands 1.0e-3 abs (9.6e-4 of max |value|) from the JAX
    kernel's precision=HIGHEST products, outside the stack's atol 5e-4 /
    rtol 1e-3; the three passes land 1.1e-6 abs (1.05e-6 of max)."""
    bits = a.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lbits = (a - hi).contiguous().view(torch.int32)
    lo = ((lbits + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, lo


def _fragment_index(K: int, N: int, per_reg: int):
    """Flat indices (k * N + n) of a [K, N] matrix in the kernel's order:
    k-steps of 8 * per_reg rows; in each, pairs of n8 tiles; per pair, the
    32 lanes (g = lane // 4 the column in the tile, t = lane % 4); per
    lane, the two tiles' two B registers of per_reg values each (128
    values a pair).  Lane t's registers hold k = 2 per_reg t .. 2 per_reg
    t + 2 per_reg - 1 of the step, the k its A fragments read
    (csrc/pna_block.cu ``product``)."""
    E = per_reg
    shape = lambda *d: torch.arange(d[0]).view(*d[1:])
    ks = shape(K // (8 * E), -1, 1, 1, 1, 1, 1)
    pair = shape(N // 16, 1, -1, 1, 1, 1, 1)
    lane = shape(32, 1, 1, -1, 1, 1, 1)
    tile = shape(2, 1, 1, 1, -1, 1, 1)
    reg = shape(2, 1, 1, 1, 1, -1, 1)
    e = shape(E, 1, 1, 1, 1, 1, -1)
    k = ks * 8 * E + 2 * E * (lane % 4) + E * reg + e
    n = 8 * (2 * pair + tile) + lane // 4
    return (k * N + n).reshape(-1)


def _ks_rows(mode: str, F: int):
    """The order of Ks's rows in the stream: in "f32" and "bf16" the
    kernel forms the aggregate in chunks of 64 columns, chunk j holding
    aggregates p = 0..3 (max, min, mean, std) of features 16 j .. 16 j +
    15; int8 quantizes the whole aggregate in its natural order."""
    kk = torch.arange(4 * F)
    if mode == "int8":
        return kk
    return (kk % 64) // 16 * F + kk // 64 * 16 + kk % 16


def _stream_order(mode: str, L: int, F: int):
    """(index, half): the positions of the stream ``stage_stack`` makes, as
    indices into the five stacks' values concatenated flat (wi, wj, k0,
    ks, w_lin), and for "f32" the TF32 half each holds (0 hi, 1 lo: a
    pair of n8 tiles' 128 hi values, then its 128 lo values).  Per layer:
    Wj, K0, Wi, the three F-column blocks of Ks (rows in ``_ks_rows``
    order) and Wlin, each in ``_fragment_index`` order."""
    E = _PER_REG[mode]
    sizes = [F * F, F * F, F * F, 12 * F * F, F * F]
    offs = [L * sum(sizes[:i]) for i in range(5)]
    sq = _fragment_index(F, F, E)
    tall = _fragment_index(4 * F, F, E)
    rows = _ks_rows(mode, F)[tall // F] * 3 * F + tall % F
    parts = []
    for l in range(L):
        parts += [offs[m] + l * F * F + sq for m in (1, 2, 0)]
        parts += [offs[3] + l * 12 * F * F + rows + s * F for s in range(3)]
        parts.append(offs[4] + l * F * F + sq)
    index = torch.cat(parts)
    if mode != "f32":
        return index, torch.zeros_like(index)
    pairs = index.numel() // 128
    index = index.view(pairs, 1, 128).expand(pairs, 2, 128).reshape(-1)
    half = torch.arange(2).view(1, 2, 1).expand(pairs, 2, 128).reshape(-1)
    return index, half


def stage_stack(stacked, mode: str):
    """The five weight stacks of ``stacked`` (as ``prepare_stack`` gives
    them for ``mode``) in the layout the kernel streams
    (``_stream_order``): one flat tensor of the weights' type, 16 F^2
    values a layer, in "f32" 32 F^2 (each weight's ``split_tf32``
    halves)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    wi, wj, _, k0, ks, _, w_lin, _ = stacked
    L, F = wi.shape[0], wi.shape[2]
    index, half = (t.to(wi.device) for t in _stream_order(mode, L, F))
    flat = torch.cat([m.reshape(-1) for m in (wi, wj, k0, ks, w_lin)])
    if mode == "f32":
        return torch.stack(split_tf32(flat))[half, index]
    return flat[index]


def unstage_stack(staged, mode: str, L: int, F: int):
    """(wi, wj, k0, ks, w_lin) back from ``stage_stack``'s layout; in "f32"
    each with a leading dimension of 2, its TF32 halves (hi, lo)."""
    index, half = (t.to(staged.device) for t in _stream_order(mode, L, F))
    shapes = [(L, F, F), (L, F, F), (L, F, F), (L, 4 * F, 3 * F), (L, F, F)]
    sizes = [a * b * c for a, b, c in shapes]
    flat = staged.new_empty((2 if mode == "f32" else 1, sum(sizes)))
    flat[half, index] = staged
    out, o = [], 0
    for n, sh in zip(sizes, shapes):
        m = flat[:, o:o + n].reshape(-1, *sh)
        out.append(m if mode == "f32" else m[0])
        o += n
    return tuple(out)


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
            block_size, mode, scales, staged):
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
    wi, wj, k0, ks, w_lin = mats
    b_pre, b_post, b_lin = biases
    if staged is None:
        staged = stage_stack((wi, wj, b_pre, k0, ks, b_post, w_lin, b_lin),
                             mode)
    n = L * 16 * F * F * (2 if mode == "f32" else 1)
    if (tuple(staged.shape) != (n,) or staged.dtype != _WEIGHT_DTYPE[mode]
            or staged.device != x.device):
        raise ValueError(f"staged must be stage_stack's layout of the "
                         f"weights: ({n},) {_WEIGHT_DTYPE[mode]} on "
                         f"{x.device}")
    tensors = (x, nbr_nodes, in_degree, staged, *biases, *(scales or ()))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")
    fn = lib.gnnb_pna_block_stack
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
        + [ctypes.c_int, ctypes.POINTER(ctypes.c_float),
           ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 5
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    )
    out = torch.empty_like(x)
    W = nbr_nodes.shape[1]
    c_deltas = (ctypes.c_float * L)(*[float(d) for d in deltas])
    c_skips = (ctypes.c_int * L)(*[int(bool(s)) for s in skips])
    scale_ptrs = ([None] * 5 if scales is None
                  else [t.data_ptr() for t in scales])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), nbr_nodes.data_ptr(), in_degree.data_ptr(), N, W,
             staged.data_ptr(), b_pre.data_ptr(), b_post.data_ptr(),
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
                          scales=None, staged=None):
    """Run the whole L-layer PNA stack.

    x [N, F] float32; nbr_nodes [N, W] int32, every neighbour inside its
    row's ``block_size``-row block (block packing); in_degree [N] int32;
    wi, wj, k0, w_lin [L, F, F]; ks [L, 4F, 3F] (float32, bfloat16 or
    int8 by ``mode``); b_pre, b_post, b_lin [L, F] float32; ``scales``
    (mode "int8" only) the five stacks' per-column scales, [L, F] and for
    ks [L, 3F].  A CUDA ``x`` launches the kernel, which takes F = 128
    and 128-row blocks and raises on anything else; a CPU ``x`` runs the
    plain version.  ``staged``: ``stage_stack``'s layout of the same
    weights, which the kernel reads (made on the call when None; unused
    on the CPU).  Returns h [N, F] float32."""
    mats = (wi, wj, k0, ks, w_lin)
    biases = (b_pre, b_post, b_lin)
    _check(x, nbr_nodes, in_degree, mats, biases, deltas, skips, act,
           block_size, mode, scales)
    if x.device.type == "cuda":
        return _launch(x, nbr_nodes, in_degree, mats, biases, deltas, skips,
                       act, block_size, mode, scales, staged)
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
                         scales=None, staged=None):
    """``fused_pna_block_stack`` on ``x`` of any width <= F: zero-pads x to
    the stacked width F and returns the first ``out_dim`` columns.
    ``stacked`` and ``scales`` as ``prepare_stack`` gives them for
    ``mode``, ``staged`` as ``stage_stack`` gives it."""
    F_p = stacked[0].shape[2]
    xp = torch.nn.functional.pad(x, (0, F_p - x.shape[1])).contiguous()
    out = fused_pna_block_stack(xp, nbr_nodes, in_degree, *stacked,
                                deltas=deltas, skips=skips, act=act,
                                block_size=block_size, mode=mode,
                                scales=scales, staged=staged)
    return out if out_dim is None else out[:, :out_dim]

"""One PNA layer, the training forward: ``fused_pna_layer`` with its
residuals, its hand-written backward (``PNALayerFunction``) and the
zero-padding entry ``fused_pna_layer_auto``.

``fused_pna_layer`` launches ``csrc/pna_layer.cu`` for CUDA tensors and
runs ``pna_layer_plain``, the same function in plain torch, for CPU
tensors.  It replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/pna_layer.py`` ``fused_pna_layer``; the
backward follows that file's ``_make_vjp_fn`` line for line, with the
epilogue's large products left to ``torch.matmul``, as the JAX package
leaves them to XLA.  Its dv takes the JAX VJP's reverse-table route when
the batch carries ``rev_nbr_nodes`` / ``out_degree``: the coefficient
stack from ``ops.cuda.scatter_bwd.fused_pna_scatter_cstk``, gathered by
``ops.cuda.ell_bwd.fused_gather_backward``, so the step's gradients are
the same bits on every run.  A batch without a reverse table (an
out-degree over 64, or ``rev_ell_width=0``) takes
``fused_pna_scatter_backward``: the same coefficient stack, gathered over
the reverse CSR built from the forward table, the same bits too.

What bounds the kernel on the H100: operations (the five products, ~0.5
MFLOP per row at 128 wide); they run on the tensor cores (split TF32 in
three passes for "f32", bf16, s8 for the int8 mode's final Linear; v = x
Wj in float64, rounded once, so its max / min ties are those of the
correctly rounded product: in "bf16" of the bf16-rounded operands, then
rounded to bf16); see the source for the design.

Weights use the JAX package's [in, out] layout: ``w_pre`` [2Fin, F]
(receiver rows first), ``k_post`` [Fin + 12F, Fout] (self rows, then the
identity, amplification and attenuation groups of max|min|mean|std
blocks), ``w_lin`` [Fout, Fout].  The kernel reads them in its own layout
(``stage_layer``): Wj (whole, "f32" and "int8"), the x products ([Wi |
K0], "bf16" [Wj | Wi | K0]), Ks and w_lin, each cut into k-steps in the
order of the tensor cores' B fragments.  A call
without ``staged`` lays the weights out on the device; ``GNNModel``
makes each layer's operands (``layer_operands``: the padded weights and
their layout) for all its layers at once, on every train step from the
live weights and once per mode for inference, where it caches them.

Modes (``mode``; the JAX kernel's ``mm``, ``gather_mode`` and
``quant``): "bf16", whose three weights are bfloat16 and whose products
round their operands (and the gathered v) to bf16 and sum in float32;
"int8", which quantizes the final Linear only (``w_lin`` int8 with
per-column scales ``s_lin``, mid's rows quantized, an exact sum), as the
JAX kernel does.  Every mode writes the residuals with ``save_res`` (v is
the mode's: bf16-rounded in "bf16", so the backward's tie tests compare
the values the forward compared, as the JAX backward's
``fwd_gather_mode``), and ``PNALayerFunction`` takes a mode: the kernel
forward in it, the f32 backward on its residuals with the float32
weights (the JAX custom VJP's; for "int8" a straight-through estimator
through the float32 ``w_lin``).  Its plain twin (``plain=True``, or the
model under ``dispatch.plain_twins``) runs the plain forward in the mode
and the same backward with the plain versions of rows 6 and 7.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.cuda.ell_bwd import (
    ell_gather_backward_plain,
    fused_gather_backward,
)
from gnnbuilder_tpu_torch.ops.cuda.gat_layer import _region_order
from gnnbuilder_tpu_torch.ops.cuda.pna_block import (
    _fragment_index,
    split_tf32,
)
from gnnbuilder_tpu_torch.ops.cuda.scatter_bwd import (
    fused_pna_scatter_backward,
    fused_pna_scatter_cstk,
    pna_scatter_backward_plain,
    pna_scatter_cstk_plain,
)
from gnnbuilder_tpu_torch.ops.ell import _STD_EPS, ell_mask
from gnnbuilder_tpu_torch.ops.quant import (
    qdot,
    quantize_weight,
    to_bf16,
    true_div,
)

__all__ = ["fused_pna_layer", "pna_layer_plain", "PNALayerFunction",
           "fused_pna_layer_vjp", "fused_pna_layer_auto", "pad_operands",
           "prepare_layer", "layer_operands", "stage_layer", "stage_layers",
           "unstage_layer", "agg_rows", "scaler_blocks", "LAYER_ACTS",
           "MODES"]

# epilogue activations the kernel takes, with their codes in the source
LAYER_ACTS = {None: 0, "relu": 1, "gelu": 2, "sigmoid": 3, "tanh": 4}
# kernel modes, with their codes in the source
MODES = {"f32": 0, "bf16": 1, "int8": 2}


def _weight_dtypes(mode):
    """The dtypes of (w_pre, k_post, w_lin) in ``mode``."""
    if mode == "bf16":
        return (torch.bfloat16,) * 3
    if mode == "int8":
        return torch.float32, torch.float32, torch.int8
    return (torch.float32,) * 3


def prepare_layer(w_pre, k_post, w_lin, mode: str):
    """(w_pre, k_post, w_lin, s_lin) as ``mode`` takes them: "bf16"
    rounds the three to bfloat16; "int8" quantizes w_lin with per-column
    scales s_lin (None in the other modes)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    if mode == "bf16":
        return (w_pre.to(torch.bfloat16), k_post.to(torch.bfloat16),
                w_lin.to(torch.bfloat16), None)
    if mode == "int8":
        q, sc = quantize_weight(w_lin)
        return w_pre, k_post, q, sc
    return w_pre, k_post, w_lin, None


# the TPU kernel's finite -inf: the extrema of an empty row in aux
_BIG = 3e38

# the kernel's geometry (csrc/pna_layer.cu): columns per region, k of one
# aggregate chunk, k depth of one mma of the aggregate's product and
# weight values per fragment register in each mode
_CB = 128
_CHK = 64
_AGG_KD = {"f32": 8, "bf16": 16}
_PER_REG = {"f32": 1, "bf16": 2, "int8": 4}


def _proj_plan(idx, mode: str):
    """(src, half) of a projection section: the [K, C] matrix of source
    indices ``idx`` in 128-column regions, each in the projection's tile
    order (``gat_layer._region_order``: per k-step the pairs of n8 tiles
    in B-fragment order, in "f32" a pair's hi values, then its lo)."""
    K, C = idx.shape
    index, half = _region_order(mode, K, _CB, False)
    regions = idx.view(K, C // _CB, _CB).permute(1, 0, 2).reshape(C // _CB,
                                                                  -1)
    return regions[:, index].reshape(-1), half.repeat(C // _CB)


def _ks_plan(post, Fin: int, F: int, Fout: int, mode: str):
    """(src, half) of the Ks section, ``post`` the [Fin + 12F, Fout]
    matrix of k_post's source indices: per column block of 128, per
    aggregate chunk j (64 k: aggregate p of feature 16 j + kk % 16 at
    chunk position kk = 16 p + kk % 16), per k-step of the chunk, per
    scaler s, that k-step's [kd, 128] block of the scaler's rows in
    B-fragment order (``pna_block._fragment_index``; in "f32" each pair's
    128 hi values, then its 128 lo values)."""
    kd, E = _AGG_KD[mode], _PER_REG[mode]
    fi = _fragment_index(kd, _CB, E)
    a = torch.arange
    cb = a(Fout // _CB).view(-1, 1, 1, 1, 1)
    j = a(4 * F // _CHK).view(1, -1, 1, 1, 1)
    e = a(_CHK // kd).view(1, 1, -1, 1, 1)
    s = a(3).view(1, 1, 1, -1, 1)
    kk = e * kd + (fi // _CB).view(1, 1, 1, 1, -1)
    row = Fin + s * 4 * F + kk // 16 * F + 16 * j + kk % 16
    src = post[row, cb * _CB + (fi % _CB).view(1, 1, 1, 1, -1)].reshape(-1)
    if mode != "f32":
        return src, torch.zeros_like(src)
    pairs = src.numel() // 128
    src = src.view(pairs, 1, 128).expand(pairs, 2, 128).reshape(-1)
    half = torch.arange(2).view(1, 2, 1).expand(pairs, 2, 128).reshape(-1)
    return src, half


# ``half`` of a stream position whose f32 value is the weight itself
_WHOLE = 2


@functools.lru_cache(maxsize=64)
def _stage_plan(Fin: int, F: int, Fout: int, mode: str,
                device: torch.device, trans=(False, False, False)):
    """The positions of ``stage_layer``'s stream on ``device``: [(src,
    half)] per source, each src indexing that source flattened, half 0 /
    1 the TF32 hi / lo of the value (``split_tf32``), ``_WHOLE`` the value
    itself.  In "f32" and "bf16" one source, [w_pre | k_post | w_lin]
    flat; in "int8" two: [w_pre | k_post] flat (f32) and w_lin (int8).
    ``trans[i]``: weight i comes as the transpose of a contiguous [out,
    in] tensor (a ``torch.nn.Linear`` weight's ``.t()``), flattened in that
    storage's order.  Sections: "f32" and "int8" Wj (whole, row-major: the
    v launch's FMAs read it), the x products [Wi | K0], Ks, w_lin; "bf16"
    the x products [Wj | Wi | K0], Ks, w_lin."""
    fmode = "bf16" if mode == "bf16" else "f32"

    def index(R, C, t, off):
        r, c = torch.arange(R).view(-1, 1), torch.arange(C).view(1, -1)
        return off + (c * R + r if t else r * C + c)

    o_k = 2 * Fin * F
    pre = index(2 * Fin, F, trans[0], 0)
    post = index(Fin + 12 * F, Fout, trans[1], o_k)
    lin = index(Fout, Fout, trans[2],
                0 if mode == "int8" else o_k + (Fin + 12 * F) * Fout)
    parts = []
    if mode == "bf16":
        xcat = torch.cat([pre[Fin:], pre[:Fin], post[:Fin]], 1)
    else:
        wj = pre[Fin:].reshape(-1)
        parts.append((wj, torch.full_like(wj, _WHOLE)))
        xcat = torch.cat([pre[:Fin], post[:Fin]], 1)
    parts += [_proj_plan(xcat, fmode), _ks_plan(post, Fin, F, Fout, fmode)]
    if mode == "int8":
        plans = [tuple(torch.cat(t) for t in zip(*parts)),
                 _proj_plan(lin, "int8")]
    else:
        parts.append(_proj_plan(lin, mode))
        plans = [tuple(torch.cat(t) for t in zip(*parts))]
    return [(src.to(device), half.to(device)) for src, half in plans]


def _flat(t):
    """(t flattened, whether in the order of t.t()): a view of a weight or
    of a transposed contiguous one (a Linear's weight.t()), no copy."""
    t = t.detach()
    if not t.is_contiguous() and t.t().is_contiguous():
        return t.t().reshape(-1), True
    return t.reshape(-1), False


@functools.lru_cache(maxsize=16)
def _layers_plan(key: tuple, mode: str, device: torch.device):
    """For ``stage_layers`` of layers keyed ((Fin, F, Fout, trans), ...):
    per source, (index into the layers' sources flat and concatenated,
    under "f32" halves [hi | lo | value] of them, bytes of each layer's
    part of the stream)."""
    plans = [_stage_plan(*k[:3], mode, torch.device("cpu"), k[3])
             for k in key]
    # each layer's sources' lengths: [w_pre | k_post | w_lin], or under
    # int8 [w_pre | k_post] and w_lin
    lens = [[2 * fi * f + (fi + 12 * f) * fo, fo * fo] for fi, f, fo, _ in key]
    if mode != "int8":
        lens = [[sum(n)] for n in lens]
    out = []
    for i in range(len(plans[0])):
        n = sum(m[i] for m in lens)
        f32 = mode != "bf16" and i == 0
        index, sizes, off = [], [], 0
        for p, m in zip(plans, lens):
            src, half = p[i]
            index.append(src + off + (half * n if f32 else 0))
            sizes.append(src.numel())
            off += m[i]
        item = 4 if f32 else (2 if mode == "bf16" else 1)
        out.append((torch.cat(index).to(device),
                    [size * item for size in sizes]))
    return out


def stage_layers(layers, mode: str):
    """``stage_layer`` of several layers (w_pre, k_post, w_lin) of any
    widths that are multiples of 128 (``_pad_weights``), in one cat, one
    split and one gather per source for all of them: what a train step
    lays out from its live weights on every call.  Weights that are
    transposed views of contiguous tensors are read in place.  Returns one
    uint8 tensor per layer."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    flats, key = [], []
    for w_pre, k_post, w_lin in layers:
        fl = [_flat(t) for t in (w_pre, k_post, w_lin)]
        flats.append([f for f, _ in fl])
        key.append((w_pre.shape[0] // 2, w_pre.shape[1], w_lin.shape[1],
                    tuple(t for _, t in fl)))
    plans = _layers_plan(tuple(key), mode, layers[0][0].device)
    groups = [[f for fl in flats for f in fl]]
    if mode == "int8":
        groups = [[f for fl in flats for f in fl[:2]],
                  [fl[2] for fl in flats]]
    parts = []
    for group, (index, sizes) in zip(groups, plans):
        src = torch.cat(group)
        if src.dtype == torch.float32:
            src = torch.cat([*split_tf32(src), src])
        parts.append(src[index].view(torch.uint8).split(sizes))
    if len(parts) == 1:
        return list(parts[0])
    return [torch.cat(p) for p in zip(*parts)]


def stage_layer(w_pre, k_post, w_lin, mode: str):
    """``w_pre``, ``k_post`` and ``w_lin`` (padded, of ``mode``'s types as
    ``prepare_layer`` gives them) in the layout the kernel streams: one
    flat uint8 tensor of sections (``_stage_plan``), the x products and
    w_lin in the projection's regions (``_proj_plan``), Ks in the
    aggregate's chunks (``_ks_plan``); "f32" (and the first sections of
    "int8") as each weight's ``split_tf32`` halves, but for Wj, which the
    v launch reads whole.  Made on the weights' device
    (``stage_layers``)."""
    return stage_layers([(w_pre, k_post, w_lin)], mode)[0]


def unstage_layer(staged, Fin: int, F: int, Fout: int, mode: str):
    """``stage_layer``'s weights back: (w_pre, k_post, w_lin); those it
    holds as TF32 halves ("f32", and w_pre and k_post of "int8") with a
    leading dimension of 2 (hi, lo), where w_pre's Wj rows, held whole,
    are (value, 0)."""
    plans = _stage_plan(Fin, F, Fout, mode, staged.device)
    dts = _weight_dtypes(mode)
    sizes = [2 * Fin * F, (Fin + 12 * F) * Fout, Fout * Fout]
    srcs = ([dts[0]] if mode != "int8" else [torch.float32, torch.int8])
    out, o = [], 0
    for dt, (src, half) in zip(srcs, plans):
        n = src.numel() * torch.empty((), dtype=dt).element_size()
        vals = staged[o:o + n].view(dt)
        o += n
        flat = vals.new_zeros((3 if dt == torch.float32 else 1,
                               int(src.max()) + 1))
        flat[half, src] = vals
        if dt == torch.float32:        # positions held whole hold no halves
            flat = torch.stack([flat[0] + flat[_WHOLE], flat[1]])
        out.append(flat if dt == torch.float32 else flat[0])
    if mode == "int8":
        first, lin = out
        parts = [first[:, :sizes[0]], first[:, sizes[0]:], lin]
    else:
        f = out[0]
        parts = [f[..., :sizes[0]], f[..., sizes[0]:sizes[0] + sizes[1]],
                 f[..., sizes[0] + sizes[1]:]]
    shapes = [(2 * Fin, F), (Fin + 12 * F, Fout), (Fout, Fout)]
    return tuple(t.reshape(*t.shape[:-1], *sh)
                 for t, sh in zip(parts, shapes))


def _act(name):
    return (lambda t: t) if name is None else ACTIVATIONS[name]


def scaler_blocks(k_post, Fin, F):
    """The scaler blocks of k_post side by side: [4F, 3Fout]."""
    return torch.cat([k_post[Fin + i * 4 * F: Fin + (i + 1) * 4 * F]
                      for i in range(3)], dim=1)


def _f32_dot(a, w):
    """The f32 mode's product in the plain version (v's aside)."""
    return a @ w


def pna_layer_plain(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post,
                    w_lin, b_lin, delta, skip=None, act=None,
                    save_res=False, mode: str = "f32", s_lin=None):
    """The layer in plain torch, with the kernel's arithmetic: u comes
    outside the reduce and the extrema start from -+3e38.  ``mode`` and
    ``s_lin`` as for ``fused_pna_layer``."""
    Fin = x.shape[1]
    F = w_pre.shape[1]
    Fout = w_lin.shape[1]

    def dot(a, w):
        if mode == "bf16":
            return to_bf16(a) @ w.float()
        return _f32_dot(a, w)

    u = dot(x, w_pre[:Fin]) + b_pre
    # correctly rounded, as the kernel's float64 FMAs give it (bf16: of
    # the bf16-rounded x, then rounded to bf16), so the max / min ties
    # are the kernel's
    xv = to_bf16(x) if mode == "bf16" else x
    v = (xv.double() @ w_pre[Fin:].double()).to(x.dtype)
    if mode == "bf16":
        v = to_bf16(v)
    m = ell_mask(nbr_nodes, in_degree)[..., None]
    g = v[nbr_nodes.long()]                               # [N, W, F]
    zero = x.new_zeros(())
    s = torch.where(m, g, zero).sum(1)
    sq = torch.where(m, g * g, zero).sum(1)
    mx = torch.where(m, g, -_BIG).amax(1)
    mn = torch.where(m, g, _BIG).amin(1)
    degf = in_degree.to(x.dtype)[:, None]
    denom = degf.clamp(min=1.0)
    nonempty = degf > 0
    mean = s / denom
    var = torch.relu(sq / denom - mean * mean)
    agg_cat = torch.cat([
        torch.where(nonempty, u + mx, zero),
        torch.where(nonempty, u + mn, zero),
        torch.where(nonempty, u + mean, zero),
        torch.sqrt(var + _STD_EPS),
    ], dim=1)
    y = dot(agg_cat, scaler_blocks(k_post, Fin, F))
    log_deg = torch.log(denom + 1.0)
    mid = (dot(x, k_post[:Fin]) + b_post + y[:, :Fout]
           + true_div(log_deg, delta) * y[:, Fout:2 * Fout]
           + true_div(delta, log_deg) * y[:, 2 * Fout:])
    o = (qdot(mid, w_lin, s_lin) if mode == "int8" else dot(mid, w_lin)) \
        + b_lin
    if skip is not None:
        o = o + skip
    out = _act(act)(o)
    if not save_res:
        return out
    ties_mx = (m & (g == mx[:, None, :])).sum(1).to(x.dtype)
    ties_mn = (m & (g == mn[:, None, :])).sum(1).to(x.dtype)
    aux = torch.cat([mx, mn, mean, ties_mx, ties_mn], dim=1)
    return out, v, agg_cat, aux, mid


def agg_rows(n_rows: int, mode: str, device) -> int:
    """Rows per CTA of the kernel's aggregate launch for ``n_rows`` rows
    in ``mode`` on the CUDA ``device`` (chosen so that the rows fill whole
    waves of the card; csrc/pna_layer.cu ``agg_rows``)."""
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    am = load().gnnb_pna_layer_agg_rows(int(n_rows), MODES[mode],
                                        torch.device(device).index or 0)
    if am < 0:
        raise RuntimeError(f"pna_layer agg_rows failed: cudaError {-am}")
    return am


def _check(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post, w_lin,
           b_lin, skip, act, mode, s_lin, save_res):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, Fin] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    N, Fin = x.shape
    F = w_pre.shape[1]
    Fout = w_lin.shape[1]
    f32 = torch.float32
    dt_pre, dt_post, dt_lin = _weight_dtypes(mode)
    shapes = {"w_pre": (w_pre, (2 * Fin, F), dt_pre),
              "b_pre": (b_pre, (F,), f32),
              "k_post": (k_post, (Fin + 12 * F, Fout), dt_post),
              "b_post": (b_post, (Fout,), f32),
              "w_lin": (w_lin, (Fout, Fout), dt_lin),
              "b_lin": (b_lin, (Fout,), f32)}
    if skip is not None:
        shapes["skip"] = (skip, (N, Fout), f32)
    if mode == "int8":
        shapes["s_lin"] = (s_lin, (Fout,), f32)
    elif s_lin is not None:
        raise ValueError(f"mode {mode!r} takes no s_lin")
    for name, (t, shape, dt) in shapes.items():
        if t is None or tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name} must be {shape} {dt} in mode "
                             f"{mode!r}, got "
                             f"{None if t is None else tuple(t.shape)} "
                             f"{None if t is None else t.dtype}")
    if nbr_nodes.dim() != 2 or nbr_nodes.shape[0] != N:
        raise ValueError("nbr_nodes must be [N, W]")
    if tuple(in_degree.shape) != (N,):
        raise ValueError("in_degree must be [N]")
    if act not in LAYER_ACTS:
        raise ValueError(f"unsupported layer activation {act!r}")
    tensors = [x, nbr_nodes, in_degree] + [t for t, _, _ in shapes.values()]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post, w_lin,
            b_lin, delta, skip, act, save_res, mode, s_lin, staged):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, Fin = x.shape
    F = w_pre.shape[1]
    Fout = w_lin.shape[1]
    dev = x.device
    mult = lib.gnnb_pna_layer_width_multiple()
    smem = lib.gnnb_pna_layer_smem_bytes(Fin, F, Fout, MODES[mode])
    smem_max = lib.gnnb_smem_per_block_optin(dev.index or 0)
    if any(d % mult or d < mult for d in (Fin, F, Fout)) or smem > smem_max:
        raise ValueError(
            f"the CUDA PNA layer takes widths that are multiples of {mult} "
            f"within {smem_max} bytes of shared memory; got Fin={Fin} F={F} "
            f"Fout={Fout} ({smem} bytes)")
    if nbr_nodes.dtype != torch.int32 or in_degree.dtype != torch.int32:
        raise ValueError("nbr_nodes and in_degree must be int32")
    if staged is None:
        staged = stage_layer(w_pre, k_post, w_lin, mode)
    if mode == "bf16":    # the v launch reads its Wj rows row-major
        w_pre = w_pre.contiguous()
    ll = ctypes.c_longlong
    lib.gnnb_pna_layer_staged_bytes.restype = ll
    lib.gnnb_pna_layer_work_bytes.restype = ll
    n_staged = lib.gnnb_pna_layer_staged_bytes(Fin, F, Fout, MODES[mode])
    if (tuple(staged.shape) != (n_staged,) or staged.dtype != torch.uint8
            or staged.device != dev):
        raise ValueError(f"staged must be stage_layer's layout of the "
                         f"weights: ({n_staged},) uint8 on {dev}")
    tensors = [x, nbr_nodes, in_degree, b_pre, b_post, b_lin, staged] + [
        t for t in (skip, s_lin) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")
    fn = lib.gnnb_pna_layer
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 3 + [I] * 5 + [P] * 7
                   + [ctypes.c_float, I, I, P] + [P] * 5 + [P, I, P, ll, P])
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((N, Fout), **f32)
    v = torch.empty((N, F), **f32)
    res = ((torch.empty((N, 4 * F), **f32), torch.empty((N, 5 * F), **f32),
            torch.empty((N, Fout), **f32)) if save_res else (None,) * 3)
    work = torch.empty(
        (lib.gnnb_pna_layer_work_bytes(N, F, Fout, MODES[mode],
                                       int(save_res)),),
        dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(x.data_ptr(), nbr_nodes.data_ptr(), in_degree.data_ptr(), N,
             nbr_nodes.shape[1], Fin, F, Fout, w_pre.data_ptr(),
             b_pre.data_ptr(), k_post.data_ptr(), b_post.data_ptr(),
             w_lin.data_ptr(), b_lin.data_ptr(), ptr(skip), float(delta),
             LAYER_ACTS[act], MODES[mode], ptr(s_lin), out.data_ptr(),
             v.data_ptr(), *[ptr(t) for t in res], stream, dev.index or 0,
             staged.data_ptr(), n_staged, ptr(work))
    if err != 0:
        raise RuntimeError(f"pna_layer launch failed: cudaError {err}")
    fused_pna_layer.launches += 1
    fused_pna_layer.mode_launches[mode] += 1
    return (out, v, *res) if save_res else out


def fused_pna_layer(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post,
                    w_lin, b_lin, delta: float, skip=None,
                    act: Optional[str] = None, save_res: bool = False,
                    mode: str = "f32", s_lin=None, staged=None):
    """One PNA layer.  x [N, Fin] float32; nbr_nodes [N, W] and in_degree
    [N] int32; weights as in the module docstring, typed by ``mode``
    (``prepare_layer``); skip [N, Fout] or None, added before ``act``.
    Returns out [N, Fout], or with ``save_res`` the tuple (out, v [N, F],
    agg_cat [N, 4F], aux [N, 5F], mid [N, Fout]), v as the mode gathers
    it, out the same bits as without (the residuals are stores only).  A
    CUDA ``x`` launches the kernel, which takes widths that are multiples
    of 128 and raises on others; a CPU ``x`` runs the plain version.
    ``staged``: ``stage_layer``'s layout of the same weights, which the
    kernel reads (made on the call when None; unused on the CPU)."""
    _check(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post, w_lin,
           b_lin, skip, act, mode, s_lin, save_res)
    if x.device.type == "cuda":
        return _launch(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post,
                       w_lin, b_lin, delta, skip, act, save_res, mode, s_lin,
                       staged)
    if x.device.type != "cpu":
        raise ValueError(f"no PNA layer for device {x.device}")
    return pna_layer_plain(x, nbr_nodes, in_degree, w_pre, b_pre, k_post,
                           b_post, w_lin, b_lin, delta, skip, act, save_res,
                           mode, s_lin)


fused_pna_layer.launches = 0
fused_pna_layer.mode_launches = dict.fromkeys(MODES, 0)


class PNALayerFunction(torch.autograd.Function):
    """``fused_pna_layer`` with the JAX package's hand-written backward
    (``pna_layer.py`` ``_make_vjp_fn``, its scatter-kernel branch): the
    forward saves (v, agg_cat, aux, mid, out); the backward forms act'
    from the saved out, the epilogue gradients from mid with torch
    products, du through ``sel``, dv over the reverse table
    (``fused_pna_scatter_cstk`` then ``fused_gather_backward``) or, when
    ``rev_nbr_nodes`` is None, over the reverse CSR
    (``fused_pna_scatter_backward``); then the pre_nn chains.

    ``mode``: the forward runs the kernel in it on ``mode_weights`` =
    ``prepare_layer`` of the float32 weights (w_pre, k_post, w_lin,
    s_lin), the backward is the one above with the float32 weights, as
    the JAX VJP's under ``mm`` / ``gather_mode`` / ``quant`` (int8: a
    straight-through estimator, the gradient through the float32 w_lin).
    ``plain``: the plain twin, ``pna_layer_plain`` forward and rows 6 and
    7's plain versions in the backward, whatever the device."""

    @staticmethod
    def forward(ctx, x, nbr_nodes, in_degree, rev_nbr_nodes, out_degree,
                skip, w_pre, b_pre, k_post, b_post, w_lin, b_lin, delta,
                act, staged=None, rev_csr=None, mode="f32",
                mode_weights=None, plain=False):
        args = [t.contiguous() for t in (x, w_pre, b_pre, k_post, b_post,
                                         w_lin, b_lin)]
        skip = None if skip is None else skip.contiguous()
        x, w_pre, b_pre, k_post, b_post, w_lin, b_lin = args
        wm = ((w_pre, k_post, w_lin, None) if mode_weights is None
              else mode_weights)
        run = pna_layer_plain if plain else functools.partial(
            fused_pna_layer, staged=staged)
        out, v, agg_cat, aux, mid = run(
            x, nbr_nodes, in_degree, wm[0], b_pre, wm[1], b_post, wm[2],
            b_lin, delta, skip=skip, act=act, save_res=True, mode=mode,
            s_lin=wm[3])
        ctx.save_for_backward(x, nbr_nodes, in_degree, rev_nbr_nodes,
                              out_degree, skip, w_pre, k_post, w_lin, b_lin,
                              v, agg_cat, aux, mid, out)
        ctx.delta = float(delta)
        ctx.act = act
        ctx.rev_csr = rev_csr
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, ct):
        (x, nbr, deg, rev, out_deg, skip, w_pre, k_post, w_lin, b_lin, v,
         agg_cat, aux, mid, out) = ctx.saved_tensors
        act, delta = ctx.act, ctx.delta
        Fin = x.shape[1]
        F = w_pre.shape[1]
        Fout = w_lin.shape[1]
        # act' exactly from the saved post-act out (gelu recomputes z)
        if act is None:
            dz = ct
        elif act == "relu":
            dz = ct * (out > 0.0).to(ct.dtype)
        elif act == "sigmoid":
            dz = ct * out * (1.0 - out)
        elif act == "tanh":
            dz = ct * (1.0 - out * out)
        else:
            with torch.enable_grad():
                z = mid @ w_lin + b_lin
                if skip is not None:
                    z = z + skip
                z = z.detach().requires_grad_()
                (dz,) = torch.autograd.grad(ACTIVATIONS[act](z), z, ct)
        dskip = dz if skip is not None else None
        db_lin = dz.sum(0)
        dw_lin = mid.t() @ dz
        d_mid = dz @ w_lin.t()
        db_post = d_mid.sum(0)
        k0 = k_post[:Fin]
        ks_t = scaler_blocks(k_post, Fin, F).t().contiguous()  # [3Fout, 4F]
        dx_epi = d_mid @ k0.t()
        dk0 = x.t() @ d_mid

        degf = deg.to(x.dtype)[:, None]
        denom = degf.clamp(min=1.0)
        nonempty = degf > 0
        log_deg = torch.log(denom + 1.0)
        dy = torch.cat([d_mid, (log_deg / delta) * d_mid,
                        (delta / log_deg) * d_mid], dim=1)   # [N, 3Fout]
        dks = agg_cat.t() @ dy                               # ks layout
        dk_post = torch.cat([dk0, dks[:, :Fout], dks[:, Fout:2 * Fout],
                             dks[:, 2 * Fout:]], dim=0)
        # du: the masked sum of the mx|mn|mean blocks of d_agg = dy ks_t
        sel = ks_t[:, :F] + ks_t[:, F:2 * F] + ks_t[:, 2 * F:3 * F]
        du = torch.where(nonempty, dy @ sel, x.new_zeros(()))
        if rev is not None:
            cstk_fn, gather = ((pna_scatter_cstk_plain,
                                ell_gather_backward_plain) if ctx.plain else
                               (fused_pna_scatter_cstk,
                                fused_gather_backward))
            cstk = cstk_fn(d_mid, aux, agg_cat, deg, ks_t, delta)
            dv = gather(cstk, rev, out_deg, v, has_lin=True, has_dev=True,
                        n_cmp=2)
        elif ctx.plain:
            dv = pna_scatter_backward_plain(d_mid, aux, agg_cat, deg, nbr, v,
                                            ks_t, delta)
        else:
            dv = fused_pna_scatter_backward(d_mid, aux, agg_cat, deg, nbr,
                                            v, ks_t, delta,
                                            rev_csr=ctx.rev_csr)

        # pre_nn chains: u = x w_i + b_pre (receiver), v = x w_j
        w_i, w_j = w_pre[:Fin], w_pre[Fin:]
        dx = dx_epi + du @ w_i.t() + dv @ w_j.t()
        dw_pre = torch.cat([x.t() @ du, x.t() @ dv], dim=0)
        db_pre = du.sum(0)
        return (dx, None, None, None, None, dskip, dw_pre, db_pre, dk_post,
                db_post, dw_lin, db_lin, None, None, None, None, None, None,
                None)


def fused_pna_layer_vjp(x, nbr_nodes, in_degree, w_pre, b_pre, k_post,
                        b_post, w_lin, b_lin, delta: float, skip=None,
                        act: Optional[str] = None, rev_nbr_nodes=None,
                        out_degree=None, staged=None, rev_csr=None,
                        mode: str = "f32", mode_weights=None,
                        plain: bool = False):
    """Differentiable ``fused_pna_layer``: the kernel forward with
    residuals and the hand-written backward, whose dv runs over the
    reverse table when both ``rev_nbr_nodes`` and ``out_degree`` are
    given, else over the reverse CSR (``rev_csr`` as
    ``fused_pna_scatter_backward`` takes it).  The weights are float32
    (the backward's); in ``mode`` the forward takes ``mode_weights`` =
    (w_pre, k_post, w_lin, s_lin) of the mode (``prepare_layer`` of the
    same weights: made here when None), with ``staged`` their layout.
    ``plain``: the plain twin (``PNALayerFunction``)."""
    if rev_nbr_nodes is None or out_degree is None:
        rev_nbr_nodes = out_degree = None
    if mode != "f32" and mode_weights is None:
        mode_weights = prepare_layer(*(t.detach().contiguous()
                                       for t in (w_pre, k_post, w_lin)),
                                     mode)
    return PNALayerFunction.apply(x, nbr_nodes, in_degree, rev_nbr_nodes,
                                  out_degree, skip, w_pre, b_pre, k_post,
                                  b_post, w_lin, b_lin, float(delta), act,
                                  staged, rev_csr, mode, mode_weights,
                                  bool(plain))


def _rup(n: int, m: int = 128) -> int:
    return ((n + m - 1) // m) * m


def _pad(a, rows=None, cols=None):
    """Zero-pad a 1-D tensor to ``rows`` or a 2-D one to [rows, cols]
    (``a`` itself when it has that shape)."""
    if a.dim() == 1:
        if a.shape[0] == rows:
            return a
        return torch.nn.functional.pad(a, (0, rows - a.shape[0]))
    if tuple(a.shape) == (rows, cols):
        return a
    return torch.nn.functional.pad(a, (0, cols - a.shape[1],
                                       0, rows - a.shape[0]))


def _pad_weights(w_pre, b_pre, k_post, b_post, w_lin, b_lin):
    """The six weights zero-padded to widths that are multiples of 128
    (differentiable ops, a few per weight); returned unchanged when they
    are."""
    Fin = w_pre.shape[0] // 2
    F = w_pre.shape[1]
    Fout = w_lin.shape[1]
    Fin_p, F_p, Fout_p = _rup(Fin), _rup(F), _rup(Fout)
    if (Fin_p, F_p, Fout_p) == (Fin, F, Fout):
        return w_pre, b_pre, k_post, b_post, w_lin, b_lin
    pad = torch.nn.functional.pad
    # w_pre's two halves and k_post's 12 scaler blocks padded at once
    w_pre_p = pad(w_pre.reshape(2, Fin, F),
                  (0, F_p - F, 0, Fin_p - Fin)).reshape(2 * Fin_p, F_p)
    blocks = pad(k_post[Fin:].reshape(12, F, Fout),
                 (0, Fout_p - Fout, 0, F_p - F)).reshape(12 * F_p, Fout_p)
    k_post_p = torch.cat([_pad(k_post[:Fin], Fin_p, Fout_p), blocks])
    return (w_pre_p, _pad(b_pre, F_p), k_post_p, _pad(b_post, Fout_p),
            _pad(w_lin, Fout_p, Fout_p), _pad(b_lin, Fout_p))


def pad_operands(x, w_pre, b_pre, k_post, b_post, w_lin, b_lin, skip=None):
    """Zero-pad Fin, F and Fout to multiples of 128 (differentiable ops,
    so autograd slices gradients back).  Pad lanes are inert: zero x lanes
    give zero v lanes, aggregate pad lanes meet zero rows of the padded
    k_post, and the caller slices the pad output columns off.  Returns the
    eight operands in the same order."""
    ws = _pad_weights(w_pre, b_pre, k_post, b_post, w_lin, b_lin)
    Fin_p, Fout_p = ws[0].shape[0] // 2, ws[4].shape[1]
    if ws[0] is w_pre:
        return (x, *ws, skip)
    return (_pad(x, x.shape[0], Fin_p), *ws,
            None if skip is None else _pad(skip, skip.shape[0], Fout_p))


def layer_operands(layers, mode: str):
    """What the kernel takes in ``mode`` for each of ``layers``, float32
    weights (w_pre, b_pre, k_post, b_post, w_lin, b_lin) of any widths:
    [{"mode": mode, "weights": the six padded (``_pad_weights``) and
    brought to the mode (``prepare_layer``), "s_lin": the int8 scales or
    None, "staged": their layout}], the layouts made together
    (``stage_layers``).  With a gradient the "f32" weights stay the
    differentiable padded ones (a train step's); otherwise they are
    detached and contiguous (what ``GNNModel`` caches for inference)."""
    grad = torch.is_grad_enabled()
    res = []
    for lay in layers:
        ws = _pad_weights(*lay)
        if not (grad and mode == "f32"):
            ws = [t.detach().contiguous() for t in ws]
        w_pre, k_post, w_lin, s_lin = prepare_layer(ws[0], ws[2], ws[4],
                                                    mode)
        res.append({"mode": mode, "s_lin": s_lin,
                    "weights": (w_pre, ws[1], k_post, ws[3], w_lin, ws[5])})
    staged = stage_layers([(o["weights"][0], o["weights"][2],
                            o["weights"][4]) for o in res], mode)
    for o, st in zip(res, staged):
        o["staged"] = st
    return res


def fused_pna_layer_auto(x, nbr_nodes, in_degree, w_pre, b_pre, k_post,
                         b_post, w_lin, b_lin, delta: float, skip=None,
                         act: Optional[str] = None, rev_nbr_nodes=None,
                         out_degree=None, mode: str = "f32", operands=None,
                         rev_csr=None):
    """The layer at any widths: ``pad_operands`` outside the autograd
    Function, then the first Fout columns of the result.  Takes the
    differentiable path (``PNALayerFunction`` in ``mode``; its plain twin
    under ``dispatch.plain_twins``) when grad mode is on and an input
    needs a gradient, else the kernel without residuals; float32 weights
    are brought to ``mode`` after padding (``prepare_layer``), or taken
    from ``operands`` (``layer_operands`` of the same weights in
    ``mode``), which also carry their staged layout.  Under a halo scope
    (``parallel.halo``) it runs on this rank's [halo | local | halo]
    window through ``halo_wrap_layer``, without the reverse table: the
    backward takes the window's reverse CSR (``rev_csr``)."""
    from gnnbuilder_tpu_torch.ops import dispatch
    from gnnbuilder_tpu_torch.parallel.halo import active_halo, halo_wrap_layer

    if active_halo() is not None:
        return halo_wrap_layer(
            lambda xw, nb, dg, sk, rc: fused_pna_layer_auto(
                xw, nb, dg, w_pre, b_pre, k_post, b_post, w_lin, b_lin,
                delta, skip=sk, act=act, mode=mode, operands=operands,
                rev_csr=rc),
            x, nbr_nodes, in_degree, skip=skip)
    Fout = w_lin.shape[1]
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, w_pre, b_pre, k_post, b_post, w_lin, b_lin, skip))
    if operands is not None:
        if operands["mode"] != mode:
            raise ValueError(f"operands of mode {operands['mode']!r} for a "
                             f"call in mode {mode!r}")
        ws = operands["weights"]
        Fin_p, Fout_p = ws[0].shape[0] // 2, ws[4].shape[1]
        staged, s_lin = operands["staged"], operands["s_lin"]
        if grad and mode != "f32":
            # the backward's float32 weights, padded alike
            ops = pad_operands(x, w_pre, b_pre, k_post, b_post, w_lin,
                               b_lin, skip)
        else:
            ops = (_pad(x, x.shape[0], Fin_p), *ws,
                   None if skip is None else _pad(skip, skip.shape[0],
                                                  Fout_p))
        mode_w = (ws[0], ws[2], ws[4], s_lin)
    else:
        ops = pad_operands(x, w_pre, b_pre, k_post, b_post, w_lin, b_lin,
                           skip)
        staged = mode_w = None
        if mode != "f32":
            mode_w = prepare_layer(
                *(t.detach().contiguous() for t in (ops[1], ops[3], ops[5])),
                mode)
    if grad:
        out = fused_pna_layer_vjp(ops[0], nbr_nodes, in_degree, *ops[1:7],
                                  delta, skip=ops[7], act=act,
                                  rev_nbr_nodes=rev_nbr_nodes,
                                  out_degree=out_degree, staged=staged,
                                  rev_csr=rev_csr, mode=mode,
                                  mode_weights=None if mode == "f32"
                                  else mode_w,
                                  plain=dispatch.twins_on())
    else:
        c = [None if t is None else t.contiguous() for t in ops]
        if mode != "f32":
            c[1], c[3], c[5], s_lin = mode_w
        out = fused_pna_layer(c[0], nbr_nodes, in_degree, *c[1:7], delta,
                              skip=c[7], act=act, mode=mode, s_lin=s_lin,
                              staged=staged)
    return out if out.shape[1] == Fout else out[:, :Fout]

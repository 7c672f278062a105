"""One GAT layer over the ELL neighbour table, concatenated heads: the
forward (``fused_gat_layer``), its backward (``GATLayerFunction``) and
the entry GATConv calls (``fused_gat_layer_auto``).

``fused_gat_layer`` launches ``csrc/gat_layer.cu`` for CUDA tensors and
runs ``gat_layer_plain``, the same function in plain torch, for CPU
tensors.  It replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/gat_layer.py`` ``fused_gat_layer``; the plain
version is that file's ``gat_layer_reference``: h = x W, per head a_src
= h . att_src and a_dst = h . att_dst, logits leaky_relu(a_src_j +
a_dst_i) over each row's ELL slots and the analytic self loop, a masked
softmax, the weighted sum of h, then bias, skip (before the activation)
and the activation.

Edge-featured attention (GATConv ``edge_dim``, the kernel's edge-logit
mode in every mode): ``edge_logits`` [N, W, H] adds a term to each
slot's logit before the leaky ReLU and ``self_edge_logit`` [N, H] one to
the self slot's.  Its backward (``GATLayerFunction``) is autograd of
the plain version with those terms as inputs, so their gradients reach
GATConv's ``lin_edge`` and ``att_edge``: the JAX package's
``_make_edge_vjp_fn``, which takes ``jax.vjp`` of its reference.

The backward follows that file's ``_make_vjp_fn``: the activation's
derivative from the saved output, the dense recompute of h, a_src and
a_dst (``torch.matmul``), the softmax backward of
``ops.cuda.gat_bwd.fused_gat_scatter_backward`` (row 11), the receiver's
self-slot terms with the m and den that it recomputed, and the dense
chains for dW, dx, datt_src, datt_dst and dbias in torch, as the JAX
package runs them in XLA.  Where the JAX gate ``_scatter_ok`` refuses
(no self loops, or an activation outside None / relu / sigmoid / tanh)
the backward is autograd of ``gat_layer_plain``, as JAX takes
``jax.vjp`` of its reference.

Modes (``mode``; the JAX kernel's ``mm="bf16"`` and ``quant=True``,
the serving precision): only the projection h = x W changes.  "bf16" rounds x
to bf16 against bfloat16 ``w``; "int8" quantizes x per row against int8
``w`` with column scales ``sw`` (``ops.quant.qdot``).  The logit halves,
the softmax, the exact gather and the weighted sum stay float32, as in
the JAX kernel (whose gather rounds nothing to bf16 in any mode).
``prepare_layer`` brings a float32 ``w`` to a mode.  ``GATLayerFunction``
takes a mode, as the JAX ``_make_vjp_fn`` / ``_make_edge_vjp_fn`` do:
the kernel forward in it; under "bf16" the backward above (row 11 where
``scatter_ok`` holds, on the float32 recompute of h and the forward's
out), under "int8" always autograd of the float32 plain layer (the JAX
straight-through fallback: its scatter backward would mix int8 residuals
with float32 logits); in a mode the fallback takes the activation's
derivative from its own recompute, as ``jax.vjp`` of the reference does.
Its plain twin (``plain=True``) runs ``gat_layer_plain`` forward and row
11's plain version.

What bounds the kernel on the H100: operations (the projection, which
runs on the tensor cores: split TF32 in three passes in "f32", bf16 and
s8 MMAs in the modes); see the source.  The kernel reads its weights in
``stage_projection``'s layout: made from ``w`` on every call (so a train
step always sees its live weights), or passed as ``staged`` (the model's
inference cache, ``GATConv.mode_operands``).

Operands (the JAX package's layout): x [N, Fin], w [Fin, H*C], att_src
and att_dst [1, H, C], bias [H*C], skip [N, H*C].
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS, leaky_relu
from gnnbuilder_tpu_torch.ops.cuda.gat_bwd import (
    fused_gat_scatter_backward,
    gat_scatter_backward_plain,
)
from gnnbuilder_tpu_torch.ops.cuda.mp_layer import (
    LAYER_ACTS,
    MODES,
    weight_dtype,
)
from gnnbuilder_tpu_torch.ops.cuda.pna_block import (
    _fragment_index,
    split_tf32,
)
from gnnbuilder_tpu_torch.ops.ell import (
    ell_gather,
    ell_mask,
    ell_own_pads,
    ell_softmax_sum,
)
from gnnbuilder_tpu_torch.ops.quant import qdot, quantize_weight, to_bf16

__all__ = ["fused_gat_layer", "gat_layer_plain", "GATLayerFunction",
           "fused_gat_layer_vjp", "fused_gat_layer_auto", "prepare_layer",
           "stage_projection", "unstage_projection", "projection_geometry",
           "GAT_ACTS", "SCATTER_ACTS", "scatter_ok"]

# epilogue activations the GAT kernels take, with their codes in the
# sources: those of the mp layer kernel
GAT_ACTS = LAYER_ACTS
# activations whose derivative the hand-written backward takes from the
# saved output (the JAX package's _scatter_ok)
SCATTER_ACTS = (None, "relu", "sigmoid", "tanh")


def _act(o, act):
    return o if act is None else ACTIVATIONS[act](o)


def prepare_layer(w, mode: str):
    """(w, sw) as ``mode`` takes them: "bf16" rounds w to bfloat16; "int8"
    quantizes it with per-column scales sw (``ops.quant.quantize_weight``,
    the JAX kernel's); sw is None in the other modes."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    w = w.contiguous()
    if mode == "int8":
        return quantize_weight(w)
    return (w.to(torch.bfloat16) if mode == "bf16" else w), None


# the projection's geometry (csrc/gat_common.cuh): k per tile, k depth of
# one mma and values per fragment register in each mode
_KC = 32
_KDEPTH = {"f32": 8, "bf16": 16, "int8": 32}
_PER_REG = {"f32": 1, "bf16": 2, "int8": 4}
_LOGIT_COLS = 8      # the logit tile: one n8 tile (wa_src, wa_dst, zeros)


def projection_geometry(Fin: int, C: int):
    """(CW, n_chunks, Kp): the kernels' chunk width (64 for C <= 64, else
    128), chunks per head and k padded to a multiple of 32."""
    cw = 64 if C <= 64 else 128
    return cw, -(-C // cw), -(-Fin // _KC) * _KC


def _region_order(mode: str, Kp: int, CW: int, logit: bool):
    """(index, half) of one region's stream: indices into the region's
    [Kp, CW (+ 8 with the logit tile)] matrix flattened, and in "f32" the
    TF32 half each holds (0 hi, 1 lo).  Per k-step of ``_KDEPTH[mode]``
    rows: the CW / 16 pairs of n8 tiles in mma B-fragment order
    (``pna_block._fragment_index``; in "f32" a pair's 128 hi values, then
    its 128 lo values), then with ``logit`` the logit tile's 128 values
    (one n8 tile: lane, register, value)."""
    E, kd = _PER_REG[mode], _KDEPTH[mode]
    wide = CW + (_LOGIT_COLS if logit else 0)
    fi = _fragment_index(kd, CW, E)
    step = fi // CW * wide + fi % CW
    half = torch.zeros_like(step)
    if mode == "f32":
        pairs = step.numel() // 128
        step = step.view(pairs, 1, 128).expand(pairs, 2, 128).reshape(-1)
        half = torch.arange(2).view(1, 2, 1).expand(pairs, 2, 128).reshape(-1)
    if logit:
        li = _fragment_index(kd, 16, E).view(32, 2, 2 * E)[:, 0].reshape(-1)
        step = torch.cat([step, li // 16 * wide + CW + li % 16])
        half = torch.cat([half, torch.zeros_like(li)])
    base = torch.arange(Kp // kd).view(-1, 1) * (kd * wide)
    return (base + step).reshape(-1), half.repeat(Kp // kd)


@functools.lru_cache(maxsize=64)
def _stage_plan(Fin: int, heads: int, C: int, mode: str, logit: bool,
                device: torch.device):
    """(src, half) on ``device``: for each position of the staged stream,
    the index of its value in the flat source [w (Fin x H*C), 0, wa_src
    (Fin x H), wa_dst (Fin x H)], and in "f32" its TF32 half.  Per head,
    per chunk of CW columns (a region of [Kp, CW (+ 8)] with zeros past
    the head's C and past Fin, and with ``logit`` the columns wa_src[:,
    hd], wa_dst[:, hd], then six zero columns), ``_region_order``."""
    CW, nch, Kp = projection_geometry(Fin, C)
    HC = heads * C
    zero = Fin * HC                                 # the source's 0
    w_idx = torch.arange(HC * Fin).view(Fin, heads, C).permute(1, 0, 2)
    reg = torch.full((heads, Kp, nch * CW), zero)
    reg[:, :Fin, :C] = w_idx
    reg = reg.view(heads, Kp, nch, CW).permute(0, 2, 1, 3)
    if logit:
        lg = torch.full((heads, nch, Kp, _LOGIT_COLS), zero)
        wa = zero + 1 + torch.arange(Fin * heads).view(Fin, heads).t()
        lg[:, :, :Fin, 0] = wa[:, None, :]
        lg[:, :, :Fin, 1] = wa[:, None, :] + Fin * heads
        reg = torch.cat([reg, lg], dim=3)
    index, half = _region_order(mode, Kp, CW, logit)
    src = reg.reshape(heads * nch, -1)[:, index].reshape(-1)
    half = half.repeat(heads * nch)
    return src.to(device), half.to(device)


def _source(w, wa_src=None, wa_dst=None):
    parts = [w.detach().reshape(-1), w.new_zeros(1)]
    if wa_src is not None:
        parts += [wa_src.detach().reshape(-1).to(w.dtype),
                  wa_dst.detach().reshape(-1).to(w.dtype)]
    return torch.cat(parts)


def stage_projection(w, heads: int, mode: str, wa_src=None, wa_dst=None):
    """The projection weights ``w`` [Fin, H*C] (of ``mode``'s type, as
    ``prepare_layer`` or ``gat_block.prepare_block`` give them) in the
    layout the GAT kernels stream (csrc/gat_common.cuh): per head, per
    chunk of CW columns, per tile of 32 k, ``_region_order``'s order; in
    "f32" each weight as its ``split_tf32`` halves.  With the bf16 logit
    weights ``wa_src`` / ``wa_dst`` [Fin, H] (the block kernel's bf16
    mode) every k-step also carries the logit tile.  One flat tensor of
    ``w``'s type: a cat, the split (f32) and one gather."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    if (wa_src is None) != (wa_dst is None) or (
            wa_src is not None and mode != "bf16"):
        raise ValueError("the logit weights wa_src and wa_dst go together, "
                         "in mode 'bf16' only")
    Fin, HC = w.shape
    src, half = _stage_plan(Fin, heads, HC // heads, mode,
                            wa_src is not None, w.device)
    flat = _source(w, wa_src, wa_dst)
    if mode == "f32":
        return torch.stack(split_tf32(flat))[half, src]
    return flat[src]


def unstage_projection(staged, Fin: int, heads: int, C: int, mode: str,
                       logit: bool = False):
    """``stage_projection``'s inputs back: w [Fin, H*C] (in "f32" [2, Fin,
    H*C], its TF32 halves hi, lo), and with ``logit`` also wa_src and
    wa_dst [Fin, H]."""
    src, half = _stage_plan(Fin, heads, C, mode, logit, staged.device)
    n = Fin * heads * C
    flat = staged.new_zeros((2 if mode == "f32" else 1,
                             n + 1 + (2 * Fin * heads if logit else 0)))
    flat[half, src] = staged
    w = flat[:, :n].reshape(-1, Fin, heads * C)
    w = w if mode == "f32" else w[0]
    if not logit:
        return w
    wa = flat[0, n + 1:].view(2, Fin, heads)
    return w, wa[0], wa[1]


def _staged_ok(staged, Fin, heads, C, mode, logit, device):
    """Raises unless ``staged`` has ``stage_projection``'s length and type
    for these widths (keeping its values current is the caller's part)."""
    CW, nch, Kp = projection_geometry(Fin, C)
    step = CW * _KDEPTH[mode] * (2 if mode == "f32" else 1) + (
        _LOGIT_COLS * _KDEPTH[mode] if logit else 0)
    n = heads * nch * (Kp // _KDEPTH[mode]) * step
    if (tuple(staged.shape) != (n,) or staged.dtype != weight_dtype(mode)
            or staged.device != device or not staged.is_contiguous()):
        raise ValueError(f"staged must be stage_projection's layout of the "
                         f"weights: ({n},) {weight_dtype(mode)} on {device}")


def _project(x, w, att_src, att_dst, heads, mode="f32", sw=None):
    """h [N, H, C], a_src and a_dst [N, H]; the product in ``mode``."""
    N = x.shape[0]
    if mode == "int8":
        h = qdot(x, w, sw)
    elif mode == "bf16":
        h = to_bf16(x) @ w.float()
    else:
        h = x @ w
    h = h.reshape(N, heads, -1)
    return h, (h * att_src).sum(-1), (h * att_dst).sum(-1)


def gat_layer_plain(x, nbr_nodes, in_degree, w, att_src, att_dst, bias,
                    heads: int, neg_slope: float = 0.2,
                    self_loops: bool = True, skip=None,
                    act: Optional[str] = None, mode: str = "f32", sw=None,
                    edge_logits=None, self_edge_logit=None):
    """The layer in plain torch (``gat_layer_reference``), its projection
    in ``mode``."""
    N = x.shape[0]
    h, a_src, a_dst = _project(x, w, att_src, att_dst, heads, mode, sw)
    z = ell_gather(a_src, nbr_nodes) + a_dst[:, None, :]
    if edge_logits is not None:
        z = z + edge_logits
    lt = leaky_relu(z, neg_slope)
    vt = ell_gather(h, nbr_nodes)
    mask = ell_mask(nbr_nodes, in_degree)
    if self_loops:
        z_s = a_src + a_dst
        if self_edge_logit is not None:
            z_s = z_s + self_edge_logit
        out = ell_softmax_sum(lt, vt, mask, leaky_relu(z_s, neg_slope), h)
    else:
        out = ell_softmax_sum(lt, vt, mask)
    out = out.reshape(N, -1) + bias
    if skip is not None:
        out = out + skip
    return _act(out, act)


def _check(x, nbr_nodes, in_degree, w, att_src, att_dst, bias, heads, skip,
           act, mode, sw, edge_logits, self_edge_logit):
    if act not in GAT_ACTS:
        raise ValueError(f"unsupported GAT layer activation {act!r}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, Fin] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    N, Fin = x.shape
    if w.dim() != 2 or w.shape[0] != Fin or heads < 1 \
            or w.shape[1] % heads:
        raise ValueError(f"w must be [{Fin}, heads * C] with heads={heads}, "
                         f"got {tuple(w.shape)}")
    HC = w.shape[1]
    C = HC // heads
    for name, t, shape in (("w", w, (Fin, HC)),
                           ("att_src", att_src, (1, heads, C)),
                           ("att_dst", att_dst, (1, heads, C)),
                           ("bias", bias, (HC,)),
                           ("skip", skip, (N, HC)),
                           ("sw", sw, (HC,))):
        dt = weight_dtype(mode) if name == "w" else torch.float32
        if t is not None and (tuple(t.shape) != shape or t.dtype != dt):
            raise ValueError(f"{name} must be {shape} {dt} in mode "
                             f"{mode!r}, got {tuple(t.shape)} {t.dtype}")
    if (sw is None) != (mode != "int8"):
        raise ValueError(f"sw goes with mode 'int8' only, got mode {mode!r} "
                         f"and sw {'None' if sw is None else 'given'}")
    if nbr_nodes is None or nbr_nodes.dim() != 2 \
            or nbr_nodes.shape[0] != N:
        raise ValueError("nbr_nodes must be [N, W]")
    if tuple(in_degree.shape) != (N,):
        raise ValueError("in_degree must be [N]")
    for name, t, shape in (
            ("edge_logits", edge_logits, (N, nbr_nodes.shape[1], heads)),
            ("self_edge_logit", self_edge_logit, (N, heads))):
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype != torch.float32):
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if self_edge_logit is not None and edge_logits is None:
        raise ValueError("self_edge_logit goes with edge_logits")
    devs = {t.device for t in (x, nbr_nodes, in_degree, w, att_src, att_dst,
                               bias, skip, sw, edge_logits, self_edge_logit)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, nbr_nodes, in_degree, w, att_src, att_dst, bias, heads,
            neg_slope, self_loops, skip, act, mode, sw, edge_logits,
            self_edge_logit, staged):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, Fin = x.shape
    HC = w.shape[1]
    C = HC // heads
    W = nbr_nodes.shape[1]
    dev = x.device
    smem = lib.gnnb_gat_layer_smem_bytes(W, heads)
    smem_max = lib.gnnb_smem_per_block_optin(dev.index or 0)
    if smem > smem_max:
        raise ValueError(f"the CUDA GAT layer takes ELL width x heads within "
                         f"{smem_max} bytes of shared memory; got W={W} "
                         f"heads={heads} ({smem} bytes)")
    if nbr_nodes.dtype != torch.int32 or in_degree.dtype != torch.int32:
        raise ValueError("nbr_nodes and in_degree must be int32")
    if staged is None:
        staged = stage_projection(w, heads, mode)
    _staged_ok(staged, Fin, heads, C, mode, False, dev)
    if edge_logits is not None and self_edge_logit is None:
        self_edge_logit = x.new_zeros((N, heads))
    ops = [t for t in (x, nbr_nodes, in_degree, att_src, att_dst, bias,
                       skip, sw, edge_logits, self_edge_logit)
           if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("all inputs must be contiguous")
    if staged.data_ptr() % 16:
        raise ValueError("staged must be 16-byte aligned")
    fn = lib.gnnb_gat_layer
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 3 + [I] * 5 + [P, ctypes.c_longlong] + [P] * 4 \
        + [ctypes.c_float, I, I, I] + [P] * 10 + [I]
    f = torch.float32
    xq = xs = None
    if mode == "int8":   # the kernel's scratch: x quantized once per row
        n128 = -(-N // 128) * 128
        xq = torch.empty((n128, projection_geometry(Fin, C)[2]),
                         dtype=torch.int8, device=dev)
        xs = torch.empty((n128,), dtype=f, device=dev)
    h = torch.empty((N, HC), dtype=f, device=dev)
    a_src = torch.empty((N, heads), dtype=f, device=dev)
    a_dst = torch.empty((N, heads), dtype=f, device=dev)
    out = torch.empty((N, HC), dtype=f, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), nbr_nodes.data_ptr(), in_degree.data_ptr(), N, W,
             Fin, heads, C, staged.data_ptr(),
             staged.numel() * staged.element_size(), att_src.data_ptr(),
             att_dst.data_ptr(), bias.data_ptr(),
             None if skip is None else skip.data_ptr(), float(neg_slope),
             int(bool(self_loops)), GAT_ACTS[act], MODES[mode],
             None if sw is None else sw.data_ptr(),
             None if edge_logits is None else edge_logits.data_ptr(),
             None if self_edge_logit is None else self_edge_logit.data_ptr(),
             None if xq is None else xq.data_ptr(),
             None if xs is None else xs.data_ptr(), h.data_ptr(),
             a_src.data_ptr(), a_dst.data_ptr(), out.data_ptr(), stream,
             dev.index or 0)
    if err != 0:
        raise RuntimeError(f"gat_layer launch failed: cudaError {err}")
    fused_gat_layer.launches += 1
    fused_gat_layer.mode_launches[mode] += 1
    if edge_logits is not None:
        fused_gat_layer.edge_launches[mode] += 1
    return out


def fused_gat_layer(x, nbr_nodes, in_degree, w, att_src, att_dst, bias,
                    heads: int, neg_slope: float = 0.2,
                    self_loops: bool = True, skip=None,
                    act: Optional[str] = None, mode: str = "f32", sw=None,
                    edge_logits=None, self_edge_logit=None, staged=None):
    """One GAT layer (module docstring) on x [N, Fin] float32 over the ELL
    table ``nbr_nodes`` [N, W] / ``in_degree`` [N] int32, concatenated
    heads: out [N, H*C]; ``w`` and ``sw`` typed by ``mode``
    (``prepare_layer``); with edge features ``edge_logits`` [N, W, H]
    and ``self_edge_logit`` [N, H] (0 when None).  A CUDA ``x`` launches
    the kernel, which takes any width and raises on what it does not
    take, on ``staged`` = ``stage_projection(w, heads, mode)`` (made here
    when None); a CPU ``x`` runs the plain version."""
    _check(x, nbr_nodes, in_degree, w, att_src, att_dst, bias, heads, skip,
           act, mode, sw, edge_logits, self_edge_logit)
    if x.device.type == "cuda":
        return _launch(x, nbr_nodes, in_degree, w, att_src, att_dst, bias,
                       heads, neg_slope, self_loops, skip, act, mode, sw,
                       edge_logits, self_edge_logit, staged)
    if x.device.type != "cpu":
        raise ValueError(f"no GAT layer for device {x.device}")
    return gat_layer_plain(x, nbr_nodes, in_degree, w, att_src, att_dst,
                           bias, heads, neg_slope, self_loops, skip, act,
                           mode, sw, edge_logits, self_edge_logit)


fused_gat_layer.launches = 0
fused_gat_layer.mode_launches = dict.fromkeys(MODES, 0)
# the launches in the edge-logit mode, per mode (also in the counts above)
fused_gat_layer.edge_launches = dict.fromkeys(MODES, 0)


def _act_backward(ct, out, act):
    """The cotangent before an activation in ``SCATTER_ACTS``, from its
    saved output ``out``."""
    if act is None:
        return ct
    if act == "relu":
        return ct * (out > 0.0).to(ct.dtype)
    if act == "sigmoid":
        return ct * out * (1.0 - out)
    return ct * (1.0 - out * out)    # tanh


def scatter_ok(self_loops: bool, act) -> bool:
    """Whether the hand-written backward applies (the JAX package's
    ``_scatter_ok`` without its TPU geometry): self loops, and an
    activation whose derivative comes from the saved output."""
    return bool(self_loops) and act in SCATTER_ACTS


class GATLayerFunction(torch.autograd.Function):
    """``fused_gat_layer`` with the JAX package's backward (module
    docstring): the hand-written one where ``scatter_ok`` holds and the
    layer has no edge-logit inputs ``le`` [N, W, H] / ``ae_self`` [N, H],
    else autograd of the plain version (with the edge terms: the JAX
    package's ``_make_edge_vjp_fn``), which also gives their gradients;
    either takes the derivative of an activation in ``SCATTER_ACTS``
    from the kernel's saved output.
    That recompute gathers over the table with each pad slot pointing at
    its own row (``ell_own_pads``): the masked softmax gives the same
    values, and the gathers' backward then adds the pad slots' zero
    gradients to their own rows, not all of them to the ghost row."""

    @staticmethod
    def forward(ctx, x, nbr_nodes, in_degree, rev_nbr_nodes, out_degree,
                skip, le, ae_self, w, att_src, att_dst, bias, heads,
                neg_slope, self_loops, act, rev_csr, mode="f32",
                mode_weights=None, plain=False):
        wm, sw = (w, None) if mode_weights is None else mode_weights
        run = gat_layer_plain if plain else fused_gat_layer
        out = run(x, nbr_nodes, in_degree, wm, att_src, att_dst, bias, heads,
                  neg_slope, self_loops, skip, act, mode=mode, sw=sw,
                  edge_logits=le, self_edge_logit=ae_self)
        ctx.save_for_backward(x, nbr_nodes, in_degree, rev_nbr_nodes,
                              out_degree, skip, le, ae_self, w, att_src,
                              att_dst, bias, out)
        ctx.heads, ctx.neg_slope = heads, float(neg_slope)
        ctx.self_loops, ctx.act = bool(self_loops), act
        ctx.rev_csr, ctx.mode, ctx.plain = rev_csr, mode, plain
        return out

    @staticmethod
    def backward(ctx, ct):
        (x, nbr, deg, rev, odeg, skip, le, ae_self, w, att_src, att_dst,
         bias, out) = ctx.saved_tensors
        H, ns, act = ctx.heads, ctx.neg_slope, ctx.act
        if (le is not None or ctx.mode == "int8"
                or not scatter_ok(ctx.self_loops, act)):
            # f32: the activation's derivative from the kernel's output
            # where it gives one, as below: the decisions of the forward
            # that ran (a recompute's own could take a ReLU near 0 the
            # other way); a mode: the recompute's, as the JAX reference
            # backward takes it
            from_out = act in SCATTER_ACTS and ctx.mode == "f32"
            live = [x, skip, le, ae_self, w, att_src, att_dst, bias]
            with torch.enable_grad():
                leaves = [None if t is None else t.detach().requires_grad_()
                          for t in live]
                o = gat_layer_plain(leaves[0], ell_own_pads(nbr, deg), deg,
                                    *leaves[4:], H, ns, ctx.self_loops,
                                    leaves[1], None if from_out else act,
                                    edge_logits=leaves[2],
                                    self_edge_logit=leaves[3])
                got = iter(torch.autograd.grad(
                    o, [t for t in leaves if t is not None],
                    _act_backward(ct, out, act) if from_out else ct))
            dx, dskip, dle, dae, dw, datt_src, datt_dst, dbias = [
                None if t is None else next(got) for t in leaves]
            return (dx, None, None, None, None, dskip, dle, dae, dw,
                    datt_src, datt_dst, dbias, None, None, None, None, None,
                    None, None, None)
        dz = _act_backward(ct, out, act).contiguous()
        N, HC = dz.shape
        C = HC // H
        h, a_src, a_dst = _project(x, w, att_src, att_dst, H)
        terms = (dz, h.reshape(N, HC).contiguous(), a_src.contiguous(),
                 a_dst.contiguous(), nbr, deg, H)
        if ctx.plain:
            dv_val, da_src_nbr, dsum, s, m, den = gat_scatter_backward_plain(
                *terms, neg_slope=ns, self_loops=True)
        else:
            dv_val, da_src_nbr, dsum, s, m, den = fused_gat_scatter_backward(
                *terms, neg_slope=ns, self_loops=True, rev_nbr_nodes=rev,
                out_degree=odeg,
                rev_csr=(ctx.rev_csr() if rev is None
                         and ctx.rev_csr is not None else None))
        # the receiver's self-slot terms, with the same m and den
        dzv = dz.view(N, H, C)
        pre_s = a_src + a_dst
        alpha_s = torch.exp(leaky_relu(pre_s, ns) - m) / den.clamp(
            min=1e-16)                                              # [N, H]
        slope_s = torch.where(pre_s >= 0, torch.ones_like(pre_s),
                              torch.full_like(pre_s, ns))
        dpre_s = alpha_s * ((dzv * h).sum(-1) - s) * slope_s
        da_src = da_src_nbr + dpre_s
        da_dst = dsum + dpre_s
        dh = (dv_val.view(N, H, C) + alpha_s[..., None] * dzv
              + da_src[..., None] * att_src + da_dst[..., None] * att_dst)
        dh = dh.reshape(N, HC)
        dw = x.t() @ dh
        dx = dh @ w.t()
        datt_src = (da_src[..., None] * h).sum(0, keepdim=True)
        datt_dst = (da_dst[..., None] * h).sum(0, keepdim=True)
        dbias = dz.sum(0)
        dskip = dz if skip is not None else None
        return (dx, None, None, None, None, dskip, None, None, dw, datt_src,
                datt_dst, dbias, None, None, None, None, None, None, None,
                None)


def fused_gat_layer_vjp(x, nbr_nodes, in_degree, w, att_src, att_dst, bias,
                        heads: int, neg_slope: float = 0.2,
                        self_loops: bool = True, skip=None,
                        act: Optional[str] = None, rev_nbr_nodes=None,
                        out_degree=None, mode: str = "f32",
                        edge_logits=None, self_edge_logit=None,
                        rev_csr=None, prepared=None, plain: bool = False):
    """Differentiable ``fused_gat_layer`` on a float32 ``w``: the kernel
    forward in ``mode`` (on ``prepared`` = ``prepare_layer(w, mode)``,
    made here when None) and the backward of ``GATLayerFunction``
    (``plain``: its plain twin), whose softmax backward gathers over
    the reverse table when both ``rev_nbr_nodes`` and ``out_degree`` are
    given, else over the reverse CSR of ``nbr_nodes`` (``rev_csr()``'s
    when ``rev_csr`` is given: a callable returning ``reverse_csr(
    nbr_nodes, in_degree, positions=True)``, as ``GraphBatch.rev_csr``
    keeps it, called only by that backward; else built there); with
    ``edge_logits`` (and ``self_edge_logit``, 0 when None) autograd of
    the plain layer."""
    if mode != "f32" and prepared is None:
        prepared = prepare_layer(w.detach(), mode)
    if edge_logits is not None and self_edge_logit is None:
        self_edge_logit = x.new_zeros((x.shape[0], int(heads)))
    if rev_nbr_nodes is None or out_degree is None:
        rev_nbr_nodes = out_degree = None
    return GATLayerFunction.apply(x, nbr_nodes, in_degree, rev_nbr_nodes,
                                  out_degree, skip, edge_logits,
                                  self_edge_logit, w, att_src, att_dst,
                                  bias, int(heads), float(neg_slope),
                                  bool(self_loops), act, rev_csr, mode,
                                  prepared if mode != "f32" else None,
                                  bool(plain))


def fused_gat_layer_auto(x, nbr_nodes, in_degree, w, att_src, att_dst, bias,
                         heads: int, neg_slope: float = 0.2,
                         self_loops: bool = True, skip=None,
                         act: Optional[str] = None, rev_nbr_nodes=None,
                         out_degree=None, mode: str = "f32", prepared=None,
                         edge_logits=None, self_edge_logit=None,
                         staged=None, rev_csr=None):
    """The layer as GATConv calls it: the differentiable path
    (``GATLayerFunction`` in ``mode``; its plain twin under
    ``dispatch.plain_twins``) when grad mode is on and an input needs a
    gradient (the kernel then lays the live weights out on every call),
    else the kernel alone, in ``mode`` with
    ``prepared`` = ``prepare_layer(w, mode)`` and ``staged`` =
    ``stage_projection`` of its weights (each made here when None).  The
    edge-logit terms go through either; ``rev_csr`` as
    ``fused_gat_layer_vjp`` takes it.  The kernel takes any width, so
    nothing is padded.  Under a halo scope (``parallel.halo``) it runs on
    this rank's [halo | local | halo] window through ``halo_wrap_layer``,
    without the reverse table: the backward takes the window's reverse
    CSR."""
    from gnnbuilder_tpu_torch.ops import dispatch
    from gnnbuilder_tpu_torch.parallel.halo import active_halo, halo_wrap_layer

    if active_halo() is not None:
        if edge_logits is not None:
            raise NotImplementedError("the GAT layer's edge terms have no "
                                      "halo window")
        return halo_wrap_layer(
            lambda xw, nb, dg, sk, rc: fused_gat_layer_auto(
                xw, nb, dg, w, att_src, att_dst, bias, heads,
                neg_slope=neg_slope, self_loops=self_loops, skip=sk, act=act,
                mode=mode, prepared=prepared, staged=staged, rev_csr=rc),
            x, nbr_nodes, in_degree, skip=skip)
    ops = [None if t is None else t.contiguous()
           for t in (x, skip, w, att_src, att_dst, bias, edge_logits,
                     self_edge_logit)]
    ekw = dict(edge_logits=ops[6], self_edge_logit=ops[7])
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ops):
        return fused_gat_layer_vjp(
            ops[0], nbr_nodes, in_degree, *ops[2:6], heads, neg_slope,
            self_loops, ops[1], act, rev_nbr_nodes, out_degree, mode=mode,
            rev_csr=rev_csr, prepared=prepared, plain=dispatch.twins_on(),
            **ekw)
    wm, sw = ((ops[2], None) if mode == "f32" else
              prepared if prepared is not None else
              prepare_layer(ops[2], mode))
    return fused_gat_layer(ops[0], nbr_nodes, in_degree, wm, *ops[3:6],
                           heads, neg_slope, self_loops, ops[1], act,
                           mode=mode, sw=sw, staged=staged, **ekw)

"""One GAT layer over the ELL neighbour table, concatenated heads: the
forward (``fused_gat_layer``), its backward (``GATLayerFunction``) and
the entry GATConv calls (``fused_gat_layer_auto``).

``fused_gat_layer`` launches ``csrc/gat_layer.cu`` for CUDA tensors and
runs ``gat_layer_plain``, the same function in plain torch, for CPU
tensors.  It replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/gat_layer.py`` ``fused_gat_layer`` (without
its edge-logit mode); the plain version is that file's
``gat_layer_reference``: h = x W, per head a_src = h . att_src and a_dst
= h . att_dst, logits leaky_relu(a_src_j + a_dst_i) over each row's ELL
slots and the analytic self loop, a masked softmax, the weighted sum of
h, then bias, skip (before the activation) and the activation.

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

Inference modes (``mode``; the JAX kernel's ``mm="bf16"`` and
``quant=True``, the serving precision; no backward: a mode meeting a
gradient raises): only the projection h = x W changes.  "bf16" rounds x
to bf16 against bfloat16 ``w``; "int8" quantizes x per row against int8
``w`` with column scales ``sw`` (``ops.quant.qdot``).  The logit halves,
the softmax, the exact gather and the weighted sum stay float32, as in
the JAX kernel (whose gather rounds nothing to bf16 in any mode).
``prepare_layer`` brings a float32 ``w`` to a mode.

What bounds the kernel on the H100: operations (the projection); see the
source.

Operands (the JAX package's layout): x [N, Fin], w [Fin, H*C], att_src
and att_dst [1, H, C], bias [H*C], skip [N, H*C].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS, leaky_relu
from gnnbuilder_tpu_torch.ops.cuda.gat_bwd import fused_gat_scatter_backward
from gnnbuilder_tpu_torch.ops.cuda.mp_layer import (
    LAYER_ACTS,
    MODES,
    weight_dtype,
)
from gnnbuilder_tpu_torch.ops.ell import ell_gather, ell_mask, ell_softmax_sum
from gnnbuilder_tpu_torch.ops.quant import qdot, quantize_weight, to_bf16

__all__ = ["fused_gat_layer", "gat_layer_plain", "GATLayerFunction",
           "fused_gat_layer_vjp", "fused_gat_layer_auto", "prepare_layer",
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
                    act: Optional[str] = None, mode: str = "f32", sw=None):
    """The layer in plain torch (``gat_layer_reference``), its projection
    in ``mode``."""
    N = x.shape[0]
    h, a_src, a_dst = _project(x, w, att_src, att_dst, heads, mode, sw)
    lt = leaky_relu(ell_gather(a_src, nbr_nodes) + a_dst[:, None, :],
                    neg_slope)
    vt = ell_gather(h, nbr_nodes)
    mask = ell_mask(nbr_nodes, in_degree)
    if self_loops:
        out = ell_softmax_sum(lt, vt, mask,
                              leaky_relu(a_src + a_dst, neg_slope), h)
    else:
        out = ell_softmax_sum(lt, vt, mask)
    out = out.reshape(N, -1) + bias
    if skip is not None:
        out = out + skip
    return _act(out, act)


def _check(x, nbr_nodes, in_degree, w, att_src, att_dst, bias, heads, skip,
           act, mode, sw):
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
    devs = {t.device for t in (x, nbr_nodes, in_degree, w, att_src, att_dst,
                               bias, skip, sw) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, nbr_nodes, in_degree, w, att_src, att_dst, bias, heads,
            neg_slope, self_loops, skip, act, mode, sw):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, Fin = x.shape
    HC = w.shape[1]
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
    ops = [t for t in (x, nbr_nodes, in_degree, w, att_src, att_dst, bias,
                       skip, sw) if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("all inputs must be contiguous")
    fn = lib.gnnb_gat_layer
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 3 + [I] * 5 + [P] * 5 + [ctypes.c_float, I, I, I] \
        + [P] * 6 + [I]
    f = torch.float32
    h = torch.empty((N, HC), dtype=f, device=dev)
    a_src = torch.empty((N, heads), dtype=f, device=dev)
    a_dst = torch.empty((N, heads), dtype=f, device=dev)
    out = torch.empty((N, HC), dtype=f, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), nbr_nodes.data_ptr(), in_degree.data_ptr(), N, W,
             Fin, heads, HC // heads, w.data_ptr(), att_src.data_ptr(),
             att_dst.data_ptr(), bias.data_ptr(),
             None if skip is None else skip.data_ptr(), float(neg_slope),
             int(bool(self_loops)), GAT_ACTS[act], MODES[mode],
             None if sw is None else sw.data_ptr(), h.data_ptr(),
             a_src.data_ptr(), a_dst.data_ptr(), out.data_ptr(), stream,
             dev.index or 0)
    if err != 0:
        raise RuntimeError(f"gat_layer launch failed: cudaError {err}")
    fused_gat_layer.launches += 1
    fused_gat_layer.mode_launches[mode] += 1
    return out


def fused_gat_layer(x, nbr_nodes, in_degree, w, att_src, att_dst, bias,
                    heads: int, neg_slope: float = 0.2,
                    self_loops: bool = True, skip=None,
                    act: Optional[str] = None, mode: str = "f32", sw=None):
    """One GAT layer (module docstring) on x [N, Fin] float32 over the ELL
    table ``nbr_nodes`` [N, W] / ``in_degree`` [N] int32, concatenated
    heads: out [N, H*C]; ``w`` and ``sw`` typed by ``mode``
    (``prepare_layer``).  A CUDA ``x`` launches the kernel, which takes
    any width and raises on what it does not take; a CPU ``x`` runs the
    plain version."""
    _check(x, nbr_nodes, in_degree, w, att_src, att_dst, bias, heads, skip,
           act, mode, sw)
    if x.device.type == "cuda":
        return _launch(x, nbr_nodes, in_degree, w, att_src, att_dst, bias,
                       heads, neg_slope, self_loops, skip, act, mode, sw)
    if x.device.type != "cpu":
        raise ValueError(f"no GAT layer for device {x.device}")
    return gat_layer_plain(x, nbr_nodes, in_degree, w, att_src, att_dst,
                           bias, heads, neg_slope, self_loops, skip, act,
                           mode, sw)


fused_gat_layer.launches = 0
fused_gat_layer.mode_launches = dict.fromkeys(MODES, 0)


def scatter_ok(self_loops: bool, act) -> bool:
    """Whether the hand-written backward applies (the JAX package's
    ``_scatter_ok`` without its TPU geometry): self loops, and an
    activation whose derivative comes from the saved output."""
    return bool(self_loops) and act in SCATTER_ACTS


class GATLayerFunction(torch.autograd.Function):
    """``fused_gat_layer`` with the JAX package's backward (module
    docstring): the hand-written one where ``scatter_ok`` holds, else
    autograd of the plain version."""

    @staticmethod
    def forward(ctx, x, nbr_nodes, in_degree, rev_nbr_nodes, out_degree,
                skip, w, att_src, att_dst, bias, heads, neg_slope,
                self_loops, act):
        out = fused_gat_layer(x, nbr_nodes, in_degree, w, att_src, att_dst,
                              bias, heads, neg_slope, self_loops, skip, act)
        ctx.save_for_backward(x, nbr_nodes, in_degree, rev_nbr_nodes,
                              out_degree, skip, w, att_src, att_dst, bias,
                              out)
        ctx.heads, ctx.neg_slope = heads, float(neg_slope)
        ctx.self_loops, ctx.act = bool(self_loops), act
        return out

    @staticmethod
    def backward(ctx, ct):
        (x, nbr, deg, rev, odeg, skip, w, att_src, att_dst, bias,
         out) = ctx.saved_tensors
        H, ns, act = ctx.heads, ctx.neg_slope, ctx.act
        if not scatter_ok(ctx.self_loops, act):
            live = [x, skip, w, att_src, att_dst, bias]
            with torch.enable_grad():
                leaves = [None if t is None else t.detach().requires_grad_()
                          for t in live]
                o = gat_layer_plain(leaves[0], nbr, deg, *leaves[2:], H, ns,
                                    ctx.self_loops, leaves[1], act)
                got = iter(torch.autograd.grad(
                    o, [t for t in leaves if t is not None], ct))
            dx, dskip, dw, datt_src, datt_dst, dbias = [
                None if t is None else next(got) for t in leaves]
            return (dx, None, None, None, None, dskip, dw, datt_src,
                    datt_dst, dbias, None, None, None, None)
        # activation derivative from the saved post-activation output
        if act is None:
            dz = ct
        elif act == "relu":
            dz = ct * (out > 0.0).to(ct.dtype)
        elif act == "sigmoid":
            dz = ct * out * (1.0 - out)
        else:   # tanh
            dz = ct * (1.0 - out * out)
        dz = dz.contiguous()
        N, HC = dz.shape
        C = HC // H
        h, a_src, a_dst = _project(x, w, att_src, att_dst, H)
        dv_val, da_src_nbr, dsum, s, m, den = fused_gat_scatter_backward(
            dz, h.reshape(N, HC).contiguous(), a_src.contiguous(),
            a_dst.contiguous(), nbr, deg, H, neg_slope=ns, self_loops=True,
            rev_nbr_nodes=rev, out_degree=odeg)
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
        return (dx, None, None, None, None, dskip, dw, datt_src, datt_dst,
                dbias, None, None, None, None)


def fused_gat_layer_vjp(x, nbr_nodes, in_degree, w, att_src, att_dst, bias,
                        heads: int, neg_slope: float = 0.2,
                        self_loops: bool = True, skip=None,
                        act: Optional[str] = None, rev_nbr_nodes=None,
                        out_degree=None, mode: str = "f32"):
    """Differentiable ``fused_gat_layer``: the kernel forward and the
    backward of ``GATLayerFunction``, whose softmax backward gathers over
    the reverse table when both ``rev_nbr_nodes`` and ``out_degree`` are
    given, else over the reverse CSR of ``nbr_nodes``.  Mode "f32" only:
    the bf16 and int8 modes are inference modes and raise here (the JAX
    package's int8 straight-through backward is not ported)."""
    if mode != "f32":
        raise ValueError(f"mode {mode!r} is an inference mode: no backward")
    if rev_nbr_nodes is None or out_degree is None:
        rev_nbr_nodes = out_degree = None
    return GATLayerFunction.apply(x, nbr_nodes, in_degree, rev_nbr_nodes,
                                  out_degree, skip, w, att_src, att_dst,
                                  bias, int(heads), float(neg_slope),
                                  bool(self_loops), act)


def fused_gat_layer_auto(x, nbr_nodes, in_degree, w, att_src, att_dst, bias,
                         heads: int, neg_slope: float = 0.2,
                         self_loops: bool = True, skip=None,
                         act: Optional[str] = None, rev_nbr_nodes=None,
                         out_degree=None, mode: str = "f32", prepared=None):
    """The layer as GATConv calls it: the differentiable path when grad
    mode is on and an input needs a gradient (mode "f32" only: an
    inference mode raises there), else the kernel alone, in ``mode`` with
    ``prepared`` = ``prepare_layer(w, mode)`` (made here when None).  The
    kernel takes any width, so nothing is padded."""
    ops = [None if t is None else t.contiguous()
           for t in (x, skip, w, att_src, att_dst, bias)]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ops):
        return fused_gat_layer_vjp(
            ops[0], nbr_nodes, in_degree, *ops[2:], heads, neg_slope,
            self_loops, ops[1], act, rev_nbr_nodes, out_degree, mode=mode)
    wm, sw = ((ops[2], None) if mode == "f32" else
              prepared if prepared is not None else
              prepare_layer(ops[2], mode))
    return fused_gat_layer(ops[0], nbr_nodes, in_degree, wm, *ops[3:],
                           heads, neg_slope, self_loops, ops[1], act,
                           mode=mode, sw=sw)

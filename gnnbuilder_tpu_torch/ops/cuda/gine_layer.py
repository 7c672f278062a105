"""One GINE layer: per-slot messages ``relu(x_j + pe_e)`` summed over each
receiver's valid ELL slots, then GIN's MLP (``fused_gine_layer``), its
backward (``GINELayerFunction``) and the entry GINEConv calls
(``fused_gine_layer_auto``).

``fused_gine_layer`` launches ``csrc/gine_layer.cu`` for CUDA tensors and
runs ``gine_layer_plain``, the same function in plain torch, for CPU
tensors.  It replaces the TPU kernel ``gnnbuilder_tpu/ops/pallas/
gine_layer.py`` ``fused_gine_layer``; the plain version is that file's
``gine_layer_reference``:

    s   = sum_{w < deg} relu(x[nbr_nodes[:, w]] + pe[nbr_edges[:, w]])
    out = act(relu(((1 + eps) x + s) w0 + b0) w1 + b1 [+ skip])

``pe = lin_edge(edge_feat)`` [E, F] is formed by the caller, in the
batch's packed (receiver-sorted) edge order that ``nbr_edges`` indexes.
Pad slots are masked by in-degree: they point at pad edges, whose pe is
lin_edge's bias, not 0.  The backward recomputes the plain version, as
the JAX package's ``_make_vjp_fn`` recomputes its reference: the MLP's
gradients by torch autograd from the recomputed sum s, and the messages'
over the valid slots alone, dpe by assignment (each valid slot owns one
edge) and dx by ``index_put_(accumulate=True)`` over the senders, whose
order is fixed, so every step gives the same bits.  (Autograd of the
[N, W] gathers would accumulate every pad slot into the ghost row, one
hot spot that costs hundreds of ms on the card at b1024.)

What bounds the kernel on the H100: operations at width 128; see the
source.  Operands are in the JAX package's [in, out] layout: w0 [F, H],
b0 [H], w1 [H, Fout], b1 [Fout].

Inference modes (``mode``; the JAX kernel's ``gather_mode="bf16"`` with
``mm="bf16"``, and ``quant``; no backward): "bf16" rounds both gathered
rows, x_j and pe_e, to bf16 before ``relu(x_j + pe_e)`` (the sum stays
float32) and the MLP's operands, with bfloat16 ``w0`` / ``w1``; "int8"
quantizes both MLP products (``ops.quant.qdot``, int8 weights with
per-column scales ``s0`` / ``s1``) and keeps the aggregation exact.
``mp_layer.prepare_layer`` brings float32 weights to a mode.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.cuda.mp_layer import (
    LAYER_ACTS,
    MODES,
    prepare_layer,
    weight_dtype,
)
from gnnbuilder_tpu_torch.ops.ell import ell_gather, ell_mask
from gnnbuilder_tpu_torch.ops.quant import qdot, to_bf16

__all__ = ["fused_gine_layer", "gine_layer_plain", "GINELayerFunction",
           "fused_gine_layer_vjp", "fused_gine_layer_auto"]


def _messages(x, pe, nbr_nodes, nbr_edges, in_degree, mode="f32"):
    """(x_j + pe_e per slot [N, W, F], the valid-slot mask [N, W, 1]);
    both rows rounded to bf16 in the bf16 mode."""
    if mode == "bf16":
        x, pe = to_bf16(x), to_bf16(pe)
    pre = ell_gather(x, nbr_nodes) + ell_gather(pe, nbr_edges)
    return pre, ell_mask(nbr_nodes, in_degree)[..., None]


def _mlp(h, w0, b0, w1, b1, skip, act, mode="f32", s0=None, s1=None):
    def dot(a, w, sw):
        if mode == "int8":
            return qdot(a, w, sw)
        if mode == "bf16":
            return to_bf16(a) @ w.float()
        return a @ w

    o = dot(torch.relu(dot(h, w0, s0) + b0), w1, s1) + b1
    if skip is not None:
        o = o + skip
    return o if act is None else ACTIVATIONS[act](o)


def gine_layer_plain(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1,
                     b1, eps: float = 0.0, skip=None,
                     act: Optional[str] = None, mode: str = "f32", s0=None,
                     s1=None):
    """The layer in plain torch (``gine_layer_reference``), in ``mode``."""
    pre, m = _messages(x, pe, nbr_nodes, nbr_edges, in_degree, mode)
    s = torch.where(m, torch.relu(pre), x.new_zeros(())).sum(1)
    return _mlp((1.0 + eps) * x + s, w0, b0, w1, b1, skip, act, mode, s0,
                s1)


def _check(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1, b1, skip,
           act, mode, s0, s1):
    if act not in LAYER_ACTS:
        raise ValueError(f"unsupported GINE layer activation {act!r}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, F] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    N, F = x.shape
    if pe.dim() != 2 or pe.shape[1] != F or pe.dtype != torch.float32:
        raise ValueError(f"pe must be [E, {F}] float32, got "
                         f"{tuple(pe.shape)} {pe.dtype}")
    H, Fout = w0.shape[-1], w1.shape[-1]
    wdt = weight_dtype(mode)
    for name, t, shape in (("w0", w0, (F, H)), ("b0", b0, (H,)),
                           ("w1", w1, (H, Fout)), ("b1", b1, (Fout,)),
                           ("skip", skip, (N, Fout))):
        dt = wdt if name[0] == "w" else torch.float32
        if t is not None and (tuple(t.shape) != shape or t.dtype != dt):
            raise ValueError(f"{name} must be {shape} {dt} in mode "
                             f"{mode!r}, got {tuple(t.shape)} {t.dtype}")
    for name, t, n in (("s0", s0, H), ("s1", s1, Fout)):
        if mode != "int8":
            if t is not None:
                raise ValueError(f"mode {mode!r} takes no {name}")
        elif t is None or tuple(t.shape) != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({n},) float32 in mode 'int8'")
    for name, t in (("nbr_nodes", nbr_nodes), ("nbr_edges", nbr_edges)):
        if t is None or t.dim() != 2 or t.shape[0] != N:
            raise ValueError(f"{name} must be [{N}, W]")
    if nbr_edges.shape != nbr_nodes.shape:
        raise ValueError("nbr_edges must match nbr_nodes' shape")
    if tuple(in_degree.shape) != (N,):
        raise ValueError(f"in_degree must be [{N}]")
    devs = {t.device for t in (x, pe, nbr_nodes, nbr_edges, in_degree, w0,
                               b0, w1, b1, skip, s0, s1) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1, b1, eps,
            skip, act, mode, s0, s1):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, F = x.shape
    H, Fout = w0.shape[1], w1.shape[1]
    dev = x.device
    smem = lib.gnnb_gine_layer_smem_bytes(F, H, MODES[mode])
    smem_max = lib.gnnb_smem_per_block_optin(dev.index or 0)
    if smem > smem_max:
        raise ValueError(f"the CUDA GINE layer takes widths within "
                         f"{smem_max} bytes of shared memory; got F={F} "
                         f"H={H} ({smem} bytes)")
    if any(t.dtype != torch.int32 for t in (nbr_nodes, nbr_edges,
                                            in_degree)):
        raise ValueError("nbr_nodes, nbr_edges and in_degree must be int32")
    ops = [t for t in (x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1,
                       b1, skip, s0, s1) if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("all inputs must be contiguous")
    fn = lib.gnnb_gine_layer
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 5 + [I] * 5 + [P] * 5 + [ctypes.c_float, I, I]
                   + [P] * 4 + [I])
    out = torch.empty((N, Fout), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), pe.data_ptr(), nbr_nodes.data_ptr(),
             nbr_edges.data_ptr(), in_degree.data_ptr(), N,
             nbr_nodes.shape[1], F, H, Fout, w0.data_ptr(), b0.data_ptr(),
             w1.data_ptr(), b1.data_ptr(),
             None if skip is None else skip.data_ptr(), float(eps),
             LAYER_ACTS[act], MODES[mode],
             None if s0 is None else s0.data_ptr(),
             None if s1 is None else s1.data_ptr(), out.data_ptr(), stream,
             dev.index or 0)
    if err != 0:
        raise RuntimeError(f"gine_layer launch failed: cudaError {err}")
    fused_gine_layer.launches += 1
    fused_gine_layer.mode_launches[mode] += 1
    return out


def fused_gine_layer(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1,
                     b1, eps: float = 0.0, skip=None,
                     act: Optional[str] = None, mode: str = "f32", s0=None,
                     s1=None):
    """One GINE layer (module docstring) on x [N, F] and pe [E, F] float32
    over the ELL table ``nbr_nodes`` / ``nbr_edges`` [N, W] and
    ``in_degree`` [N] (int32), weights typed by ``mode``
    (``mp_layer.prepare_layer``).  A CUDA ``x`` launches the kernel, which
    takes any width within shared memory and raises on what it does not
    take; a CPU ``x`` runs the plain version."""
    _check(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1, b1, skip,
           act, mode, s0, s1)
    if x.device.type == "cuda":
        return _launch(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1,
                       b1, eps, skip, act, mode, s0, s1)
    if x.device.type != "cpu":
        raise ValueError(f"no GINE layer for device {x.device}")
    return gine_layer_plain(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0,
                            w1, b1, eps, skip, act, mode, s0, s1)


fused_gine_layer.launches = 0
fused_gine_layer.mode_launches = dict.fromkeys(MODES, 0)


class GINELayerFunction(torch.autograd.Function):
    """``fused_gine_layer`` with the JAX package's backward, a recompute
    of ``gine_layer_plain`` on the saved inputs (module docstring)."""

    @staticmethod
    def forward(ctx, x, pe, nbr_nodes, nbr_edges, in_degree, skip, w0, b0,
                w1, b1, eps, act):
        ctx.save_for_backward(x, pe, nbr_nodes, nbr_edges, in_degree, skip,
                              w0, b0, w1, b1)
        ctx.eps, ctx.act = eps, act
        return fused_gine_layer(x, pe, nbr_nodes, nbr_edges, in_degree, w0,
                                b0, w1, b1, eps, skip, act)

    @staticmethod
    def backward(ctx, ct):
        x, pe, nbr, nbre, deg, skip, w0, b0, w1, b1 = ctx.saved_tensors
        pre, m = _messages(x, pe, nbr, nbre, deg)
        zero = x.new_zeros(())
        s = torch.where(m, torch.relu(pre), zero).sum(1)
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_()
                      for t in ((1.0 + ctx.eps) * x + s, skip, w0, b0, w1,
                                b1)]
            h, sk, *ws = leaves
            o = _mlp(h, *ws, sk, ctx.act)
            got = iter(torch.autograd.grad(
                o, [t for t in leaves if t is not None], ct))
        dh, dskip, dw0, db0, dw1, db1 = [
            None if t is None else next(got) for t in leaves]
        # d(x_j + pe_e) per valid slot: dh of the receiver where the relu
        # passed (relu'(0) = 0, as in torch and JAX)
        valid = m[..., 0]
        dmsg = torch.where(pre > 0, dh[:, None, :], zero)[valid]
        dx = ((1.0 + ctx.eps) * dh).index_put_((nbr[valid].long(),), dmsg,
                                               accumulate=True)
        dpe = torch.zeros_like(pe).index_put_((nbre[valid].long(),), dmsg)
        return (dx, dpe, None, None, None, dskip, dw0, db0, dw1, db1, None,
                None)


def fused_gine_layer_vjp(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1,
                         b1, eps: float = 0.0, skip=None,
                         act: Optional[str] = None, mode: str = "f32"):
    """Differentiable ``fused_gine_layer``: the kernel forward and the
    plain-recompute backward.  Mode "f32" only: the bf16 and int8 modes
    are inference modes and raise here."""
    if mode != "f32":
        raise ValueError(f"mode {mode!r} is an inference mode: no backward")
    return GINELayerFunction.apply(x, pe, nbr_nodes, nbr_edges, in_degree,
                                   skip, w0, b0, w1, b1, float(eps), act)


def fused_gine_layer_auto(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0,
                          w1, b1, eps: float = 0.0, skip=None,
                          act: Optional[str] = None, mode: str = "f32"):
    """The layer as GINEConv calls it: the differentiable path when grad
    mode is on and an input needs a gradient (mode "f32" only), else the
    kernel alone, with float32 weights brought to ``mode`` here.  The
    kernel takes any width, so nothing is padded."""
    ops = [None if t is None else t.contiguous()
           for t in (x, pe, skip, w0, b0, w1, b1)]
    x, pe, skip, w0, b0, w1, b1 = ops
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ops):
        return fused_gine_layer_vjp(x, pe, nbr_nodes, nbr_edges, in_degree,
                                    w0, b0, w1, b1, eps, skip, act, mode)
    if mode == "f32":
        return fused_gine_layer(x, pe, nbr_nodes, nbr_edges, in_degree, w0,
                                b0, w1, b1, eps, skip, act)
    w0, w1, s0, s1 = prepare_layer(w0, w1, mode)
    return fused_gine_layer(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0,
                            w1, b1, eps, skip, act, mode=mode, s0=s0, s1=s1)

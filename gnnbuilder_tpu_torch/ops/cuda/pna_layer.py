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
out-degree over 64) takes ``fused_pna_scatter_backward``, whose atomic
adds make dv reproducible to f32 rounding only.

What bounds the kernel on the H100: operations (the five products, ~0.5
MFLOP per row at 128 wide, run as f32 FMAs); see the source.

Weights use the JAX package's [in, out] layout: ``w_pre`` [2Fin, F]
(receiver rows first), ``k_post`` [Fin + 12F, Fout] (self rows, then the
identity, amplification and attenuation groups of max|min|mean|std
blocks), ``w_lin`` [Fout, Fout].
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.cuda.ell_bwd import fused_gather_backward
from gnnbuilder_tpu_torch.ops.cuda.scatter_bwd import (
    fused_pna_scatter_backward,
    fused_pna_scatter_cstk,
)
from gnnbuilder_tpu_torch.ops.ell import _STD_EPS, ell_mask

__all__ = ["fused_pna_layer", "pna_layer_plain", "PNALayerFunction",
           "fused_pna_layer_vjp", "fused_pna_layer_auto", "pad_operands",
           "scaler_blocks", "LAYER_ACTS"]

# epilogue activations the kernel takes, with their codes in the source
LAYER_ACTS = {None: 0, "relu": 1, "gelu": 2, "sigmoid": 3, "tanh": 4}
# the TPU kernel's finite -inf: the extrema of an empty row in aux
_BIG = 3e38


def _act(name):
    return (lambda t: t) if name is None else ACTIVATIONS[name]


def scaler_blocks(k_post, Fin, F):
    """The scaler blocks of k_post side by side: [4F, 3Fout]."""
    return torch.cat([k_post[Fin + i * 4 * F: Fin + (i + 1) * 4 * F]
                      for i in range(3)], dim=1)


def pna_layer_plain(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post,
                    w_lin, b_lin, delta, skip=None, act=None,
                    save_res=False):
    """The layer in plain torch, with the kernel's arithmetic: u comes
    outside the reduce and the extrema start from -+3e38."""
    Fin = x.shape[1]
    F = w_pre.shape[1]
    Fout = w_lin.shape[1]
    u = x @ w_pre[:Fin] + b_pre
    v = x @ w_pre[Fin:]
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
    y = agg_cat @ scaler_blocks(k_post, Fin, F)
    log_deg = torch.log(denom + 1.0)
    mid = (x @ k_post[:Fin] + b_post + y[:, :Fout]
           + (log_deg / delta) * y[:, Fout:2 * Fout]
           + (delta / log_deg) * y[:, 2 * Fout:])
    o = mid @ w_lin + b_lin
    if skip is not None:
        o = o + skip
    out = _act(act)(o)
    if not save_res:
        return out
    ties_mx = (m & (g == mx[:, None, :])).sum(1).to(x.dtype)
    ties_mn = (m & (g == mn[:, None, :])).sum(1).to(x.dtype)
    aux = torch.cat([mx, mn, mean, ties_mx, ties_mn], dim=1)
    return out, v, agg_cat, aux, mid


def _check(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post, w_lin,
           b_lin, skip, act):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, Fin] float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    N, Fin = x.shape
    F = w_pre.shape[1]
    Fout = w_lin.shape[1]
    shapes = {"w_pre": (w_pre, (2 * Fin, F)), "b_pre": (b_pre, (F,)),
              "k_post": (k_post, (Fin + 12 * F, Fout)),
              "b_post": (b_post, (Fout,)), "w_lin": (w_lin, (Fout, Fout)),
              "b_lin": (b_lin, (Fout,))}
    if skip is not None:
        shapes["skip"] = (skip, (N, Fout))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if nbr_nodes.dim() != 2 or nbr_nodes.shape[0] != N:
        raise ValueError("nbr_nodes must be [N, W]")
    if tuple(in_degree.shape) != (N,):
        raise ValueError("in_degree must be [N]")
    if act not in LAYER_ACTS:
        raise ValueError(f"unsupported layer activation {act!r}")
    tensors = [x, nbr_nodes, in_degree] + [t for t, _ in shapes.values()]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post, w_lin,
            b_lin, delta, skip, act, save_res):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, Fin = x.shape
    F = w_pre.shape[1]
    Fout = w_lin.shape[1]
    mult = lib.gnnb_pna_layer_width_multiple()
    smem = lib.gnnb_pna_layer_smem_bytes(Fin, F, Fout)
    smem_max = lib.gnnb_smem_per_block_optin(x.device.index or 0)
    if any(d % mult or d < mult for d in (Fin, F, Fout)) or smem > smem_max:
        raise ValueError(
            f"the CUDA PNA layer takes widths that are multiples of {mult} "
            f"within {smem_max} bytes of shared memory; got Fin={Fin} F={F} "
            f"Fout={Fout} ({smem} bytes)")
    if nbr_nodes.dtype != torch.int32 or in_degree.dtype != torch.int32:
        raise ValueError("nbr_nodes and in_degree must be int32")
    tensors = [x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post, w_lin,
               b_lin] + ([skip] if skip is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")
    fn = lib.gnnb_pna_layer
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 3 + [I] * 5 + [P] * 7
                   + [ctypes.c_float, I] + [P] * 5 + [P, I])
    f32 = dict(dtype=torch.float32, device=x.device)
    out = torch.empty((N, Fout), **f32)
    v = torch.empty((N, F), **f32)
    res = ((torch.empty((N, 4 * F), **f32), torch.empty((N, 5 * F), **f32),
            torch.empty((N, Fout), **f32)) if save_res else (None,) * 3)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = fn(x.data_ptr(), nbr_nodes.data_ptr(), in_degree.data_ptr(), N,
             nbr_nodes.shape[1], Fin, F, Fout, w_pre.data_ptr(),
             b_pre.data_ptr(), k_post.data_ptr(), b_post.data_ptr(),
             w_lin.data_ptr(), b_lin.data_ptr(), ptr(skip), float(delta),
             LAYER_ACTS[act], out.data_ptr(), v.data_ptr(),
             *[ptr(t) for t in res], stream, x.device.index or 0)
    if err != 0:
        raise RuntimeError(f"pna_layer launch failed: cudaError {err}")
    fused_pna_layer.launches += 1
    return (out, v, *res) if save_res else out


def fused_pna_layer(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post,
                    w_lin, b_lin, delta: float, skip=None,
                    act: Optional[str] = None, save_res: bool = False):
    """One PNA layer.  x [N, Fin] float32; nbr_nodes [N, W] and in_degree
    [N] int32; weights as in the module docstring; skip [N, Fout] or None,
    added before ``act``.  Returns out [N, Fout], or with ``save_res`` the
    tuple (out, v [N, F], agg_cat [N, 4F], aux [N, 5F], mid [N, Fout]).  A
    CUDA ``x`` launches the kernel, which takes widths that are multiples
    of 128 and raises on others; a CPU ``x`` runs the plain version."""
    _check(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post, w_lin,
           b_lin, skip, act)
    if x.device.type == "cuda":
        return _launch(x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post,
                       w_lin, b_lin, delta, skip, act, save_res)
    if x.device.type != "cpu":
        raise ValueError(f"no PNA layer for device {x.device}")
    return pna_layer_plain(x, nbr_nodes, in_degree, w_pre, b_pre, k_post,
                           b_post, w_lin, b_lin, delta, skip, act, save_res)


fused_pna_layer.launches = 0


class PNALayerFunction(torch.autograd.Function):
    """``fused_pna_layer`` with the JAX package's hand-written backward
    (``pna_layer.py`` ``_make_vjp_fn``, its scatter-kernel branch): the
    forward saves (v, agg_cat, aux, mid, out); the backward forms act'
    from the saved out, the epilogue gradients from mid with torch
    products, du through ``sel``, dv over the reverse table
    (``fused_pna_scatter_cstk`` then ``fused_gather_backward``) or, when
    ``rev_nbr_nodes`` is None, with ``fused_pna_scatter_backward``; then
    the pre_nn chains."""

    @staticmethod
    def forward(ctx, x, nbr_nodes, in_degree, rev_nbr_nodes, out_degree,
                skip, w_pre, b_pre, k_post, b_post, w_lin, b_lin, delta,
                act):
        args = [t.contiguous() for t in (x, w_pre, b_pre, k_post, b_post,
                                         w_lin, b_lin)]
        skip = None if skip is None else skip.contiguous()
        x, w_pre, b_pre, k_post, b_post, w_lin, b_lin = args
        out, v, agg_cat, aux, mid = fused_pna_layer(
            x, nbr_nodes, in_degree, w_pre, b_pre, k_post, b_post, w_lin,
            b_lin, delta, skip=skip, act=act, save_res=True)
        ctx.save_for_backward(x, nbr_nodes, in_degree, rev_nbr_nodes,
                              out_degree, skip, w_pre, k_post, w_lin, b_lin,
                              v, agg_cat, aux, mid, out)
        ctx.delta = float(delta)
        ctx.act = act
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
            cstk = fused_pna_scatter_cstk(d_mid, aux, agg_cat, deg, ks_t,
                                          delta)
            dv = fused_gather_backward(cstk, rev, out_deg, v, has_lin=True,
                                       has_dev=True, n_cmp=2)
        else:
            dv = fused_pna_scatter_backward(d_mid, aux, agg_cat, deg, nbr,
                                            v, ks_t, delta)

        # pre_nn chains: u = x w_i + b_pre (receiver), v = x w_j
        w_i, w_j = w_pre[:Fin], w_pre[Fin:]
        dx = dx_epi + du @ w_i.t() + dv @ w_j.t()
        dw_pre = torch.cat([x.t() @ du, x.t() @ dv], dim=0)
        db_pre = du.sum(0)
        return (dx, None, None, None, None, dskip, dw_pre, db_pre, dk_post,
                db_post, dw_lin, db_lin, None, None)


def fused_pna_layer_vjp(x, nbr_nodes, in_degree, w_pre, b_pre, k_post,
                        b_post, w_lin, b_lin, delta: float, skip=None,
                        act: Optional[str] = None, rev_nbr_nodes=None,
                        out_degree=None):
    """Differentiable ``fused_pna_layer``: the kernel forward with
    residuals and the hand-written backward, whose dv runs over the
    reverse table when both ``rev_nbr_nodes`` and ``out_degree`` are
    given."""
    if rev_nbr_nodes is None or out_degree is None:
        rev_nbr_nodes = out_degree = None
    return PNALayerFunction.apply(x, nbr_nodes, in_degree, rev_nbr_nodes,
                                  out_degree, skip, w_pre, b_pre, k_post,
                                  b_post, w_lin, b_lin, float(delta), act)


def _rup(n: int, m: int = 128) -> int:
    return ((n + m - 1) // m) * m


def _pad(a, rows=None, cols=None):
    """Zero-pad a 1-D tensor to ``rows`` or a 2-D one to [rows, cols]."""
    if a.dim() == 1:
        return torch.nn.functional.pad(a, (0, rows - a.shape[0]))
    return torch.nn.functional.pad(a, (0, cols - a.shape[1],
                                       0, rows - a.shape[0]))


def pad_operands(x, w_pre, b_pre, k_post, b_post, w_lin, b_lin, skip=None):
    """Zero-pad Fin, F and Fout to multiples of 128 (differentiable ops,
    so autograd slices gradients back).  Pad lanes are inert: zero x lanes
    give zero v lanes, aggregate pad lanes meet zero rows of the padded
    k_post, and the caller slices the pad output columns off.  Returns the
    eight operands in the same order."""
    Fin = x.shape[1]
    F = w_pre.shape[1]
    Fout = w_lin.shape[1]
    Fin_p, F_p, Fout_p = _rup(Fin), _rup(F), _rup(Fout)
    if (Fin_p, F_p, Fout_p) == (Fin, F, Fout):
        return x, w_pre, b_pre, k_post, b_post, w_lin, b_lin, skip
    blocks = [_pad(k_post[:Fin], Fin_p, Fout)] + [
        _pad(k_post[Fin + i * F: Fin + (i + 1) * F], F_p, Fout)
        for i in range(12)]
    return (_pad(x, x.shape[0], Fin_p),
            torch.cat([_pad(w_pre[:Fin], Fin_p, F_p),
                       _pad(w_pre[Fin:], Fin_p, F_p)], dim=0),
            _pad(b_pre, F_p),
            _pad(torch.cat(blocks, dim=0), Fin_p + 12 * F_p, Fout_p),
            _pad(b_post, Fout_p), _pad(w_lin, Fout_p, Fout_p),
            _pad(b_lin, Fout_p),
            None if skip is None else _pad(skip, skip.shape[0], Fout_p))


def fused_pna_layer_auto(x, nbr_nodes, in_degree, w_pre, b_pre, k_post,
                         b_post, w_lin, b_lin, delta: float, skip=None,
                         act: Optional[str] = None, rev_nbr_nodes=None,
                         out_degree=None):
    """The layer at any widths: ``pad_operands`` outside the autograd
    Function, then the first Fout columns of the result.  Takes the
    differentiable path when grad mode is on and an input needs a
    gradient, else the kernel without residuals."""
    Fout = w_lin.shape[1]
    ops = pad_operands(x, w_pre, b_pre, k_post, b_post, w_lin, b_lin, skip)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ops):
        out = fused_pna_layer_vjp(ops[0], nbr_nodes, in_degree, *ops[1:7],
                                  delta, skip=ops[7], act=act,
                                  rev_nbr_nodes=rev_nbr_nodes,
                                  out_degree=out_degree)
    else:
        c = [None if t is None else t.contiguous() for t in ops]
        out = fused_pna_layer(c[0], nbr_nodes, in_degree, *c[1:7], delta,
                              skip=c[7], act=act)
    return out if out.shape[1] == Fout else out[:, :Fout]

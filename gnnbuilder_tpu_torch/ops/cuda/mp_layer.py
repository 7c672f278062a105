"""One GIN, SAGE, GCN, LG or Simple conv layer: the neighbour sum and the
conv's epilogue (``fused_mp_layer``), its backward (``MPLayerFunction``)
and the entry the convs call (``fused_mp_layer_auto``).

``fused_mp_layer`` launches ``csrc/mp_layer.cu`` for CUDA tensors and runs
``mp_layer_plain``, the same function in plain torch, for CPU tensors.  It
replaces the TPU kernel ``gnnbuilder_tpu/ops/pallas/mp_layer.py``
``fused_mp_layer`` in both of its modes: over the ELL table (``_kernel``)
and over the block adjacency ``block_adj`` (``_block_kernel``).  The plain
version is that file's ``mp_layer_reference`` with a block variant through
``ops.block.block_spmm``.

The backward follows that file's ``_make_vjp_fn``: the forward saves the
aggregate s, the epilogue's gradients come from it in torch (as
``_epilogue_and_grads``), and ds becomes dv on one of three routes: on a
block batch the transposed block product (``torch.bmm``, which the JAX
package also leaves outside its kernels); with the batch's reverse table
``ops.cuda.ell_bwd.fused_gather_backward`` (lin-only); without one the
same gather over ``ops.ell.reverse_csr`` of the forward table (where the
JAX package runs XLA's VJP of its reference).  Every route gives the same
bits on every run.

What bounds the kernel on the H100: bytes for gcn, lg and simple,
operations for gin and sage at width 128; see the source.

Operands per conv (the JAX package's [in, out] layout): gin ``w0`` [F, H],
``b0`` [H], ``w1`` [H, Fout], ``b1`` [Fout]; sage ``w0`` [F, Fout] (lin_l),
``b0`` [Fout], ``w1`` [F, Fout] (lin_r); gcn ``b0`` [F] with v = lin(x) *
rsqrt(deg + 1) formed by the caller; lg (v pre-scaled by the caller) and
simple none.  gcn, lg and simple keep the width: Fout = F.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.block import block_spmm
from gnnbuilder_tpu_torch.ops.cuda.ell_bwd import (
    fused_gather_backward,
    fused_gather_backward_csr,
)
from gnnbuilder_tpu_torch.ops.ell import ell_sum, reverse_csr

__all__ = ["fused_mp_layer", "mp_layer_plain", "MPLayerFunction",
           "fused_mp_layer_vjp", "fused_mp_layer_auto", "MP_CONVS",
           "LAYER_ACTS"]

# the convs the kernel takes, with their codes in the source
MP_CONVS = {"gin": 0, "sage": 1, "gcn": 2, "lg": 3, "simple_sum": 4,
            "simple_mean": 5}
# epilogue activations the kernel takes, with their codes in the source
# (also the GINE and EdgeConv kernels' codes: dense_rows.cuh act_fn)
LAYER_ACTS = {None: 0, "relu": 1, "gelu": 2, "sigmoid": 3, "tanh": 4}
# the operands each conv takes, in the order (w0, b0, w1, b1)
_OPERANDS = {"gin": (True, True, True, True),
             "sage": (True, True, True, False),
             "gcn": (False, True, False, False),
             "lg": (False,) * 4, "simple_sum": (False,) * 4,
             "simple_mean": (False,) * 4}


def _epilogue(conv, s, v, in_degree, w0, b0, w1, b1, eps, skip, act):
    """The conv's epilogue on the aggregate s (``_mp_epilogue``), then the
    skip and the activation."""
    degf = in_degree.to(v.dtype)[:, None]
    if conv == "gin":
        o = torch.relu(((1.0 + eps) * v + s) @ w0 + b0) @ w1 + b1
    elif conv == "sage":
        o = (s / degf.clamp(min=1.0)) @ w0 + b0 + v @ w1
    elif conv == "gcn":
        o = torch.rsqrt(degf + 1.0) * (s + v) + b0
    elif conv == "lg":
        dis = torch.where(degf > 0, torch.rsqrt(degf.clamp(min=1.0)),
                          v.new_zeros(()))
        o = dis * s
    elif conv == "simple_sum":
        o = s
    else:
        o = s / degf.clamp(min=1.0)
    if skip is not None:
        o = o + skip
    return o if act is None else ACTIVATIONS[act](o)


def mp_layer_plain(v, nbr_nodes, in_degree, conv, w0=None, b0=None, w1=None,
                   b1=None, eps=0.0, skip=None, act=None, save_s=False,
                   block_adj=None):
    """The layer in plain torch: s over the ELL table (``block_adj`` None)
    or the block product, then the epilogue.  Returns out, or (out, s)
    with ``save_s``."""
    if block_adj is not None:
        s = block_spmm(block_adj, v)
    else:
        s = ell_sum(v, nbr_nodes, in_degree)
    out = _epilogue(conv, s, v, in_degree, w0, b0, w1, b1, eps, skip, act)
    return (out, s) if save_s else out


def _out_width(conv, v, w0, w1):
    if conv == "gin":
        return w1.shape[1]
    if conv == "sage":
        return w0.shape[1]
    return v.shape[1]


def _check(v, nbr_nodes, in_degree, conv, w0, b0, w1, b1, skip, act,
           block_adj):
    if conv not in MP_CONVS:
        raise ValueError(f"unsupported mp layer conv {conv!r}; options: "
                         f"{sorted(MP_CONVS)}")
    if act not in LAYER_ACTS:
        raise ValueError(f"unsupported mp layer activation {act!r}")
    if v.dim() != 2 or v.dtype != torch.float32:
        raise ValueError(f"v must be [N, F] float32, got {tuple(v.shape)} "
                         f"{v.dtype}")
    N, F = v.shape
    given = tuple(t is not None for t in (w0, b0, w1, b1))
    if given != _OPERANDS[conv]:
        raise ValueError(f"{conv} takes (w0, b0, w1, b1) = "
                         f"{_OPERANDS[conv]} (True = given), got {given}")
    Fout = _out_width(conv, v, w0, w1)
    H = w0.shape[1] if conv == "gin" else Fout
    shapes = {"gin": ((F, H), (H,), (H, Fout), (Fout,)),
              "sage": ((F, Fout), (Fout,), (F, Fout), None),
              "gcn": (None, (F,), None, None)}.get(conv, (None,) * 4)
    for name, t, shape in zip(("w0", "b0", "w1", "b1"), (w0, b0, w1, b1),
                              shapes):
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype != torch.float32):
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if skip is not None and (tuple(skip.shape) != (N, Fout)
                             or skip.dtype != torch.float32):
        raise ValueError(f"skip must be ({N}, {Fout}) float32")
    if tuple(in_degree.shape) != (N,):
        raise ValueError("in_degree must be [N]")
    if block_adj is not None:
        if (block_adj.dim() != 3 or block_adj.shape[1] != block_adj.shape[2]
                or block_adj.shape[0] * block_adj.shape[1] != N):
            raise ValueError(f"block_adj must be [N / B, B, B] with N={N}")
    elif nbr_nodes is None or nbr_nodes.dim() != 2 \
            or nbr_nodes.shape[0] != N:
        raise ValueError("nbr_nodes must be [N, W] (or pass block_adj)")
    devs = {t.device for t in (v, nbr_nodes, in_degree, w0, b0, w1, b1,
                               skip, block_adj) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(v, nbr_nodes, in_degree, conv, w0, b0, w1, b1, eps, skip, act,
            save_s, block_adj):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, F = v.shape
    Fout = _out_width(conv, v, w0, w1)
    H = w0.shape[1] if conv == "gin" else 0
    dev = v.device
    block = block_adj is not None
    rows = lib.gnnb_mp_layer_block_rows()
    if block and (block_adj.shape[1] != rows
                  or block_adj.dtype != torch.float32):
        raise ValueError(f"the CUDA mp layer takes float32 blocks of {rows} "
                         f"rows; got {tuple(block_adj.shape)} "
                         f"{block_adj.dtype}")
    if conv in ("gin", "sage"):
        smem = lib.gnnb_mp_layer_smem_bytes(F, H, int(block))
        smem_max = lib.gnnb_smem_per_block_optin(dev.index or 0)
        if smem > smem_max:
            raise ValueError(
                f"the CUDA mp layer takes gin / sage widths within "
                f"{smem_max} bytes of shared memory; got F={F} H={H} "
                f"({smem} bytes)")
    table = None if block else nbr_nodes
    if in_degree.dtype != torch.int32 or (
            table is not None and table.dtype != torch.int32):
        raise ValueError("nbr_nodes and in_degree must be int32")
    tensors = [t for t in (v, table, block_adj, in_degree, w0, b0, w1, b1,
                           skip) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if block and block_adj.data_ptr() % 16:
        raise ValueError("block_adj must be 16-byte aligned")
    fn = lib.gnnb_mp_layer
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 4 + [I] * 5 + [P] * 5 + [I, ctypes.c_float, I, P, P,
                                                   P, I]
    out = torch.empty((N, Fout), dtype=torch.float32, device=dev)
    s = torch.empty_like(v) if save_s else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(v.data_ptr(), ptr(table), ptr(block_adj), in_degree.data_ptr(),
             N, 0 if block else table.shape[1], F, H, Fout, ptr(w0), ptr(b0),
             ptr(w1), ptr(b1), ptr(skip), MP_CONVS[conv], float(eps),
             LAYER_ACTS[act], out.data_ptr(), ptr(s), stream, dev.index or 0)
    if err != 0:
        raise RuntimeError(f"mp_layer launch failed: cudaError {err}")
    fused_mp_layer.launches += 1
    return (out, s) if save_s else out


def fused_mp_layer(v, nbr_nodes, in_degree, conv: str, w0=None, b0=None,
                   w1=None, b1=None, eps: float = 0.0, skip=None,
                   act: Optional[str] = None, save_s: bool = False,
                   block_adj=None):
    """One conv layer ``conv`` (``MP_CONVS``) on v [N, F] float32 over the
    ELL table ``nbr_nodes`` [N, W] / ``in_degree`` [N] int32, or over
    ``block_adj`` [N / 128, 128, 128] float32 counts when it is given,
    with the conv's operands (module docstring), an optional skip [N,
    Fout] added before the activation ``act``.  Returns out [N, Fout], or
    (out, s) with ``save_s``, s [N, F] the neighbour sum.  A CUDA ``v``
    launches the kernel, which takes any width within shared memory and
    raises on what it does not take; a CPU ``v`` runs the plain
    version."""
    _check(v, nbr_nodes, in_degree, conv, w0, b0, w1, b1, skip, act,
           block_adj)
    if v.device.type == "cuda":
        return _launch(v, nbr_nodes, in_degree, conv, w0, b0, w1, b1, eps,
                       skip, act, save_s, block_adj)
    if v.device.type != "cpu":
        raise ValueError(f"no mp layer for device {v.device}")
    return mp_layer_plain(v, nbr_nodes, in_degree, conv, w0, b0, w1, b1, eps,
                          skip, act, save_s, block_adj)


fused_mp_layer.launches = 0


class MPLayerFunction(torch.autograd.Function):
    """``fused_mp_layer`` with the JAX package's hand-written backward
    (``mp_layer.py`` ``_make_vjp_fn``): the forward saves s; the backward
    takes the epilogue's gradients from s in torch, then dv = dv_self +
    the transpose of the aggregation applied to ds (module docstring)."""

    @staticmethod
    def forward(ctx, v, nbr_nodes, in_degree, rev_nbr_nodes, out_degree,
                block_adj, skip, w0, b0, w1, b1, conv, eps, act):
        out, s = fused_mp_layer(v, nbr_nodes, in_degree, conv, w0, b0, w1,
                                b1, eps, skip=skip, act=act, save_s=True,
                                block_adj=block_adj)
        ctx.save_for_backward(v, s, nbr_nodes, in_degree, rev_nbr_nodes,
                              out_degree, block_adj, skip, w0, b0, w1, b1)
        ctx.conv, ctx.eps, ctx.act = conv, float(eps), act
        return out

    @staticmethod
    def backward(ctx, ct):
        (v, s, nbr, deg, rev, out_deg, badj, skip, w0, b0, w1,
         b1) = ctx.saved_tensors
        live = [v, s, skip, w0, b0, w1, b1]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_()
                      for t in live]
            o = _epilogue(ctx.conv, leaves[1], leaves[0], deg, *leaves[3:],
                          ctx.eps, leaves[2], ctx.act)
            # v is no input of the lg and simple epilogues
            got = torch.autograd.grad(
                o, [t for t in leaves if t is not None], ct,
                allow_unused=True)
        grads = iter(got)
        dv_self, ds, dskip, dw0, db0, dw1, db1 = [
            None if t is None else next(grads) for t in leaves]
        ds = ds.contiguous()
        if badj is not None:
            dv_agg = block_spmm(badj, ds, transpose=True)
        elif rev is not None:
            dv_agg = fused_gather_backward(ds, rev, out_deg, has_lin=True)
        else:
            rev_ptr, rev_idx = reverse_csr(nbr, deg)
            dv_agg = fused_gather_backward_csr(ds, rev_ptr, rev_idx,
                                               has_lin=True)
        dv = dv_agg if dv_self is None else dv_self + dv_agg
        return (dv, None, None, None, None, None, dskip, dw0, db0, dw1, db1,
                None, None, None)


def fused_mp_layer_vjp(v, nbr_nodes, in_degree, conv: str, w0=None, b0=None,
                       w1=None, b1=None, eps: float = 0.0, skip=None,
                       rev_nbr_nodes=None, out_degree=None,
                       act: Optional[str] = None, block_adj=None):
    """Differentiable ``fused_mp_layer``: the kernel forward with s saved
    and the hand-written backward, whose dv runs over ``block_adj`` when
    given, else over the reverse table when both ``rev_nbr_nodes`` and
    ``out_degree`` are given, else over the reverse CSR of
    ``nbr_nodes``."""
    if block_adj is not None or rev_nbr_nodes is None or out_degree is None:
        rev_nbr_nodes = out_degree = None
    return MPLayerFunction.apply(v, nbr_nodes, in_degree, rev_nbr_nodes,
                                 out_degree, block_adj, skip, w0, b0, w1, b1,
                                 conv, float(eps), act)


def fused_mp_layer_auto(v, nbr_nodes, in_degree, conv: str, w0=None,
                        b0=None, w1=None, b1=None, eps: float = 0.0,
                        skip=None, rev_nbr_nodes=None, out_degree=None,
                        act: Optional[str] = None, block_adj=None):
    """The layer as a conv calls it: the differentiable path when grad
    mode is on and an input needs a gradient, else the kernel without
    s.  The kernel takes any width, so nothing is padded."""
    ops = [None if t is None else t.contiguous()
           for t in (v, skip, w0, b0, w1, b1)]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ops):
        return fused_mp_layer_vjp(ops[0], nbr_nodes, in_degree, conv,
                                  *ops[2:], eps=eps, skip=ops[1],
                                  rev_nbr_nodes=rev_nbr_nodes,
                                  out_degree=out_degree, act=act,
                                  block_adj=block_adj)
    return fused_mp_layer(ops[0], nbr_nodes, in_degree, conv, *ops[2:],
                          eps=eps, skip=ops[1], act=act, block_adj=block_adj)

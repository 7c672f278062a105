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

What bounds the kernel on the H100: bytes, for gcn, lg and simple and,
since gin's and sage's products run on the tensor cores (3 x TF32,
bf16, s8 ``mma.sync`` on the caller's weights as they are), for gin and
sage at width 128 too; see the source.  The plain version's float32
products go through ``_f32_dot``, the seam through which the CPU tests
put the kernel's chain order; sage's two are one product of [mean | v]
with [w0; w1] there, as the kernel chains them.

Operands per conv (the JAX package's [in, out] layout): gin ``w0`` [F, H],
``b0`` [H], ``w1`` [H, Fout], ``b1`` [Fout]; sage ``w0`` [F, Fout] (lin_l),
``b0`` [Fout], ``w1`` [F, Fout] (lin_r); gcn ``b0`` [F] with v = lin(x) *
rsqrt(deg + 1) formed by the caller; lg (v pre-scaled by the caller) and
simple none.  gcn, lg and simple keep the width: Fout = F.

Modes (``mode``; the JAX kernel's ``gather_mode="bf16"`` with
``mm="bf16"``, and ``quant``): "bf16" rounds
each gathered v to bf16 (the sum stays float32) and, for gin and sage,
the products' operands, with bfloat16 ``w0`` / ``w1`` (gin's first
product, whose result is rounded to bf16 next, a float64 product rounded
once in both the kernel and the plain version); "int8" (gin and
sage only, as in the JAX kernel) quantizes every epilogue product
(``ops.quant.qdot``: per-row scales, int8 ``w0`` / ``w1`` with column
scales ``s0`` / ``s1``, an exact sum) and keeps the aggregation exact.
``prepare_layer`` brings float32 weights to a mode.  Every mode writes s
with ``save_s`` (the sum of the mode's gathered v: of bf16-rounded rows
in "bf16", as the JAX kernel saves it), and ``MPLayerFunction`` takes a
mode: the kernel forward in it, the float32 epilogue's gradients on that
s with the float32 weights (the JAX VJP's; for "int8" its
straight-through estimator), then dv as above (on a block batch under
"bf16" the transposed product rounds ds to bf16, as the JAX backward's
``block_spmm(mm="bf16")``).  Its plain twin (``plain=True``) runs
``mp_layer_plain`` forward and row 7's plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.block import block_spmm
from gnnbuilder_tpu_torch.ops.cuda.ell_bwd import (
    ell_gather_backward_csr_plain,
    ell_gather_backward_plain,
    fused_gather_backward,
    fused_gather_backward_csr,
)
from gnnbuilder_tpu_torch.ops.ell import ell_sum, reverse_csr
from gnnbuilder_tpu_torch.ops.quant import qdot, quantize_weight, to_bf16

__all__ = ["fused_mp_layer", "mp_layer_plain", "MPLayerFunction",
           "fused_mp_layer_vjp", "fused_mp_layer_auto", "prepare_layer",
           "mp_layer_ew_ordered", "weight_dtype", "MP_CONVS", "LAYER_ACTS",
           "MODES", "QUANT_CONVS", "EW_CONVS", "BLOCK_ROWS"]

# the convs the kernel takes, with their codes in the source
MP_CONVS = {"gin": 0, "sage": 1, "gcn": 2, "lg": 3, "simple_sum": 4,
            "simple_mean": 5}
# epilogue activations the kernel takes, with their codes in the source
# (also the GINE and EdgeConv kernels' codes: dense_rows.cuh act_fn)
LAYER_ACTS = {None: 0, "relu": 1, "gelu": 2, "sigmoid": 3, "tanh": 4}
# kernel modes, with their codes in the source
MODES = {"f32": 0, "bf16": 1, "int8": 2}
# the convs with an int8 mode: the others run no product to quantize
QUANT_CONVS = ("gin", "sage")
# the rows of one block the block mode takes (``csrc/mp_layer.cu``
# ``gnnb_mp_layer_block_rows``), for the gate, which loads no library: a
# batch packed at another block size takes the ELL mode
# (``dispatch.mp_layer_cfg``)
BLOCK_ROWS = 128
# the operands each conv takes, in the order (w0, b0, w1, b1)
_OPERANDS = {"gin": (True, True, True, True),
             "sage": (True, True, True, False),
             "gcn": (False, True, False, False),
             "lg": (False,) * 4, "simple_sum": (False,) * 4,
             "simple_mean": (False,) * 4}


def weight_dtype(mode):
    """The dtype of the product weights a kernel takes in ``mode``."""
    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[mode]


def prepare_layer(w0, w1, mode: str):
    """(w0, w1, s0, s1) as ``mode`` takes them: "bf16" rounds w0 and w1
    to bfloat16; "int8" quantizes each with per-column scales s0, s1
    (``ops.quant.quantize_weight``, the JAX wrapper's); the scales are
    None in the other modes, and so is a weight the conv lacks."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    if mode == "f32":
        return w0, w1, None, None
    if mode == "bf16":
        return tuple(None if w is None else w.to(torch.bfloat16)
                     for w in (w0, w1)) + (None, None)
    (q0, s0), (q1, s1) = (quantize_weight(w.contiguous()) for w in (w0, w1))
    return q0, q1, s0, s1


def _f32_dot(a, w):
    """The f32 mode's product in the plain version."""
    return a @ w


def _epilogue(conv, s, v, in_degree, w0, b0, w1, b1, eps, skip, act,
              mode="f32", s0=None, s1=None):
    """The conv's epilogue on the aggregate s (``_mp_epilogue``), then the
    skip and the activation; gin's and sage's products in ``mode``."""
    degf = in_degree.to(v.dtype)[:, None]

    def dot(a, w, sw):
        if mode == "int8":
            return qdot(a, w, sw)
        if mode == "bf16":
            return to_bf16(a) @ w.float()
        return _f32_dot(a, w)

    if conv == "gin":
        t = (1.0 + eps) * v + s
        # bf16: Z is rounded to bf16 next, so T W0 is the float64 product
        # rounded once, as the kernel forms it (any float32 order flips a
        # bf16 rounding now and then)
        z = ((to_bf16(t).double() @ w0.double()).float() if mode == "bf16"
             else dot(t, w0, s0))
        o = dot(torch.relu(z + b0), w1, s1) + b1
    elif conv == "sage" and mode == "f32":
        o = _f32_dot(torch.cat([s / degf.clamp(min=1.0), v], 1),
                     torch.cat([w0, w1], 0)) + b0
    elif conv == "sage":
        o = dot(s / degf.clamp(min=1.0), w0, s0) + b0 + dot(v, w1, s1)
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
                   block_adj=None, mode: str = "f32", s0=None, s1=None):
    """The layer in plain torch: s over the ELL table (``block_adj`` None)
    or the block product, then the epilogue, in ``mode`` (the bf16 mode
    sums bf16-rounded v).  Returns out, or (out, s) with ``save_s``."""
    src = to_bf16(v) if mode == "bf16" else v
    if block_adj is not None:
        s = block_spmm(block_adj, src)
    else:
        s = ell_sum(src, nbr_nodes, in_degree)
    out = _epilogue(conv, s, v, in_degree, w0, b0, w1, b1, eps, skip, act,
                    mode, s0, s1)
    return (out, s) if save_s else out


def _ieee(op, a, b=None):
    """sqrt(a) or a / b as the IEEE float32 operation rounds it: formed in
    float64 and rounded once (53 >= 2 x 24 + 2 bits)."""
    a = a.double()
    return (a.sqrt() if op == "sqrt" else a / b.double()).to(torch.float32)


def _fma(a, b, c):
    """fmaf(a, b, c) of float32 tensors: the float64 product is exact, its
    sum with c rounded once more (a double rounding at an exact tie only
    in principle)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


EW_CONVS = ("gcn", "lg", "simple_sum", "simple_mean")


def mp_layer_ew_ordered(v, nbr_nodes, in_degree, conv, b0=None, skip=None,
                        act=None, block_adj=None, mode: str = "f32"):
    """gcn, lg, simple_sum and simple_mean as the kernel forms them:
    (out, s).  s adds each row's valid ELL slots in slot order from +0
    (with ``block_adj``, each nonzero count of the row in column order as
    fmaf(count, v, s)), each v rounded to bf16 first in "bf16"; the
    epilogue is the kernel's: gcn fmaf(1 / sqrt(d + 1), s + v, b0), lg
    (d > 0 ? 1 / sqrt(max(d, 1)) : 0) * s, simple_mean s / max(d, 1)
    (IEEE square roots and divisions), then + skip and the activation.
    On the card the kernel's s is these bits, and so is out under relu
    or no activation."""
    if conv not in EW_CONVS:
        raise ValueError(f"mp_layer_ew_ordered takes {EW_CONVS}; got "
                         f"{conv!r}")
    N, F = v.shape
    src = to_bf16(v) if mode == "bf16" else v
    s = v.new_zeros((N, F))
    if block_adj is None:
        for w in range(nbr_nodes.shape[1]):
            on = (w < in_degree)[:, None]
            s = torch.where(on, s + src[nbr_nodes[:, w].long()], s)
    else:
        T, B, _ = block_adj.shape
        sb, vb = s.view(T, B, F), src.view(T, B, F)
        for j in range(B):
            cnt = block_adj[:, :, j:j + 1]
            x = vb[:, j:j + 1, :].expand(T, B, F)
            one = sb + x
            many = _fma(cnt.expand(T, B, F), x, sb)
            sb = torch.where(cnt == 0, sb, torch.where(cnt == 1, one, many))
        s = sb.reshape(N, F)
    d = in_degree.to(v.dtype)[:, None]
    one = torch.ones((), dtype=v.dtype, device=v.device)
    if conv == "gcn":
        rs = _ieee("div", one.expand_as(d), _ieee("sqrt", d + 1.0))
        o = _fma(rs.expand(N, F), s + v, b0.expand(N, F))
    elif conv == "lg":
        rs = torch.where(d > 0, _ieee("div", one.expand_as(d),
                                      _ieee("sqrt", d.clamp(min=1.0))),
                         v.new_zeros(()))
        o = rs * s
    elif conv == "simple_sum":
        o = s
    else:
        o = _ieee("div", s, d.clamp(min=1.0).expand(N, F))
    if skip is not None:
        o = o + skip
    return (o if act is None else ACTIVATIONS[act](o)), s


def _out_width(conv, v, w0, w1):
    if conv == "gin":
        return w1.shape[1]
    if conv == "sage":
        return w0.shape[1]
    return v.shape[1]


def _check(v, nbr_nodes, in_degree, conv, w0, b0, w1, b1, skip, act,
           block_adj, mode, s0, s1, save_s):
    if conv not in MP_CONVS:
        raise ValueError(f"unsupported mp layer conv {conv!r}; options: "
                         f"{sorted(MP_CONVS)}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    if mode == "int8" and conv not in QUANT_CONVS:
        raise ValueError(f"the int8 mode exists for {QUANT_CONVS} only; "
                         f"{conv} runs no product to quantize: run it in "
                         f"f32")
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
    wdt = weight_dtype(mode)
    for name, t, shape in zip(("w0", "b0", "w1", "b1"), (w0, b0, w1, b1),
                              shapes):
        dt = wdt if name[0] == "w" else torch.float32
        if t is not None and (tuple(t.shape) != shape or t.dtype != dt):
            raise ValueError(f"{name} must be {shape} {dt} in mode "
                             f"{mode!r}, got {tuple(t.shape)} {t.dtype}")
    for name, t, w in (("s0", s0, w0), ("s1", s1, w1)):
        if mode != "int8":
            if t is not None:
                raise ValueError(f"mode {mode!r} takes no {name}")
        elif t is None or tuple(t.shape) != (w.shape[1],) \
                or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({w.shape[1]},) float32 in "
                             f"mode 'int8'")
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
                               skip, block_adj, s0, s1) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


_fn = (None, None)


def _kernel_fn():
    """The library's launcher, its argument types set once per library."""
    global _fn
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    if _fn[0] is not lib:
        fn = lib.gnnb_mp_layer
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.restype = I
        fn.argtypes = ([P] * 4 + [I] * 5 + [P] * 5
                       + [I, ctypes.c_float, I, I] + [P] * 5 + [I])
        _fn = (lib, fn)
    return _fn[1]


def _launch(v, nbr_nodes, in_degree, conv, w0, b0, w1, b1, eps, skip, act,
            save_s, block_adj, mode, s0, s1):
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
        smem = lib.gnnb_mp_layer_smem_bytes(F, H, int(block), MODES[mode])
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
                           skip, s0, s1) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if block and block_adj.data_ptr() % 16:
        raise ValueError("block_adj must be 16-byte aligned")
    fn = _kernel_fn()
    out = torch.empty((N, Fout), dtype=torch.float32, device=dev)
    s = torch.empty_like(v) if save_s else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(v.data_ptr(), ptr(table), ptr(block_adj), in_degree.data_ptr(),
             N, 0 if block else table.shape[1], F, H, Fout, ptr(w0), ptr(b0),
             ptr(w1), ptr(b1), ptr(skip), MP_CONVS[conv], float(eps),
             LAYER_ACTS[act], MODES[mode], ptr(s0), ptr(s1), out.data_ptr(),
             ptr(s), stream, dev.index or 0)
    if err != 0:
        raise RuntimeError(f"mp_layer launch failed: cudaError {err}")
    fused_mp_layer.launches += 1
    fused_mp_layer.mode_launches[mode] += 1
    return (out, s) if save_s else out


def fused_mp_layer(v, nbr_nodes, in_degree, conv: str, w0=None, b0=None,
                   w1=None, b1=None, eps: float = 0.0, skip=None,
                   act: Optional[str] = None, save_s: bool = False,
                   block_adj=None, mode: str = "f32", s0=None, s1=None):
    """One conv layer ``conv`` (``MP_CONVS``) on v [N, F] float32 over the
    ELL table ``nbr_nodes`` [N, W] / ``in_degree`` [N] int32, or over
    ``block_adj`` [N / 128, 128, 128] float32 counts when it is given,
    with the conv's operands (module docstring, typed by ``mode``:
    ``prepare_layer``), an optional skip [N, Fout] added before the
    activation ``act``.  Returns out [N, Fout], or (out, s) with
    ``save_s``, s [N, F] the neighbour sum of the mode's gathered v (out
    the same bits as without).  A CUDA
    ``v`` launches the kernel, which takes any width within shared memory
    and raises on what it does not take; a CPU ``v`` runs the plain
    version."""
    _check(v, nbr_nodes, in_degree, conv, w0, b0, w1, b1, skip, act,
           block_adj, mode, s0, s1, save_s)
    if v.device.type == "cuda":
        return _launch(v, nbr_nodes, in_degree, conv, w0, b0, w1, b1, eps,
                       skip, act, save_s, block_adj, mode, s0, s1)
    if v.device.type != "cpu":
        raise ValueError(f"no mp layer for device {v.device}")
    return mp_layer_plain(v, nbr_nodes, in_degree, conv, w0, b0, w1, b1, eps,
                          skip, act, save_s, block_adj, mode, s0, s1)


fused_mp_layer.launches = 0
fused_mp_layer.mode_launches = dict.fromkeys(MODES, 0)


class MPLayerFunction(torch.autograd.Function):
    """``fused_mp_layer`` with the JAX package's hand-written backward
    (``mp_layer.py`` ``_make_vjp_fn``): the forward saves s; the backward
    takes the epilogue's gradients from s in torch, then dv = dv_self +
    the transpose of the aggregation applied to ds (module docstring).
    ``mode``: the forward in it on ``mode_weights`` = (w0, w1, s0, s1)
    of the mode, the backward's epilogue in float32 on the float32
    weights.  ``plain``: the plain twin."""

    @staticmethod
    def forward(ctx, v, nbr_nodes, in_degree, rev_nbr_nodes, out_degree,
                block_adj, skip, w0, b0, w1, b1, conv, eps, act,
                rev_csr=None, mode="f32", mode_weights=None, plain=False):
        wm = (w0, w1, None, None) if mode_weights is None else mode_weights
        run = mp_layer_plain if plain else fused_mp_layer
        out, s = run(v, nbr_nodes, in_degree, conv, wm[0], b0, wm[1], b1,
                     eps, skip=skip, act=act, save_s=True,
                     block_adj=block_adj, mode=mode, s0=wm[2], s1=wm[3])
        ctx.save_for_backward(v, s, nbr_nodes, in_degree, rev_nbr_nodes,
                              out_degree, block_adj, skip, w0, b0, w1, b1)
        ctx.conv, ctx.eps, ctx.act = conv, float(eps), act
        ctx.rev_csr, ctx.mode, ctx.plain = rev_csr, mode, plain
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
            dv_agg = block_spmm(badj, ds, transpose=True,
                                mm="bf16" if ctx.mode == "bf16" else None)
        elif rev is not None:
            gather = (ell_gather_backward_plain if ctx.plain
                      else fused_gather_backward)
            dv_agg = gather(ds, rev, out_deg, has_lin=True)
        else:
            rev_ptr, rev_idx = (ctx.rev_csr()[:2] if ctx.rev_csr is not None
                                else reverse_csr(nbr, deg))
            gather = (ell_gather_backward_csr_plain if ctx.plain
                      else fused_gather_backward_csr)
            dv_agg = gather(ds, rev_ptr, rev_idx, has_lin=True)
        dv = dv_agg if dv_self is None else dv_self + dv_agg
        return (dv, None, None, None, None, None, dskip, dw0, db0, dw1, db1,
                None, None, None, None, None, None, None)


def fused_mp_layer_vjp(v, nbr_nodes, in_degree, conv: str, w0=None, b0=None,
                       w1=None, b1=None, eps: float = 0.0, skip=None,
                       rev_nbr_nodes=None, out_degree=None,
                       act: Optional[str] = None, block_adj=None,
                       mode: str = "f32", rev_csr=None, plain: bool = False):
    """Differentiable ``fused_mp_layer`` on float32 weights: the kernel
    forward in ``mode`` (the weights brought to it here,
    ``prepare_layer``) with s saved, and the hand-written backward, whose
    dv runs over ``block_adj`` when given, else over the reverse table
    when both ``rev_nbr_nodes`` and ``out_degree`` are given, else over
    the reverse CSR of ``nbr_nodes`` (``rev_csr()[:2]`` when ``rev_csr``
    is given: a callable returning ``reverse_csr(nbr_nodes, in_degree)``'s
    arrays first, called only by that backward; else built there).
    ``plain``: the plain twin (``MPLayerFunction``)."""
    if block_adj is not None or rev_nbr_nodes is None or out_degree is None:
        rev_nbr_nodes = out_degree = None
    mode_weights = None
    if mode != "f32":
        mode_weights = (prepare_layer(w0.detach().contiguous(),
                                      w1.detach().contiguous(), mode)
                        if conv in ("gin", "sage") else (None,) * 4)
    return MPLayerFunction.apply(v, nbr_nodes, in_degree, rev_nbr_nodes,
                                 out_degree, block_adj, skip, w0, b0, w1, b1,
                                 conv, float(eps), act, rev_csr, mode,
                                 mode_weights, bool(plain))


def fused_mp_layer_auto(v, nbr_nodes, in_degree, conv: str, w0=None,
                        b0=None, w1=None, b1=None, eps: float = 0.0,
                        skip=None, rev_nbr_nodes=None, out_degree=None,
                        act: Optional[str] = None, block_adj=None,
                        mode: str = "f32", rev_csr=None):
    """The layer as a conv calls it: the differentiable path
    (``MPLayerFunction`` in ``mode``; its plain twin under
    ``dispatch.plain_twins``) when grad mode is on and an input needs a
    gradient, else the kernel without s; float32 weights are brought to
    ``mode`` here (``prepare_layer``).  The kernel
    takes any width, so nothing is padded.  Under a halo scope
    (``parallel.halo``) it runs on this rank's [halo | local | halo]
    window through ``halo_wrap_layer``, without the reverse table (a
    whole-batch layout): the backward takes the window's reverse CSR."""
    from gnnbuilder_tpu_torch.ops import dispatch
    from gnnbuilder_tpu_torch.parallel.halo import active_halo, halo_wrap_layer

    if active_halo() is not None:
        return halo_wrap_layer(
            lambda xw, nb, dg, sk, rc: fused_mp_layer_auto(
                xw, nb, dg, conv, w0=w0, b0=b0, w1=w1, b1=b1, eps=eps,
                skip=sk, act=act, mode=mode, rev_csr=rc),
            v, nbr_nodes, in_degree, skip=skip)
    ops = [None if t is None else t.contiguous()
           for t in (v, skip, w0, b0, w1, b1)]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ops):
        return fused_mp_layer_vjp(ops[0], nbr_nodes, in_degree, conv,
                                  *ops[2:], eps=eps, skip=ops[1],
                                  rev_nbr_nodes=rev_nbr_nodes,
                                  out_degree=out_degree, act=act,
                                  block_adj=block_adj, mode=mode,
                                  rev_csr=rev_csr, plain=dispatch.twins_on())
    if mode == "f32":
        return fused_mp_layer(ops[0], nbr_nodes, in_degree, conv, *ops[2:],
                              eps=eps, skip=ops[1], act=act,
                              block_adj=block_adj)
    w0, w1, s0, s1 = prepare_layer(ops[2], ops[4], mode) if conv in (
        "gin", "sage") else (None, None, None, None)
    return fused_mp_layer(ops[0], nbr_nodes, in_degree, conv, w0, ops[3],
                          w1, ops[5], eps=eps, skip=ops[1], act=act,
                          block_adj=block_adj, mode=mode, s0=s0, s1=s1)

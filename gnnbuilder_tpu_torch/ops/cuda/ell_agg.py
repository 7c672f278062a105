"""The multi-aggregate of an ELL table: sum, mean, max, min and std of
``(u_i +) v_j`` over each receiver's valid slots, concatenated ``[N,
A*F]`` in the caller's order (``fused_ell_aggregate``), its backward
(``ELLAggregateFunction``) and the entry the convs call
(``fused_ell_aggregate_vjp``).

``fused_ell_aggregate`` launches ``csrc/ell_agg.cu`` for CUDA tensors and
runs ``ell_aggregate_plain``, the same function in plain torch, for CPU
tensors.  It replaces the TPU kernel ``gnnbuilder_tpu/ops/pallas/
ell_agg.py`` ``fused_ell_aggregate``; the plain version is that file's
``_reference``: the receiver shift u is added per slot before any
reduction, so max gives max(u_i + v_j).  Empty rows give 0 for every
aggregator but std, which gives sqrt(1e-5); mean divides by max(deg, 1).

The backward follows that file's ``_make_vjp_fn``.  Without u, dv is a
gather of per-receiver coefficients (``ell_aggregate_cstk``: the JAX
``_pallas_bwd`` assembly) through ``ops.cuda.ell_bwd``: over the batch's
reverse table when it has one, else over ``ops.ell.reverse_csr`` of the
forward table (where the JAX package runs XLA's VJP of its reference);
each extremum coefficient is divided by its receiver's tie count, which
the same gather counts over the forward table.  With u the backward is
torch autograd of the plain version (over ``ops.ell.ell_own_pads`` of
the table), as the JAX package's is of its reference.  Every route
gives the same bits on every run.

What bounds the kernel on the H100: bytes; see the source.  The kernel
forms each output element with the same operations in the same order as
``ell_aggregate_ordered``, a slot-ordered loop in torch, so on the card
its outputs are that loop's bits (the card tests check it); the plain
version sums in another order.

The bf16 mode (``mode="bf16"``; the JAX kernel's ``gather_mode="bf16"``)
rounds each gathered v to bf16, reduces
the rounded rows alone in float32 and applies u after the reduction, as
the TPU kernel does: sum + deg u, u + mean, u + max, u + min (0 on an
empty row), std of v alone.  There is no int8 mode: the JAX package
keeps this kernel in float32 under the int8 policy.  Its backward is the
JAX ``_pallas_bwd`` with ``gather_mode="bf16"``: the u-free coefficient
gather on the bf16-rounded v (the forward's values: the tie counts and
the extrema tests compare what the forward compared, the std's
deviations are taken from them), the gradient passing the rounding
straight through to v; with u, autograd of the float32 plain version,
as the JAX backward's ``jax.vjp`` of its reference.  The plain twin
(``plain=True``) runs the plain forward and row 7's plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from gnnbuilder_tpu_torch.ops.cuda.ell_bwd import (
    ell_gather_backward_csr_plain,
    ell_gather_backward_plain,
    fused_gather_backward,
    fused_gather_backward_csr,
)
from gnnbuilder_tpu_torch.ops.ell import (
    ell_gather,
    ell_mask,
    ell_multi_table,
    ell_own_pads,
    reverse_csr,
)
from gnnbuilder_tpu_torch.ops.quant import to_bf16

__all__ = ["fused_ell_aggregate", "ell_aggregate_plain",
           "ell_aggregate_ordered", "ell_aggregate_cstk",
           "ELLAggregateFunction", "fused_ell_aggregate_vjp", "AGGREGATORS",
           "MODES"]

# the aggregators the kernel takes, with their codes in the source
AGGREGATORS = {"sum": 0, "mean": 1, "max": 2, "min": 3, "std": 4}
# kernel modes, with their codes in the source
MODES = {"f32": 0, "bf16": 1}


def ell_aggregate_plain(v, nbr_nodes, in_degree, aggregators, u=None,
                        mode: str = "f32"):
    """The multi-aggregate in plain torch (``_reference``; in the bf16
    mode the TPU kernel's order: rounded v reduced alone, then u)."""
    mask = ell_mask(nbr_nodes, in_degree)
    if mode == "bf16":
        d = ell_multi_table(ell_gather(to_bf16(v), nbr_nodes), in_degree,
                            aggregators, mask)
        if u is not None:
            deg = in_degree.to(v.dtype)[:, None]
            zero = v.new_zeros(())
            for a in aggregators:
                if a == "sum":
                    d[a] = d[a] + deg * u
                elif a != "std":
                    d[a] = torch.where(deg > 0, u + d[a], zero)
        return torch.cat([d[a] for a in aggregators], dim=-1)
    table = ell_gather(v, nbr_nodes)
    if u is not None:
        table = u[:, None, :] + table
    d = ell_multi_table(table, in_degree, aggregators, mask)
    return torch.cat([d[a] for a in aggregators], dim=-1)


def _ieee(op, a, b=None):
    """a / b or sqrt(a) as the IEEE float32 operation rounds it: formed in
    float64 and rounded to float32, which for float32 operands gives the
    correctly rounded result (53 >= 2 x 24 + 2 bits)."""
    a = a.double()
    return (a.sqrt() if op == "sqrt" else a / b.double()).to(torch.float32)


def ell_aggregate_ordered(v, nbr_nodes, in_degree, aggregators, u=None,
                          mode: str = "f32"):
    """The multi-aggregate as the kernel forms it: for w = 0, 1, .. each
    row's w-th valid slot adds t (``u + v`` in f32 with u; the bf16-rounded
    v alone in bf16) into float32 accumulators, each sum and product
    rounded on its own (s + t, q + t * t, max, min), then each aggregator
    from them in the kernel's order, with IEEE divisions and square root.
    On the card the kernel's outputs are these bits."""
    N, F = v.shape
    s = v.new_zeros((N, F))
    q = v.new_zeros((N, F))
    mx = v.new_full((N, F), float("-inf"))
    mn = v.new_full((N, F), float("inf"))
    for w in range(nbr_nodes.shape[1]):
        on = (w < in_degree)[:, None]
        t = v[nbr_nodes[:, w].long()]
        if mode == "bf16":
            t = to_bf16(t)
        elif u is not None:
            t = u + t
        s = torch.where(on, s + t, s)
        q = torch.where(on, q + t * t, q)
        mx = torch.where(on, torch.maximum(mx, t), mx)
        mn = torch.where(on, torch.minimum(mn, t), mn)
    deg = in_degree.to(v.dtype)[:, None]
    denom = deg.clamp(min=1.0)
    has = in_degree[:, None] > 0
    shift = mode == "bf16" and u is not None
    zero = v.new_zeros(())
    out = []
    for a in aggregators:
        if a == "sum":
            val = s + deg * u if shift else s
        elif a == "mean":
            mean = _ieee("div", s, denom)
            val = torch.where(has, u + mean, zero) if shift else mean
        elif a in ("max", "min"):
            ext = mx if a == "max" else mn
            val = torch.where(has, u + ext if shift else ext, zero)
        else:
            mean = _ieee("div", s, denom)
            var = (_ieee("div", q, denom) - mean * mean).clamp(min=0.0)
            val = _ieee("sqrt", var + 1e-5)
        out.append(val)
    return torch.cat(out, dim=-1)


def _check(v, nbr_nodes, in_degree, aggregators, u, mode):
    bad = [a for a in aggregators if a not in AGGREGATORS]
    if not aggregators or bad or len(set(aggregators)) != len(aggregators):
        raise ValueError(f"aggregators must be distinct names of "
                         f"{sorted(AGGREGATORS)}, got {aggregators}")
    if mode not in MODES:
        raise ValueError(f"the multi-aggregate has modes {tuple(MODES)}, "
                         f"got {mode!r}")
    if v.dim() != 2 or v.dtype != torch.float32:
        raise ValueError(f"v must be [N, F] float32, got {tuple(v.shape)} "
                         f"{v.dtype}")
    N = v.shape[0]
    if u is not None and (u.shape != v.shape or u.dtype != torch.float32):
        raise ValueError(f"u must be {tuple(v.shape)} float32")
    if nbr_nodes.dim() != 2 or nbr_nodes.shape[0] != N:
        raise ValueError(f"nbr_nodes must be [{N}, W]")
    if tuple(in_degree.shape) != (N,):
        raise ValueError(f"in_degree must be [{N}]")
    devs = {t.device for t in (v, u, nbr_nodes, in_degree) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(v, nbr_nodes, in_degree, aggregators, u, mode):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, F = v.shape
    A = len(aggregators)
    if nbr_nodes.dtype != torch.int32 or in_degree.dtype != torch.int32:
        raise ValueError("nbr_nodes and in_degree must be int32")
    if N * A * F >= 2 ** 31:
        raise ValueError(f"the CUDA multi-aggregate takes outputs under 2^31 "
                         f"elements; got N={N} x {A} x F={F}")
    ops = [t for t in (v, u, nbr_nodes, in_degree) if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("all inputs must be contiguous")
    fn = lib.gnnb_ell_agg
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 4 + [I] * 3 + [P, I, I, P, P, I]
    codes = (ctypes.c_int * A)(*(AGGREGATORS[a] for a in aggregators))
    out = torch.empty((N, A * F), dtype=torch.float32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = fn(v.data_ptr(), None if u is None else u.data_ptr(),
             nbr_nodes.data_ptr(), in_degree.data_ptr(), N,
             nbr_nodes.shape[1], F, codes, A, MODES[mode], out.data_ptr(),
             stream, v.device.index or 0)
    if err != 0:
        raise RuntimeError(f"ell_agg launch failed: cudaError {err}")
    fused_ell_aggregate.launches += 1
    fused_ell_aggregate.mode_launches[mode] += 1
    return out


def fused_ell_aggregate(v, nbr_nodes, in_degree, aggregators, u=None,
                        mode: str = "f32"):
    """Every aggregator of ``aggregators`` (names of ``AGGREGATORS``) of
    ``(u_i +) v_j`` over the ELL table ``nbr_nodes`` [N, W] /
    ``in_degree`` [N] (int32), v and u [N, F] float32: [N, A*F] in
    aggregator order, in ``mode`` ("f32" or "bf16", module docstring).
    A CUDA ``v`` launches the kernel; a CPU one runs the plain
    version."""
    aggregators = tuple(aggregators)
    _check(v, nbr_nodes, in_degree, aggregators, u, mode)
    if v.device.type == "cuda":
        return _launch(v, nbr_nodes, in_degree, aggregators, u, mode)
    if v.device.type != "cpu":
        raise ValueError(f"no multi-aggregate for device {v.device}")
    return ell_aggregate_plain(v, nbr_nodes, in_degree, aggregators, u,
                               mode)


fused_ell_aggregate.launches = 0
fused_ell_aggregate.mode_launches = dict.fromkeys(MODES, 0)


def ell_aggregate_cstk(v, nbr_nodes, in_degree, aggregators, out, ct,
                       plain: bool = False):
    """The u-free backward's coefficient stack (the JAX ``_pallas_bwd``):
    (cstk, has_lin, has_dev, n_cmp) for ``ops.cuda.ell_bwd``, from the
    forward's output ``out`` and its cotangent ``ct`` [N, A*F].  sum and
    mean give the linear block, std the pair c/(deg std), c mean/(deg
    std), max and min each (extremum, c / ties), 0 on an empty row; the
    tie counts and, without a mean output, the mean come from the
    forward table through the same kernels (their plain versions with
    ``plain``)."""
    mean_fn, ties_fn = ((ell_aggregate_plain, ell_gather_backward_plain)
                        if plain else
                        (fused_ell_aggregate, fused_gather_backward))
    F = v.shape[1]
    col = {a: slice(i * F, (i + 1) * F) for i, a in enumerate(aggregators)}
    deg = in_degree.to(v.dtype)[:, None]
    denom = deg.clamp(min=1.0)
    c_lin = None
    if "sum" in col:
        c_lin = ct[:, col["sum"]]
    if "mean" in col:
        m = ct[:, col["mean"]] / denom
        c_lin = m if c_lin is None else c_lin + m
    blocks = [] if c_lin is None else [c_lin]
    if "std" in col:
        mean = (out[:, col["mean"]] if "mean" in col else
                mean_fn(v, nbr_nodes, in_degree, ("mean",)))
        c_a = ct[:, col["std"]] / (denom * out[:, col["std"]])
        blocks += [c_a, c_a * mean]
    n_cmp = 0
    ones = None
    for name in ("max", "min"):
        if name not in col:
            continue
        if ones is None:
            ones = torch.cat([v, torch.ones_like(v)], dim=-1)
        ext = out[:, col[name]].contiguous()
        ties = ties_fn(ones, nbr_nodes, in_degree, v=ext, has_lin=False,
                       n_cmp=1)
        coef = torch.where(deg > 0, ct[:, col[name]],
                           v.new_zeros(())) / ties.clamp(min=1.0)
        blocks += [ext, coef]
        n_cmp += 1
    cstk = torch.cat(blocks, dim=-1).contiguous()
    return cstk, c_lin is not None, "std" in col, n_cmp


class ELLAggregateFunction(torch.autograd.Function):
    """``fused_ell_aggregate`` with the JAX package's backward (module
    docstring): the coefficient gather without u, over the reverse table
    when ``rev_nbr_nodes`` is given, else over the reverse CSR; autograd
    of the float32 plain version with u.  ``mode``: the forward's, and
    under "bf16" the u-free backward on the bf16-rounded v.  ``plain``:
    the plain twin."""

    @staticmethod
    def forward(ctx, v, u, nbr_nodes, in_degree, rev_nbr_nodes, out_degree,
                aggregators, mode="f32", plain=False):
        run = ell_aggregate_plain if plain else fused_ell_aggregate
        out = run(v, nbr_nodes, in_degree, aggregators, u, mode=mode)
        ctx.save_for_backward(v, u, nbr_nodes, in_degree, rev_nbr_nodes,
                              out_degree, out)
        ctx.aggregators, ctx.mode, ctx.plain = aggregators, mode, plain
        return out

    @staticmethod
    def backward(ctx, ct):
        v, u, nbr, deg, rev, odeg, out = ctx.saved_tensors
        aggs = ctx.aggregators
        ct = ct.contiguous()
        if u is not None:
            with torch.enable_grad():
                vv = v.detach().requires_grad_()
                uu = u.detach().requires_grad_()
                o = ell_aggregate_plain(vv, ell_own_pads(nbr, deg), deg,
                                        aggs, uu)
                dv, du = torch.autograd.grad(o, (vv, uu), ct)
            return dv, du, None, None, None, None, None, None, None
        # the forward's gathered values: the JAX backward's fwd_gather_mode
        vg = to_bf16(v).contiguous() if ctx.mode == "bf16" else v
        cstk, has_lin, has_dev, n_cmp = ell_aggregate_cstk(
            vg, nbr, deg, aggs, out, ct, plain=ctx.plain)
        terms = dict(v=vg, has_lin=has_lin, has_dev=has_dev, n_cmp=n_cmp)
        if rev is not None:
            gather = (ell_gather_backward_plain if ctx.plain
                      else fused_gather_backward)
            dv = gather(cstk, rev, odeg, **terms)
        else:
            gather = (ell_gather_backward_csr_plain if ctx.plain
                      else fused_gather_backward_csr)
            rev_ptr, rev_idx = reverse_csr(nbr, deg)
            dv = gather(cstk, rev_ptr, rev_idx, **terms)
        return dv, None, None, None, None, None, None, None, None


def fused_ell_aggregate_vjp(v, nbr_nodes, in_degree, aggregators, u=None,
                            rev_nbr_nodes=None, out_degree=None,
                            mode: str = "f32"):
    """Differentiable ``fused_ell_aggregate`` in ``mode``: the kernel
    forward and the backward of ``ELLAggregateFunction`` (its plain twin
    under ``dispatch.plain_twins``), whose u-free dv runs over the
    reverse table when both ``rev_nbr_nodes`` and ``out_degree`` are
    given, else over the reverse CSR of ``nbr_nodes``.  Without a
    gradient the kernel alone."""
    from gnnbuilder_tpu_torch.ops import dispatch

    v = v.contiguous()
    u = None if u is None else u.contiguous()
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (v, u))):
        return fused_ell_aggregate(v, nbr_nodes, in_degree, aggregators, u,
                                   mode=mode)
    if rev_nbr_nodes is None or out_degree is None:
        rev_nbr_nodes = out_degree = None
    return ELLAggregateFunction.apply(
        v, u, nbr_nodes, in_degree, rev_nbr_nodes, out_degree,
        tuple(aggregators), mode, dispatch.twins_on())

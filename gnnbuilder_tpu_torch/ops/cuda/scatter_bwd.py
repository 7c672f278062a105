"""PNA aggregation backward over the forward ELL table.

The kernel ``csrc/scatter_bwd.cu`` replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/scatter_bwd.py`` ``fused_pna_scatter_backward``
(its raw PNA mode): from the cotangent of mid and the forward's residuals
it forms d_agg = dy ks_t and the per-receiver coefficients.

* ``fused_pna_scatter_cstk`` (plain: ``pna_scatter_cstk_plain``) launches
  it for CUDA tensors: it writes the coefficient stack cstk [N, 7F] =
  [c_lin | c_a | c_a*mean | mx | c_mx | mn | c_mn], which
  ``ops.cuda.ell_bwd.fused_gather_backward`` turns into dv over the
  reverse table, the same bits on every run: the route of the JAX PNA VJP
  when the batch carries reverse tables.
* ``fused_pna_scatter_backward`` (plain: ``pna_scatter_backward_plain``,
  the coefficients, each valid slot's contribution and ``index_add_`` into
  the senders) gives dv on a batch without a reverse table: on the card
  the cstk kernel, then ``ops.ell.reverse_csr`` of the forward table and
  the gather's CSR mode, so dv is the same bits on every run there too.
* ``fused_scatter_backward`` (plain: ``scatter_backward_plain``) is the
  TPU file's generic entry of the same name: any coefficient stack over
  the forward table, in ``ops.cuda.ell_bwd``'s column layout, as dv.  It
  has no kernel of its own: it builds ``ops.ell.reverse_csr`` of the
  forward table and runs the gather's CSR mode (row 7), so no float is
  added atomically and dv is the same bits on every run.

What bounds the kernel on the H100: operations (d_agg, 2 * 3Fout * 4F
flops per row), run on the tensor cores in three TF32 passes.  The kernel
reads ks_t in its own layout (``stage_ks_t``), which the wrapper lays out
on the card on every call: ks_t changes with every optimizer step.
"""

from __future__ import annotations

import ctypes

import torch

from gnnbuilder_tpu_torch.ops.cuda.ell_bwd import (
    _terms,
    fused_gather_backward_csr,
    n_blocks,
)
from gnnbuilder_tpu_torch.ops.cuda.pna_block import (
    _fragment_index,
    split_tf32,
)
from gnnbuilder_tpu_torch.ops.ell import ell_mask, reverse_csr

__all__ = ["fused_pna_scatter_backward", "pna_scatter_backward_plain",
           "fused_pna_scatter_cstk", "pna_scatter_cstk_plain",
           "fused_scatter_backward", "scatter_backward_plain",
           "stage_ks_t", "unstage_ks_t"]

# features of one CTA's column group in the kernel
_GROUP = 32
# (K, F, device) -> the device's copy of _stream_order(K, F)
_ORDERS = {}


def _f32_dot(a, w):
    """d_agg's product in the plain version."""
    return a @ w


def _stream_order(K: int, F: int):
    """(index, half): the positions of ``stage_ks_t``'s stream as flat
    indices into ks_t [K, 4F], and the TF32 half each holds (0 hi, 1 lo:
    a pair of n8 tiles' 128 hi values, then its 128 lo values).  Per group
    of 32 features, 128 staged columns (the features' four blocks: column
    s holds block (s % 64) // 8 % 4 of feature 32 group + 16 (s // 64) +
    8 ((s % 64) // 32) + s % 8, so that each thread's accumulators hold
    the four blocks of its features), in ``_fragment_index`` order (k-steps
    of 8)."""
    frag = _fragment_index(K, 128, 1)
    k, s = frag // 128, frag % 128
    nt = (s % 64) // 8
    feat = 16 * (s // 64) + 8 * (nt // 4) + s % 8
    col = (nt % 4) * F + feat
    index = torch.cat([k * 4 * F + col + _GROUP * cg
                       for cg in range(F // _GROUP)])
    pairs = index.numel() // 128
    index = index.view(pairs, 1, 128).expand(pairs, 2, 128).reshape(-1)
    half = torch.arange(2).view(1, 2, 1).expand(pairs, 2, 128).reshape(-1)
    return index, half


def _order(K: int, F: int, device):
    key = (K, F, str(device))
    if key not in _ORDERS:
        _ORDERS[key] = tuple(t.to(device) for t in _stream_order(K, F))
    return _ORDERS[key]


def stage_ks_t(ks_t):
    """ks_t [3Fout, 4F] float32 in the layout the kernel streams
    (``_stream_order``): one flat float32 tensor of 2 x 3Fout x 4F values,
    each weight's ``split_tf32`` halves, made with torch ops on ks_t's
    device."""
    K, F4 = ks_t.shape
    index, half = _order(K, F4 // 4, ks_t.device)
    return torch.stack(split_tf32(ks_t.reshape(-1)))[half, index]


def unstage_ks_t(staged, K: int, F: int):
    """ks_t's TF32 halves [2, K, 4F] back from ``stage_ks_t``'s layout."""
    index, half = _order(K, F, staged.device)
    flat = staged.new_empty((2, K * 4 * F))
    flat[half, index] = staged
    return flat.view(2, K, 4 * F)


def scatter_backward_plain(cstk, nbr_nodes, in_degree, v, has_lin=True,
                           has_dev=False, n_cmp=0):
    """The generic scatter in plain torch: every valid slot of receiver i
    (sender j) forms the terms of i's coefficient row against v_j and
    ``index_add_`` adds them into dv_j."""
    F = cstk.shape[1] // n_blocks(has_lin, has_dev, n_cmp)
    idx = nbr_nodes.long()
    g = cstk[:, None, :].expand(-1, idx.shape[1], -1)     # [N, W, K*F]
    t = _terms(g, v[idx], F, has_lin, has_dev, n_cmp)
    m = ell_mask(nbr_nodes, in_degree)
    return torch.zeros_like(v).index_add_(0, idx[m], t[m])


def fused_scatter_backward(cstk, nbr_nodes, in_degree, v,
                           has_lin: bool = True, has_dev: bool = False,
                           n_cmp: int = 0):
    """dv [N, F] from the stacked receiver coefficients ``cstk`` [N, K*F]
    (``ops.cuda.ell_bwd`` layout: [c_lin? | c_a, c_a*mean? | (ref, coef)
    x n_cmp]) over the FORWARD table ``nbr_nodes`` [N, W] / ``in_degree``
    [N] (int32), with the sender rows ``v`` [N, F]: the JAX package's
    ``fused_scatter_backward``.  The reverse CSR of the table, then
    ``fused_gather_backward_csr`` (the kernel for CUDA tensors, its plain
    version for CPU ones)."""
    if n_blocks(has_lin, has_dev, n_cmp) == 0:
        raise ValueError("no terms requested")
    rev_ptr, rev_idx = reverse_csr(nbr_nodes, in_degree)
    return fused_gather_backward_csr(cstk, rev_ptr, rev_idx, v=v,
                                     has_lin=has_lin, has_dev=has_dev,
                                     n_cmp=n_cmp)


def _coefficients(d_mid, aux, agg_cat, in_degree, ks_t, delta):
    """(c_lin, c_a, c_mx, c_mn) per receiver row, each [N, F]."""
    F = agg_cat.shape[1] // 4
    degf = in_degree.to(d_mid.dtype)[:, None]
    denom = degf.clamp(min=1.0)
    nonempty = degf > 0
    log_deg = torch.log(denom + 1.0)
    dy = torch.cat([d_mid, (log_deg / delta) * d_mid,
                    (delta / log_deg) * d_mid], dim=1)
    d_agg = _f32_dot(dy, ks_t)                              # [N, 4F]
    zero = d_mid.new_zeros(())
    ct_mx = torch.where(nonempty, d_agg[:, :F], zero)
    ct_mn = torch.where(nonempty, d_agg[:, F:2 * F], zero)
    ct_mean = torch.where(nonempty, d_agg[:, 2 * F:3 * F], zero)
    c_lin = ct_mean / denom
    c_a = d_agg[:, 3 * F:] / (denom * agg_cat[:, 3 * F:])
    c_mx = ct_mx / aux[:, 3 * F:4 * F].clamp(min=1.0)
    c_mn = ct_mn / aux[:, 4 * F:].clamp(min=1.0)
    return c_lin, c_a, c_mx, c_mn


def pna_scatter_cstk_plain(d_mid, aux, agg_cat, in_degree, ks_t, delta):
    """The coefficient stack in plain torch: [N, 7F]."""
    F = agg_cat.shape[1] // 4
    c_lin, c_a, c_mx, c_mn = _coefficients(d_mid, aux, agg_cat, in_degree,
                                           ks_t, delta)
    mx, mn, mean = aux[:, :F], aux[:, F:2 * F], aux[:, 2 * F:3 * F]
    return torch.cat([c_lin, c_a, c_a * mean, mx, c_mx, mn, c_mn], dim=1)


def pna_scatter_backward_plain(d_mid, aux, agg_cat, in_degree, nbr_nodes,
                               v, ks_t, delta):
    """The scatter backward in plain torch: the coefficients, the
    per-slot C and ``index_add_`` into the senders."""
    F = v.shape[1]
    c_lin, c_a, c_mx, c_mn = _coefficients(d_mid, aux, agg_cat, in_degree,
                                           ks_t, delta)
    zero = v.new_zeros(())
    mx, mn, mean = aux[:, :F], aux[:, F:2 * F], aux[:, 2 * F:3 * F]
    idx = nbr_nodes.long()
    g = v[idx]                                              # [N, W, F]
    C = (c_lin[:, None] + c_a[:, None] * (g - mean[:, None])
         + torch.where(g == mx[:, None], c_mx[:, None], zero)
         + torch.where(g == mn[:, None], c_mn[:, None], zero))
    m = ell_mask(nbr_nodes, in_degree)
    return torch.zeros_like(v).index_add_(0, idx[m], C[m])


def _check(d_mid, aux, agg_cat, in_degree, nbr_nodes, v, ks_t):
    """Shapes, types and devices; ``nbr_nodes`` and ``v`` are None for the
    coefficient stack alone."""
    if agg_cat.dim() != 2 or agg_cat.shape[1] % 4:
        raise ValueError("agg_cat must be [N, 4F]")
    N, F = agg_cat.shape[0], agg_cat.shape[1] // 4
    Fout = d_mid.shape[-1]
    named = [("d_mid", d_mid, (N, Fout)), ("aux", aux, (N, 5 * F)),
             ("agg_cat", agg_cat, (N, 4 * F)),
             ("ks_t", ks_t, (3 * Fout, 4 * F))]
    if v is not None:
        named.append(("v", v, (N, F)))
    for name, t, shape in named:
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if nbr_nodes is not None and (nbr_nodes.dim() != 2
                                  or nbr_nodes.shape[0] != N):
        raise ValueError("nbr_nodes must be [N, W]")
    if tuple(in_degree.shape) != (N,):
        raise ValueError("in_degree must be [N]")
    devs = {t.device for t in (d_mid, aux, agg_cat, in_degree, nbr_nodes, v,
                               ks_t) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(d_mid, aux, agg_cat, in_degree, ks_t, delta):
    """The kernel: cstk [N, 7F]."""
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, F = agg_cat.shape[0], agg_cat.shape[1] // 4
    Fout = d_mid.shape[1]
    mult = lib.gnnb_scatter_bwd_width_multiple()
    smem = lib.gnnb_scatter_bwd_smem_bytes(Fout)
    smem_max = lib.gnnb_smem_per_block_optin(d_mid.device.index or 0)
    if any(d % mult or d < mult for d in (F, Fout)) or smem > smem_max:
        raise ValueError(
            f"the CUDA PNA scatter backward takes widths that are multiples "
            f"of {mult} within {smem_max} bytes of shared memory; got F={F} "
            f"Fout={Fout} ({smem} bytes)")
    if in_degree.dtype != torch.int32:
        raise ValueError("in_degree must be int32")
    tensors = (d_mid, aux, agg_cat, in_degree, ks_t)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")
    staged = stage_ks_t(ks_t)
    fn = lib.gnnb_pna_scatter_bwd
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 5 + [I] * 3 + [ctypes.c_float, P, P, I, P,
                                        ctypes.c_longlong])
    dev = d_mid.device
    cstk = torch.empty((N, 7 * F), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(d_mid.data_ptr(), aux.data_ptr(), agg_cat.data_ptr(),
             in_degree.data_ptr(), ks_t.data_ptr(), N, F, Fout, float(delta),
             cstk.data_ptr(), stream, dev.index or 0, staged.data_ptr(),
             staged.numel() * staged.element_size())
    if err != 0:
        raise RuntimeError(f"pna_scatter_bwd launch failed: cudaError {err}")
    return cstk


def fused_pna_scatter_backward(d_mid, aux, agg_cat, in_degree, nbr_nodes, v,
                               ks_t, delta: float, rev_csr=None):
    """dv [N, F] of the PNA aggregation, on a batch with or without a
    reverse table.  d_mid [N, Fout] is the cotangent of mid; aux [N, 5F],
    agg_cat [N, 4F] (its std block is read) and v [N, F] are the forward's
    residuals; nbr_nodes [N, W] and in_degree [N] int32 the forward's
    table; ks_t [3Fout, 4F] the transposed scaler blocks of k_post.  A
    CUDA ``v`` runs ``fused_pna_scatter_cstk`` (widths that are multiples
    of 128, else it raises), ``reverse_csr`` and
    ``fused_gather_backward_csr``, each launch counted by its own wrapper
    (``rev_csr()[:2]`` in place of ``reverse_csr`` when ``rev_csr`` is
    given: a callable returning the reverse CSR's arrays first, as a halo
    window keeps it); a CPU ``v`` runs the plain version."""
    _check(d_mid, aux, agg_cat, in_degree, nbr_nodes, v, ks_t)
    if v.device.type == "cuda":
        cstk = fused_pna_scatter_cstk(d_mid, aux, agg_cat, in_degree, ks_t,
                                      delta)
        rev_ptr, rev_idx = (rev_csr()[:2] if rev_csr is not None
                            else reverse_csr(nbr_nodes, in_degree))
        return fused_gather_backward_csr(cstk, rev_ptr, rev_idx, v,
                                         has_lin=True, has_dev=True, n_cmp=2)
    if v.device.type != "cpu":
        raise ValueError(f"no PNA scatter backward for device {v.device}")
    return pna_scatter_backward_plain(d_mid, aux, agg_cat, in_degree,
                                      nbr_nodes, v, ks_t, delta)


def fused_pna_scatter_cstk(d_mid, aux, agg_cat, in_degree, ks_t,
                           delta: float):
    """The coefficient stack cstk [N, 7F] of the PNA aggregation backward
    (arguments as ``fused_pna_scatter_backward``, without the table and
    v), for ``ell_bwd.fused_gather_backward`` with has_lin, has_dev and
    n_cmp=2.  A CUDA ``d_mid`` launches the kernel, which takes widths
    that are multiples of 128 and raises on others; a CPU ``d_mid`` runs
    the plain version."""
    _check(d_mid, aux, agg_cat, in_degree, None, None, ks_t)
    if d_mid.device.type == "cuda":
        cstk = _launch(d_mid, aux, agg_cat, in_degree, ks_t, delta)
        fused_pna_scatter_cstk.launches += 1
        return cstk
    if d_mid.device.type != "cpu":
        raise ValueError(f"no PNA scatter backward for device "
                         f"{d_mid.device}")
    return pna_scatter_cstk_plain(d_mid, aux, agg_cat, in_degree, ks_t,
                                  delta)


fused_pna_scatter_cstk.launches = 0

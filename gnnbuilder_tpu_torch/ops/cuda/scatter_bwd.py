"""PNA aggregation backward over the forward ELL table.

``fused_pna_scatter_backward`` launches ``csrc/scatter_bwd.cu`` for CUDA
tensors and runs ``pna_scatter_backward_plain``, the same function in
plain torch, for CPU tensors.  It replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/scatter_bwd.py`` ``fused_pna_scatter_backward``
(its raw PNA mode): from the cotangent of mid and the forward's residuals
it forms d_agg = dy ks_t, the per-receiver coefficients and each valid
slot's contribution C, and adds C into the slot's sender row of dv.

What bounds it on the H100: operations (d_agg, 2 * 3Fout * 4F flops per
row, run as f32 FMAs).  The kernel adds contributions with atomics, so dv
agrees with the plain version, and with itself from run to run, to f32
rounding, not bitwise.
"""

from __future__ import annotations

import ctypes

import torch

from gnnbuilder_tpu_torch.ops.ell import ell_mask

__all__ = ["fused_pna_scatter_backward", "pna_scatter_backward_plain"]


def pna_scatter_backward_plain(d_mid, aux, agg_cat, in_degree, nbr_nodes,
                               v, ks_t, delta):
    """The backward in plain torch: d_agg, the coefficients, the per-slot
    C and ``index_add_`` into the senders."""
    F = v.shape[1]
    degf = in_degree.to(v.dtype)[:, None]
    denom = degf.clamp(min=1.0)
    nonempty = degf > 0
    log_deg = torch.log(denom + 1.0)
    dy = torch.cat([d_mid, (log_deg / delta) * d_mid,
                    (delta / log_deg) * d_mid], dim=1)
    d_agg = dy @ ks_t                                       # [N, 4F]
    zero = v.new_zeros(())
    ct_mx = torch.where(nonempty, d_agg[:, :F], zero)
    ct_mn = torch.where(nonempty, d_agg[:, F:2 * F], zero)
    ct_mean = torch.where(nonempty, d_agg[:, 2 * F:3 * F], zero)
    c_lin = ct_mean / denom
    c_a = d_agg[:, 3 * F:] / (denom * agg_cat[:, 3 * F:])
    c_mx = ct_mx / aux[:, 3 * F:4 * F].clamp(min=1.0)
    c_mn = ct_mn / aux[:, 4 * F:].clamp(min=1.0)
    mx, mn, mean = aux[:, :F], aux[:, F:2 * F], aux[:, 2 * F:3 * F]
    idx = nbr_nodes.long()
    g = v[idx]                                              # [N, W, F]
    C = (c_lin[:, None] + c_a[:, None] * (g - mean[:, None])
         + torch.where(g == mx[:, None], c_mx[:, None], zero)
         + torch.where(g == mn[:, None], c_mn[:, None], zero))
    m = ell_mask(nbr_nodes, in_degree)
    return torch.zeros_like(v).index_add_(0, idx[m], C[m])


def _check(d_mid, aux, agg_cat, in_degree, nbr_nodes, v, ks_t):
    if v.dim() != 2:
        raise ValueError("v must be [N, F]")
    N, F = v.shape
    Fout = d_mid.shape[-1]
    for name, t, shape in (("d_mid", d_mid, (N, Fout)),
                           ("aux", aux, (N, 5 * F)),
                           ("agg_cat", agg_cat, (N, 4 * F)),
                           ("v", v, (N, F)),
                           ("ks_t", ks_t, (3 * Fout, 4 * F))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if nbr_nodes.dim() != 2 or nbr_nodes.shape[0] != N:
        raise ValueError("nbr_nodes must be [N, W]")
    if tuple(in_degree.shape) != (N,):
        raise ValueError("in_degree must be [N]")
    devs = {t.device for t in (d_mid, aux, agg_cat, in_degree, nbr_nodes, v,
                               ks_t)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(d_mid, aux, agg_cat, in_degree, nbr_nodes, v, ks_t, delta):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, F = v.shape
    Fout = d_mid.shape[1]
    mult = lib.gnnb_scatter_bwd_width_multiple()
    smem = lib.gnnb_scatter_bwd_smem_bytes(Fout)
    smem_max = lib.gnnb_smem_per_block_optin(v.device.index or 0)
    if any(d % mult or d < mult for d in (F, Fout)) or smem > smem_max:
        raise ValueError(
            f"the CUDA PNA scatter backward takes widths that are multiples "
            f"of {mult} within {smem_max} bytes of shared memory; got F={F} "
            f"Fout={Fout} ({smem} bytes)")
    if nbr_nodes.dtype != torch.int32 or in_degree.dtype != torch.int32:
        raise ValueError("nbr_nodes and in_degree must be int32")
    tensors = (d_mid, aux, agg_cat, in_degree, nbr_nodes, v, ks_t)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")
    fn = lib.gnnb_pna_scatter_bwd
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 7 + [I] * 4 + [ctypes.c_float, P, P, I]
    dv = torch.zeros_like(v)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    err = fn(d_mid.data_ptr(), aux.data_ptr(), agg_cat.data_ptr(),
             in_degree.data_ptr(), nbr_nodes.data_ptr(), v.data_ptr(),
             ks_t.data_ptr(), N, nbr_nodes.shape[1], F, Fout, float(delta),
             dv.data_ptr(), stream, v.device.index or 0)
    if err != 0:
        raise RuntimeError(f"pna_scatter_bwd launch failed: cudaError {err}")
    fused_pna_scatter_backward.launches += 1
    return dv


def fused_pna_scatter_backward(d_mid, aux, agg_cat, in_degree, nbr_nodes, v,
                               ks_t, delta: float):
    """dv [N, F] of the PNA aggregation.  d_mid [N, Fout] is the cotangent
    of mid; aux [N, 5F], agg_cat [N, 4F] (its std block is read) and v
    [N, F] are the forward's residuals; nbr_nodes [N, W] and in_degree [N]
    int32 the forward's table; ks_t [3Fout, 4F] the transposed scaler
    blocks of k_post.  A CUDA ``v`` launches the kernel, which takes
    widths that are multiples of 128 and raises on others; a CPU ``v``
    runs the plain version."""
    _check(d_mid, aux, agg_cat, in_degree, nbr_nodes, v, ks_t)
    if v.device.type == "cuda":
        return _launch(d_mid, aux, agg_cat, in_degree, nbr_nodes, v, ks_t,
                       delta)
    if v.device.type != "cpu":
        raise ValueError(f"no PNA scatter backward for device {v.device}")
    return pna_scatter_backward_plain(d_mid, aux, agg_cat, in_degree,
                                      nbr_nodes, v, ks_t, delta)


fused_pna_scatter_backward.launches = 0

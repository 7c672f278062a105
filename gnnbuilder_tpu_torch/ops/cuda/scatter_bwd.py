"""PNA aggregation backward over the forward ELL table.

Both entry points launch ``csrc/scatter_bwd.cu`` for CUDA tensors and run
the same function in plain torch for CPU tensors.  The kernel replaces
the TPU kernel ``gnnbuilder_tpu/ops/pallas/scatter_bwd.py``
``fused_pna_scatter_backward`` (its raw PNA mode): from the cotangent of
mid and the forward's residuals it forms d_agg = dy ks_t and the
per-receiver coefficients.

* ``fused_pna_scatter_cstk`` (plain: ``pna_scatter_cstk_plain``) writes
  them as the coefficient stack cstk [N, 7F] = [c_lin | c_a | c_a*mean |
  mx | c_mx | mn | c_mn], which ``ops.cuda.ell_bwd.fused_gather_backward``
  turns into dv over the reverse table, the same bits on every run: the
  route of the JAX PNA VJP when the batch carries reverse tables.
* ``fused_pna_scatter_backward`` (plain: ``pna_scatter_backward_plain``)
  forms each valid slot's contribution C and adds it into the slot's
  sender row of dv, with atomics on the card, so dv agrees with the plain
  version, and with itself from run to run, to f32 rounding, not bitwise.
  It serves batches without a reverse table.

What bounds the kernel on the H100: operations (d_agg, 2 * 3Fout * 4F
flops per row, run as f32 FMAs).
"""

from __future__ import annotations

import ctypes

import torch

from gnnbuilder_tpu_torch.ops.ell import ell_mask

__all__ = ["fused_pna_scatter_backward", "pna_scatter_backward_plain",
           "fused_pna_scatter_cstk", "pna_scatter_cstk_plain"]


def _coefficients(d_mid, aux, agg_cat, in_degree, ks_t, delta):
    """(c_lin, c_a, c_mx, c_mn) per receiver row, each [N, F]."""
    F = agg_cat.shape[1] // 4
    degf = in_degree.to(d_mid.dtype)[:, None]
    denom = degf.clamp(min=1.0)
    nonempty = degf > 0
    log_deg = torch.log(denom + 1.0)
    dy = torch.cat([d_mid, (log_deg / delta) * d_mid,
                    (delta / log_deg) * d_mid], dim=1)
    d_agg = dy @ ks_t                                       # [N, 4F]
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
    """Shapes, types and devices; ``nbr_nodes`` and ``v`` are None in cstk
    mode."""
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


def _launch(d_mid, aux, agg_cat, in_degree, nbr_nodes, v, ks_t, delta):
    """Scatter mode (dv) when ``nbr_nodes`` is given, else cstk mode."""
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
    scatter = nbr_nodes is not None
    if in_degree.dtype != torch.int32 or (
            scatter and nbr_nodes.dtype != torch.int32):
        raise ValueError("nbr_nodes and in_degree must be int32")
    tensors = [t for t in (d_mid, aux, agg_cat, in_degree, nbr_nodes, v,
                           ks_t) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")
    fn = lib.gnnb_pna_scatter_bwd
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 7 + [I] * 4 + [ctypes.c_float, P, P, P, I]
    dev = d_mid.device
    if scatter:
        dv, cstk = torch.zeros((N, F), dtype=torch.float32, device=dev), None
    else:
        dv = None
        cstk = torch.empty((N, 7 * F), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(d_mid.data_ptr(), aux.data_ptr(), agg_cat.data_ptr(),
             in_degree.data_ptr(), ptr(nbr_nodes), ptr(v), ks_t.data_ptr(),
             N, nbr_nodes.shape[1] if scatter else 0, F, Fout, float(delta),
             ptr(dv), ptr(cstk), stream, dev.index or 0)
    if err != 0:
        raise RuntimeError(f"pna_scatter_bwd launch failed: cudaError {err}")
    return dv if scatter else cstk


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
        dv = _launch(d_mid, aux, agg_cat, in_degree, nbr_nodes, v, ks_t,
                     delta)
        fused_pna_scatter_backward.launches += 1
        return dv
    if v.device.type != "cpu":
        raise ValueError(f"no PNA scatter backward for device {v.device}")
    return pna_scatter_backward_plain(d_mid, aux, agg_cat, in_degree,
                                      nbr_nodes, v, ks_t, delta)


fused_pna_scatter_backward.launches = 0


def fused_pna_scatter_cstk(d_mid, aux, agg_cat, in_degree, ks_t,
                           delta: float):
    """The coefficient stack cstk [N, 7F] of the PNA aggregation backward
    (arguments as ``fused_pna_scatter_backward``, without the table and
    v), for ``ell_bwd.fused_gather_backward`` with has_lin, has_dev and
    n_cmp=2.  A CUDA ``d_mid`` launches the kernel in its cstk mode, which
    takes widths that are multiples of 128 and raises on others; a CPU
    ``d_mid`` runs the plain version."""
    _check(d_mid, aux, agg_cat, in_degree, None, None, ks_t)
    if d_mid.device.type == "cuda":
        cstk = _launch(d_mid, aux, agg_cat, in_degree, None, None, ks_t,
                       delta)
        fused_pna_scatter_cstk.launches += 1
        return cstk
    if d_mid.device.type != "cpu":
        raise ValueError(f"no PNA scatter backward for device "
                         f"{d_mid.device}")
    return pna_scatter_cstk_plain(d_mid, aux, agg_cat, in_degree, ks_t,
                                  delta)


fused_pna_scatter_cstk.launches = 0

"""Reverse-table gather backward of an ELL aggregation.

``fused_gather_backward`` launches ``csrc/ell_bwd.cu`` for CUDA tensors
and runs ``ell_gather_backward_plain``, the same function in plain torch,
for CPU tensors.  It replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/ell_bwd.py`` ``fused_gather_backward``: for
each sender row j it walks j's out-neighbours i (the batch's reverse
table ``rev_nbr_nodes`` / ``out_degree``) and sums per-receiver
coefficient terms, so dv needs no scatter and comes out the same bits on
every run.

``cstk`` [N, K*F] holds the coefficients in F-wide blocks
``[c_lin? | d1, d2? | (ref_1, coef_1) .. (ref_C, coef_C)]``, with K =
has_lin + 2*has_dev + 2*n_cmp, and the terms per slot are ``c_lin[i]``,
``v[j] * d1[i] - d2[i]`` (each operation rounded on its own, so a
degree-1 receiver cancels exactly) and ``[v[j] == ref_k[i]] * coef_k[i]``.
The caller divides each extremum coefficient by its tie count.

What bounds it on the H100: bytes (a few operations per gathered
coefficient); see the source.
"""

from __future__ import annotations

import ctypes

import torch

from gnnbuilder_tpu_torch.ops.ell import ell_mask

__all__ = ["fused_gather_backward", "ell_gather_backward_plain",
           "n_blocks"]


def n_blocks(has_lin: bool, has_dev: bool, n_cmp: int) -> int:
    """K, the number of F-wide blocks of ``cstk``."""
    return int(bool(has_lin)) + 2 * int(bool(has_dev)) + 2 * int(n_cmp)


def ell_gather_backward_plain(cstk, rev_nbr_nodes, out_degree, v=None,
                              has_lin=True, has_dev=False, n_cmp=0):
    """The gather in plain torch: [N, Wr, K*F] rows of cstk over the
    reverse table, the terms per valid slot, summed over the slots."""
    K = n_blocks(has_lin, has_dev, n_cmp)
    F = cstk.shape[1] // K
    g = cstk[rev_nbr_nodes.long()]                      # [N, Wr, K*F]
    m = ell_mask(rev_nbr_nodes, out_degree)[..., None]
    zero = cstk.new_zeros(())
    vj = None if v is None else v[:, None, :]
    terms = []
    o = 0
    if has_lin:
        terms.append(g[..., :F])
        o = F
    if has_dev:
        terms.append(vj * g[..., o:o + F] - g[..., o + F:o + 2 * F])
        o += 2 * F
    for _ in range(n_cmp):
        terms.append(torch.where(vj == g[..., o:o + F],
                                 g[..., o + F:o + 2 * F], zero))
        o += 2 * F
    return torch.where(m, sum(terms), zero).sum(1)


def _check(cstk, rev_nbr_nodes, out_degree, v, has_lin, has_dev, n_cmp):
    K = n_blocks(has_lin, has_dev, n_cmp)
    if K == 0:
        raise ValueError("no terms requested")
    if cstk.dim() != 2 or cstk.dtype != torch.float32:
        raise ValueError(f"cstk must be [N, K*F] float32, got "
                         f"{tuple(cstk.shape)} {cstk.dtype}")
    N = cstk.shape[0]
    if cstk.shape[1] % K:
        raise ValueError(f"cstk width {cstk.shape[1]} does not split into "
                         f"{K} blocks")
    F = cstk.shape[1] // K
    if (has_dev or n_cmp) and v is None:
        raise ValueError("dev and cmp terms need the local rows v")
    if v is not None and (tuple(v.shape) != (N, F)
                          or v.dtype != torch.float32):
        raise ValueError(f"v must be ({N}, {F}) float32")
    if rev_nbr_nodes.dim() != 2 or rev_nbr_nodes.shape[0] != N:
        raise ValueError("rev_nbr_nodes must be [N, Wr]")
    if tuple(out_degree.shape) != (N,):
        raise ValueError("out_degree must be [N]")
    devs = {t.device for t in (cstk, rev_nbr_nodes, out_degree, v)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(cstk, rev_nbr_nodes, out_degree, v, has_lin, has_dev, n_cmp):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    K = n_blocks(has_lin, has_dev, n_cmp)
    N = cstk.shape[0]
    F = cstk.shape[1] // K
    if rev_nbr_nodes.dtype != torch.int32 or out_degree.dtype != torch.int32:
        raise ValueError("rev_nbr_nodes and out_degree must be int32")
    tensors = [t for t in (cstk, rev_nbr_nodes, out_degree, v)
               if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    fn = lib.gnnb_ell_gather_bwd
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 4 + [I] * 6 + [P, P, I]
    dv = torch.empty((N, F), dtype=torch.float32, device=cstk.device)
    stream = torch.cuda.current_stream(cstk.device).cuda_stream
    err = fn(cstk.data_ptr(), rev_nbr_nodes.data_ptr(),
             out_degree.data_ptr(), None if v is None else v.data_ptr(), N,
             rev_nbr_nodes.shape[1], F, int(bool(has_lin)),
             int(bool(has_dev)), int(n_cmp), dv.data_ptr(), stream,
             cstk.device.index or 0)
    if err != 0:
        raise RuntimeError(f"ell_gather_bwd launch failed: cudaError {err}")
    fused_gather_backward.launches += 1
    return dv


def fused_gather_backward(cstk, rev_nbr_nodes, out_degree, v=None,
                          has_lin: bool = True, has_dev: bool = False,
                          n_cmp: int = 0):
    """dv [N, F] from the coefficient stack ``cstk`` [N, K*F] over the
    reverse table ``rev_nbr_nodes`` [N, Wr] / ``out_degree`` [N] (int32),
    with the local rows ``v`` [N, F] for dev and cmp terms.  A CUDA
    ``cstk`` launches the kernel; a CPU one runs the plain version."""
    _check(cstk, rev_nbr_nodes, out_degree, v, has_lin, has_dev, n_cmp)
    if cstk.device.type == "cuda":
        return _launch(cstk, rev_nbr_nodes, out_degree, v, has_lin, has_dev,
                       n_cmp)
    if cstk.device.type != "cpu":
        raise ValueError(f"no gather backward for device {cstk.device}")
    return ell_gather_backward_plain(cstk, rev_nbr_nodes, out_degree, v,
                                     has_lin, has_dev, n_cmp)


fused_gather_backward.launches = 0

"""The GAT softmax backward over the ELL neighbour table.

``fused_gat_scatter_backward`` launches ``csrc/gat_bwd.cu`` for CUDA
tensors and runs ``gat_scatter_backward_plain``, the same function in
plain torch, for CPU tensors.  It replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/gat_bwd.py`` ``fused_gat_scatter_backward``
and returns what that returns: ``(dh_val [N, HC], da_src_nbr [N, H], dsum
[N, H], s [N, H], m [N, H], den [N, H])``:

* dh_val -- the alpha-weighted value sum, sum over edges j -> i of
  alpha_ij dz_i, at each sender j;
* da_src_nbr -- sum over edges j -> i of dpre_ij at each sender j;
* dsum -- per receiver, sum of dpre over its slots (self slot excluded);
* s -- per receiver, sum of alpha * dalpha over its slots and the self
  slot;
* m, den -- the softmax statistics recomputed from the given h, a_src
  and a_dst (m at least -BIG / 2, den before its 1e-16 clamp): the
  caller's self-slot terms must use these.

The kernel gathers over each sender's reverse slots instead of
scattering: over the batch's reverse table ``rev_nbr_nodes`` /
``out_degree`` when both are given, else over ``ops.ell.reverse_csr`` of
the forward table with each forward slot's CSR position (the caller's
``rev_csr``, as ``GraphBatch.rev_csr`` keeps it, else built on the
call).  Its receiver pass writes each edge's
(alpha, dpre) at the edge's reverse position, in a scratch the wrapper
allocates (2 H floats an edge), and its sender pass sums them there; the
two tables must hold the same edges, as the packer's and
``reverse_csr``'s do.  No float is added atomically, so the results are
the same bits on every run.

What bounds it on the H100: bytes (a gathered dz and h row per edge for
~4 HC flops); see the source.  The kernel's index math is 32-bit: it
takes N x HC (and N times either table's width) below 2^31.
"""

from __future__ import annotations

import ctypes

import torch

from gnnbuilder_tpu_torch.ops.activations import leaky_relu
from gnnbuilder_tpu_torch.ops.block import BIG
from gnnbuilder_tpu_torch.ops.ell import ell_mask, reverse_csr
from gnnbuilder_tpu_torch.ops.segment import segment_sum

__all__ = ["fused_gat_scatter_backward", "gat_scatter_backward_plain"]


def gat_scatter_backward_plain(dz, h, a_src, a_dst, nbr_nodes, in_degree,
                               heads: int, neg_slope: float = 0.2,
                               self_loops: bool = True):
    """The six outputs in plain torch: the per-slot softmax backward over
    the ELL table, then segment sums over the senders."""
    N, HC = dz.shape
    H = heads
    C = HC // H
    idx = nbr_nodes.long()
    mask = ell_mask(nbr_nodes, in_degree)[..., None]         # [N, W, 1]
    zero = dz.new_zeros(())
    pre = a_src[idx] + a_dst[:, None, :]                     # [N, W, H]
    lr = leaky_relu(pre, neg_slope)
    m = torch.where(mask, lr, -BIG).amax(dim=1)              # [N, H]
    pre_s = a_src + a_dst
    lr_s = leaky_relu(pre_s, neg_slope)
    if self_loops:
        m = torch.maximum(m, lr_s)
    m = m.clamp(min=-BIG * 0.5)
    e = torch.where(mask, torch.exp(torch.where(
        mask, lr - m[:, None, :], zero)), zero)
    e_s = torch.exp(lr_s - m) if self_loops else torch.zeros_like(m)
    den = e.sum(dim=1) + e_s
    den_c = den.clamp(min=1e-16)
    alpha = e / den_c[:, None, :]                            # [N, W, H]
    alpha_s = e_s / den_c
    hv, dzv = h.view(N, H, C), dz.view(N, H, C)
    dalpha = (dzv[:, None] * hv[idx]).sum(-1)                # [N, W, H]
    dalpha_s = (dzv * hv).sum(-1)
    s = (alpha * dalpha).sum(dim=1)
    if self_loops:
        s = s + alpha_s * dalpha_s
    slope = torch.where(pre >= 0, torch.ones_like(pre),
                        torch.full_like(pre, neg_slope))
    dpre = torch.where(mask, alpha * (dalpha - s[:, None, :]) * slope, zero)
    dsum = dpre.sum(dim=1)
    send = idx[mask[..., 0]]                                 # [E]
    val = (alpha[..., None] * dzv[:, None])[mask[..., 0]]    # [E, H, C]
    dh_val = segment_sum(val.reshape(-1, HC), send, N)
    da_src = segment_sum(dpre[mask[..., 0]], send, N)
    return dh_val, da_src, dsum, s, m, den


def _check(dz, h, a_src, a_dst, nbr_nodes, in_degree, heads, rev, odeg,
           rev_csr):
    if dz.dim() != 2 or dz.dtype != torch.float32:
        raise ValueError(f"dz must be [N, HC] float32, got "
                         f"{tuple(dz.shape)} {dz.dtype}")
    N, HC = dz.shape
    if heads < 1 or HC % heads:
        raise ValueError(f"width {HC} does not split into {heads} heads")
    for name, t, shape in (("h", h, (N, HC)), ("a_src", a_src, (N, heads)),
                           ("a_dst", a_dst, (N, heads))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if nbr_nodes.dim() != 2 or nbr_nodes.shape[0] != N:
        raise ValueError("nbr_nodes must be [N, W]")
    if tuple(in_degree.shape) != (N,):
        raise ValueError("in_degree must be [N]")
    if (rev is None) != (odeg is None):
        raise ValueError("pass both rev_nbr_nodes and out_degree, or "
                         "neither")
    if rev_csr is not None:
        ptr, idx, pos = rev_csr
        if (tuple(ptr.shape) != (N + 1,) or idx.dim() != 1
                or pos.shape != nbr_nodes.shape):
            raise ValueError("rev_csr must be reverse_csr(nbr_nodes, "
                             "in_degree, positions=True)")
    widest = max(HC, nbr_nodes.shape[1], 0 if rev is None else rev.shape[1])
    if N * widest >= 2 ** 31:
        raise ValueError(f"the GAT backward takes N x HC and N x the table "
                         f"widths under 2^31 elements; got N={N} x {widest}")
    devs = {t.device for t in (dz, h, a_src, a_dst, nbr_nodes, in_degree,
                               rev, odeg, *(rev_csr or ())) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(dz, h, a_src, a_dst, nbr_nodes, in_degree, heads, neg_slope,
            self_loops, rev, odeg, rev_csr):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, HC = dz.shape
    H = heads
    csr = rev is None
    if csr:
        # (rev_ptr, rev_idx, rev_pos): the gnnb_gat_bwd_csr argument order
        if rev_csr is None:
            rev_csr = reverse_csr(nbr_nodes, in_degree, positions=True)
        ints = (nbr_nodes, in_degree, *rev_csr)
        positions = ints[3].shape[0]
    else:
        ints = (nbr_nodes, in_degree, rev, odeg)
        positions = N * rev.shape[1]
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("the neighbour tables and degrees must be int32")
    if not all(t.is_contiguous() for t in (dz, h, a_src, a_dst) + ints):
        raise ValueError("all inputs must be contiguous")
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    f = torch.float32
    outs = [torch.empty((N, H), dtype=f, device=dz.device)
            for _ in range(4)]                       # dsum, s, m, den
    dh_val = torch.empty((N, HC), dtype=f, device=dz.device)
    da_src = torch.empty((N, H), dtype=f, device=dz.device)
    # scratch: (alpha, dpre) of every edge at its reverse position
    ev = torch.empty((max(positions, 1), H, 2), dtype=f, device=dz.device)
    stream = torch.cuda.current_stream(dz.device).cuda_stream
    ptrs = [t.data_ptr() for t in (dz, h, a_src, a_dst) + ints]
    tail = [t.data_ptr() for t in outs + [dh_val, da_src, ev]]
    W = nbr_nodes.shape[1]
    if csr:
        fn = lib.gnnb_gat_bwd_csr
        fn.argtypes = [P] * 9 + [I] * 4 + [Fl, I] + [P] * 8 + [I]
        sizes = [N, W, H, HC // H]
    else:
        fn = lib.gnnb_gat_bwd
        fn.argtypes = [P] * 8 + [I] * 5 + [Fl, I] + [P] * 8 + [I]
        sizes = [N, W, rev.shape[1], H, HC // H]
    fn.restype = ctypes.c_int
    err = fn(*ptrs, *sizes, float(neg_slope), int(bool(self_loops)), *tail,
             stream, dz.device.index or 0)
    if err != 0:
        raise RuntimeError(f"gat_bwd launch failed: cudaError {err}")
    fused_gat_scatter_backward.launches += 1
    dsum, s, m, den = outs
    return dh_val, da_src, dsum, s, m, den


def fused_gat_scatter_backward(dz, h, a_src, a_dst, nbr_nodes, in_degree,
                               heads: int, neg_slope: float = 0.2,
                               self_loops: bool = True, rev_nbr_nodes=None,
                               out_degree=None, rev_csr=None):
    """The GAT softmax backward (module docstring) for the cotangent dz
    [N, HC] of the pre-bias output, the projected features h [N, HC] and
    the logit halves a_src, a_dst [N, H], over the forward ELL table
    ``nbr_nodes`` [N, W] / ``in_degree`` [N] (int32).  A CUDA ``dz``
    launches the kernel (its sender pass over the reverse table when
    ``rev_nbr_nodes`` and ``out_degree`` are given, else over the
    reverse CSR: ``rev_csr`` = ``reverse_csr(nbr_nodes, in_degree,
    positions=True)`` when given, else built here); a CPU one runs the
    plain version."""
    _check(dz, h, a_src, a_dst, nbr_nodes, in_degree, heads, rev_nbr_nodes,
           out_degree, rev_csr)
    if dz.device.type == "cuda":
        return _launch(dz, h, a_src, a_dst, nbr_nodes, in_degree, heads,
                       neg_slope, self_loops, rev_nbr_nodes, out_degree,
                       rev_csr)
    if dz.device.type != "cpu":
        raise ValueError(f"no GAT backward for device {dz.device}")
    return gat_scatter_backward_plain(dz, h, a_src, a_dst, nbr_nodes,
                                      in_degree, heads, neg_slope,
                                      self_loops)


fused_gat_scatter_backward.launches = 0

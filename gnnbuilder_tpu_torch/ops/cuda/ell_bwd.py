"""Reverse-table gather backward of an ELL aggregation.

``fused_gather_backward`` launches ``csrc/ell_bwd.cu`` for CUDA tensors
and runs ``ell_gather_backward_plain``, the same function in plain torch,
for CPU tensors.  It replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/ell_bwd.py`` ``fused_gather_backward``: for
each sender row j it walks j's out-neighbours i (the batch's reverse
table ``rev_nbr_nodes`` / ``out_degree``) and sums per-receiver
coefficient terms, so dv needs no scatter and comes out the same bits on
every run.  ``fused_gather_backward_csr`` (plain:
``ell_gather_backward_csr_plain``) is the same gather over the reverse
CSR of ``ops.ell.reverse_csr``, for batches that carry no reverse table.

``cstk`` [N, K*F] holds the coefficients in F-wide blocks
``[c_lin? | d1, d2? | (ref_1, coef_1) .. (ref_C, coef_C)]``, with K =
has_lin + 2*has_dev + 2*n_cmp, and the terms per slot are ``c_lin[i]``,
``v[j] * d1[i] - d2[i]`` (each operation rounded on its own, so a
degree-1 receiver cancels exactly) and ``[v[j] == ref_k[i]] * coef_k[i]``.
The caller divides each extremum coefficient by its tie count.

``ell_gather_backward_ordered`` / ``ell_gather_backward_csr_ordered``
form the same sums as the kernel does, slot by slot in slot order and,
within a slot, term by term (each element's float32 sum in the kernel's
order), so on the card the kernel's dv equals them bit for bit.

What bounds it on the H100: bytes (a few operations per gathered
coefficient); see the source.  The kernel takes N * K * F below 2^31.
"""

from __future__ import annotations

import ctypes

import torch

from gnnbuilder_tpu_torch.ops.ell import ell_mask
from gnnbuilder_tpu_torch.ops.segment import segment_sum

__all__ = ["fused_gather_backward", "ell_gather_backward_plain",
           "fused_gather_backward_csr", "ell_gather_backward_csr_plain",
           "ell_gather_backward_ordered", "ell_gather_backward_csr_ordered",
           "n_blocks"]


def n_blocks(has_lin: bool, has_dev: bool, n_cmp: int) -> int:
    """K, the number of F-wide blocks of ``cstk``."""
    return int(bool(has_lin)) + 2 * int(bool(has_dev)) + 2 * int(n_cmp)


def _terms(g, vj, F, has_lin, has_dev, n_cmp):
    """The gathered terms per slot: g [..., K*F] coefficient rows, vj the
    sender's v rows broadcast against them."""
    zero = g.new_zeros(())
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
    return sum(terms)


def ell_gather_backward_plain(cstk, rev_nbr_nodes, out_degree, v=None,
                              has_lin=True, has_dev=False, n_cmp=0):
    """The gather in plain torch: [N, Wr, K*F] rows of cstk over the
    reverse table, the terms per valid slot, summed over the slots."""
    F = cstk.shape[1] // n_blocks(has_lin, has_dev, n_cmp)
    g = cstk[rev_nbr_nodes.long()]                      # [N, Wr, K*F]
    m = ell_mask(rev_nbr_nodes, out_degree)[..., None]
    vj = None if v is None else v[:, None, :]
    t = _terms(g, vj, F, has_lin, has_dev, n_cmp)
    return torch.where(m, t, cstk.new_zeros(())).sum(1)


def ell_gather_backward_csr_plain(cstk, rev_ptr, rev_idx, v=None,
                                  has_lin=True, has_dev=False, n_cmp=0):
    """The gather over the reverse CSR in plain torch: the terms of every
    sorted slot (sender j, receiver ``rev_idx[e]``), then a segment sum
    over the senders."""
    N = cstk.shape[0]
    F = cstk.shape[1] // n_blocks(has_lin, has_dev, n_cmp)
    counts = (rev_ptr[1:] - rev_ptr[:-1]).long()
    send = torch.repeat_interleave(
        torch.arange(N, device=cstk.device), counts)
    g = cstk[rev_idx.long()]                            # [E, K*F]
    vj = None if v is None else v[send]
    t = _terms(g, vj, F, has_lin, has_dev, n_cmp)
    return segment_sum(t, send, N)


def ell_gather_backward_ordered(cstk, rev_nbr_nodes, out_degree, v=None,
                                has_lin=True, has_dev=False, n_cmp=0):
    """The gather as the kernel sums it: for r = 0, 1, .. each row's r-th
    valid slot adds its terms one at a time (c_lin, then v d1 - d2 with
    each operation rounded, then each hit coefficient) into a float32
    accumulator, which a term that does not apply leaves untouched."""
    F = cstk.shape[1] // n_blocks(has_lin, has_dev, n_cmp)
    acc = cstk.new_zeros((cstk.shape[0], F))
    for r in range(rev_nbr_nodes.shape[1]):
        on = (r < out_degree)[:, None]
        g = cstk[rev_nbr_nodes[:, r].long()]
        o = 0
        if has_lin:
            acc = torch.where(on, acc + g[:, :F], acc)
            o = F
        if has_dev:
            acc = torch.where(on, acc + (v * g[:, o:o + F]
                                         - g[:, o + F:o + 2 * F]), acc)
            o += 2 * F
        for _ in range(n_cmp):
            hit = on & (v == g[:, o:o + F])
            acc = torch.where(hit, acc + g[:, o + F:o + 2 * F], acc)
            o += 2 * F
    return acc


def ell_gather_backward_csr_ordered(cstk, rev_ptr, rev_idx, v=None,
                                    has_lin=True, has_dev=False, n_cmp=0):
    """``ell_gather_backward_ordered`` over the reverse CSR: the CSR laid
    out as a table of each sender's slots in order."""
    counts = rev_ptr[1:] - rev_ptr[:-1]
    width = max(int(counts.max()) if counts.numel() else 0, 1)
    r = torch.arange(width, device=rev_ptr.device)
    table = torch.zeros((counts.shape[0], width), dtype=rev_idx.dtype,
                        device=rev_idx.device)
    table[r < counts[:, None]] = rev_idx   # row-major: the CSR's order
    return ell_gather_backward_ordered(cstk, table, counts, v, has_lin,
                                       has_dev, n_cmp)


def _check(cstk, v, has_lin, has_dev, n_cmp, named_ints):
    """Shapes, types and devices; ``named_ints`` are the table or CSR
    arrays, (name, tensor, shape) with None for a free extent."""
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
    if cstk.numel() >= 2 ** 31 or n_cmp > 4:
        raise ValueError(f"the gather takes N * K * F below 2^31 and at "
                         f"most 4 compares; got {cstk.numel()} coefficients"
                         f", {n_cmp} compares")
    if v is not None and (tuple(v.shape) != (N, F)
                          or v.dtype != torch.float32):
        raise ValueError(f"v must be ({N}, {F}) float32")
    for name, t, shape in named_ints:
        if t.dim() != len(shape) or any(
                want is not None and got != want
                for got, want in zip(t.shape, shape)):
            raise ValueError(f"{name} must be {shape} (None = any), got "
                             f"{tuple(t.shape)}")
    devs = {t.device for t in (cstk, v, *(t for _, t, _ in named_ints))
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(entry, cstk, ints, v, has_lin, has_dev, n_cmp, extra=()):
    """Launch ``entry`` of the library on cstk, the int32 table or CSR
    arrays ``ints`` and v; ``extra`` are the int arguments between N and
    F (the table's width)."""
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    K = n_blocks(has_lin, has_dev, n_cmp)
    N = cstk.shape[0]
    F = cstk.shape[1] // K
    if any(t.dtype != torch.int32 for t in ints):
        raise ValueError("the reverse table or CSR must be int32")
    tensors = [t for t in (cstk, *ints, v) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 4 + [I] * (5 + len(extra)) + [P, P, I]
    dv = torch.empty((N, F), dtype=torch.float32, device=cstk.device)
    stream = torch.cuda.current_stream(cstk.device).cuda_stream
    err = fn(cstk.data_ptr(), *(t.data_ptr() for t in ints),
             None if v is None else v.data_ptr(), N, *extra, F,
             int(bool(has_lin)), int(bool(has_dev)), int(n_cmp),
             dv.data_ptr(), stream, cstk.device.index or 0)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return dv


def fused_gather_backward(cstk, rev_nbr_nodes, out_degree, v=None,
                          has_lin: bool = True, has_dev: bool = False,
                          n_cmp: int = 0):
    """dv [N, F] from the coefficient stack ``cstk`` [N, K*F] over the
    reverse table ``rev_nbr_nodes`` [N, Wr] / ``out_degree`` [N] (int32),
    with the local rows ``v`` [N, F] for dev and cmp terms.  A CUDA
    ``cstk`` launches the kernel; a CPU one runs the plain version."""
    N = cstk.shape[0]
    _check(cstk, v, has_lin, has_dev, n_cmp,
           (("rev_nbr_nodes", rev_nbr_nodes, (N, None)),
            ("out_degree", out_degree, (N,))))
    if cstk.device.type == "cuda":
        dv = _launch("gnnb_ell_gather_bwd", cstk,
                     (rev_nbr_nodes, out_degree), v, has_lin, has_dev, n_cmp,
                     extra=(rev_nbr_nodes.shape[1],))
        fused_gather_backward.launches += 1
        return dv
    if cstk.device.type != "cpu":
        raise ValueError(f"no gather backward for device {cstk.device}")
    return ell_gather_backward_plain(cstk, rev_nbr_nodes, out_degree, v,
                                     has_lin, has_dev, n_cmp)


fused_gather_backward.launches = 0


def fused_gather_backward_csr(cstk, rev_ptr, rev_idx, v=None,
                              has_lin: bool = True, has_dev: bool = False,
                              n_cmp: int = 0):
    """``fused_gather_backward`` over the reverse CSR ``rev_ptr`` [N + 1],
    ``rev_idx`` [E] (int32, ``ops.ell.reverse_csr``) in place of the
    reverse table: the kernel's CSR mode for a CUDA ``cstk``, the plain
    version for a CPU one.  Each output element still has one owner that
    sums in slot order, so dv is the same bits on every run."""
    N = cstk.shape[0]
    _check(cstk, v, has_lin, has_dev, n_cmp,
           (("rev_ptr", rev_ptr, (N + 1,)), ("rev_idx", rev_idx, (None,))))
    if cstk.device.type == "cuda":
        dv = _launch("gnnb_ell_gather_bwd_csr", cstk, (rev_ptr, rev_idx), v,
                     has_lin, has_dev, n_cmp)
        fused_gather_backward_csr.launches += 1
        return dv
    if cstk.device.type != "cpu":
        raise ValueError(f"no gather backward for device {cstk.device}")
    return ell_gather_backward_csr_plain(cstk, rev_ptr, rev_idx, v, has_lin,
                                         has_dev, n_cmp)


fused_gather_backward_csr.launches = 0

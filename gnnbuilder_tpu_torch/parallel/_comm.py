"""The collectives of the sharded paths, as ``torch.autograd.Function``s.

Every rank computes the same loss, and the sharded train step counts it
once: each rank's backward starts from the loss over the mesh's size
(``count_once``), and each collective's backward is the transpose of its
forward as a map from all ranks' inputs to all ranks' outputs (the rule
JAX's ``ppermute`` / ``psum`` / ``all_gather`` follow).  So:

* ``all_reduce_sum`` (every rank gets the sum): backward sums the
  cotangents again;
* ``all_gather`` (every rank gets the concat): backward sums the
  cotangents and keeps this rank's slice;
* the halo exchange (``halo.halo_exchange``): backward sends each halo's
  cotangent back to the rank it came from, which adds it into the rows it
  sent.

Then a replicated parameter's gradient is the sum of every rank's, and
the train step sums it over the mesh; a tp shard's is the sum over dp.

Under ``Mesh.staging`` (gloo with CUDA tensors) each collective copies
its buffers to the host and back, explicitly.  A group of one rank runs
no collective.  No collective here catches an error: a failed send or
receive raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "all_gather", "count_once", "p2p_start"]


def _comm(mesh, t):
    t = t.contiguous()
    return t.cpu() if mesh.staging else t


def _back(mesh, t, like):
    return t.to(like.device) if mesh.staging else t


def _all_reduce(mesh, axis, t):
    """The sum of ``t`` over ``axis`` ("dp", "tp" or "mesh": all of the
    mesh's ranks), a new tensor."""
    n = mesh.size if axis == "mesh" else mesh.shape[axis]
    if n == 1:
        return t.clone()
    group = mesh.mesh_group if axis == "mesh" else mesh.group(axis)
    buf = _comm(mesh, t)
    if buf is t:
        buf = t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return _back(mesh, buf, t)


def _all_gather(mesh, axis, t, dim):
    n = mesh.shape[axis]
    if n == 1:
        return t.clone()
    buf = _comm(mesh, t)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=mesh.group(axis))
    return _back(mesh, torch.cat(parts, dim=dim), t)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(mesh, axis, x)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ctx.mesh, ctx.axis, ct), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.width = x.shape[dim]
        return _all_gather(mesh, axis, x, dim)

    @staticmethod
    def backward(ctx, ct):
        total = _all_reduce(ctx.mesh, ctx.axis, ct)
        i, w = ctx.mesh.index(ctx.axis), ctx.width
        return total.narrow(ctx.dim, i * w, w), None, None, None


class _Scale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.scale, None


def all_reduce_sum(x, mesh, axis: str = "dp"):
    """The sum of ``x`` over ``axis`` on every rank (differentiable)."""
    return _AllReduceSum.apply(x, mesh, axis)


def all_gather(x, mesh, axis: str = "dp", dim: int = 0):
    """The ranks' ``x`` along ``axis``, concatenated on ``dim`` in axis
    order, on every rank (differentiable)."""
    return _AllGather.apply(x, mesh, axis, dim)


def count_once(loss, mesh):
    """``loss`` with its backward scaled by 1 / the mesh's ranks: a loss
    that every rank of the mesh forms counts once in the summed
    gradients."""
    return _Scale.apply(loss, 1.0 / mesh.size)


class P2P:
    """Point-to-point sends and receives started on a group, finished by
    ``wait``, which returns the received tensors on the caller's device."""

    def __init__(self, mesh, like, works, recvs, keep):
        self.mesh, self.like = mesh, like
        self.works, self.recvs, self.keep = works, recvs, keep

    def wait(self):
        for w in self.works:
            w.wait()
        self.keep = None
        return [None if r is None else _back(self.mesh, r, self.like)
                for r in self.recvs]


def p2p_start(mesh, axis, like, sends, recvs):
    """Start ``sends`` [(tensor, index along axis)] and receives
    ``recvs`` [(shape, index) or None] on ``axis``'s group with
    ``dist.batch_isend_irecv``; returns a ``P2P`` whose ``wait`` gives
    the received tensors (None for a None entry)."""
    ranks = mesh.group_ranks(axis)
    group = mesh.group(axis)
    dev = torch.device("cpu") if mesh.staging else like.device
    ops, keep, bufs = [], [], []
    for t, i in sends:
        buf = _comm(mesh, t)
        keep.append(buf)
        ops.append(dist.P2POp(dist.isend, buf, ranks[i], group))
    for spec in recvs:
        if spec is None:
            bufs.append(None)
            continue
        shape, i = spec
        buf = torch.empty(shape, dtype=like.dtype, device=dev)
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, ranks[i], group))
    works = dist.batch_isend_irecv(ops) if ops else []
    return P2P(mesh, like, works, bufs, keep)

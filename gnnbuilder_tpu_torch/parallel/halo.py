"""The halo exchange and the edge-partitioned ELL aggregation (the JAX
package's ``parallel/halo.py``).

Layout: the packer lays graphs out contiguously and no edge crosses
graphs.  Shard the node rows (and their incoming-edge ELL tables, which
keep GLOBAL ids) into dp contiguous blocks; then a row's neighbours are
local or inside the one graph that straddles a block boundary, within
``halo`` (>= the largest graph) rows of it.  So the only communication
is a fixed-size swap with the left and right ring neighbours, after
which aggregation is the plain ELL reduce on the [halo | local | halo]
window.  Per layer and rank that is 2 * halo * F values, whatever the
batch size.

``halo_exchange`` is a ``torch.autograd.Function``: its forward is a
``dist.batch_isend_irecv`` ring on the dp group (each rank sends its
first ``halo`` rows left and its last ``halo`` rows right; the ends of
the ring get zeros), its backward the transpose of JAX's ``ppermute``:
each halo's cotangent goes back to the rank it came from and adds into
the rows it sent.  With one rank on dp it sends nothing and gives the
same window with zero halos.

The scope (``halo_scope``, a contextvar as in JAX) is what lets the
unchanged convs run on a rank's rows: ``ops.ell.ell_gather`` reads from
the window, ``nn.pool.GlobalPooling`` reduces its per-graph partials over
dp, the kernel gates of ``ops.dispatch`` decline where the JAX gates do,
and the per-layer kernel wrappers of rows 4, 5 and 10 run their kernel
on the window through ``halo_wrap_layer``.  ``allgather_scope`` is the
scope of the other strategy (``train.make_sharded_forward(halo=False)``):
the gathers read the all-gathered rows instead of a window.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

from gnnbuilder_tpu_torch.ops import ell, segment
from gnnbuilder_tpu_torch.parallel import _comm

__all__ = [
    "ell_aggregate_sharded",
    "ell_sum_sharded",
    "halo_exchange",
    "halo_scope",
    "allgather_scope",
    "no_halo",
    "active_halo",
    "active_scope",
    "halo_pad_rows",
    "halo_wrap_layer",
    "scoped_edge_mean",
]


class _Scope:
    """A sharded forward's state: the mesh, the axis of the node rows, the
    halo (0 under the all-gather strategy) and the windows its layers
    share (``window``)."""

    def __init__(self, mesh, axis: str, halo: int):
        self.mesh, self.axis, self.halo = mesh, axis, int(halo)
        self._windows = {}
        self._edge_means = {}

    def window(self, nbr_nodes, in_degree, n_pad: int):
        """The window tables of ``nbr_nodes`` for this rank, made once per
        scope (so once per forward or train step, whatever the layers)."""
        key = (id(nbr_nodes), n_pad)
        hit = self._windows.get(key)
        if hit is None or hit.nbr_nodes is not nbr_nodes:
            hit = _Window(self, nbr_nodes, in_degree, n_pad)
            self._windows[key] = hit
        return hit


class _Window:
    """The window's ids and degrees: the rows' global ids moved into the
    [halo | local | halo | pad] window and clamped to it (ghost and pad
    slots fall outside and are masked by degree), the halo and pad rows
    with degree 0 and ids 0; and its reverse CSR at first use."""

    def __init__(self, scope, nbr_nodes, in_degree, n_pad):
        h = scope.halo
        n_local, W = nbr_nodes.shape
        base = scope.mesh.index(scope.axis) * n_local
        ids = (nbr_nodes.long() - base + h).clamp(0, n_pad - 1)
        tail = n_pad - h - n_local
        self.nbr_nodes = nbr_nodes
        self.nbr_ext = torch.cat([
            ids.new_zeros((h, W)), ids, ids.new_zeros((tail, W))]).to(
                torch.int32)
        deg = in_degree.to(torch.int32)
        self.deg_ext = torch.cat([deg.new_zeros(h), deg,
                                  deg.new_zeros(tail)])
        self._rev = None

    def rev_csr(self):
        """``ops.ell.reverse_csr(nbr_ext, deg_ext, positions=True)``,
        built once per window."""
        if self._rev is None:
            self._rev = ell.reverse_csr(self.nbr_ext, self.deg_ext,
                                        positions=True)
        return self._rev


_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "gnnb_torch_halo_scope", default=None
)


@contextlib.contextmanager
def halo_scope(axis: str, halo: int, mesh):
    """Run the model on this rank's node rows with windowed gathers of
    width ``halo`` over ``mesh``'s ``axis``."""
    if int(halo) <= 0:
        raise ValueError(f"halo must be positive, got {halo}")
    tok = _SCOPE.set(_Scope(mesh, axis, halo))
    try:
        yield
    finally:
        _SCOPE.reset(tok)


@contextlib.contextmanager
def allgather_scope(mesh, axis: str = "dp"):
    """Run the model on this rank's node and edge rows with gathers that
    read the rows all-gathered over ``axis`` (the all-gather strategy)."""
    tok = _SCOPE.set(_Scope(mesh, axis, 0))
    try:
        yield
    finally:
        _SCOPE.reset(tok)


@contextlib.contextmanager
def no_halo():
    """Clear the scope: for code whose arrays and ids are already
    window-local (``halo_wrap_layer``), which the scope's ops must not
    remap again."""
    tok = _SCOPE.set(None)
    try:
        yield
    finally:
        _SCOPE.reset(tok)


def active_scope() -> Optional[_Scope]:
    """The active scope of either strategy, or None."""
    return _SCOPE.get()


def active_halo() -> Optional[Tuple[str, int]]:
    """(axis, halo) inside ``halo_scope``, else None."""
    s = _SCOPE.get()
    return None if s is None or s.halo == 0 else (s.axis, s.halo)


def _exchange_start(x, h: int, mesh, axis: str):
    """Start the ring: my first h rows to the left neighbour (its right
    halo), my last h rows to the right neighbour (its left halo)."""
    n, i = mesh.shape[axis], mesh.index(axis)
    shape = (h,) + tuple(x.shape[1:])
    sends, recvs = [], [None, None]
    if i > 0:
        sends.append((x[:h], i - 1))
        recvs[0] = (shape, i - 1)
    if i < n - 1:
        sends.append((x[-h:], i + 1))
        recvs[1] = (shape, i + 1)
    if not sends:
        return None
    return _comm.p2p_start(mesh, axis, x, sends, recvs)


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, mesh, axis, pending):
        ctx.h, ctx.mesh, ctx.axis = h, mesh, axis
        if pending is None:
            pending = _exchange_start(x, h, mesh, axis)
        left = right = None
        if pending is not None:
            left, right = pending.wait()
        zero = x.new_zeros((h,) + tuple(x.shape[1:]))
        return torch.cat([zero if left is None else left, x,
                          zero if right is None else right])

    @staticmethod
    def backward(ctx, ct):
        h, mesh, axis = ctx.h, ctx.mesh, ctx.axis
        n_local = ct.shape[0] - 2 * h
        dx = ct[h:h + n_local].clone()
        n, i = mesh.shape[axis], mesh.index(axis)
        shape = (h,) + tuple(ct.shape[1:])
        sends, recvs = [], [None, None]
        # my left halo was the left neighbour's last rows; my right halo
        # the right neighbour's first rows
        if i > 0:
            sends.append((ct[:h], i - 1))
            recvs[0] = (shape, i - 1)
        if i < n - 1:
            sends.append((ct[-h:], i + 1))
            recvs[1] = (shape, i + 1)
        if sends:
            from_left, from_right = _comm.p2p_start(
                mesh, axis, ct, sends, recvs).wait()
            if from_right is not None:
                dx[-h:] += from_right
            if from_left is not None:
                dx[:h] += from_left
        return dx, None, None, None, None


def _scope_mesh(mesh, axis):
    if mesh is not None:
        return mesh
    s = _SCOPE.get()
    if s is None:
        raise RuntimeError("halo_exchange needs a mesh or an active "
                           "halo_scope")
    return s.mesh


def halo_exchange(x_local, halo: int, axis: str = "dp", mesh=None):
    """[left halo | x_local | right halo] from the ring neighbours on
    ``axis`` (the scope's mesh when ``mesh`` is None): x_local is this
    rank's [n_local, ...] rows; the result has n_local + 2 * halo rows,
    zeros beyond the ends of the ring.  Differentiable."""
    mesh = _scope_mesh(mesh, axis)
    return _HaloExchange.apply(x_local, int(halo), mesh, axis, None)


def scoped_gather(scope, values, table, node_rows: bool = True):
    """``ops.ell.ell_gather`` under a scope: rows of the window (halo) or
    of the all-gathered rows (all-gather strategy) by the table's global
    ids.  ``node_rows=False`` marks an edge-indexed gather: under halo the
    edge arrays replicate, so the global ids are taken as they are;
    under the all-gather strategy the edge rows are sharded like the
    node rows and gathered first."""
    ids = table.long()
    if scope.halo == 0:
        full = _comm.all_gather(values, scope.mesh, scope.axis)
        return full[ids]
    if not node_rows:
        return values[ids]
    h = scope.halo
    xw = halo_exchange(values, h, scope.axis, scope.mesh)
    base = scope.mesh.index(scope.axis) * values.shape[0]
    return xw[(ids - base + h).clamp(0, xw.shape[0] - 1)]


def scoped_edge_mean(scope, values, receivers, in_degree):
    """The mean of each node's incoming edge rows, for this rank's node
    rows, under the all-gather strategy: ``values`` [E_local, F] and
    ``receivers`` [E_local] (global ids) are this rank's edge rows, and
    all ranks' are gathered in rank order, summed by receiver, and this
    rank's [n_local, F] slice taken over max(in_degree, 1) (0 on an empty
    row).  Formed once per scope for a given ``values``, so a forward's
    layers share it."""
    key = id(values)
    hit = scope._edge_means.get(key)
    if hit is not None and hit[0] is values:
        return hit[1]
    n = in_degree.shape[0]
    mesh, axis = scope.mesh, scope.axis
    base = mesh.index(axis) * n
    s = segment.segment_sum(
        _comm.all_gather(values, mesh, axis),
        _comm.all_gather(receivers, mesh, axis),
        n * mesh.shape[axis])[base:base + n]
    mean = s / in_degree.to(values.dtype)[:, None].clamp(min=1.0)
    scope._edge_means[key] = (values, mean)
    return mean


def ell_aggregate_sharded(
    mesh,
    x,             # [n_local, F] this rank's node rows
    nbr_nodes,     # [n_local, W] their ELL table, global ids
    in_degree,     # [n_local]
    halo: int,
    aggregators=("sum",),
    axis: str = "dp",
    overlap: bool = True,
):
    """Edge-partitioned ELL aggregation of this rank's rows: any of sum,
    mean, max, min and std, concatenated [n_local, A*F] in aggregator
    order (the sharded ``ops.ell.ell_multi``).  ``halo`` must cover the
    largest graph (the packer's graph contiguity keeps every neighbour
    id within it).

    ``overlap=True`` issues the ring's sends and receives first, reduces
    the rows whose neighbours are all local (every row but the first and
    last ``halo``) on the current stream while they are in flight, waits,
    then re-reduces the 2 * halo boundary rows against the window and
    patches them in.  Under NCCL the sends and receives run on NCCL's own
    stream, so on several cards the exchange hides behind the reduce.
    Each row's reduce reads the same values in the same slot order in
    either form, so both give the same bits.  With fewer than 2 * halo
    local rows it takes the sequential exchange-then-reduce."""
    n_local = x.shape[0]
    if not 0 < halo <= n_local:
        raise ValueError(f"halo must be in (0, {n_local}], got {halo}")
    h = int(halo)
    base = mesh.index(axis) * n_local
    nbr = nbr_nodes.long()

    def cat(d):
        return torch.cat([d[a] for a in aggregators], dim=-1)

    if not (overlap and n_local >= 2 * h):
        xw = _HaloExchange.apply(x, h, mesh, axis, None)
        ids = (nbr - base + h).clamp(0, n_local + 2 * h - 1)
        return cat(ell.ell_multi(xw, ids, in_degree, aggregators))

    pending = _exchange_start(x.detach(), h, mesh, axis)
    ids_int = (nbr - base).clamp(0, n_local - 1)
    d_int = cat(ell.ell_multi(x, ids_int, in_degree, aggregators))
    xw = _HaloExchange.apply(x, h, mesh, axis, pending)
    bnd = torch.cat([torch.arange(h), torch.arange(n_local - h, n_local)]
                    ).to(nbr.device)
    ids_bnd = (nbr[bnd] - base + h).clamp(0, n_local + 2 * h - 1)
    d_bnd = cat(ell.ell_multi(xw, ids_bnd, in_degree[bnd], aggregators))
    return torch.cat([d_bnd[:h], d_int[h:n_local - h], d_bnd[h:]])


def ell_sum_sharded(mesh, x, nbr_nodes, in_degree, halo, axis="dp"):
    """Sum-only ``ell_aggregate_sharded``."""
    return ell_aggregate_sharded(mesh, x, nbr_nodes, in_degree, halo,
                                 ("sum",), axis)


def halo_pad_rows(n_local: int, halo: int, quantum: int = 8) -> int:
    """Rows of a layer kernel's window: [halo | local | halo] rounded up
    to ``quantum`` (the JAX package rounds to its TPU tile of 256; the
    CUDA kernels take any row count, and 8 keeps the rows aligned)."""
    return -(-(n_local + 2 * halo) // quantum) * quantum


def halo_wrap_layer(call, x, nbr_nodes, in_degree, skip=None):
    """Run a per-layer kernel on this rank's window.

    Under ``halo_scope``, ``x`` and ``skip`` are this rank's rows and
    ``nbr_nodes`` holds global ids.  Exchanges the halo rows, takes the
    window's tables (``_Window``: ids moved into the window and clamped,
    halo and pad rows of degree 0, made once per scope), clears the
    scope (everything ``call`` gets is window-local, so no op remaps ids
    again, in the backward neither), and returns the local rows of the
    result.  ``call(xw, nbr_ext, deg_ext, skip_ext, rev_csr)`` runs the
    kernel, ``rev_csr`` a callable giving the window's reverse CSR (the
    windows have no reverse table, so the backwards take their CSR
    routes).  Gradients flow back through the exchange, the padding and
    the slice.  Counts its calls in ``halo_wrap_layer.calls``."""
    scope = _SCOPE.get()
    if scope is None or scope.halo == 0:
        raise RuntimeError("halo_wrap_layer requires an active halo scope")
    halo_wrap_layer.calls += 1
    h = scope.halo
    n_local = x.shape[0]
    n_pad = halo_pad_rows(n_local, h)
    win = scope.window(nbr_nodes, in_degree, n_pad)
    tail = n_pad - h - n_local
    xw = halo_exchange(x, h, scope.axis, scope.mesh)
    if n_pad > xw.shape[0]:
        xw = torch.cat([xw, xw.new_zeros((n_pad - xw.shape[0],)
                                         + tuple(xw.shape[1:]))])
    skip_ext = None
    if skip is not None:
        skip_ext = torch.cat([skip.new_zeros((h,) + tuple(skip.shape[1:])),
                              skip,
                              skip.new_zeros((tail,)
                                             + tuple(skip.shape[1:]))])
    with no_halo():
        out = call(xw, win.nbr_ext, win.deg_ext, skip_ext, win.rev_csr)
    return out[h:h + n_local]


halo_wrap_layer.calls = 0

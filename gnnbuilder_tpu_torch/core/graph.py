"""Padded graph batches as torch tensors.

Every array has a static (bucketed) shape, edges are sorted by receiver on
the host, and one trailing ghost graph absorbs all padding (pad nodes live
in it, pad edges run ghost -> ghost), so segment reductions stay mask-free
and masks exist only for pooling and losses.  Degree tables, CSR offsets,
the ELL neighbour table and the block adjacency are computed once on the
host in numpy and shipped with the batch; the tensors are made at the end,
on the device the caller names.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from gnnbuilder_tpu_torch.core import packing

__all__ = ["GraphBatch", "build_graph_batch", "pad_sizes",
           "resolve_block_size", "resolve_device", "ELL_MAX_WIDTH",
           "set_default_ell_width"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card; raises when CUDA is requested and absent
    (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "path on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """A statically-shaped batch of graphs packed into flat node/edge arrays.

    N = padded node count, E = padded edge count, G = padded graph count
    (the last graph is the ghost graph holding all padding).  Edges follow
    the PyG convention ``senders[e] -> receivers[e]`` and are sorted by
    receiver, so per-receiver segments are contiguous.
    """

    node_feat: torch.Tensor              # [N, F] float
    senders: torch.Tensor                # [E] int32, sorted by receivers
    receivers: torch.Tensor              # [E] int32, non-decreasing
    edge_feat: Optional[torch.Tensor]    # [E, Fe] float or None
    node_graph: torch.Tensor             # [N] int32 graph id (pad -> G-1)
    in_degree: torch.Tensor              # [N] int32 real incoming edges
    row_offsets: torch.Tensor            # [N+1] int32 CSR offsets
    n_node: torch.Tensor                 # [G] int32 real nodes per graph
    n_edge: torch.Tensor                 # [G] int32 real edges per graph
    node_mask: torch.Tensor              # [N] bool
    edge_mask: torch.Tensor              # [E] bool
    graph_mask: torch.Tensor             # [G] bool
    # ELL table: slot d of node v holds its d-th incoming neighbour (pad
    # slots hold the ghost id; valid iff d < in_degree[v])
    nbr_nodes: Optional[torch.Tensor] = None      # [N, W] int32
    nbr_edges: Optional[torch.Tensor] = None      # [N, W] int32
    # reverse (out-neighbour) table + out-degree, for backward kernels
    rev_nbr_nodes: Optional[torch.Tensor] = None  # [N, Wr] int32
    out_degree: Optional[torch.Tensor] = None     # [N] int32
    # block-diagonal layout (block_size=B): no graph crosses a B-row
    # boundary; A[t, i, j] = #edges (t*B+j) -> (t*B+i).  Small integer
    # counts, exact in float32.
    block_adj: Optional[torch.Tensor] = None      # [T, B, B] float32
    # row of each graph's first node (ghost entry: first pad row under
    # standard packing, the reserved ghost row N-1 under block packing)
    graph_starts: Optional[torch.Tensor] = None   # [G] int32

    num_graphs_static: int = 0
    # largest real graph in the batch, rounded up to 8 (0 = unknown)
    max_graph_nodes_static: int = 0
    # block packing block size B (0 = standard contiguous packing)
    block_size_static: int = 0
    # True when some (sender, receiver) pair repeats
    multigraph_static: bool = False

    @property
    def num_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.n_node.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.node_feat.shape[1]

    @property
    def ell_width(self) -> Optional[int]:
        return None if self.nbr_nodes is None else self.nbr_nodes.shape[1]

    @property
    def device(self) -> torch.device:
        return self.node_feat.device

    @functools.cached_property
    def rev_csr(self):
        """``ops.ell.reverse_csr(nbr_nodes, in_degree, positions=True)``:
        (rev_ptr, rev_idx, rev_pos), the reverse CSR of the ELL table with
        each forward slot's CSR position, built on the table's device at
        first use and kept with the batch, so a train step's layers and
        later steps on the batch share one.  A batch made by ``replace``
        or ``to`` builds its own."""
        from gnnbuilder_tpu_torch.ops.ell import reverse_csr

        return reverse_csr(self.nbr_nodes, self.in_degree, positions=True)

    def replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def with_node_feat(self, x: torch.Tensor) -> "GraphBatch":
        return self.replace(node_feat=x)

    def to(self, device) -> "GraphBatch":
        """The same batch with every tensor on ``device``."""
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return self.replace(**moved)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_sizes(
    num_nodes: int,
    num_edges: int,
    num_graphs: int,
    node_multiple: int = 8,
    edge_multiple: int = 8,
) -> tuple[int, int, int]:
    """Bucketed padded sizes: +1 ghost node/graph, rounded up to multiples,
    so the number of distinct shapes stays small."""
    n_pad = _round_up(num_nodes + 1, node_multiple)
    e_pad = _round_up(max(num_edges, 1), edge_multiple)
    g_pad = num_graphs + 1
    return n_pad, e_pad, g_pad


# in-degree above which the ELL layout stops paying off
ELL_MAX_WIDTH = 64

# "auto" block packing: total real nodes above which block packing is
# chosen (the JAX package's policy, measured on its TPU; not re-measured
# for this package), and the block size it picks
_BLOCK_AUTO_MIN_NODES = 1024
_BLOCK_AUTO_SIZE = 128


def resolve_block_size(block_size, n_node_list) -> Optional[int]:
    """Resolve a ``block_size`` argument that may be the string "auto":
    block packing (B=128) when the batch is large enough and every graph
    fits in one block, else standard packing.  Other values pass through."""
    if block_size != "auto":
        return block_size
    if not n_node_list:
        return None
    if max(n_node_list) > _BLOCK_AUTO_SIZE:
        return None
    if sum(n_node_list) < _BLOCK_AUTO_MIN_NODES:
        return None
    return _BLOCK_AUTO_SIZE


# process-wide default for build_graph_batch(ell_width=None): the DSE's
# handle on the batch layout (ops/dispatch.set_kernel_overrides)
_DEFAULT_ELL_WIDTH: Optional[int] = None


def set_default_ell_width(w: Optional[int]) -> None:
    """Set the ELL width that ``build_graph_batch`` packs with when called
    with ``ell_width=None``: ``None`` restores the automatic policy, ``0``
    packs no table (the edge-list path), an int fixes the width.  Only
    batches packed after the call see it."""
    global _DEFAULT_ELL_WIDTH
    _DEFAULT_ELL_WIDTH = w


def build_graph_batch(
    graphs,
    node_budget: Optional[int] = None,
    edge_budget: Optional[int] = None,
    graph_budget: Optional[int] = None,
    node_multiple: int = 8,
    edge_multiple: int = 8,
    ell_width: Optional[int] = None,
    rev_ell_width: Optional[int] = None,
    dtype=np.float32,
    block_size: Optional[int] = None,
    device=None,
) -> GraphBatch:
    """Pack a list of host graphs into one padded ``GraphBatch`` on ``device``
    (None = the CUDA card, through ``resolve_device``, which raises without
    one; pass ``device="cpu"`` for the CPU).

    ``graphs`` is a sequence of objects with ``x [n,F]``, ``edge_index
    [2,e]`` (numpy) and optionally ``edge_attr [e,Fe]``.  ``block_size=B``
    selects the block-diagonal layout: graphs are bin-packed (order
    preserving, greedy) so no graph crosses a B-row boundary, pad rows sit
    between graphs, and ``block_adj`` carries the [N/B, B, B] adjacency.
    ``block_size="auto"`` applies ``resolve_block_size``.
    ``ell_width``: None = the process default (``set_default_ell_width``),
    and where that is None too, the batch max in-degree rounded up to 4
    (no table above ELL_MAX_WIDTH); 0 = no table, an int = that width.
    """
    device = resolve_device(device)
    if block_size == "auto":
        block_size = resolve_block_size(
            "auto", [int(g.x.shape[0]) for g in graphs]
        )

    xs, eidx, eattr = [], [], []
    has_edge_feat = graphs[0].edge_attr is not None if graphs else False
    n_node, n_edge = [], []
    for g in graphs:
        xs.append(np.asarray(g.x, dtype=dtype))
        eidx.append(np.asarray(g.edge_index, dtype=np.int64))
        if has_edge_feat:
            eattr.append(np.asarray(g.edge_attr, dtype=dtype))
        n_node.append(int(g.x.shape[0]))
        n_edge.append(int(g.edge_index.shape[1]))

    num_nodes = int(sum(n_node))
    num_edges = int(sum(n_edge))
    num_graphs = len(graphs)

    n_pad, e_pad, g_pad = pad_sizes(
        num_nodes, num_edges, num_graphs, node_multiple, edge_multiple
    )

    # graph row starts: contiguous cumsum, or greedy block bin-pack
    if block_size:
        big = [n for n in n_node if n > block_size]
        assert not big, (
            f"block_size={block_size} < largest graph ({max(big)} nodes); "
            "use a larger block or standard packing"
        )
        starts, cur = [], 0
        for n in n_node:
            if (cur % block_size) + n > block_size:
                cur = _round_up(cur, block_size)
            starts.append(cur)
            cur += n
        starts = np.asarray(starts, dtype=np.int64)
        # +1 keeps the ghost row (n_pad - 1) a pad row even when the last
        # block packed full; lcm honours both alignment contracts
        n_pad = _round_up(cur + 1, math.lcm(block_size, node_multiple))
    else:
        starts = np.zeros((num_graphs,), dtype=np.int64)
        np.cumsum(np.asarray(n_node[:-1], dtype=np.int64), out=starts[1:])

    if node_budget is not None:
        assert node_budget >= n_pad, (node_budget, n_pad)
        if block_size:
            assert node_budget % block_size == 0, (node_budget, block_size)
        n_pad = node_budget
    if edge_budget is not None:
        assert edge_budget >= e_pad, (edge_budget, e_pad)
        e_pad = edge_budget
    if graph_budget is not None:
        assert graph_budget >= g_pad, (graph_budget, g_pad)
        g_pad = graph_budget

    # row index of every real node, graph-major (non-contiguous iff blocked)
    n_node_a = np.asarray(n_node, dtype=np.int64)
    row_index = (
        np.repeat(starts, n_node_a)
        + (
            np.arange(num_nodes, dtype=np.int64)
            - np.repeat(np.cumsum(n_node_a) - n_node_a, n_node_a)
        )
        if num_nodes
        else np.zeros((0,), dtype=np.int64)
    )

    feat_dim = xs[0].shape[1]
    x = np.zeros((n_pad, feat_dim), dtype=dtype)
    if num_nodes:
        x[row_index] = np.concatenate(xs, axis=0)

    edge_index = (
        np.concatenate(eidx, axis=1)
        if num_edges
        else np.zeros((2, 0), dtype=np.int64)
    )
    if block_size:
        per_edge_off = np.repeat(starts, np.asarray(n_edge, dtype=np.int64))
        senders_raw = edge_index[0].astype(np.int64) + per_edge_off
        receivers_raw = edge_index[1].astype(np.int64) + per_edge_off
        node_graph = np.repeat(
            np.arange(num_graphs, dtype=np.int32), n_node_a
        )
    else:
        senders_raw, receivers_raw, node_graph = packing.concat_graphs(
            np.asarray(n_edge, dtype=np.int64),
            n_node_a,
            edge_index,
            num_nodes,
        )

    ghost = n_pad - 1  # pad nodes region holds the ghost node at the end

    # real rows are a prefix under standard packing but interleave with
    # pad rows under block packing (never the reserved ghost row)
    id_bound = (n_pad - 1) if block_size else num_nodes
    senders, receivers, perm, row_offsets, in_degree = packing.sort_and_csr(
        senders_raw, receivers_raw, id_bound, n_pad, e_pad, ghost
    )

    max_deg = int(in_degree.max()) if num_edges else 0
    if ell_width is None:
        ell_width = _DEFAULT_ELL_WIDTH
    if ell_width is None:
        w = max(_round_up(max_deg, 4), 4)
        ell_width = w if w <= ELL_MAX_WIDTH else 0
    nbr_nodes = nbr_edges = rev_nbr = out_deg = None
    if ell_width:
        assert ell_width >= max_deg, (
            f"ell_width={ell_width} < batch max in-degree {max_deg}"
        )
        nbr_nodes, nbr_edges = packing.build_ell(
            senders, row_offsets, e_pad, ell_width, ghost
        )
        max_out = (
            int(np.bincount(senders_raw, minlength=1).max()) if num_edges else 0
        )
        if rev_ell_width is None:
            rev_w = max(_round_up(max_out, 4), 4)
            if rev_w > ELL_MAX_WIDTH:
                rev_w = 0
        else:
            rev_w = rev_ell_width
            assert rev_w == 0 or rev_w >= max_out, (
                f"rev_ell_width={rev_w} < batch max out-degree {max_out}"
            )
        if rev_w:
            rev_nbr, out_deg = packing.build_reverse_ell(
                senders_raw, receivers_raw, id_bound, n_pad, e_pad, ghost,
                rev_w,
            )

    edge_feat = None
    if has_edge_feat:
        fe = eattr[0].shape[1]
        ef = np.zeros((e_pad, fe), dtype=dtype)
        if num_edges:
            ef[:num_edges] = np.concatenate(eattr, axis=0)[perm]
        edge_feat = ef

    ng = np.full((n_pad,), g_pad - 1, dtype=np.int32)  # pad -> ghost graph
    ng[row_index] = node_graph

    nn_ = np.zeros((g_pad,), dtype=np.int32)
    ne_ = np.zeros((g_pad,), dtype=np.int32)
    nn_[:num_graphs] = np.array(n_node, dtype=np.int32)
    ne_[:num_graphs] = np.array(n_edge, dtype=np.int32)
    nn_[g_pad - 1] = n_pad - num_nodes
    ne_[g_pad - 1] = e_pad - num_edges

    node_mask = np.zeros((n_pad,), dtype=bool)
    node_mask[row_index] = True
    edge_mask = np.zeros((e_pad,), dtype=bool)
    edge_mask[:num_edges] = True
    graph_mask = np.zeros((g_pad,), dtype=bool)
    graph_mask[:num_graphs] = True

    block_adj = None
    if block_size:
        T = n_pad // block_size
        A = np.zeros((T, block_size, block_size), dtype=np.float32)
        if num_edges:
            tb, li = np.divmod(receivers_raw, block_size)
            lj = senders_raw % block_size
            assert (senders_raw // block_size == tb).all(), "cross-block edge"
            np.add.at(A, (tb, li, lj), 1.0)
        block_adj = A

    graph_starts = np.zeros((g_pad,), dtype=np.int32)
    graph_starts[:num_graphs] = starts.astype(np.int32)
    graph_starts[num_graphs:] = (n_pad - 1) if block_size else num_nodes

    def t(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return GraphBatch(
        node_feat=t(x),
        senders=t(senders),
        receivers=t(receivers),
        edge_feat=t(edge_feat),
        node_graph=t(ng),
        in_degree=t(in_degree),
        row_offsets=t(row_offsets),
        n_node=t(nn_),
        n_edge=t(ne_),
        node_mask=t(node_mask),
        edge_mask=t(edge_mask),
        graph_mask=t(graph_mask),
        nbr_nodes=t(nbr_nodes),
        nbr_edges=t(nbr_edges),
        rev_nbr_nodes=t(rev_nbr),
        out_degree=t(out_deg),
        block_adj=t(block_adj),
        graph_starts=t(graph_starts),
        num_graphs_static=g_pad,
        # bucketed to a multiple of 8, as in the JAX package
        max_graph_nodes_static=(
            _round_up(int(max(n_node)), 8) if n_node else 0
        ),
        block_size_static=int(block_size or 0),
        multigraph_static=bool(
            num_edges
            and np.unique(
                senders_raw.astype(np.int64) * n_pad + receivers_raw
            ).size < num_edges
        ),
    )

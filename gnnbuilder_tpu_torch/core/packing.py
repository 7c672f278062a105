"""Host-side graph packing: edge sort + CSR and ELL table build.

The tables are built once on the host and shipped to the device with the
batch, rather than rebuilt per inference call.  ``concat_graphs``,
``sort_and_csr`` and ``build_ell`` run the native C++ packer
(``native/packing.cpp``, a counting sort, built with g++ at first use),
as the JAX package's packer does; a failed build raises.  The numpy
functions ``*_plain`` are their plain versions, with the same results bit
for bit, which the tests hold the library against.
"""

from __future__ import annotations

import numpy as np

from gnnbuilder_tpu_torch.native import lib as _native

__all__ = ["sort_and_csr", "concat_graphs", "build_ell", "build_reverse_ell",
           "sort_and_csr_plain", "concat_graphs_plain", "build_ell_plain"]


# the native packer: the arguments and results of the ``*_plain``
# versions below, bit for bit
concat_graphs = _native.concat_edges
sort_and_csr = _native.sort_and_csr
build_ell = _native.build_ell


def concat_graphs_plain(
    edge_counts: np.ndarray,
    node_counts: np.ndarray,
    edge_index: np.ndarray,
    total_nodes: int,
):
    """Offset per-graph edge ids into global batch ids + per-node graph ids.

    ``edge_index`` is [2, total_edges], the graph-major concatenation of the
    raw per-graph edge arrays.  Returns (senders i64, receivers i64,
    node_graph i32) in flat batch coordinates.
    """
    num_graphs = int(edge_counts.shape[0])
    node_offsets = np.zeros((num_graphs,), dtype=np.int64)
    np.cumsum(node_counts[:-1], out=node_offsets[1:])
    per_edge_off = np.repeat(node_offsets, edge_counts)
    senders = edge_index[0].astype(np.int64) + per_edge_off
    receivers = edge_index[1].astype(np.int64) + per_edge_off
    node_graph = np.repeat(
        np.arange(num_graphs, dtype=np.int32), node_counts
    )
    return senders, receivers, node_graph


def sort_and_csr_plain(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    n_pad: int,
    e_pad: int,
    ghost: int,
):
    """Sort edges by receiver and build CSR row offsets + in-degree tables.

    Returns (senders[e_pad] i32, receivers[e_pad] i32, perm[num_edges] i64,
    row_offsets[n_pad+1] i32, in_degree[n_pad] i32).  Pad edges are
    ghost->ghost self edges so sorted order is preserved (ghost is the last
    padded node id) and segment reductions dump pad traffic into the ghost row.
    """
    num_edges = int(senders.shape[0])
    assert num_edges <= e_pad, (num_edges, e_pad)

    if num_edges:
        perm = np.argsort(receivers, kind="stable")
    else:
        perm = np.zeros((0,), dtype=np.int64)
    s = np.full((e_pad,), ghost, dtype=np.int32)
    r = np.full((e_pad,), ghost, dtype=np.int32)
    if num_edges:
        s[:num_edges] = senders[perm].astype(np.int32)
        r[:num_edges] = receivers[perm].astype(np.int32)

    in_degree = np.zeros((n_pad,), dtype=np.int32)
    if num_edges:
        np.add.at(in_degree, receivers.astype(np.int64), 1)

    row_offsets = np.zeros((n_pad + 1,), dtype=np.int32)
    # real rows first; the ghost row absorbs the pad edges at the tail
    counts = in_degree.copy()
    counts[ghost] += e_pad - num_edges
    row_offsets[1:] = np.cumsum(counts).astype(np.int32)
    return s, r, perm, row_offsets, in_degree


def build_ell_plain(
    sorted_senders: np.ndarray,
    row_offsets: np.ndarray,
    e_pad: int,
    ell_width: int,
    ghost: int,
):
    """Dense [n_pad, ell_width] neighbor tables from sorted CSR, so device
    aggregation is a dense gather + masked reduce over the width axis.

    Returns (nbr_nodes i32 [n_pad, W], nbr_edges i32 [n_pad, W]); pad slots
    hold the ghost node id / the last pad edge id.  Rows longer than
    ``ell_width`` (only the ghost row, by construction) are truncated.
    """
    n_pad = int(row_offsets.shape[0]) - 1
    nbr_nodes = np.full((n_pad, ell_width), ghost, dtype=np.int32)
    nbr_edges = np.full((n_pad, ell_width), e_pad - 1, dtype=np.int32)
    lo = row_offsets[:-1].astype(np.int64)
    length = np.minimum(
        (row_offsets[1:] - row_offsets[:-1]).astype(np.int64), ell_width
    )
    # flat (row, slot) pairs for every kept edge
    rows = np.repeat(np.arange(n_pad, dtype=np.int64), length)
    slots = (np.arange(int(length.sum()), dtype=np.int64)
             - np.repeat(np.cumsum(length) - length, length))
    eids = np.repeat(lo, length) + slots
    nbr_nodes[rows, slots] = sorted_senders[eids]
    nbr_edges[rows, slots] = eids.astype(np.int32)
    return nbr_nodes, nbr_edges


def build_reverse_ell(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    n_pad: int,
    e_pad: int,
    ghost: int,
    ell_width: int,
):
    """Reverse (out-neighbor) ELL table: row j lists the RECEIVERS of j's
    outgoing edges, i.e. the transpose graph's neighbor table (the backward
    kernels walk it).  ``senders``/``receivers`` are the RAW (unsorted,
    real-edges-only) batch edge arrays.  Returns
    (rev_nbr_nodes i32 [n_pad, ell_width], out_degree i32 [n_pad]).
    """
    r_sorted, _, _, offsets, out_degree = sort_and_csr(
        receivers, senders, num_nodes, n_pad, e_pad, ghost
    )
    rev_nbr, _ = build_ell(r_sorted, offsets, e_pad, ell_width, ghost)
    return rev_nbr, out_degree

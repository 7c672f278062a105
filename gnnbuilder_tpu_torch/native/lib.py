"""ctypes bindings of the native packing library.

``load()`` builds the library at first use (``native/build.py``) and
raises when it cannot be built or loaded: a caller of this package's
packing always gets the native path, never a quiet fallback.  The
functions take and return numpy arrays with the results of
``core/packing.py``'s numpy versions, bit for bit.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

__all__ = ["load", "sort_and_csr", "concat_edges", "build_ell"]

_ABI_VERSION = 2  # gnnb_abi_version() of packing.cpp

_lib = None
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """The loaded library, built on first use (once per process, also
    when the loader's producer thread and the caller ask at once)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _open()
    return _lib


def _open() -> ctypes.CDLL:
    from gnnbuilder_tpu_torch.native.build import build

    path = build()
    lib = ctypes.CDLL(str(path))
    version = lib.gnnb_abi_version()
    if version != _ABI_VERSION:
        raise RuntimeError(f"{path}: ABI version {version}, expected "
                           f"{_ABI_VERSION}")
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.gnnb_sort_and_csr.argtypes = [
        i64p, i64p,            # senders, receivers [num_edges]
        i64, i64, i64, i64, i64,   # num_edges, num_nodes, n_pad, e_pad, ghost
        i32p, i32p,            # out senders, receivers [e_pad]
        i64p,                  # out perm [num_edges]
        i32p, i32p,            # out row_offsets [n_pad+1], in_degree [n_pad]
    ]
    lib.gnnb_sort_and_csr.restype = ctypes.c_int
    lib.gnnb_concat_edges.argtypes = [
        i64p, i64p,            # edge_counts, node_counts [num_graphs]
        i64p,                  # edges_concat [2 * total_edges]
        i64, i64,              # num_graphs, total_edges
        i64p, i64p,            # out senders, receivers [total_edges]
        i32p,                  # out node_graph [total_nodes]
        i64,                   # total_nodes
    ]
    lib.gnnb_concat_edges.restype = ctypes.c_int
    lib.gnnb_build_ell.argtypes = [
        i32p, i32p,            # sorted_senders [e_pad], row_offsets [n_pad+1]
        i64, i64, i64, i64,    # n_pad, e_pad, ell_width, ghost
        i32p, i32p,            # out nbr_nodes, nbr_edges [n_pad * ell_width]
    ]
    lib.gnnb_build_ell.restype = ctypes.c_int
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed with code {rc} (1: an edge "
                           f"endpoint out of range; 2: inconsistent sizes)")


def sort_and_csr(senders, receivers, num_nodes, n_pad, e_pad, ghost):
    """Edges sorted by receiver, CSR offsets and in-degrees:
    ``core.packing.sort_and_csr_plain``'s arguments and results."""
    lib = load()
    num_edges = int(senders.shape[0])
    if receivers.shape != senders.shape or num_edges > e_pad:
        raise ValueError(f"senders {senders.shape} and receivers "
                         f"{receivers.shape} must be alike, at most e_pad="
                         f"{e_pad}")
    s_out = np.empty((e_pad,), dtype=np.int32)
    r_out = np.empty((e_pad,), dtype=np.int32)
    perm = np.empty((num_edges,), dtype=np.int64)
    row_offsets = np.empty((n_pad + 1,), dtype=np.int32)
    in_degree = np.empty((n_pad,), dtype=np.int32)
    _check(lib.gnnb_sort_and_csr(
        np.ascontiguousarray(senders, dtype=np.int64),
        np.ascontiguousarray(receivers, dtype=np.int64),
        num_edges, num_nodes, n_pad, e_pad, ghost,
        s_out, r_out, perm, row_offsets, in_degree), "gnnb_sort_and_csr")
    return s_out, r_out, perm, row_offsets, in_degree


def concat_edges(edge_counts, node_counts, edges_concat, total_nodes):
    """Per-graph edge ids offset into global ids + per-node graph ids:
    ``core.packing.concat_graphs_plain``'s arguments and results
    (``edges_concat`` [2, total_edges]; senders i64, receivers i64,
    node_graph i32)."""
    lib = load()
    num_graphs = int(edge_counts.shape[0])
    total_edges = int(edges_concat.shape[1])
    if (edges_concat.shape[0] != 2 or node_counts.shape != edge_counts.shape
            or int(np.sum(edge_counts)) != total_edges
            or int(np.sum(node_counts)) != total_nodes):
        raise ValueError("edge_counts / node_counts must sum to the edges "
                         "and nodes of a [2, E] edges_concat")
    s_out = np.empty((total_edges,), dtype=np.int64)
    r_out = np.empty((total_edges,), dtype=np.int64)
    node_graph = np.empty((total_nodes,), dtype=np.int32)
    _check(lib.gnnb_concat_edges(
        np.ascontiguousarray(edge_counts, dtype=np.int64),
        np.ascontiguousarray(node_counts, dtype=np.int64),
        np.ascontiguousarray(edges_concat, dtype=np.int64).reshape(-1),
        num_graphs, total_edges, s_out, r_out, node_graph, total_nodes),
        "gnnb_concat_edges")
    return s_out, r_out, node_graph


def build_ell(sorted_senders, row_offsets, e_pad, ell_width, ghost):
    """The [n_pad, ell_width] neighbour-node and edge-id tables from the
    sorted CSR: ``core.packing.build_ell_plain``'s arguments and
    results."""
    lib = load()
    n_pad = int(row_offsets.shape[0]) - 1
    if (n_pad < 0 or int(row_offsets[0]) != 0
            or int(row_offsets[-1]) > sorted_senders.shape[0]):
        raise ValueError("row_offsets must run from 0 to at most the "
                         "sorted senders' length")
    nbr_nodes = np.empty((n_pad, ell_width), dtype=np.int32)
    nbr_edges = np.empty((n_pad, ell_width), dtype=np.int32)
    _check(lib.gnnb_build_ell(
        np.ascontiguousarray(sorted_senders, dtype=np.int32),
        np.ascontiguousarray(row_offsets, dtype=np.int32),
        n_pad, int(e_pad), int(ell_width), int(ghost),
        nbr_nodes.reshape(-1), nbr_edges.reshape(-1)), "gnnb_build_ell")
    return nbr_nodes, nbr_edges

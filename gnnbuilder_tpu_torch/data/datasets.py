"""Datasets: host graph containers + molecular-style benchmark datasets.

The reference benchmarks on MoleculeNet (ESOL, FreeSolv, Lipophilicity, HIV)
and QM9 via torch_geometric downloads (build_gnnbuilder_benchmarks.py:121-148).
This environment has no network egress and no PyG, so each dataset is
available two ways:

* ``load_dataset(name, root=...)`` reads preprocessed ``.npz`` shards from
  disk when present (fields x_<i>, edge_index_<i>, edge_attr_<i>, y_<i>), and
* otherwise falls back to a **seeded synthetic generator** whose graph-size /
  degree statistics and feature dims match the published dataset statistics
  (SURVEY.md section 6: QM9 median ~12 nodes / 24 edges; MoleculeNet dims),
  so padding buckets, kernels and benchmarks exercise realistic shapes.

Also provides the seeded Erdos-Renyi fixture generator mirroring the
reference's test-fixture graph (gen_test_data.py:75-98: directed ER, n=100,
p=0.05, self-checked against networkx) used by the kernel parity tests.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Optional

import numpy as np

__all__ = ["Graph", "load_dataset", "er_graph", "DATASET_SPECS", "FakeDataset",
           "drop_repeated_edges"]


@dataclasses.dataclass
class Graph:
    """Host-side graph: numpy arrays, PyG layout (edge_index[0]=src)."""

    x: np.ndarray  # [n, F] float32
    edge_index: np.ndarray  # [2, e] int64
    edge_attr: Optional[np.ndarray] = None  # [e, Fe] float32
    y: Optional[np.ndarray] = None  # graph-level target

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_graphs: int
    node_dim: int
    edge_dim: int
    target_dim: int
    task: str  # "regression" | "binary_classification"
    mean_nodes: float
    std_nodes: float
    min_nodes: int
    max_nodes: int


# Statistics follow the published MoleculeNet / QM9 characteristics the
# reference sizes its hardware with (SURVEY.md section 6; print_graph_stats.py)
DATASET_SPECS = {
    "qm9": DatasetSpec("qm9", 130831, 11, 4, 1, "regression", 18.0, 3.0, 3, 29),
    "esol": DatasetSpec("esol", 1128, 9, 3, 1, "regression", 13.3, 6.5, 2, 55),
    "freesolv": DatasetSpec("freesolv", 642, 9, 3, 1, "regression", 8.7, 4.0, 2, 24),
    "lipo": DatasetSpec("lipo", 4200, 9, 3, 1, "regression", 27.0, 7.4, 4, 115),
    "hiv": DatasetSpec(
        "hiv", 41127, 9, 3, 1, "binary_classification", 25.5, 12.0, 2, 222
    ),
}


def _molecule_like_graph(rng: np.random.Generator, spec: DatasetSpec) -> Graph:
    """A random molecule-like graph: a connected tree backbone plus a few
    ring-closing edges, undirected (both directions stored, as in PyG
    molecular datasets), degree capped at 4 like organic molecules."""
    n = int(np.clip(round(rng.normal(spec.mean_nodes, spec.std_nodes)),
                    spec.min_nodes, spec.max_nodes))
    src, dst = [], []
    deg = np.zeros(n, dtype=np.int64)
    for v in range(1, n):
        # attach to a random earlier node with available valence
        cand = np.flatnonzero(deg[:v] < 4)
        u = int(rng.choice(cand)) if cand.size else int(rng.integers(v))
        src += [u, v]
        dst += [v, u]
        deg[u] += 1
        deg[v] += 1
    n_rings = int(rng.poisson(max(n / 12.0, 0.1)))
    for _ in range(n_rings):
        cand = np.flatnonzero(deg < 4)
        if cand.size < 2:
            break
        u, v = rng.choice(cand, size=2, replace=False)
        if u == v:
            continue
        src += [int(u), int(v)]
        dst += [int(v), int(u)]
        deg[u] += 1
        deg[v] += 1
    edge_index = np.stack(
        [np.array(src, dtype=np.int64), np.array(dst, dtype=np.int64)]
    )
    e = edge_index.shape[1]
    # one-hot-ish sparse features like atom/bond types
    x = np.zeros((n, spec.node_dim), dtype=np.float32)
    x[np.arange(n), rng.integers(0, spec.node_dim, size=n)] = 1.0
    edge_attr = np.zeros((e, spec.edge_dim), dtype=np.float32)
    edge_attr[np.arange(e), rng.integers(0, spec.edge_dim, size=e)] = 1.0
    if spec.task == "regression":
        y = np.array(
            [float(n) / spec.mean_nodes - 1.0 + rng.normal(0, 0.1)],
            dtype=np.float32,
        )
    else:
        # structural label (size + ring density above dataset mean), flipped
        # with 15% noise: learnable like real activity labels, so end-to-end
        # classification results (ROC-AUC tables) measure the model, not a
        # coin flip.  Bernoulli draw keeps the old rng call count.
        signal = float(n) / spec.mean_nodes - 1.0 + 0.5 * (
            n_rings / max(n / 12.0, 0.1) - 1.0
        )
        label = float(signal > 0.0)
        if rng.random() < 0.15:
            label = 1.0 - label
        y = np.array([label], dtype=np.float32)
    return Graph(x=x, edge_index=edge_index, edge_attr=edge_attr, y=y)


def load_dataset(
    name: str,
    n: Optional[int] = 1000,
    root: Optional[str] = None,
    seed: int = 0,
) -> list[Graph]:
    """First ``n`` graphs of the named dataset (the reference benchmarks on
    the first 1000, build_gnnbuilder_benchmarks.py:128-148).  Reads real data
    from ``root``/``GNNB_DATA_ROOT`` if available, else synthesizes."""
    name = name.lower()
    if name not in DATASET_SPECS:
        raise ValueError(f"unknown dataset {name}; options {sorted(DATASET_SPECS)}")
    spec = DATASET_SPECS[name]
    root = root or os.environ.get("GNNB_DATA_ROOT")
    if root:
        path = os.path.join(root, f"{name}.npz")
        if os.path.exists(path):
            return _load_npz(path, n)
    count = spec.num_graphs if n is None else min(n, spec.num_graphs)
    # zlib.crc32, NOT hash(): str hash is randomized per-process
    # (PYTHONHASHSEED), which would make every synthetic dataset — and every
    # results table built from one — irreproducible across runs
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2**31))
    return [_molecule_like_graph(rng, spec) for _ in range(count)]


def drop_repeated_edges(graphs):
    """``graphs`` with each repeated (sender, receiver) pair kept once, at
    its first occurrence, with its edge features: simple graphs, as real
    molecules are (a synthetic molecule's ring closure can repeat a bond).
    GAT's block kernel takes edge features on such batches only
    (``GraphBatch.multigraph_static``)."""
    out = []
    for g in graphs:
        key = g.edge_index[0] * (g.num_nodes + 1) + g.edge_index[1]
        keep = np.sort(np.unique(key, return_index=True)[1])
        out.append(dataclasses.replace(
            g, edge_index=g.edge_index[:, keep],
            edge_attr=None if g.edge_attr is None else g.edge_attr[keep]))
    return out


def _load_npz(path: str, n: Optional[int]) -> list[Graph]:
    data = np.load(path)
    if "n_node" in data:
        return _load_npz_flat(data, n)
    count = int(data["num_graphs"])
    if n is not None:
        count = min(count, n)
    out = []
    for i in range(count):
        out.append(
            Graph(
                x=data[f"x_{i}"].astype(np.float32),
                edge_index=data[f"edge_index_{i}"].astype(np.int64),
                edge_attr=(
                    data[f"edge_attr_{i}"].astype(np.float32)
                    if f"edge_attr_{i}" in data
                    else None
                ),
                y=data[f"y_{i}"].astype(np.float32) if f"y_{i}" in data else None,
            )
        )
    return out


def _load_npz_flat(data, n: Optional[int]) -> list[Graph]:
    """Flat ragged format written by scripts/export_pyg_datasets.py:
    x [sum_n,F], ei [2,sum_e], y [G,T], n_node [G], n_edge [G]."""
    n_node = data["n_node"].astype(np.int64)
    n_edge = data["n_edge"].astype(np.int64)
    count = len(n_node) if n is None else min(n, len(n_node))
    x = data["x"]
    ei = data["ei"]
    y = data["y"] if "y" in data else None
    ea = data["edge_attr"] if "edge_attr" in data else None
    node_off = np.zeros(count + 1, np.int64)
    np.cumsum(n_node[:count], out=node_off[1:])
    edge_off = np.zeros(count + 1, np.int64)
    np.cumsum(n_edge[:count], out=edge_off[1:])
    out = []
    for i in range(count):
        ns, ne_ = node_off[i], node_off[i + 1]
        es, ee = edge_off[i], edge_off[i + 1]
        out.append(
            Graph(
                x=x[ns:ne_].astype(np.float32),
                edge_index=ei[:, es:ee].astype(np.int64),
                edge_attr=(
                    ea[es:ee].astype(np.float32) if ea is not None else None
                ),
                y=y[i].astype(np.float32) if y is not None else None,
            )
        )
    return out


def er_graph(
    n: int = 100,
    p: float = 0.05,
    node_dim: int = 8,
    edge_dim: int = 4,
    seed: int = 0,
) -> Graph:
    """Seeded directed Erdos-Renyi fixture graph (reference
    gen_test_data.py:75-98) with random node/edge features."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < p
    np.fill_diagonal(mask, False)
    src, dst = np.nonzero(mask)
    edge_index = np.stack([src.astype(np.int64), dst.astype(np.int64)])
    e = edge_index.shape[1]
    x = rng.standard_normal((n, node_dim)).astype(np.float32)
    edge_attr = rng.standard_normal((e, edge_dim)).astype(np.float32)
    return Graph(x=x, edge_index=edge_index, edge_attr=edge_attr)


def FakeDataset(
    num_graphs: int = 1,
    avg_num_nodes: int = 20,
    node_dim: int = 8,
    edge_dim: int = 4,
    seed: int = 0,
) -> list[Graph]:
    """Small random dataset for smoke tests — the PyG FakeDataset analog the
    reference demos use (demos/simple_test.py:49-57)."""
    rng = np.random.default_rng(seed)
    spec = DatasetSpec(
        "fake", num_graphs, node_dim, edge_dim, 1, "regression",
        float(avg_num_nodes), max(avg_num_nodes / 4.0, 1.0), 2,
        avg_num_nodes * 2,
    )
    return [_molecule_like_graph(rng, spec) for _ in range(num_graphs)]

"""Canonical benchmark model and batches.

The reference's benchmark model (build_gnnbuilder_benchmarks.py:59-118):
6 GNN layers, hidden 128, GNN output 64, skip connections, global pooling
add+mean+max, MLP head with 4 hidden layers x 64, output dim 1.
"""

from __future__ import annotations

import math

from gnnbuilder_tpu_torch.core.graph import build_graph_batch, resolve_device
from gnnbuilder_tpu_torch.data.datasets import DATASET_SPECS, load_dataset
from gnnbuilder_tpu_torch.nn.model import GNNModel
from gnnbuilder_tpu_torch.utils.stats import compute_pna_delta

__all__ = ["canonical_model", "canonical_batches", "CANONICAL"]

CANONICAL = dict(
    gnn_hidden_dim=128,
    gnn_num_layers=6,
    gnn_output_dim=64,
    gnn_skip_connection=True,
    pooling_aggrs=("add", "mean", "max"),
    mlp_hidden_dim=64,
    mlp_hidden_layers=4,
    mlp_out_dim=1,
)


def canonical_model(conv: str, dataset: str, graphs=None,
                    **overrides) -> GNNModel:
    spec = DATASET_SPECS[dataset]
    kw = dict(CANONICAL)
    kw.update(overrides)
    conv_kwargs = dict(kw.pop("conv_kwargs", {}))
    if conv == "pna" and "delta" not in conv_kwargs:
        if graphs is None:
            graphs = load_dataset(dataset, n=200)
        conv_kwargs["delta"] = compute_pna_delta(graphs)
    return GNNModel(
        graph_input_feature_dim=spec.node_dim,
        graph_input_edge_dim=spec.edge_dim,
        gnn_conv=conv,
        conv_kwargs=conv_kwargs,
        **kw,
    )


def _rup(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def canonical_batches(
    dataset: str,
    n_graphs: int = 1000,
    batch_size: int = 1,
    node_multiple: int = 8,
    edge_multiple: int = 8,
    seed: int = 0,
    block_size: int = 0,
    device=None,
):
    """Pack the first ``n_graphs`` graphs into batches of ``batch_size``
    graphs that share one (max) padding bucket; ``block_size`` > 0 selects
    block packing, the bucket then covering the worst pack waste.  Returns
    (graphs, batches on ``device``): None = the CUDA card, which raises
    without one; pass ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    graphs = load_dataset(dataset, n=n_graphs, seed=seed)
    chunks = [
        graphs[i: i + batch_size] for i in range(0, len(graphs), batch_size)
    ]
    chunks = [c for c in chunks if len(c) == batch_size]
    max_e = max(sum(g.num_edges for g in c) for c in chunks)
    if block_size:
        align = math.lcm(block_size, node_multiple)

        def packed_rows(c):
            cur = 0
            for g in c:
                if (cur % block_size) + g.num_nodes > block_size:
                    cur = _rup(cur, block_size)
                cur += g.num_nodes
            return _rup(cur + 1, align)

        node_budget = max(packed_rows(c) for c in chunks)
    else:
        max_n = max(sum(g.num_nodes for g in c) for c in chunks)
        node_budget = _rup(max_n + 1, node_multiple)
    edge_budget = _rup(max_e, edge_multiple)
    batches = [
        build_graph_batch(
            c,
            node_budget=node_budget,
            edge_budget=edge_budget,
            graph_budget=batch_size + 1,
            node_multiple=node_multiple,
            edge_multiple=edge_multiple,
            block_size=block_size or None,
            device=device,
        )
        for c in chunks
    ]
    return graphs, batches

"""The port's graph packing against the JAX package's: every array of
``build_graph_batch`` is bit-equal (tolerance 0), for standard and block
packing, on FakeDataset and canonical QM9 graphs."""

import dataclasses

import numpy as np
import pytest
import torch

from gnnbuilder_tpu.bench.canonical import (
    canonical_batches as jax_canonical_batches,
)
from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset as JaxFakeDataset
from gnnbuilder_tpu.data.datasets import load_dataset as jax_load_dataset
from gnnbuilder_tpu_torch.bench.canonical import canonical_batches
from gnnbuilder_tpu_torch.core.graph import GraphBatch, build_graph_batch
from gnnbuilder_tpu_torch.core.validate import validate_batch
from gnnbuilder_tpu_torch.data.datasets import FakeDataset, load_dataset

_STATIC = ("num_graphs_static", "max_graph_nodes_static",
           "block_size_static", "multigraph_static")


def _assert_same_batch(ours, ref):
    for f in dataclasses.fields(GraphBatch):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name in _STATIC:
            assert a == b, f.name
            continue
        if b is None:
            assert a is None, f.name
            continue
        assert a is not None, f.name
        a = a.cpu().numpy()
        b = np.asarray(b)
        if f.name == "block_adj":  # bf16 in JAX, f32 here: exact counts
            b = b.astype(np.float32)
        assert a.shape == b.shape, (f.name, a.shape, b.shape)
        assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_datasets_match():
    ours = load_dataset("qm9", n=50, seed=3)
    ref = jax_load_dataset("qm9", n=50, seed=3)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.edge_index, b.edge_index)
        np.testing.assert_array_equal(a.edge_attr, b.edge_attr)
        np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("block_size", [None, 128])
@pytest.mark.parametrize("seed", [0, 7])
def test_fake_dataset_batches_bit_equal(block_size, seed):
    kw = dict(num_graphs=20, avg_num_nodes=14, node_dim=8, edge_dim=4,
              seed=seed)
    ours = build_graph_batch(FakeDataset(**kw), block_size=block_size,
                             device="cpu")
    ref = jax_build(JaxFakeDataset(**kw), block_size=block_size)
    validate_batch(ours)
    _assert_same_batch(ours, ref)


@pytest.mark.parametrize("block_size", [0, 128])
def test_canonical_qm9_batches_bit_equal(block_size):
    kw = dict(n_graphs=96, batch_size=32, block_size=block_size,
              node_multiple=128 if block_size else 8)
    gs, ours = canonical_batches("qm9", **kw, device="cpu")
    gr, ref = jax_canonical_batches("qm9", **kw)
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        validate_batch(a)
        _assert_same_batch(a, b)


def test_default_device_is_the_card():
    """With no device named, the data entry points put the batch on the
    CUDA card, and raise without one rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gs = FakeDataset(num_graphs=3, avg_num_nodes=6, node_dim=5, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_graph_batch(gs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        canonical_batches("qm9", n_graphs=4, batch_size=4)
    from gnnbuilder_tpu_torch.train import stack_targets

    with pytest.raises(RuntimeError, match="no CUDA device"):
        stack_targets(gs, 4)


def test_budgets_and_device():
    gs = FakeDataset(num_graphs=6, avg_num_nodes=10, node_dim=5, seed=1)
    b = build_graph_batch(gs, node_budget=256, edge_budget=256,
                          graph_budget=9, block_size=128, device="cpu")
    assert b.num_nodes == 256 and b.num_edges == 256 and b.num_graphs == 9
    assert b.device == torch.device("cpu")
    moved = b.to("cpu")
    assert moved.num_nodes == b.num_nodes
    ref = jax_build(
        [dataclasses.replace(g) for g in gs], node_budget=256,
        edge_budget=256, graph_budget=9, block_size=128,
    )
    _assert_same_batch(b, ref)


@pytest.mark.parametrize("n_graphs", [8, 120])
def test_auto_block_size_bit_equal(n_graphs):
    """"auto" picks standard packing for a small batch and 128-row block
    packing for one above the JAX package's node threshold."""
    gs = load_dataset("qm9", n=n_graphs, seed=1)
    ours = build_graph_batch(gs, block_size="auto", device="cpu")
    ref = jax_build(jax_load_dataset("qm9", n=n_graphs, seed=1),
                    block_size="auto")
    assert ours.block_size_static == (128 if n_graphs == 120 else 0)
    _assert_same_batch(ours, ref)

"""The port's readout (ops/cuda/readout.py) against the JAX package: its
plain version vs ``fused_readout(..., interpret=True)`` and
``readout_reference`` on the same numpy inputs, for standard and block
packing, on the rows where ``graph_mask`` is true (the ghost row is
finite garbage by contract).

Tolerance atol 1e-4 / rtol 1e-4, the JAX readout tests' contract: the
pooling sums run in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset
from gnnbuilder_tpu.ops import segment as jax_segment
from gnnbuilder_tpu.ops.pallas.readout import fused_readout as jax_readout
from gnnbuilder_tpu.ops.pallas.readout import readout_reference
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.ops import dispatch, segment
from gnnbuilder_tpu_torch.ops.cuda import readout

ATOL, RTOL = 1e-4, 1e-4


def _weights(rng, din, dims):
    out, d = [], din
    for o in dims:
        out.append(((rng.standard_normal((d, o)) * 0.1).astype(np.float32),
                    rng.standard_normal(o).astype(np.float32)))
        d = o
    return out


@pytest.mark.parametrize("block_size", [None, 128])
@pytest.mark.parametrize("aggrs,out_act", [
    (("add", "mean", "max"), None),
    (("add",), None),
    (("mean", "max"), "softmax"),
    (("add", "mean"), "log_softmax"),
])
def test_plain_readout_matches_jax(block_size, aggrs, out_act):
    gs = FakeDataset(num_graphs=40, avg_num_nodes=12, node_dim=8, seed=5)
    b = build_graph_batch(gs, block_size=block_size, node_multiple=128,
                          device="cpu")
    g = jax_build(gs, block_size=block_size, node_multiple=128)
    rng = np.random.default_rng(6)
    F = 64
    x = rng.standard_normal((b.num_nodes, F)).astype(np.float32)
    ws = _weights(rng, len(aggrs) * F, (64, 64, 64, 64, 3))
    maxg = b.max_graph_nodes_static
    mx_t = mx_j = None
    if "max" in aggrs:
        mx_t = segment.contiguous_segment_max(
            torch.from_numpy(x), b.graph_starts, b.n_node, maxg)
        mx_j = jax_segment.contiguous_segment_max(
            jnp.asarray(x), g.graph_starts, g.n_node, maxg)
        np.testing.assert_array_equal(mx_t.numpy(), np.asarray(mx_j))
    ours = readout.fused_readout(
        torch.from_numpy(x), b.n_node,
        [(torch.from_numpy(w), torch.from_numpy(c)) for w, c in ws],
        aggrs=aggrs, mx=mx_t, act="relu", out_act=out_act,
        starts=b.graph_starts,
    ).numpy()
    jws = tuple((jnp.asarray(w), jnp.asarray(c)) for w, c in ws)
    starts = g.graph_starts if block_size else None
    kern = jax_readout(
        jnp.asarray(x), g.n_node, jws, aggrs=aggrs, mx=mx_j, act="relu",
        out_act=out_act, tile_graphs=8, maxg=maxg, interpret=True,
        mm="f32", starts=starts, block_size=block_size or 0,
    )
    ref = readout_reference(jnp.asarray(x), g.n_node, jws, aggrs=aggrs,
                            mx=mx_j, act="relu", out_act=out_act,
                            starts=starts)
    m = b.graph_mask.numpy()
    assert ours.shape == (b.num_graphs, 3)
    np.testing.assert_allclose(ours[m], np.asarray(kern)[m], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(ours[m], np.asarray(ref)[m], atol=ATOL,
                               rtol=RTOL)
    assert np.isfinite(ours).all()


def test_segment_max_matches_contiguous():
    gs = FakeDataset(num_graphs=30, avg_num_nodes=10, node_dim=4, seed=2)
    b = build_graph_batch(gs, block_size=128, device="cpu")
    x = torch.randn(b.num_nodes, 16)
    m = b.graph_mask
    a = segment.contiguous_segment_max(x, b.graph_starts, b.n_node,
                                       b.max_graph_nodes_static)
    c = segment.segment_max(x, b.node_graph, b.num_graphs)
    torch.testing.assert_close(a[m], c[m], rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    x = torch.randn(64, 8)
    n_node = torch.tensor([10, 20, 34], dtype=torch.int32)
    ws = [(torch.randn(16, 4), torch.randn(4))]
    with pytest.raises(ValueError):      # max without mx
        readout.fused_readout(x, n_node, ws, aggrs=("add", "max"))
    with pytest.raises(ValueError):      # weights do not chain
        readout.fused_readout(x, n_node, ws, aggrs=("add",))
    with pytest.raises(ValueError):
        readout.fused_readout(x, n_node, ws, aggrs=("add", "mean"),
                              act="elu")
    assert readout.fused_readout(
        x, n_node, ws, aggrs=("add", "mean")).shape == (3, 4)


def test_supported_limits():
    """The gate leaves the head's size to the kernel: a head far wider
    than one block's shared memory still takes the fused readout (the
    CUDA wrapper raises on it; on the CPU the plain version computes it),
    and the gate says no only to what the kernel never computes."""
    gs = FakeDataset(num_graphs=12, avg_num_nodes=10, node_dim=4, seed=3)
    b = build_graph_batch(gs, block_size=128, device="cpu")
    with dispatch.inference_mode():
        cfg = dispatch.readout_config(b, ("add", "mean", "max"), "relu",
                                      None)
        assert cfg is not None and cfg["starts"] is b.graph_starts
        assert dispatch.readout_config(b, ("max",), "relu", None) is None
        assert dispatch.readout_config(b, ("add",), "elu", None) is None
    # the readout has a backward, so the gate needs no inference scope
    cfg = dispatch.readout_config(b, ("add",), "relu", None)
    assert cfg is not None and cfg["starts"] is b.graph_starts
    dispatch.set_fused_mode("never")
    try:
        assert dispatch.readout_config(b, ("add",), "relu", None) is None
    finally:
        dispatch.set_fused_mode("auto")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b.num_nodes, 16)).astype(np.float32)
    ws = _weights(rng, 16, (4096, 2))
    ours = readout.fused_readout(
        torch.from_numpy(x), b.n_node,
        [(torch.from_numpy(w), torch.from_numpy(c)) for w, c in ws],
        aggrs=("add",), act="relu", starts=b.graph_starts).numpy()
    st, nn = b.graph_starts.numpy(), b.n_node.numpy()
    pooled = np.stack([x[s:s + n].sum(0) for s, n in zip(st, nn)])
    ref = np.maximum(pooled @ ws[0][0] + ws[0][1], 0) @ ws[1][0] + ws[1][1]
    m = b.graph_mask.numpy()
    np.testing.assert_allclose(ours[m], ref[m], atol=ATOL, rtol=RTOL)

"""PNA on batches that carry no ELL table, against the JAX package on the
CPU.

``build_graph_batch`` ships no table when an in-degree exceeds
``ELL_MAX_WIDTH`` (64) or when the caller passes ``ell_width=0``.  The
JAX ``PNAConv`` then aggregates over the edge list (``segment_multi``);
so must the port.  Two batches: QM9 graphs with a 71-node star whose hub
has in-degree 70, block-packed and standard-packed, and QM9 graphs
packed with ``ell_width=0``.  The port's ``PNAConv`` and the whole
canonical-shaped model (3 layers, hidden 32), weights moved with
``params_from_jax``, against the JAX ones, on ``node_mask`` /
``graph_mask`` rows.  Tolerance atol 5e-4 / rtol 1e-3 and 1e-4 of max
|value| (f32 sums in another order), as the other model parity tests."""

import jax
import numpy as np
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu.bench.canonical import canonical_model as jax_model
from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import Graph, load_dataset
from gnnbuilder_tpu.nn.conv import PNAConv as JaxPNAConv
from gnnbuilder_tpu.ops import dispatch as jax_dispatch
from gnnbuilder_tpu_torch import Program
from gnnbuilder_tpu_torch.bench.canonical import canonical_model
from gnnbuilder_tpu_torch.core.graph import ELL_MAX_WIDTH, build_graph_batch
from gnnbuilder_tpu_torch.nn.conv import PNAConv
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.port import params_from_jax

ATOL, RTOL = 5e-4, 1e-3
SCALED_TOL = 1e-4


def _star(n=71, dim=11, seed=0):
    """A hub (node 0) with edges to and from every other node."""
    rng = np.random.default_rng(seed)
    leaves = np.arange(1, n)
    ei = np.concatenate([np.stack([leaves, np.zeros_like(leaves)]),
                         np.stack([np.zeros_like(leaves), leaves])], axis=1)
    return Graph(x=rng.standard_normal((n, dim)).astype(np.float32),
                 edge_index=ei.astype(np.int64),
                 edge_attr=rng.standard_normal((ei.shape[1], 4)).astype(
                     np.float32))


CASES = {
    "star_block": dict(star=True, block_size=128, node_multiple=128),
    "star_standard": dict(star=True, block_size=None, node_multiple=8),
    "ell_width_0": dict(star=False, block_size=128, node_multiple=128,
                        ell_width=0),
}


def _batches(case):
    kw = dict(CASES[case])
    graphs = load_dataset("qm9", n=12, seed=1)
    if kw.pop("star"):
        graphs = graphs[:5] + [_star()] + graphs[5:]
    jb = jax_build(graphs, **kw)
    tb = build_graph_batch(graphs, device="cpu", **kw)
    assert tb.nbr_nodes is None and jb.nbr_nodes is None
    if case != "ell_width_0":
        assert int(tb.in_degree.max()) > ELL_MAX_WIDTH
    return graphs, jb, tb


@pytest.mark.parametrize("case", sorted(CASES))
def test_pna_conv_without_ell_table_matches_jax(case):
    _, jb, tb = _batches(case)
    x = np.random.default_rng(2).standard_normal(
        (tb.num_nodes, 11)).astype(np.float32)
    jconv = JaxPNAConv(in_channels=11, out_channels=24, delta=1.6)
    jp = jconv.init(jax.random.PRNGKey(3), jb, x)
    jax_dispatch.set_fused_mode("never")
    try:
        ref = np.asarray(jconv.apply(jp, jb, x, "relu", None))
    finally:
        jax_dispatch.set_fused_mode("auto")
    conv = PNAConv(11, 24, delta=1.6)
    conv.load_state_dict({
        f"{n}.{k}": torch.tensor(np.asarray(jp["params"][n][leaf])).T
        if leaf == "kernel" else torch.tensor(np.asarray(
            jp["params"][n][leaf]))
        for n in ("pre_nn", "post_nn", "lin")
        for k, leaf in (("weight", "kernel"), ("bias", "bias"))})
    assert dispatch.pna_layer_cfg(tb, "relu") is None
    with torch.no_grad():
        ours = conv(tb, torch.from_numpy(x), "relu", None).numpy()
    m = tb.node_mask.numpy()
    assert np.isfinite(ours[m]).all()
    np.testing.assert_allclose(ours[m], ref[m], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pna_model_without_ell_table_matches_jax(case):
    graphs, jb, tb = _batches(case)
    over = dict(gnn_num_layers=3, gnn_hidden_dim=32)
    jm = jax_model("pna", "qm9", graphs=graphs, **over)
    tm = canonical_model("pna", "qm9", graphs=graphs, **over)
    bs = CASES[case]["block_size"] or 0
    size = dict(max_nodes=jb.num_nodes, max_edges=jb.num_edges,
                max_graphs=jb.num_graphs, block_size=bs)
    jp = gnnb.Program(jm, **size)
    params = jax.tree.map(np.asarray, jp.init_params(jb))
    tp = Program(tm, **size, device="cpu")
    tp.set_params(params_from_jax(params))
    ref = np.asarray(jp.forward(jb))
    m = tb.graph_mask.numpy()
    for mode in ("auto", "never"):
        dispatch.set_fused_mode(mode)
        try:
            ours = tp.forward(tb).numpy()
        finally:
            dispatch.set_fused_mode("auto")
        assert np.isfinite(ours[m]).all()
        np.testing.assert_allclose(ours[m], ref[m], atol=ATOL, rtol=RTOL)
        err = np.abs(ours[m] - ref[m]).max()
        assert err <= SCALED_TOL * np.abs(ref[m]).max(), (mode, err)

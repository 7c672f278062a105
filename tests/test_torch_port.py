"""Weight transfer (gnnbuilder_tpu_torch/port.py): the canonical model's
flax params land in the port's state dict leaf for leaf, shape for shape
(kernels transposed), exactly (tolerance 0)."""

import jax
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.bench.canonical import (
    canonical_batches as jax_canonical_batches,
)
from gnnbuilder_tpu.bench.canonical import (
    canonical_model as jax_canonical_model,
)
from gnnbuilder_tpu_torch.bench.canonical import canonical_model
from gnnbuilder_tpu_torch.port import params_from_jax


def _canonical_flax_params():
    gs, (b,) = jax_canonical_batches("qm9", n_graphs=8, batch_size=8,
                                     block_size=128, node_multiple=128)
    jm = jax_canonical_model("pna", "qm9", graphs=gs)
    params = jm.init(jax.random.PRNGKey(0), b)
    return gs, jax.tree.map(np.asarray, params)


def test_canonical_round_trip_every_leaf():
    gs, params = _canonical_flax_params()
    sd = params_from_jax(params)
    model = canonical_model("pna", "qm9", graphs=gs)
    ours = model.state_dict()
    assert set(sd) == set(ours)          # no leaf missing or left over
    model.load_state_dict(sd, strict=True)
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert len(flat) == len(sd) == 6 * 3 * 2 + 5 * 2
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] == "mlp_head":
            prefix = f"mlp_head.linear_layers.{keys[1].rsplit('_', 1)[1]}"
        else:
            prefix = f"gnn_convs.{keys[0].rsplit('_', 1)[1]}.{keys[1]}"
        name = prefix + (".weight" if keys[-1] == "kernel" else ".bias")
        got = model.state_dict()[name].numpy()
        want = leaf.T if keys[-1] == "kernel" else leaf
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_rejects_non_pna_tree():
    _, params = _canonical_flax_params()
    bad = {"params": dict(params["params"])}
    bad["params"]["gnn_convs_0"] = {"lin": params["params"]["gnn_convs_0"]
                                    ["lin"]}
    with pytest.raises(ValueError, match="expected PNA params"):
        params_from_jax(bad)
    assert isinstance(params_from_jax(params)["mlp_head.linear_layers.0"
                                              ".weight"], torch.Tensor)


@pytest.mark.parametrize("conv,leaves", [
    ("gcn", 2), ("gin", 4), ("sage", 3)])
def test_mp_conv_round_trip_every_leaf(conv, leaves):
    """GCN (lin without bias, separate bias), GIN (lin0, lin1) and SAGE
    (lin_l, lin_r without bias): every flax leaf lands in the state dict,
    kernels transposed, exactly."""
    gs, (b,) = jax_canonical_batches("qm9", n_graphs=8, batch_size=8,
                                     block_size=128, node_multiple=128)
    params = jax.tree.map(np.asarray, jax_canonical_model(
        conv, "qm9", graphs=gs).init(jax.random.PRNGKey(1), b))
    sd = params_from_jax(params)
    model = canonical_model(conv, "qm9", graphs=gs)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert len(flat) == len(sd) == 6 * leaves + 5 * 2
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] == "mlp_head":
            name = (f"mlp_head.linear_layers.{keys[1].rsplit('_', 1)[1]}."
                    + ("weight" if keys[-1] == "kernel" else "bias"))
        else:
            name = ".".join(["gnn_convs", keys[0].rsplit("_", 1)[1]]
                            + keys[1:])
            name = name.replace(".kernel", ".weight")
        got = model.state_dict()[name].numpy()
        want = leaf.T if keys[-1] == "kernel" else leaf
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_rejects_mixed_convs():
    _, params = _canonical_flax_params()
    bad = {"params": dict(params["params"])}
    bad["params"]["gnn_convs_1"] = {
        "lin0": params["params"]["gnn_convs_0"]["lin"],
        "lin1": params["params"]["gnn_convs_0"]["lin"]}
    with pytest.raises(ValueError, match="mix convs"):
        params_from_jax(bad)


@pytest.mark.parametrize("concat", [True, False])
def test_gat_round_trip_every_leaf(concat):
    """GAT (lin without bias, att_src and att_dst [1, H, C] carried as they
    are, bias): every flax leaf of the canonical heads-4 model lands in
    the state dict, kernels transposed, exactly; with concat heads the
    layers take heads * hidden and the MLP heads * output * 3."""
    gs, (b,) = jax_canonical_batches("qm9", n_graphs=8, batch_size=8,
                                     block_size=128, node_multiple=128)
    kw = dict(conv_kwargs=dict(heads=4, concat=concat))
    params = jax.tree.map(np.asarray, jax_canonical_model(
        "gat", "qm9", graphs=gs, **kw).init(jax.random.PRNGKey(2), b))
    sd = params_from_jax(params)
    model = canonical_model("gat", "qm9", graphs=gs, **kw)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert len(flat) == len(sd) == 6 * 4 + 5 * 2
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] == "mlp_head":
            name = (f"mlp_head.linear_layers.{keys[1].rsplit('_', 1)[1]}."
                    + ("weight" if keys[-1] == "kernel" else "bias"))
        else:
            name = ".".join(["gnn_convs", keys[0].rsplit("_", 1)[1]]
                            + keys[1:])
            name = name.replace(".kernel", ".weight")
        got = model.state_dict()[name].numpy()
        want = leaf.T if keys[-1] == "kernel" else leaf
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    k = 4 if concat else 1
    assert model.gnn_convs[1].lin.in_features == 128 * k
    assert model.mlp_head.linear_layers[0].in_features == 64 * k * 3


@pytest.mark.parametrize("conv,leaves", [("gine", 6), ("edge", 4)])
def test_gine_and_edge_round_trip_every_leaf(conv, leaves):
    """GINE (lin_edge, lin0, lin1) and EdgeConv (lin0 a PairLinear
    [2 Fin, F], lin1): every flax leaf of the canonical model lands in
    the state dict, kernels transposed, exactly.  EdgeConv's leaves are
    GIN's; the mapping goes by them and not by the conv's name."""
    gs, (b,) = jax_canonical_batches("qm9", n_graphs=8, batch_size=8,
                                     block_size=128, node_multiple=128)
    params = jax.tree.map(np.asarray, jax_canonical_model(
        conv, "qm9", graphs=gs).init(jax.random.PRNGKey(3), b))
    sd = params_from_jax(params)
    model = canonical_model(conv, "qm9", graphs=gs)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    assert len(flat) == len(sd) == 6 * leaves + 5 * 2
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] == "mlp_head":
            name = (f"mlp_head.linear_layers.{keys[1].rsplit('_', 1)[1]}."
                    + ("weight" if keys[-1] == "kernel" else "bias"))
        else:
            name = ".".join(["gnn_convs", keys[0].rsplit("_", 1)[1]]
                            + keys[1:])
            name = name.replace(".kernel", ".weight")
        got = model.state_dict()[name].numpy()
        want = leaf.T if keys[-1] == "kernel" else leaf
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    first = model.gnn_convs[0]
    if conv == "gine":
        assert (first.lin_edge.in_features, first.lin_edge.out_features) \
            == (4, 11)
    else:
        assert tuple(first.lin0.weight.shape) == (128, 22)

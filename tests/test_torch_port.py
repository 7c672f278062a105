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

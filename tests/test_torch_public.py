"""The port's public surface (``gnnbuilder_tpu_torch.__all__``) against
the JAX package's: the port exports every public name of
``gnnbuilder_tpu`` (its ``__all__`` is the JAX package's, and its
``NOT_YET_PORTED`` list is empty), every exported name resolves, and the
conv and pooling tables hold the same keys."""

import pytest

import gnnbuilder_tpu as gnnb
import gnnbuilder_tpu_torch as port


def test_every_jax_public_name_is_ported_or_listed():
    missing = [n for n in gnnb.__all__
               if n not in port.__all__ and n not in port.NOT_YET_PORTED]
    assert missing == []
    assert port.NOT_YET_PORTED == ()
    assert port.__all__ == gnnb.__all__
    from gnnbuilder_tpu_torch import dse

    assert (port.DSEEngine, port.DSEConfig, port.CostModel) == (
        dse.DSEEngine, dse.DSEConfig, dse.CostModel)


def test_exported_names_resolve_and_tables_match():
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    assert set(port.SUPPORTED_GNN_CONVS) == set(gnnb.SUPPORTED_GNN_CONVS)
    assert (tuple(port.SUPPORTED_GLOBAL_POOLING_AGGRS)
            == tuple(gnnb.SUPPORTED_GLOBAL_POOLING_AGGRS))
    assert port.Precision.from_name("int8").name == "int8"


def test_persistent_cache_is_the_kernel_build_root(tmp_path):
    from gnnbuilder_tpu_torch.ops.cuda import _build

    before = _build.build_root()
    try:
        assert port.enable_persistent_cache() == str(before)
        got = port.enable_persistent_cache(str(tmp_path / "kernels"))
        assert got == str(tmp_path / "kernels")
        assert (tmp_path / "kernels").is_dir()
        assert _build.build_root() == tmp_path / "kernels"
    finally:
        _build.set_build_root(before)


P_FACTORS = dict(gnn_p_in=2, gnn_p_hidden=4, gnn_p_out=8, mlp_p_in=3,
                 mlp_p_hidden=5, mlp_p_out=7)


@pytest.mark.parametrize("conv,layers,mlp_layers",
                         [("pna", 3, 2), ("gcn", 1, 0), ("sage", 4, 1)])
def test_constructors_take_the_reference_p_factors(conv, layers, mlp_layers):
    """Both packages' models built with the same non-default p-factors:
    the layer sizes, each conv's (p_in, p_out), the MLP head's
    ``p_factors``, the feature-width properties, ``num_of_aggrs`` and the
    p fields of ``spec()`` agree."""
    from gnnbuilder_tpu.nn.mlp import MLP as JaxMLP
    from gnnbuilder_tpu.nn.pool import GlobalPooling as JaxPooling

    kw = dict(graph_input_feature_dim=9, gnn_hidden_dim=16,
              gnn_num_layers=layers, gnn_output_dim=8, gnn_conv=conv,
              graph_input_edge_dim=4, pooling_aggrs=("add", "max"),
              mlp_hidden_dim=12, mlp_hidden_layers=mlp_layers, mlp_out_dim=3,
              **P_FACTORS)
    ref = gnnb.GNNModel(**kw)
    ours = port.GNNModel(**kw)
    assert ours.gnn_layer_sizes == ref.gnn_layer_sizes
    assert [(c.p_in, c.p_out) for c in ours.gnn_convs] == [
        d[2:] for d in ref._layer_dims()]
    mlp = dict(in_dim=16, out_dim=3, hidden_dim=12,
               hidden_layers=mlp_layers, p_in=3, p_hidden=5, p_out=7)
    assert ours.mlp_head.p_factors == JaxMLP(**mlp).p_factors
    assert port.MLP(**mlp).p_factors == JaxMLP(**mlp).p_factors
    for name in ("input_node_features_dim", "input_edge_features_dim",
                 "output_features_dim"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert (ours.global_pooling.num_of_aggrs
            == JaxPooling(aggrs=("add", "max")).num_of_aggrs == 2)
    spec = ours.spec()
    assert {k: spec[k] for k in P_FACTORS} == P_FACTORS
    assert port.GNNModel(**spec).spec() == spec

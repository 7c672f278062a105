"""The port's public surface (``gnnbuilder_tpu_torch.__all__``) against
the JAX package's: every public name of ``gnnbuilder_tpu`` is exported by
the port or named on its ``NOT_YET_PORTED`` list, every exported name
resolves, and the conv and pooling tables hold the same keys."""

import gnnbuilder_tpu as gnnb
import gnnbuilder_tpu_torch as port


def test_every_jax_public_name_is_ported_or_listed():
    missing = [n for n in gnnb.__all__
               if n not in port.__all__ and n not in port.NOT_YET_PORTED]
    assert missing == []
    assert set(port.NOT_YET_PORTED) == {"DSEEngine", "DSEConfig",
                                        "CostModel"}
    assert not set(port.NOT_YET_PORTED) & set(port.__all__)


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

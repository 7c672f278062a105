"""GAT's cases of the per-conv ``Program`` check
(``test_torch_precision.check_program_policy_each_conv``):
``Program(precision="bf16" | "int8").forward`` of a 2-layer GAT (heads
2), with dynamic and static int8 scales, block- and standard-packed,
against JAX ``Program`` with ``set_fused_mode("always")``, and the kernel
functions reached in each mode (row 9 in bf16 on block batches, row 10
in the policy's mode otherwise and under int8, none under a static
calibration).  Apart from the kernels' own mode tests
(``tests/test_torch_gat_precision.py``), so that two xdist workers share
the work."""

import pytest

from test_torch_precision import check_program_policy_each_conv


@pytest.mark.parametrize("block_size", [128, 0])
@pytest.mark.parametrize("precision", ["bf16", "int8", "int8_static"])
def test_program_policy_matches_jax_program_gat(precision, block_size,
                                                monkeypatch):
    check_program_policy_each_conv("gat", precision, block_size,
                                   monkeypatch)

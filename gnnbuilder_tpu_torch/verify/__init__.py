"""Golden-parity verification (the JAX package's ``verify``): pure-torch
PyG-semantics reference models (``torch_ref``), from-the-equations
oracles of GAT and EdgeConv (``numpy_oracle``), torch_ref-to-port weight
porting (``port``), and the reference-format binary golden-data
serializer + MAE parity check (``golden``)."""

from gnnbuilder_tpu_torch.verify.golden import (
    gen_testbench_data,
    load_golden_outputs,
    parity_check,
    serialize_params,
    serialize_tensor,
)

__all__ = [
    "gen_testbench_data",
    "load_golden_outputs",
    "parity_check",
    "serialize_params",
    "serialize_tensor",
]

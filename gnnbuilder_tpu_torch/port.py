"""Weight transfer from the JAX package's flax parameter tree.

``params_from_jax`` maps a flax ``GNNModel`` tree, as numpy arrays
(``gnn_convs_{i}/...``, ``mlp_head/linear_{i}/{kernel,bias}``), onto this
package's ``GNNModel`` state dict.  The conv leaves per conv (the JAX
package's ``verify/port.py`` ``port_conv`` names): PNA ``pre_nn``,
``post_nn``, ``lin``; GCN ``lin`` (no bias) and ``bias``; GIN ``lin0``,
``lin1``; SAGE ``lin_l`` and ``lin_r`` (no bias).  A flax kernel is
[in, out]; a torch Linear weight is [out, in], so kernels are transposed
on the way over.  Only numpy crosses the boundary: this module imports
nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]

# the flax leaves of each conv: {Linear name: has a bias}, plus GCN's
# separate bias (an array, not a Linear)
_CONV_PARAMS = {
    "pna": {"pre_nn": True, "post_nn": True, "lin": True},
    "gcn": {"lin": False, "bias": None},
    "gin": {"lin0": True, "lin1": True},
    "sage": {"lin_l": True, "lin_r": False},
}


def _conv_of(key, node) -> str:
    for conv, leaves in _CONV_PARAMS.items():
        if set(node) != set(leaves):
            continue
        if all(leaves[k] is None or set(node[k]) == (
                {"kernel", "bias"} if leaves[k] else {"kernel"})
               for k in leaves):
            return conv
    raise ValueError(
        f"{key}: got {sorted(node)}, which matches no conv this port "
        f"takes: expected PNA params {tuple(_CONV_PARAMS['pna'])}, or "
        f"those of gcn, gin or sage ({_CONV_PARAMS})")


def params_from_jax(flax_params) -> dict:
    """flax params (``{"params": {...}}`` or the inner dict) as numpy ->
    a state dict for ``GNNModel.load_state_dict`` / ``Program.set_params``.
    Raises on a conv it does not know, or on layers of different convs."""
    tree = flax_params.get("params", flax_params)
    sd = {}

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float32))

    def linear(prefix, node):
        sd[f"{prefix}.weight"] = tensor(node["kernel"]).T.contiguous()
        if "bias" in node:
            sd[f"{prefix}.bias"] = tensor(node["bias"])

    convs = sorted((k for k in tree if k.startswith("gnn_convs_")),
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    kinds = set()
    for key in convs:
        i = int(key.rsplit("_", 1)[1])
        node = tree[key]
        kind = _conv_of(key, node)
        kinds.add(kind)
        for name, has_bias in _CONV_PARAMS[kind].items():
            if has_bias is None:
                sd[f"gnn_convs.{i}.{name}"] = tensor(node[name])
            else:
                linear(f"gnn_convs.{i}.{name}", node[name])
    if len(kinds) > 1:
        raise ValueError(f"the conv layers mix convs: {sorted(kinds)}")
    head = tree["mlp_head"]
    for key in head:
        i = int(key.rsplit("_", 1)[1])
        linear(f"mlp_head.linear_layers.{i}", head[key])
    return sd

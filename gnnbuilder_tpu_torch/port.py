"""Weight transfer from the JAX package's flax parameter tree.

``params_from_jax`` maps a flax ``GNNModel`` tree, as numpy arrays
(``gnn_convs_{i}/...``, ``mlp_head/linear_{i}/{kernel,bias}``), onto this
package's ``GNNModel`` state dict.  The conv leaves per conv (the JAX
package's ``verify/port.py`` ``port_conv`` names): PNA ``pre_nn``,
``post_nn``, ``lin``; GCN ``lin`` (no bias) and ``bias``; GIN and
EdgeConv ``lin0``, ``lin1`` (EdgeConv's lin0 a PairLinear, [2 Fin, F] in
flax); GINE ``lin_edge``, ``lin0``, ``lin1``; SAGE ``lin_l`` and
``lin_r`` (no bias); GAT ``lin`` (no bias), ``att_src`` and ``att_dst``
([1, H, C], carried as they are) and ``bias``, and with ``edge_dim``
also ``lin_edge`` (no bias) and ``att_edge``; LG and Simple none (flax
leaves their layers out of the tree).  The mapping goes by the leaves
alone: GIN's and EdgeConv's trees are alike and map the same way.  A
flax kernel is
[in, out]; a torch Linear weight is [out, in], so kernels are transposed
on the way over.  Only numpy crosses the boundary: this module imports
nothing of JAX.

``params_to_jax`` is the inverse: a state dict back to the flax tree's
names and layouts, as numpy (the golden files' parameter names and bytes,
``verify.golden``).

``site_to_jax`` maps an int8 calibration site, a ``Linear``'s name in
this package's model (``gnn_convs.0.lin``, ``mlp_head.linear_layers.2``),
to the JAX package's flax module path (``gnn_convs_0/lin``,
``mlp_head/linear_2``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax", "site_to_jax"]

# the flax leaves of each conv: {Linear name: has a bias}, plus GCN's
# separate bias (an array, not a Linear); GIN's leaves are EdgeConv's too
_CONV_PARAMS = {
    "pna": {"pre_nn": True, "post_nn": True, "lin": True},
    "gcn": {"lin": False, "bias": None},
    "gin or edge": {"lin0": True, "lin1": True},
    "gine": {"lin_edge": True, "lin0": True, "lin1": True},
    "sage": {"lin_l": True, "lin_r": False},
    "gat": {"lin": False, "att_src": None, "att_dst": None, "bias": None},
    "gat with edge_dim": {"lin": False, "lin_edge": False, "att_src": None,
                          "att_dst": None, "att_edge": None, "bias": None},
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
        f"those of gcn, gin, gine, sage, gat (with or without edge_dim) or "
        f"edge ({_CONV_PARAMS})")


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


def params_to_jax(state_dict) -> dict:
    """A state dict of this package's ``GNNModel`` -> the flax tree
    ``{"params": {...}}`` of numpy float32 arrays that ``params_from_jax``
    maps onto it: ``gnn_convs.{i}.{name}.weight`` [out, in] ->
    ``gnn_convs_{i}/{name}/kernel`` [in, out], ``.bias`` -> ``/bias``,
    a conv's own array ``gnn_convs.{i}.{name}`` -> ``gnn_convs_{i}/{name}``,
    ``mlp_head.linear_layers.{i}`` -> ``mlp_head/linear_{i}``."""
    tree: dict = {}
    for key, value in state_dict.items():
        a = value.detach().cpu().numpy().astype(np.float32)
        parts = key.split(".")
        if parts[0] == "gnn_convs" and len(parts) == 3:
            tree.setdefault(f"gnn_convs_{parts[1]}", {})[parts[2]] = a
            continue
        if parts[0] == "gnn_convs" and len(parts) == 4:
            node = tree.setdefault(f"gnn_convs_{parts[1]}", {})
            name = parts[2]
        elif parts[:2] == ["mlp_head", "linear_layers"] and len(parts) == 4:
            node = tree.setdefault("mlp_head", {})
            name = f"linear_{parts[2]}"
        else:
            raise ValueError(f"not a parameter of GNNModel: {key!r}")
        leaf = parts[-1]
        if leaf not in ("weight", "bias"):
            raise ValueError(f"not a parameter of GNNModel: {key!r}")
        node.setdefault(name, {})["kernel" if leaf == "weight" else "bias"] = (
            np.ascontiguousarray(a.T) if leaf == "weight" else a)
    return {"params": tree}


def site_to_jax(site: str) -> str:
    """``gnn_convs.{i}.{name}`` -> ``gnn_convs_{i}/{name}``;
    ``mlp_head.linear_layers.{i}`` -> ``mlp_head/linear_{i}``."""
    parts = site.split(".")
    if len(parts) == 3 and parts[0] == "gnn_convs":
        return f"gnn_convs_{parts[1]}/{parts[2]}"
    if len(parts) == 3 and parts[:2] == ["mlp_head", "linear_layers"]:
        return f"mlp_head/linear_{parts[2]}"
    raise ValueError(f"not a Linear site of GNNModel: {site!r}")


"""Port ``verify.torch_ref`` golden-model weights into this package's
``GNNModel`` (the JAX package's ``verify/port.py``, which ports them into
its flax tree).

``port_conv`` / ``port_mlp`` give each torch_ref module's weights under
the flax tree's names and layouts (a torch Linear's weight [out, in] as a
kernel [in, out]), as the JAX package's functions of the same names do;
``port_model`` carries the whole tree onto this package's state dict with
``port.params_from_jax``, so both packages take a torch_ref model's
weights by one mapping.  Every conv of ``torch_ref.TORCH_CONVS``: gcn,
gin, gine, sage, pna, gat (with ``edge_dim`` too), edge, lg and simple
(the last two have no weights).
"""

from __future__ import annotations

import numpy as np
import torch

from gnnbuilder_tpu_torch.port import params_from_jax

__all__ = ["port_conv", "port_mlp", "port_model"]


def _t(p: torch.Tensor) -> np.ndarray:
    return p.detach().cpu().numpy().astype(np.float32)


def _linear(mod: torch.nn.Linear) -> dict:
    out = {"kernel": _t(mod.weight).T}
    if mod.bias is not None:
        out["bias"] = _t(mod.bias)
    return out


def port_conv(conv_type: str, tconv) -> dict:
    """One torch_ref conv's weights under the flax tree's names."""
    if conv_type == "gcn":
        return {"lin": _linear(tconv.lin), "bias": _t(tconv.bias)}
    if conv_type in ("gin", "edge"):
        # EdgeConv's lin0 is a torch Linear [out, 2 in]: kernel [2 in, out]
        return {"lin0": _linear(tconv.lin0), "lin1": _linear(tconv.lin1)}
    if conv_type == "gine":
        return {
            "lin_edge": _linear(tconv.lin_edge),
            "lin0": _linear(tconv.lin0),
            "lin1": _linear(tconv.lin1),
        }
    if conv_type == "sage":
        return {"lin_l": _linear(tconv.lin_l), "lin_r": _linear(tconv.lin_r)}
    if conv_type == "pna":
        return {
            "pre_nn": _linear(tconv.pre_nn),
            "post_nn": _linear(tconv.post_nn),
            "lin": _linear(tconv.lin),
        }
    if conv_type == "gat":
        out = {
            "lin": _linear(tconv.lin),
            "att_src": _t(tconv.att_src),
            "att_dst": _t(tconv.att_dst),
            "bias": _t(tconv.bias),
        }
        if getattr(tconv, "edge_dim", None) is not None:
            out["lin_edge"] = _linear(tconv.lin_edge)
            out["att_edge"] = _t(tconv.att_edge)
        return out
    if conv_type in ("lg", "simple"):
        return {}
    raise ValueError(f"unknown conv type {conv_type}")


def port_mlp(tmlp) -> dict:
    return {
        f"linear_{i}": _linear(lin)
        for i, lin in enumerate(tmlp.linear_layers)
    }


def port_model(conv_type: str, tmodel) -> dict:
    """A whole ``torch_ref.TorchGNNModel`` -> a state dict for this
    package's ``GNNModel.load_state_dict`` / ``Program.set_params``."""
    params = {}
    for i, tconv in enumerate(tmodel.gnn_convs):
        p = port_conv(conv_type, tconv)
        if p:
            params[f"gnn_convs_{i}"] = p
    params["mlp_head"] = port_mlp(tmodel.mlp_head)
    return params_from_jax({"params": params})

"""Placements of a batch's fields and a model's parameters on a mesh (the
JAX package's ``parallel/sharding.py``).

A placement is plain data, a tuple read as the JAX package's
``PartitionSpec``: ``("dp", None)`` shards dim 0 over the dp ranks in
contiguous blocks, ``()`` replicates.  Every rank packs the same global
``GraphBatch`` (the native packer is deterministic), and
``shard_batch`` keeps this rank's blocks of it, on its device: the ELL
tables keep their global ids.  The two strategies place a batch
differently:

* ``batch_shardings`` (the all-gather strategy, JAX's GSPMD layout):
  node rows, edge rows, the ELL tables and the block rows shard over dp;
* ``halo_batch_specs`` (the halo strategy): node rows and their tables
  shard over dp, the edge arrays replicate (the halo formulation reads
  neighbours through the ELL tables only; GINE's edge-slot gathers take
  global ids into them).

Block rows follow node rows (a dp block must hold whole blocks).

Parameters (a state dict): a 2-D weight whose output features (dim 0 of
a torch Linear's [out, in], the JAX kernel's dim 1) divide by tp shards
them over tp, ``("tp", None)``, where its layer's p-factor is above 1
(``model_p_factors``) or, without p-factors, wherever it divides;
everything else replicates.
"""

from __future__ import annotations

import dataclasses

import torch

from gnnbuilder_tpu_torch.core.graph import GraphBatch

__all__ = [
    "batch_shardings",
    "halo_batch_specs",
    "shard_batch",
    "shard_batch_global",
    "model_p_factors",
    "param_shardings",
    "shard_params",
    "gather_params",
]

ROWS = ("dp",)
ROWS2 = ("dp", None)
ROWS3 = ("dp", None, None)
REP = ()
TP_OUT = ("tp", None)

# fields with a placement; the rest are static ints
_FIELDS = [f.name for f in dataclasses.fields(GraphBatch)
           if not f.name.endswith("_static")]


def _specs(batch: GraphBatch, edge) -> dict:
    """{field: placement or None (field absent)}: node rows over dp, the
    edge arrays as ``edge`` gives them."""
    spec = dict(
        node_feat=ROWS2, senders=edge[0], receivers=edge[0],
        edge_feat=edge[1], node_graph=ROWS, in_degree=ROWS,
        row_offsets=REP, n_node=REP, n_edge=REP, node_mask=ROWS,
        edge_mask=edge[0], graph_mask=REP, nbr_nodes=ROWS2,
        nbr_edges=ROWS2, rev_nbr_nodes=ROWS2, out_degree=ROWS,
        block_adj=ROWS3, graph_starts=REP,
    )
    return {k: (None if getattr(batch, k) is None else spec[k])
            for k in _FIELDS}


def batch_shardings(mesh, batch: GraphBatch) -> dict:
    """The all-gather strategy's placement of each field (JAX's GSPMD
    edge partitioning: node, edge and block rows over dp)."""
    return _specs(batch, (ROWS, ROWS2))


def halo_batch_specs(batch: GraphBatch) -> dict:
    """The halo strategy's placement of each field: node rows and their
    tables over dp, everything else replicated."""
    return _specs(batch, (REP, REP))


def _local(t, spec, mesh):
    if spec is None:
        return None
    if not spec:
        return t
    n = mesh.shape["dp"]
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split over dp={n}; "
                         f"pad the batch (node_multiple / edge_multiple "
                         f"or budgets that divide)")
    k = t.shape[0] // n
    i = mesh.index("dp")
    return t[i * k:(i + 1) * k].contiguous()


def shard_batch(mesh, batch: GraphBatch, halo: bool = False) -> GraphBatch:
    """This rank's ``GraphBatch`` on ``mesh.device``: its blocks of the
    fields the strategy shards (``halo_batch_specs`` with ``halo``, else
    ``batch_shardings``), the rest whole.  ``batch`` is the global batch,
    which every rank packs alike; a block-packed batch's blocks must not
    straddle two ranks."""
    specs = (halo_batch_specs(batch) if halo
             else batch_shardings(mesh, batch))
    n = mesh.shape["dp"]
    if batch.block_adj is not None and (
            (batch.num_nodes // n) % batch.block_size_static
            or batch.num_nodes % n):
        raise ValueError(f"{batch.num_nodes} block-packed rows do not "
                         f"split into whole blocks over dp={n}")
    local = {k: _local(getattr(batch, k), s, mesh) for k, s in specs.items()}
    out = batch.replace(**local).to(mesh.device)
    return out


def shard_batch_global(mesh, batch: GraphBatch,
                       halo: bool = False) -> GraphBatch:
    """``shard_batch``: every process packs the same global batch and
    keeps its own blocks, so the multi-host placement (JAX's
    ``shard_batch_global``) is the same call, with no cross-host copy."""
    return shard_batch(mesh, batch, halo)


def model_p_factors(model) -> dict:
    """Per-layer parallelism factors of a ``GNNModel``, keyed by the
    module's name in the model (``gnn_convs.{i}``,
    ``mlp_head.linear_layers.{i}``; ``port.site_to_jax`` gives the JAX
    keys): each conv layer its p_out, the MLP's hidden Linears p_hidden
    and its last p_out.  A layer with p > 1 shards its weights' output
    features over tp."""
    out = {}
    for i, (_, _, _, p_out) in enumerate(model._layer_dims()):
        out[f"gnn_convs.{i}"] = int(p_out)
    n_lin = model.mlp_hidden_layers + 1
    for i in range(n_lin):
        p = model.mlp_p_out if i == n_lin - 1 else model.mlp_p_hidden
        out[f"mlp_head.linear_layers.{i}"] = int(p)
    return out


def _params(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.state_dict())
    return dict(params)


def param_shardings(mesh, params, p_factors=None) -> dict:
    """{name: ``("tp", None)`` or ``()``} for a state dict (or a model):
    2-D weights whose output features divide by tp shard, with
    ``p_factors`` only those of layers whose factor is above 1."""
    tp = mesh.shape["tp"]
    out = {}
    for name, p in _params(params).items():
        spec = REP
        if p.dim() == 2 and tp > 1 and p.shape[0] % tp == 0:
            spec = TP_OUT
            if p_factors is not None:
                dotted = f".{name}."
                factor = next((v for k, v in p_factors.items()
                               if f".{k}." in dotted), 1)
                if factor <= 1:
                    spec = REP
        out[name] = spec
    return out


def shard_params(mesh, params, p_factors=None) -> dict:
    """This rank's parameters on ``mesh.device``: a tp-sharded weight's
    block of output features (rows of the torch [out, in] weight), the
    rest whole; new leaf tensors."""
    specs = param_shardings(mesh, params, p_factors)
    tp = mesh.shape["tp"]
    out = {}
    for name, p in _params(params).items():
        p = torch.as_tensor(p).detach()
        if specs[name] == TP_OUT:
            k = p.shape[0] // tp
            t = mesh.index("tp")
            p = p[t * k:(t + 1) * k]
        out[name] = p.to(mesh.device).clone().contiguous()
    return out


def gather_params(mesh, params: dict, model) -> dict:
    """The whole of each of ``params`` (this rank's, as ``shard_params``
    gives them, or their gradients): a tp block all-gathered over tp,
    where its shape is a block of ``model``'s parameter of that name."""
    from gnnbuilder_tpu_torch.parallel import _comm

    full = dict(model.state_dict())
    out = {}
    for name, p in params.items():
        whole = full[name].shape
        if tuple(p.shape) != tuple(whole):
            if (len(whole) != 2 or p.shape[0] * mesh.shape["tp"] != whole[0]
                    or p.shape[1:] != whole[1:]):
                raise ValueError(f"{name}: {tuple(p.shape)} is no tp block "
                                 f"of {tuple(whole)}")
            p = _comm._all_gather(mesh, "tp", p.detach().contiguous(), 0)
        out[name] = p
    return out

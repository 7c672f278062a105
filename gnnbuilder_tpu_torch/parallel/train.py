"""The sharded forward and train step over a mesh (the JAX package's
``parallel/train.py``).

Each rank runs the model on its blocks of the batch
(``sharding.shard_batch``) in one of two strategies:

* ``halo=True``: the model runs on the rank's node rows under
  ``halo.halo_scope``.  Every neighbour gather reads the ring-exchanged
  [halo | local | halo] window, pooling sums its per-graph partials over
  dp, and the per-layer kernels of rows 4 (GCN, GIN, SAGE, LG, Simple),
  5 (PNA) and 10 (GAT) run once per rank on the window
  (``halo.halo_wrap_layer``), their backwards (rows 6, 7 and 11) over the
  window's reverse CSR, made once per step.  The gates of the kernels
  whose layouts span the batch decline, as in the JAX package.  Weights
  sharded over tp are all-gathered first, as JAX's ``shard_map`` takes
  its replicated parameters.
* ``halo=False``, the counterpart of JAX's GSPMD path: the port has no
  compiler to infer collectives, so the model runs under
  ``halo.allgather_scope`` and ``dispatch.no_fused()`` (JAX enters
  ``no_fused`` here too): each gather all-gathers the rows it reads,
  pooling reduces its partials as under halo, and a Linear whose weight
  is sharded over tp computes its block of output columns and
  all-gathers them (``nn.linear.tp_scope``).

Both need the batch's ELL tables and graph-contiguous packing (the
packer's guarantees).  Every rank gets the whole prediction [G, out].

The step forms the loss on every rank and counts it once
(``_comm.count_once``: each rank's backward starts from loss / the
mesh's ranks, and each collective's backward is its transpose); then it
sums each replicated parameter's gradient over the mesh and each tp
block's over dp, so every rank holds the single-device step's gradient
(of its blocks), and steps its optimizer.  Parameters are a dict of this
rank's tensors (``sharding.shard_params``), updated in place.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gnnbuilder_tpu_torch.core.graph import GraphBatch, _round_up
from gnnbuilder_tpu_torch.nn.linear import tp_scope
from gnnbuilder_tpu_torch.ops.dispatch import no_fused
from gnnbuilder_tpu_torch.parallel import _comm
from gnnbuilder_tpu_torch.parallel.halo import allgather_scope, halo_scope
from gnnbuilder_tpu_torch.parallel.sharding import (
    model_p_factors,
    shard_params,
)
from gnnbuilder_tpu_torch.train import masked_mse_loss

__all__ = ["make_sharded_train_step", "make_sharded_forward"]


def _halo_size(example_batch: GraphBatch, mesh, axis: str = "dp") -> int:
    """The halo width: the largest graph rounded up to 8; raises where
    the halo strategy does not apply."""
    maxg = example_batch.max_graph_nodes_static
    if maxg <= 0:
        raise ValueError(
            "halo=True requires max_graph_nodes_static metadata "
            "(build batches with build_graph_batch)")
    halo = _round_up(maxg, 8)
    n_local = example_batch.num_nodes // mesh.shape[axis]
    if halo > n_local:
        raise ValueError(
            f"halo {halo} exceeds local rows {n_local}; use fewer dp shards")
    return halo


def _check_example(example_batch: GraphBatch, mesh):
    if example_batch.nbr_nodes is None:
        raise ValueError("a sharded forward requires ELL neighbor tables")
    if not mesh.member:
        raise RuntimeError(f"rank {mesh.rank} is not in the mesh")


def _check_batch(batch: GraphBatch, example: GraphBatch, mesh, halo):
    dp = mesh.shape["dp"]
    want_e = example.num_edges if halo else example.num_edges // dp
    if (batch.num_nodes != example.num_nodes // dp
            or batch.num_edges != want_e):
        raise ValueError(
            f"this rank's batch has {batch.num_nodes} rows and "
            f"{batch.num_edges} edges; the {'halo' if halo else 'all-gather'}"
            f" strategy over dp={dp} wants {example.num_nodes // dp} and "
            f"{want_e}: shard it with shard_batch(mesh, batch, halo={halo})")


def _blocks(model, mesh, params: dict) -> set:
    """Names of ``params`` that are this rank's tp block of the model's
    parameter (a shape that differs from the model's)."""
    full = dict(model.named_parameters())
    out = set()
    for name, p in params.items():
        whole = full[name].shape
        if tuple(p.shape) == tuple(whole):
            continue
        if (len(whole) != 2 or p.shape[0] * mesh.shape["tp"] != whole[0]
                or tuple(p.shape[1:]) != tuple(whole[1:])):
            raise ValueError(f"{name}: {tuple(p.shape)} is no tp block of "
                             f"{tuple(whole)}")
        out.add(name)
    return out


def _apply(model, mesh, params: Optional[dict], batch: GraphBatch,
           example: GraphBatch, halo: Optional[int], axis: str = "dp"):
    """The model on this rank's ``batch`` with ``params`` (the model's own
    when None) in the strategy of ``halo`` (None: all-gather)."""
    _check_batch(batch, example, mesh, halo is not None)
    if params is None:
        params = dict(model.named_parameters())
    blocks = _blocks(model, mesh, params)
    call = torch.func.functional_call
    if halo is not None:
        full = {k: _comm.all_gather(v, mesh, "tp", 0) if k in blocks else v
                for k, v in params.items()}
        with halo_scope(axis, halo, mesh):
            return call(model, full, (batch,))
    owners = {name.rsplit(".", 1)[0] for name in blocks}
    mods = [m for n, m in model.named_modules() if n in owners]
    with no_fused(), allgather_scope(mesh, axis), tp_scope(mesh, mods):
        return call(model, params, (batch,))


def make_sharded_forward(model, mesh, example_batch: GraphBatch,
                         halo: bool = False):
    """``fwd(params, batch) -> [G, out]``: the model on this rank's
    ``batch`` (``shard_batch(mesh, global_batch, halo=halo)``) with this
    rank's ``params`` (``shard_params``' dict, or None for the model's
    own), the whole prediction on every rank.  ``example_batch`` is the
    global batch (every rank packs the same), as in the JAX package.
    The model moves to ``mesh.device``."""
    _check_example(example_batch, mesh)
    h = _halo_size(example_batch, mesh) if halo else None
    model.to(mesh.device)

    def fwd(params, batch):
        return _apply(model, mesh, params, batch, example_batch, h)

    return fwd


def _sum_grads(mesh, params: dict, blocks: set):
    """Each replicated parameter's gradient summed over the mesh, each tp
    block's over dp, in one flat all-reduce per group."""
    for axis, names in (("mesh", [k for k in params if k not in blocks]),
                        ("dp", [k for k in params if k in blocks])):
        if not names:
            continue
        grads = []
        for k in names:
            p = params[k]
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        flat = _comm._all_reduce(mesh, axis,
                                 torch.cat([g.reshape(-1) for g in grads]))
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def make_sharded_train_step(
    model,
    optimizer,
    mesh,
    example_batch: GraphBatch,
    loss_fn: Callable = masked_mse_loss,
    donate: bool = True,
    halo: bool = False,
):
    """Returns ``(step, init)``.  ``init(params=None)`` places a state dict
    (the model's own when None) as this rank's parameters, sharding over
    tp the weights of layers with a p-factor above 1
    (``model_p_factors``), and makes ``optimizer(list of them)`` (a
    ``torch.optim`` class or factory); it returns ``(params,
    opt_state)``.  ``step(params, opt_state, batch, target)`` runs one
    step on this rank's ``batch`` with the replicated ``target`` [G, T]
    and returns ``(params, opt_state, loss)``: the parameters and the
    optimizer are updated in place, as ``train.make_train_step`` does, so
    ``donate`` (JAX's buffer donation) changes nothing.  ``halo`` picks
    the strategy (module docstring)."""
    del donate
    _check_example(example_batch, mesh)
    h = _halo_size(example_batch, mesh) if halo else None
    model.to(mesh.device)
    p_factors = model_p_factors(model)

    def init(params=None):
        params = model.state_dict() if params is None else params
        local = shard_params(mesh, params, p_factors)
        for v in local.values():
            v.requires_grad_(True)
        return local, optimizer(list(local.values()))

    def step(params, opt_state, batch, target):
        opt_state.zero_grad(set_to_none=True)
        pred = _apply(model, mesh, params, batch, example_batch, h)
        loss = loss_fn(pred, target, batch.graph_mask)
        _comm.count_once(loss, mesh).backward()
        _sum_grads(mesh, params, _blocks(model, mesh, params))
        opt_state.step()
        return params, opt_state, loss.detach()

    return step, init

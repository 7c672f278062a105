"""Gradients under the bf16 and int8 policies through the layer kernels'
autograd Functions, against the JAX package, on the CPU.

* Layer level: each Function in each mode (``mode="bf16"`` and
  ``"int8"``), and its plain twin (``plain=True``, or
  ``dispatch.plain_twins``), against ``jax.grad`` of the JAX
  ``fused_*_vjp`` in interpret mode, called directly: ``mm="bf16",
  gather_mode="bf16"`` (GAT's gather is exact in every mode) at 2e-3 of
  max, ``quant=True`` (its gather "highest": the port's int8 gather is
  exact) at 5e-3.  PNA (rows 5, 6, 7; with and without the reverse
  table, both held to the JAX backward's table route), the mp layer (row
  4: gin, sage, gcn on the table, gcn on the block adjacency), GINE (row 12), GAT (rows 10, 11; the edge GAT under
  bf16), the multi-aggregate under bf16 (row 8: Simple max without u,
  PNA's five aggregators with u) and the readout (row 2).
* Model level: ``tests/test_torch_policy_grad_model.py``.

Each tolerance is max |ours - ref| <= tol * max |ref|.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset
from gnnbuilder_tpu.ops.pallas import ell_agg as jax_ell_agg
from gnnbuilder_tpu.ops.pallas import gat_layer as jax_gat
from gnnbuilder_tpu.ops.pallas import gine_layer as jax_gine
from gnnbuilder_tpu.ops.pallas import mp_layer as jax_mp
from gnnbuilder_tpu.ops.pallas import pna_layer as jax_pna
from gnnbuilder_tpu.ops.pallas import readout as jax_readout
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.ops.cuda import (
    ell_agg,
    gat_layer,
    gine_layer,
    mp_layer,
    pna_layer,
    readout,
)

TOL_LAYER = {"bf16": 2e-3, "int8": 5e-3}
# the JAX kernels' arguments in each mode
JAX_MODE = {"bf16": dict(gather_mode="bf16", mm="bf16"),
            "int8": dict(gather_mode="highest", mm="f32", quant=True)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def batch():
    """(JAX batch, port batch) of 12 small random graphs with edge
    features; some graphs repeat a node's row, so max and min tie."""
    gs = FakeDataset(num_graphs=12, avg_num_nodes=10, node_dim=16, seed=3)
    out = []
    for i, g in enumerate(gs):
        x = np.array(g.x)
        if i % 2 == 0 and x.shape[0] > 3:
            x[1] = x[3] = x[0]
        out.append(dataclasses.replace(g, x=x))
    jb, tb = jax_build(out), build_graph_batch(out, device="cpu")
    assert tb.rev_nbr_nodes is not None
    return jb, tb


def _check_layer(mode, port_fn, jax_fn, arrays, ct, what):
    """``port_fn(leaves, plain)`` for plain False (the Function) and True
    (its twin) against ``jax.grad`` of ``jax_fn(*arrays)``, every
    array's gradient."""
    jin = [jnp.asarray(a) for a in arrays]
    refs = jax.grad(lambda *a: (jax_fn(*a) * ct).sum(),
                    argnums=tuple(range(len(jin))))(*jin)
    for plain in (False, True):
        leaves = [_t(a).requires_grad_() for a in arrays]
        port_fn(leaves, plain).backward(_t(ct))
        for i, (t, ref) in enumerate(zip(leaves, refs)):
            assert t.grad is not None, (what, plain, i)
            rel = _rel(t.grad.numpy(), ref)
            assert rel <= TOL_LAYER[mode], (what, mode, plain, i, rel)


def _r(rng, *shape, sc=None):
    sc = 1.0 / np.sqrt(shape[0]) if sc is None else sc
    return (rng.standard_normal(shape) * sc).astype(np.float32)


@pytest.mark.parametrize("mode,rev", [("bf16", True), ("bf16", False),
                                      ("int8", True)])
def test_pna_layer_function_matches_jax(batch, mode, rev, monkeypatch):
    jb, tb = batch
    N, Fin = tb.node_feat.shape
    F, Fout = 16, 24
    rng = np.random.default_rng(11)
    arrays = [tb.node_feat.numpy(), _r(rng, 2 * Fin, F), _r(rng, F, sc=.1),
              _r(rng, Fin + 12 * F, Fout), _r(rng, Fout, sc=.1),
              _r(rng, Fout, Fout), _r(rng, Fout, sc=.1),
              _r(rng, N, Fout, sc=.5)]
    ct = rng.standard_normal((N, Fout)).astype(np.float32)
    delta = 1.9
    # without the reverse table the port gathers over the reverse CSR with
    # the same formulas; the JAX VJP takes them (its scatter or gather
    # kernel) only where its TPU geometry gate holds, else the float32
    # reference's VJP, so both port routes are held to its table route
    tr = (tb.rev_nbr_nodes, tb.out_degree) if rev else (None, None)
    jr = (jb.rev_nbr_nodes, jb.out_degree)
    modes = []
    fn = pna_layer.fused_pna_layer
    monkeypatch.setattr(pna_layer, "fused_pna_layer", lambda *a, **k: (
        modes.append(k["mode"]), fn(*a, **k))[1])

    def port(L, plain):
        return pna_layer.fused_pna_layer_vjp(
            L[0], tb.nbr_nodes, tb.in_degree, *L[1:7], delta, skip=L[7],
            act="relu", rev_nbr_nodes=tr[0], out_degree=tr[1], mode=mode,
            plain=plain)

    def ref(x, *p):
        return jax_pna.fused_pna_layer_vjp(
            x, jb.nbr_nodes, jb.in_degree, *p[:6], delta, skip=p[6],
            rev_nbr_nodes=jr[0], out_degree=jr[1], tile_rows=N,
            window_slack=0, interpret=True, act="relu", **JAX_MODE[mode])

    _check_layer(mode, port, ref, arrays, ct, "pna")
    # the Function launches the mode's kernel (here its plain version);
    # the twin calls no kernel wrapper
    assert modes == [mode]


_MP_CASES = [("gin", "bf16", False), ("sage", "bf16", False),
             ("gcn", "bf16", False), ("gcn", "bf16", True),
             ("gin", "int8", False), ("sage", "int8", False)]


@pytest.mark.parametrize("conv,mode,block", _MP_CASES)
def test_mp_layer_function_matches_jax(batch, conv, mode, block):
    jb, tb = batch
    if block:
        gs = FakeDataset(num_graphs=12, avg_num_nodes=10, node_dim=16,
                         seed=3)
        jb, tb = (jax_build(gs, block_size=128),
                  build_graph_batch(gs, block_size=128, device="cpu"))
    N, F = tb.node_feat.shape
    H = Fout = 24 if conv != "gcn" else F
    rng = np.random.default_rng(12)
    names = {"gin": ("w0", "b0", "w1", "b1"), "sage": ("w0", "b0", "w1"),
             "gcn": ("b0",)}[conv]
    shapes = {"w0": (F, H), "b0": (H,), "w1": (H if conv == "gin" else F,
                                              Fout), "b1": (Fout,)}
    arrays = ([tb.node_feat.numpy(), _r(rng, N, Fout, sc=.5)]
              + [_r(rng, *shapes[k]) if k[0] == "w" else
                 _r(rng, *shapes[k], sc=.1) for k in names])
    ct = rng.standard_normal((N, Fout)).astype(np.float32)
    badj = (tb.block_adj, jb.block_adj) if block else (None, None)

    def port(L, plain):
        return mp_layer.fused_mp_layer_vjp(
            L[0], tb.nbr_nodes, tb.in_degree, conv,
            **dict(zip(names, L[2:])), eps=0.1, skip=L[1],
            rev_nbr_nodes=tb.rev_nbr_nodes, out_degree=tb.out_degree,
            act="relu", block_adj=badj[0], mode=mode, plain=plain)

    def ref(v, sk, *p):
        return jax_mp.fused_mp_layer_vjp(
            v, jb.nbr_nodes, jb.in_degree, conv, **dict(zip(names, p)),
            eps=0.1, skip=sk, rev_nbr_nodes=jb.rev_nbr_nodes,
            out_degree=jb.out_degree, tile_rows=N, window_slack=0,
            interpret=True, act="relu", block_adj=badj[1],
            **JAX_MODE[mode])

    _check_layer(mode, port, ref, arrays, ct, conv)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_gine_layer_function_matches_jax(batch, mode):
    jb, tb = batch
    N, F = tb.node_feat.shape
    E = tb.num_edges
    rng = np.random.default_rng(13)
    arrays = [tb.node_feat.numpy(), _r(rng, E, F, sc=1.0),
              _r(rng, N, 24, sc=.5), _r(rng, F, 32), _r(rng, 32, sc=.1),
              _r(rng, 32, 24), _r(rng, 24, sc=.1)]
    ct = rng.standard_normal((N, 24)).astype(np.float32)

    def port(L, plain):
        return gine_layer.fused_gine_layer_vjp(
            L[0], L[1], tb.nbr_nodes, tb.nbr_edges, tb.in_degree, *L[3:],
            eps=0.1, skip=L[2], act="relu", mode=mode, plain=plain)

    def ref(x, pe, sk, *p):
        return jax_gine.fused_gine_layer_vjp(
            x, pe, jb.nbr_nodes, jb.nbr_edges, jb.row_offsets, jb.in_degree,
            *p, eps=0.1, skip=sk, act="relu", tile_rows=N, window_slack=0,
            interpret=True, **JAX_MODE[mode])

    _check_layer(mode, port, ref, arrays, ct, "gine")


@pytest.mark.parametrize("mode,edge", [("bf16", False), ("int8", False),
                                       ("bf16", True)])
def test_gat_layer_function_matches_jax(batch, mode, edge, monkeypatch):
    jb, tb = batch
    N, Fin = tb.node_feat.shape
    W = tb.nbr_nodes.shape[1]
    H, C = 2, 8
    rng = np.random.default_rng(14)
    arrays = [tb.node_feat.numpy(), _r(rng, N, H * C, sc=.5),
              _r(rng, Fin, H * C), _r(rng, 1, H, C, sc=.3),
              _r(rng, 1, H, C, sc=.3), _r(rng, H * C, sc=.1)]
    if edge:
        arrays += [_r(rng, N, W, H, sc=.5), _r(rng, N, H, sc=.5)]
    ct = rng.standard_normal((N, H * C)).astype(np.float32)
    calls = []
    fn = gat_layer.fused_gat_scatter_backward
    monkeypatch.setattr(gat_layer, "fused_gat_scatter_backward",
                        lambda *a, **k: (calls.append(1), fn(*a, **k))[1])

    def port(L, plain):
        ekw = dict(edge_logits=L[6], self_edge_logit=L[7]) if edge else {}
        return gat_layer.fused_gat_layer_vjp(
            L[0], tb.nbr_nodes, tb.in_degree, *L[2:6], H, skip=L[1],
            act="relu", rev_nbr_nodes=tb.rev_nbr_nodes,
            out_degree=tb.out_degree, mode=mode, plain=plain, **ekw)

    def ref(x, sk, *p):
        ekw = dict(edge_logits=p[4], self_edge_logit=p[5]) if edge else {}
        kw = dict(JAX_MODE[mode], gather_mode="highest")
        return jax_gat.fused_gat_layer_vjp(
            x, jb.nbr_nodes, jb.in_degree, *p[:4], H, skip=sk, act="relu",
            tile_rows=N, window_slack=0, interpret=True, **kw, **ekw)

    _check_layer(mode, port, ref, arrays, ct, "gat")
    # row 11 in the Function's bf16 backward without edge terms; the int8
    # and edge backwards are autograd of the float32 plain layer
    assert calls == ([1] if mode == "bf16" and not edge else [])


@pytest.mark.parametrize("aggrs,with_u", [(("max",), False),
                                          (("min",), False),
                                          (("sum", "mean", "min", "max",
                                            "std"), True)])
def test_ell_aggregate_function_bf16_matches_jax(batch, aggrs, with_u):
    jb, tb = batch
    N, F = tb.node_feat.shape
    rng = np.random.default_rng(15)
    arrays = [tb.node_feat.numpy()] + ([_r(rng, N, F, sc=1.0)]
                                       if with_u else [])
    ct = rng.standard_normal((N, len(aggrs) * F)).astype(np.float32)

    def port(L, plain):
        with dispatch.plain_twins() if plain else contextlib.nullcontext():
            return ell_agg.fused_ell_aggregate_vjp(
                L[0], tb.nbr_nodes, tb.in_degree, aggrs,
                u=L[1] if with_u else None, rev_nbr_nodes=tb.rev_nbr_nodes,
                out_degree=tb.out_degree, mode="bf16")

    def ref(v, *u):
        return jax_ell_agg.fused_ell_aggregate_vjp(
            v, jb.nbr_nodes, jb.in_degree, aggrs, u=u[0] if u else None,
            rev_nbr_nodes=jb.rev_nbr_nodes, out_degree=jb.out_degree,
            tile_rows=N, window_slack=0, interpret=True, gather_mode="bf16")

    _check_layer("bf16", port, ref, arrays, ct, aggrs)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_readout_function_matches_jax(batch, mode):
    jb, tb = batch
    N, F = tb.node_feat.shape
    G = tb.num_graphs
    rng = np.random.default_rng(16)
    dims, d, ws = (32, 32, 3), 2 * F, []
    for o in dims:
        ws += [_r(rng, d, o), _r(rng, o, sc=.1)]
        d = o
    arrays = [rng.standard_normal((N, F)).astype(np.float32)] + ws
    ct = rng.standard_normal((G, 3)).astype(np.float32)
    ct[~tb.graph_mask.numpy()] = 0.0
    aggrs = ("add", "mean")

    def port(L, plain):
        pairs = [(L[i], L[i + 1]) for i in range(1, len(L), 2)]
        return readout.fused_readout_vjp(
            L[0], tb.n_node, pairs, aggrs=aggrs, act="relu",
            starts=tb.graph_starts, mode=mode, plain=plain)

    def ref(x, *flat):
        pairs = tuple((flat[i], flat[i + 1]) for i in range(0, len(flat), 2))
        kw = {k: v for k, v in JAX_MODE[mode].items() if k != "gather_mode"}
        return jax_readout.fused_readout_vjp(
            x, jb.n_node, pairs, aggrs=aggrs, act="relu", tile_graphs=8,
            maxg=tb.max_graph_nodes_static, interpret=True, **kw)

    _check_layer(mode, port, ref, arrays, ct, "readout")

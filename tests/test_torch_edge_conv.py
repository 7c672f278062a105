"""EdgeConv's slice (ops/cuda/edge_block.py, EdgeConv, edge in GNNModel)
against the JAX package on the CPU.

* ``fused_edge_block_layer`` (its plain version on the CPU) for max, sum
  and mean, with and without skip, at Fin = 11 and 16, against the
  Pallas ``fused_edge_block_layer(..., interpret=True, mm="f32",
  gather_mode="highest")`` and ``edge_block_reference``.
* ``EdgeBlockFunction``'s gradients against ``jax.grad`` of the JAX
  ``edge_block_layer_auto`` (its recompute VJP, interpret mode).
* ``EdgeConv`` (max, sum, mean) on the block, ELL and edge-list routes,
  in and out of inference scope, and the route each takes.
* ``Program.forward`` of a 3-layer EdgeConv model (max) block- and
  standard-packed against the JAX ``Program`` on the same weights
  (``params_from_jax``).

Tolerances: layer outputs to max |ours - ref| <= 1e-5 * max |ref| (f32
sums in another order; the kernel sums the relu rows before lin1 for sum
and mean); gradients to 2e-5 of max; convs and forwards at atol 5e-4 /
rtol 1e-3 and 1e-4 of max on real rows, as tests/test_torch_mp_layer.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu.bench.canonical import (
    canonical_model as jax_canonical_model,
)
from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset, load_dataset
from gnnbuilder_tpu.nn import conv as jax_conv
from gnnbuilder_tpu.ops.pallas.edge_block import (
    edge_block_layer_auto as jax_layer_auto,
)
from gnnbuilder_tpu.ops.pallas.edge_block import edge_block_reference
from gnnbuilder_tpu.ops.pallas.edge_block import (
    fused_edge_block_layer as jax_layer,
)
from gnnbuilder_tpu_torch import Program
from gnnbuilder_tpu_torch.bench.canonical import canonical_model
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.nn import conv as torch_conv
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.ops.cuda import edge_block
from gnnbuilder_tpu_torch.port import params_from_jax

TOL_OUT, TOL_GRAD = 1e-5, 2e-5
ATOL, RTOL, SCALED_TOL = 5e-4, 1e-3, 1e-4
AGGRS = ("max", "sum", "mean")


def _scaled_close(ours, ref, tol, what=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    assert np.isfinite(ours).all(), what
    err = float(np.abs(ours - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (what, err)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batches():
    """24 small random graphs (multi-edges; every third graph's node 0
    receives no edge), block-packed at 128 rows."""
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=11, seed=4)
    gs = [dataclasses.replace(g, edge_index=g.edge_index[
        :, g.edge_index[1] != 0]) if i % 3 == 0 else g
        for i, g in enumerate(gs)]
    kw = dict(block_size=128, node_multiple=128)
    jb, tb = jax_build(gs, **kw), build_graph_batch(gs, device="cpu", **kw)
    assert (tb.in_degree[tb.node_mask] == 0).any()
    return jb, tb


def _operands(rng, N, Fin, F=24, Fout=24):
    def r(*shape, sc=0.4):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    return r(N, Fin, sc=1.0), dict(w_pair=r(2 * Fin, F), b0=r(F, sc=0.1),
                                   w1=r(F, Fout), b1=r(Fout, sc=0.1))


@pytest.mark.parametrize("aggr", AGGRS)
@pytest.mark.parametrize("Fin,use_skip", [(11, True), (16, False)])
def test_layer_matches_jax_kernel_and_reference(aggr, Fin, use_skip):
    jb, tb = _batches()
    N = tb.num_nodes
    rng = np.random.default_rng(5)
    x, p = _operands(rng, N, Fin)
    skip = (rng.standard_normal((N, 24)).astype(np.float32)
            if use_skip else None)
    ours = edge_block.fused_edge_block_layer(
        _t(x), tb.nbr_nodes, tb.in_degree, **{k: _t(a) for k, a in p.items()},
        aggregation=aggr, skip=None if skip is None else _t(skip),
        act="relu").numpy()
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jskip = None if skip is None else jnp.asarray(skip)
    kern = jax_layer(jnp.asarray(x), jb.nbr_nodes, jb.in_degree, **jp,
                     aggregation=aggr, skip=jskip, act="relu", tile_rows=N,
                     interpret=True, gather_mode="highest", mm="f32")
    ref = edge_block_reference(jnp.asarray(x), jb.nbr_nodes, jb.in_degree,
                               **jp, aggregation=aggr, skip=jskip,
                               act="relu")
    m = tb.node_mask.numpy()
    for name, want in (("kernel", kern), ("reference", ref)):
        _scaled_close(ours[m], np.asarray(want)[m], TOL_OUT, (name, aggr))


@pytest.mark.parametrize("aggr", AGGRS)
def test_layer_gradients_match_jax(aggr):
    jb, tb = _batches()
    N = tb.num_nodes
    rng = np.random.default_rng(8)
    x, p = _operands(rng, N, 11)
    skip = rng.standard_normal((N, 24)).astype(np.float32)
    ct = rng.standard_normal((N, 24)).astype(np.float32)
    ct[~tb.node_mask.numpy()] = 0.0
    names = ("w_pair", "b0", "w1", "b1")
    xt, st = _t(x).requires_grad_(), _t(skip).requires_grad_()
    pt = [_t(p[k]).requires_grad_() for k in names]
    out = edge_block.fused_edge_block_layer_auto(
        xt, tb.nbr_nodes, tb.in_degree, *pt, aggregation=aggr, skip=st,
        act="tanh")
    out.backward(_t(ct))
    ours = [xt.grad, st.grad] + [t.grad for t in pt]

    def kern_loss(xx, sk, *ws):
        return (jax_layer_auto(xx, jb.nbr_nodes, jb.in_degree, *ws,
                               aggregation=aggr, skip=sk, act="tanh",
                               tile_rows=N, interpret=True,
                               gather_mode="highest", mm="f32") * ct).sum()

    def ref_loss(xx, sk, *ws):
        return (edge_block_reference(xx, jb.nbr_nodes, jb.in_degree, *ws,
                                     aggregation=aggr, skip=sk, act="tanh")
                * ct).sum()

    jin = [jnp.asarray(x), jnp.asarray(skip)] + [jnp.asarray(p[k])
                                                 for k in names]
    argnums = tuple(range(len(jin)))
    for name, fn in (("kernel", kern_loss), ("reference", ref_loss)):
        grads = jax.grad(fn, argnums=argnums)(*jin)
        for i, (o, w) in enumerate(zip(ours, grads)):
            _scaled_close(o.numpy(), w, TOL_GRAD, (name, aggr, i))


ROUTES = {
    "block": dict(block_size=128, node_multiple=128),
    "ell": dict(block_size=None, node_multiple=8),
    "edge_list": dict(block_size=None, node_multiple=8, ell_width=0),
}


def _route_batches(route):
    graphs = load_dataset("qm9", n=20, seed=2)
    kw = ROUTES[route]
    jb = jax_build(graphs, **kw)
    tb = build_graph_batch(graphs, device="cpu", **kw)
    assert (tb.nbr_nodes is None) == (route == "edge_list")
    return graphs, jb, tb


class _Calls:
    """Counts ``edge_block.fused_edge_block_layer`` calls."""

    def __enter__(self):
        self.n = 0
        self.orig = edge_block.fused_edge_block_layer

        def counted(*a, **k):
            self.n += 1
            return self.orig(*a, **k)

        edge_block.fused_edge_block_layer = counted
        return self

    def __exit__(self, *exc):
        edge_block.fused_edge_block_layer = self.orig
        return False


@pytest.mark.parametrize("aggr", AGGRS + ("add",))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_conv_matches_jax_on_each_route(aggr, route):
    _, jb, tb = _route_batches(route)
    rng = np.random.default_rng(4)
    F, Fo = 11, 24
    x = rng.standard_normal((tb.num_nodes, F)).astype(np.float32)
    skip = rng.standard_normal((tb.num_nodes, Fo)).astype(np.float32)
    jc = jax_conv.EdgeConv(in_channels=F, out_channels=Fo, aggregation=aggr)
    jp = jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(5), jb, x))
    ref = np.asarray(jc.apply(jp, jb, x, "relu", skip))
    tc = torch_conv.EdgeConv(F, Fo, aggregation=aggr)
    sd = params_from_jax({"params": {"gnn_convs_0": jp["params"],
                                     "mlp_head": {}}})
    tc.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    m = tb.node_mask.numpy()
    for mode, infer in (("auto", True), ("auto", False), ("never", True)):
        dispatch.set_fused_mode(mode)
        try:
            with torch.no_grad(), _Calls() as c:
                if infer:
                    with dispatch.inference_mode():
                        ours = tc(tb, _t(x), "relu", _t(skip)).numpy()
                else:
                    ours = tc(tb, _t(x), "relu", _t(skip)).numpy()
        finally:
            dispatch.set_fused_mode("auto")
        np.testing.assert_allclose(ours[m], ref[m], atol=ATOL, rtol=RTOL,
                                   err_msg=f"{mode} {infer}")
        kernel = mode == "auto" and infer and route == "block"
        assert c.n == int(kernel), (mode, infer, c.n)


@pytest.mark.parametrize("route", ["block", "ell"])
def test_program_matches_jax(route):
    graphs, jb, tb = _route_batches(route)
    over = dict(gnn_num_layers=3, gnn_hidden_dim=32, gnn_output_dim=16)
    jm = jax_canonical_model("edge", "qm9", graphs=graphs, **over)
    tm = canonical_model("edge", "qm9", graphs=graphs, **over)
    bs = ROUTES[route]["block_size"] or 0
    size = dict(max_nodes=jb.num_nodes, max_edges=jb.num_edges,
                max_graphs=jb.num_graphs, block_size=bs)
    jprog = gnnb.Program(jm, **size)
    params = jax.tree.map(np.asarray, jprog.init_params(jb))
    tp = Program(tm, **size, device="cpu")
    tp.set_params(params_from_jax(params))
    ref = np.asarray(jprog.forward(jb))
    m = tb.graph_mask.numpy()
    for mode in ("auto", "never"):
        dispatch.set_fused_mode(mode)
        try:
            with _Calls() as c:
                ours = tp.forward(tb).numpy()
        finally:
            dispatch.set_fused_mode("auto")
        assert ours.shape == ref.shape and np.isfinite(ours[m]).all()
        np.testing.assert_allclose(ours[m], ref[m], atol=ATOL, rtol=RTOL,
                                   err_msg=mode)
        err = np.abs(ours[m] - ref[m]).max()
        assert err <= SCALED_TOL * np.abs(ref[m]).max(), (mode, err)
        assert c.n == (3 if mode == "auto" and route == "block" else 0)


def test_gate_and_wrapper_checks():
    _, _, blk = _route_batches("block")
    _, _, std = _route_batches("ell")
    assert dispatch.edge_block_cfg(blk, "relu") is None   # not inference
    with dispatch.inference_mode():
        assert dispatch.edge_block_cfg(blk, "relu") == {}
        assert dispatch.edge_block_cfg(blk, "elu") is None
        assert dispatch.edge_block_cfg(std, "relu") is None
        assert dispatch.edge_block_cfg(blk.replace(nbr_nodes=None),
                                       "relu") is None
        dispatch.set_fused_mode("never")
        try:
            assert dispatch.edge_block_cfg(blk, "relu") is None
        finally:
            dispatch.set_fused_mode("auto")
    x = torch.zeros(blk.num_nodes, 8)
    ops = (torch.zeros(16, 4), torch.zeros(4), torch.zeros(4, 4),
           torch.zeros(4))
    with pytest.raises(ValueError, match="unknown aggregation"):
        edge_block.fused_edge_block_layer(x, blk.nbr_nodes, blk.in_degree,
                                          *ops, aggregation="min")
    with pytest.raises(ValueError, match="w_pair"):
        edge_block.fused_edge_block_layer(x, blk.nbr_nodes, blk.in_degree,
                                          torch.zeros(8, 4), *ops[1:])

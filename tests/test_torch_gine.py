"""GINE's slice (ops/cuda/gine_layer.py, GINEConv, gine in GNNModel and
its training) against the JAX package on the CPU.

* ``fused_gine_layer`` (its plain version on the CPU) at F = 11 and 32,
  with and without skip, on a batch whose pad slots point at pad edges
  with nonzero pe, against the Pallas ``fused_gine_layer(...,
  interpret=True, gather_mode="highest", mm="f32")`` and
  ``gine_layer_reference``.
* ``GINELayerFunction``'s gradients (x, pe, skip and the four weights)
  against ``jax.grad`` of the Pallas ``fused_gine_layer_vjp`` (interpret
  mode) and of the reference.
* ``GINEConv`` on the block, ELL and edge-list routes, the route each
  takes, and on a batch without an ELL table (a 71-node star whose hub
  has in-degree 70, as tests/test_torch_no_ell.py builds it).
* ``Program.forward`` of a 3-layer GINE model (edge features of QM9's
  width 4) block- and standard-packed, and five Adam steps of it on a
  standard-packed batch (every layer through ``GINELayerFunction``),
  against the JAX ``Program`` and ``make_train_step`` on the same
  weights (``params_from_jax``).

Tolerances: layer outputs to max |ours - ref| <= 1e-5 * max |ref| (f32
sums in another order); gradients to 2e-5 of max; convs and forwards at
atol 5e-4 / rtol 1e-3 and 1e-4 of max on real rows; loss curves to 1e-3
relative per step, as tests/test_torch_mp_layer.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu import train as jax_train
from gnnbuilder_tpu.bench.canonical import (
    canonical_batches as jax_canonical_batches,
)
from gnnbuilder_tpu.bench.canonical import (
    canonical_model as jax_canonical_model,
)
from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset, Graph, load_dataset
from gnnbuilder_tpu.nn import conv as jax_conv
from gnnbuilder_tpu.ops.pallas.gine_layer import (
    fused_gine_layer as jax_layer,
)
from gnnbuilder_tpu.ops.pallas.gine_layer import (
    fused_gine_layer_vjp as jax_layer_vjp,
)
from gnnbuilder_tpu.ops.pallas.gine_layer import gine_layer_reference
from gnnbuilder_tpu_torch import Program, train
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.nn import conv as torch_conv
from gnnbuilder_tpu_torch.nn.model import GNNModel
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.ops.cuda import gine_layer
from gnnbuilder_tpu_torch.port import params_from_jax

TOL_OUT, TOL_GRAD = 1e-5, 2e-5
ATOL, RTOL, SCALED_TOL = 5e-4, 1e-3, 1e-4
CURVE_TOL = 1e-3


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
    receives no edge), standard-packed with 8 pad edges, so pad slots
    point at pad edges."""
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=11, seed=4)
    gs = [dataclasses.replace(g, edge_index=g.edge_index[
        :, g.edge_index[1] != 0]) if i % 3 == 0 else g
        for i, g in enumerate(gs)]
    n_edges = sum(g.num_edges for g in gs)
    kw = dict(node_multiple=8, edge_budget=n_edges + 8)
    jb, tb = jax_build(gs, **kw), build_graph_batch(gs, device="cpu", **kw)
    m = tb.node_mask
    assert (tb.in_degree[m] == 0).any()
    assert int(tb.in_degree.max()) < tb.ell_width or (
        tb.in_degree[m] < tb.ell_width).any()
    return jb, tb


def _operands(rng, N, E, F, H=32, Fout=24):
    def r(*shape, sc=0.4):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    # pe on every edge row, pad edges included, as lin_edge's bias puts
    # it there: a kernel that read pad slots would add relu(x + pe)
    return r(N, F, sc=1.0), r(E, F, sc=1.0), dict(
        w0=r(F, H), b0=r(H, sc=0.1), w1=r(H, Fout), b1=r(Fout, sc=0.1))


def _jax_kw():
    return dict(window_slack=0, interpret=True, gather_mode="highest",
                mm="f32")


@pytest.mark.parametrize("F", [11, 32])
@pytest.mark.parametrize("use_skip", [True, False])
def test_layer_matches_jax_kernel_and_reference(F, use_skip):
    jb, tb = _batches()
    N, E = tb.num_nodes, tb.num_edges
    rng = np.random.default_rng(5)
    x, pe, p = _operands(rng, N, E, F)
    skip = (rng.standard_normal((N, 24)).astype(np.float32)
            if use_skip else None)
    eps = 0.2
    ours = gine_layer.fused_gine_layer(
        _t(x), _t(pe), tb.nbr_nodes, tb.nbr_edges, tb.in_degree,
        **{k: _t(a) for k, a in p.items()}, eps=eps,
        skip=None if skip is None else _t(skip), act="relu").numpy()
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jskip = None if skip is None else jnp.asarray(skip)
    kern = jax_layer(jnp.asarray(x), jnp.asarray(pe), jb.nbr_nodes,
                     jb.nbr_edges, jb.row_offsets, jb.in_degree, **jp,
                     eps=eps, skip=jskip, act="relu", tile_rows=N,
                     **_jax_kw())
    ref = gine_layer_reference(jnp.asarray(x), jnp.asarray(pe),
                               jb.nbr_nodes, jb.nbr_edges, jb.in_degree,
                               **jp, eps=eps, skip=jskip, act="relu")
    m = tb.node_mask.numpy()
    for name, want in (("kernel", kern), ("reference", ref)):
        _scaled_close(ours[m], np.asarray(want)[m], TOL_OUT, (name, F))
    # the pad slots hold nonzero pe: reading them would move the output
    unmasked = gine_layer.gine_layer_plain(
        _t(x), _t(pe), tb.nbr_nodes, tb.nbr_edges,
        torch.full_like(tb.in_degree, tb.ell_width),
        **{k: _t(a) for k, a in p.items()}, eps=eps,
        skip=None if skip is None else _t(skip), act="relu").numpy()
    assert np.abs(unmasked[m] - ours[m]).max() > 1e-2


@pytest.mark.parametrize("F", [11, 32])
def test_layer_gradients_match_jax(F):
    jb, tb = _batches()
    N, E = tb.num_nodes, tb.num_edges
    rng = np.random.default_rng(8)
    x, pe, p = _operands(rng, N, E, F)
    skip = rng.standard_normal((N, 24)).astype(np.float32)
    ct = rng.standard_normal((N, 24)).astype(np.float32)
    ct[~tb.node_mask.numpy()] = 0.0
    names = sorted(p)
    xt, pet, st = (_t(a).requires_grad_() for a in (x, pe, skip))
    pt = {k: _t(p[k]).requires_grad_() for k in names}
    out = gine_layer.fused_gine_layer_vjp(
        xt, pet, tb.nbr_nodes, tb.nbr_edges, tb.in_degree,
        **pt, eps=0.1, skip=st, act="tanh")
    out.backward(_t(ct))
    ours = [xt.grad, pet.grad, st.grad] + [pt[k].grad for k in names]

    def kern_loss(xx, pp, sk, *ws):
        return (jax_layer_vjp(xx, pp, jb.nbr_nodes, jb.nbr_edges,
                              jb.row_offsets, jb.in_degree,
                              **dict(zip(names, ws)), eps=0.1, skip=sk,
                              act="tanh", tile_rows=N, **_jax_kw())
                * ct).sum()

    def ref_loss(xx, pp, sk, *ws):
        return (gine_layer_reference(xx, pp, jb.nbr_nodes, jb.nbr_edges,
                                     jb.in_degree, **dict(zip(names, ws)),
                                     eps=0.1, skip=sk, act="tanh")
                * ct).sum()

    jin = [jnp.asarray(a) for a in (x, pe, skip)] + [jnp.asarray(p[k])
                                                     for k in names]
    argnums = tuple(range(len(jin)))
    for name, fn in (("kernel", kern_loss), ("reference", ref_loss)):
        grads = jax.grad(fn, argnums=argnums)(*jin)
        for i, (o, w) in enumerate(zip(ours, grads)):
            _scaled_close(o.numpy(), w, TOL_GRAD, (name, F, i))


ROUTES = {
    "block": dict(block_size=128, node_multiple=128),
    "ell": dict(block_size=None, node_multiple=8),
    "edge_list": dict(block_size=None, node_multiple=8, ell_width=0),
}


def _star(n=71, dim=11, seed=0):
    """A hub (node 0) with edges to and from every other node."""
    rng = np.random.default_rng(seed)
    leaves = np.arange(1, n)
    ei = np.concatenate([np.stack([leaves, np.zeros_like(leaves)]),
                         np.stack([np.zeros_like(leaves), leaves])], axis=1)
    return Graph(x=rng.standard_normal((n, dim)).astype(np.float32),
                 edge_index=ei.astype(np.int64),
                 edge_attr=rng.standard_normal((ei.shape[1], 4)).astype(
                     np.float32))


def _route_batches(route):
    graphs = load_dataset("qm9", n=20, seed=2)
    if route == "star":
        graphs = graphs[:5] + [_star()] + graphs[5:12]
        kw = dict(block_size=128, node_multiple=128)
    else:
        kw = ROUTES[route]
    jb = jax_build(graphs, **kw)
    tb = build_graph_batch(graphs, device="cpu", **kw)
    assert (tb.nbr_nodes is None) == (route in ("edge_list", "star"))
    assert tb.edge_feat is not None and tb.edge_feat.shape[1] == 4
    return graphs, jb, tb


class _Calls:
    """Counts ``gine_layer.fused_gine_layer`` calls."""

    def __enter__(self):
        self.n = 0
        self.orig = gine_layer.fused_gine_layer

        def counted(*a, **k):
            self.n += 1
            return self.orig(*a, **k)

        gine_layer.fused_gine_layer = counted
        return self

    def __exit__(self, *exc):
        gine_layer.fused_gine_layer = self.orig
        return False


@pytest.mark.parametrize("route", sorted(ROUTES) + ["star"])
def test_conv_matches_jax_on_each_route(route):
    _, jb, tb = _route_batches(route)
    rng = np.random.default_rng(4)
    F, Fo = 11, 24
    x = rng.standard_normal((tb.num_nodes, F)).astype(np.float32)
    skip = rng.standard_normal((tb.num_nodes, Fo)).astype(np.float32)
    jc = jax_conv.GINEConv(in_channels=F, out_channels=Fo, edge_dim=4,
                           eps=0.1)
    jp = jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(5), jb, x))
    ref = np.asarray(jc.apply(jp, jb, x, "relu", skip))
    tc = torch_conv.GINEConv(F, Fo, edge_dim=4, eps=0.1)
    sd = params_from_jax({"params": {"gnn_convs_0": jp["params"],
                                     "mlp_head": {}}})
    tc.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    m = tb.node_mask.numpy()
    for mode in ("auto", "never"):
        dispatch.set_fused_mode(mode)
        try:
            with torch.no_grad(), _Calls() as c:
                ours = tc(tb, _t(x), "relu", _t(skip)).numpy()
        finally:
            dispatch.set_fused_mode("auto")
        np.testing.assert_allclose(ours[m], ref[m], atol=ATOL, rtol=RTOL,
                                   err_msg=mode)
        kernel = mode == "auto" and tb.nbr_nodes is not None
        assert c.n == int(kernel), (mode, c.n)


@pytest.mark.parametrize("route", ["block", "ell", "star"])
def test_program_matches_jax(route):
    graphs, jb, tb = _route_batches(route)
    over = dict(gnn_num_layers=3, gnn_hidden_dim=32, gnn_output_dim=16)
    jm = jax_canonical_model("gine", "qm9", graphs=graphs, **over)
    tm = canonical_model("gine", "qm9", graphs=graphs, **over)
    assert tm.graph_input_edge_dim == 4
    bs = 128 if route != "ell" else 0
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
        assert c.n == (3 if mode == "auto" and route != "star" else 0)


def test_adam_loss_curve_matches_jax():
    """Five Adam(1e-3) steps of a 3-layer GINE model from the same weights
    on a standard-packed batch: every layer through ``GINELayerFunction``,
    the loss before each step within 1e-3 relative of the JAX
    ``make_train_step``'s."""
    kw = dict(n_graphs=24, batch_size=24)
    gj, (jb,) = jax_canonical_batches("qm9", **kw)
    gt, (tb,) = canonical_batches("qm9", **kw, device="cpu")
    over = dict(gnn_num_layers=3, gnn_hidden_dim=32, gnn_output_dim=16)
    jm = jax_canonical_model("gine", "qm9", graphs=gj, **over)
    tm = canonical_model("gine", "qm9", graphs=gt, **over)
    params = jm.init(jax.random.PRNGKey(0), jb)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    target_np = np.asarray(jax_train.stack_targets(gj, jb.num_graphs, 1))
    target = train.stack_targets(gt, tb.num_graphs, 1, device="cpu")
    opt = optax.adam(1e-3)
    jstep = jax_train.make_train_step(jm, opt, donate=False)
    jp, jo = params, opt.init(params)
    step = train.make_train_step(tm, torch.optim.Adam(tm.parameters(),
                                                      lr=1e-3))
    calls = []
    orig = gine_layer.fused_gine_layer_vjp

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    gine_layer.fused_gine_layer_vjp = counted
    try:
        for i in range(5):
            jp, jo, jl = jstep(jp, jo, jb, jnp.asarray(target_np))
            tl = float(step(tb, target))
            assert abs(tl - float(jl)) <= CURVE_TOL * abs(float(jl)), (
                i, tl, jl)
    finally:
        gine_layer.fused_gine_layer_vjp = orig
    assert len(calls) == 15


def test_gate_and_model_checks():
    _, _, blk = _route_batches("block")
    _, _, std = _route_batches("ell")
    _, _, edge = _route_batches("edge_list")
    for g in (blk, std):
        assert dispatch.gine_layer_cfg(g, "relu") == {}
        assert dispatch.gine_layer_cfg(g, "elu") is None
    assert dispatch.gine_layer_cfg(edge, "relu") is None
    assert dispatch.gine_layer_cfg(std.replace(nbr_edges=None),
                                   "relu") is None
    dispatch.set_fused_mode("never")
    try:
        assert dispatch.gine_layer_cfg(std, "relu") is None
    finally:
        dispatch.set_fused_mode("auto")
    with pytest.raises(ValueError, match="graph_input_edge_dim"):
        GNNModel(11, 16, 2, 8, "gine")
    with pytest.raises(ValueError, match="edge_dim"):
        torch_conv.GINEConv(11, 16)
    m = GNNModel(11, 16, 2, 8, "gine", graph_input_edge_dim=4)
    assert [c.lin_edge.in_features for c in m.gnn_convs] == [4, 4]
    assert [c.lin_edge.out_features for c in m.gnn_convs] == [11, 16]
    x = torch.zeros(std.num_nodes, 11)
    with pytest.raises(ValueError, match="pe must be"):
        gine_layer.fused_gine_layer(
            x, torch.zeros(std.num_edges, 8), std.nbr_nodes, std.nbr_edges,
            std.in_degree, torch.zeros(11, 4), torch.zeros(4),
            torch.zeros(4, 4), torch.zeros(4))

"""The per-layer mp kernel's slice (ops/cuda/mp_layer.py and the convs,
models and train steps that run it) against the JAX package on the CPU.

* ``fused_mp_layer`` (its plain version on the CPU) in the ELL and block
  modes, for gin, sage, gcn, lg, simple_sum and simple_mean, with and
  without skip, relu and tanh, against the Pallas ``fused_mp_layer(...,
  interpret=True, gather_mode="highest", mm="f32")`` and against
  ``mp_layer_reference``, widths 11 -> 32 -> 32 (gin), 11 -> 16 (sage)
  and 16 (the rest); ``save_s``'s s against the JAX kernel's and the
  plain neighbour sum.
* ``MPLayerFunction``'s gradients on its three dv routes (the block
  transpose, the reverse table, the reverse CSR of a batch without one)
  against ``jax.grad`` of the Pallas ``fused_mp_layer_vjp`` (interpret
  mode) and of ``mp_layer_reference``, and the route each takes.
* ``LGConv`` and ``SimpleConv`` (sum, mean, max, min) on the block, ELL
  and edge-list routes against the JAX convs, and ``Program.forward`` of
  3-layer LG and Simple models against the JAX ``Program`` on the same
  weights (``params_from_jax``).
* Five Adam steps of 3-layer GCN, GIN and SAGE models (every layer
  through ``MPLayerFunction``) against the JAX ``make_train_step``.

Tolerances: outputs and s to max |ours - ref| <= 1e-5 * max |ref| (f32
sums in another order); gradients to 2e-5 of max; convs and forwards at
atol 5e-4 / rtol 1e-3 and 1e-4 of max on real rows, as
tests/test_torch_mp_block.py; loss curves to 1e-3 relative per step, as
tests/test_torch_train.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu import train as jax_train
from gnnbuilder_tpu.bench.canonical import CANONICAL as JAX_CANONICAL
from gnnbuilder_tpu.bench.canonical import (
    canonical_batches as jax_canonical_batches,
)
from gnnbuilder_tpu.bench.canonical import (
    canonical_model as jax_canonical_model,
)
from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset, load_dataset
from gnnbuilder_tpu.nn import conv as jax_conv
from gnnbuilder_tpu.ops.pallas.mp_layer import (
    fused_mp_layer as jax_layer,
)
from gnnbuilder_tpu.ops.pallas.mp_layer import (
    fused_mp_layer_vjp as jax_layer_vjp,
)
from gnnbuilder_tpu.ops.pallas.mp_layer import mp_layer_reference
from gnnbuilder_tpu_torch import Program, train
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.nn import conv as torch_conv
from gnnbuilder_tpu_torch.ops import dispatch, ell
from gnnbuilder_tpu_torch.ops.cuda import mp_layer
from gnnbuilder_tpu_torch.port import params_from_jax

TOL_OUT, TOL_GRAD = 1e-5, 2e-5
ATOL, RTOL, SCALED_TOL = 5e-4, 1e-3, 1e-4
CURVE_TOL = 1e-3
CONVS = ("gin", "sage", "gcn", "lg", "simple_sum", "simple_mean")


def _scaled_close(ours, ref, tol, what=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    assert np.isfinite(ours).all(), what
    err = float(np.abs(ours - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (what, err)


def _graphs():
    """24 small random graphs with multi-edges; every third graph's node 0
    receives no edge, so degree-0 rows occur."""
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=11, seed=4)
    return [dataclasses.replace(g, edge_index=g.edge_index[
        :, g.edge_index[1] != 0]) if i % 3 == 0 else g
        for i, g in enumerate(gs)]


def _batches(block, **kw):
    """``_graphs`` packed at 128 rows for the block mode or standard-packed
    for the ELL mode, with the ELL and (unless ``rev_ell_width=0``)
    reverse tables."""
    kw.update(dict(block_size=128, node_multiple=128) if block
              else dict(node_multiple=8))
    gs = _graphs()
    jb, tb = jax_build(gs, **kw), build_graph_batch(gs, device="cpu", **kw)
    deg = tb.in_degree[tb.node_mask]
    assert (deg == 0).any() and tb.multigraph_static
    return jb, tb


def _operands(conv, rng, N):
    """(v, params as numpy) for one layer of ``conv``."""
    def r(*shape, sc=0.4):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    if conv == "gin":
        return r(N, 11, sc=1.0), dict(w0=r(11, 32), b0=r(32, sc=0.1),
                                      w1=r(32, 32), b1=r(32, sc=0.1))
    if conv == "sage":
        return r(N, 11, sc=1.0), dict(w0=r(11, 16), b0=r(16, sc=0.1),
                                      w1=r(11, 16))
    if conv == "gcn":
        return r(N, 16, sc=1.0), dict(b0=r(16, sc=0.1))
    return r(N, 16, sc=1.0), {}


def _out_width(conv, v, p):
    return {"gin": 32, "sage": 16}.get(conv, v.shape[1])


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_kw(jb, block):
    """The Pallas kernel's schedule for these batches: one tile with the
    whole batch as its window (ELL), or one tile of 128-row blocks."""
    if block:
        return dict(tile_rows=jb.num_nodes, interpret=True,
                    gather_mode="highest", mm="f32",
                    block_adj=jb.block_adj)
    return dict(tile_rows=jb.num_nodes, window_slack=0, interpret=True,
                gather_mode="highest", mm="f32")


@pytest.mark.parametrize("conv", CONVS)
@pytest.mark.parametrize("mode", ["ell", "block"])
@pytest.mark.parametrize("act,use_skip", [("relu", True), ("tanh", False)])
def test_layer_matches_jax_kernel_and_reference(conv, mode, act, use_skip):
    block = mode == "block"
    jb, tb = _batches(block)
    N = tb.num_nodes
    rng = np.random.default_rng(5)
    v, p = _operands(conv, rng, N)
    Fout = _out_width(conv, v, p)
    skip = (rng.standard_normal((N, Fout)).astype(np.float32)
            if use_skip else None)
    eps = 0.15 if conv == "gin" else 0.0
    ours, s = mp_layer.fused_mp_layer(
        _t(v), tb.nbr_nodes, tb.in_degree, conv,
        **{k: _t(a) for k, a in p.items()}, eps=eps,
        skip=None if skip is None else _t(skip), act=act, save_s=True,
        block_adj=tb.block_adj if block else None)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jskip = None if skip is None else jnp.asarray(skip)
    kern, ks = jax_layer(
        jnp.asarray(v), None if block else jb.nbr_nodes, jb.in_degree, conv,
        **jp, eps=eps, skip=jskip, act=act, save_s=True,
        **_jax_kw(jb, block))
    ref = mp_layer_reference(jnp.asarray(v), jb.nbr_nodes, jb.in_degree,
                             conv, **jp, eps=eps, skip=jskip, act=act)
    m = tb.node_mask.numpy()
    for want in (kern, ref):
        _scaled_close(ours.numpy()[m], np.asarray(want)[m], TOL_OUT,
                      (conv, mode))
    plain_s = ell.ell_sum(_t(v), tb.nbr_nodes, tb.in_degree)
    _scaled_close(s.numpy()[m], np.asarray(ks)[m], TOL_OUT, "s")
    _scaled_close(s.numpy()[m], plain_s.numpy()[m], TOL_OUT, "s plain")


def _route_batch(route):
    """A standard-packed batch with its reverse table ("rev") or without
    ("csr", as ``rev_ell_width=0`` builds it), or a block batch."""
    if route != "csr":
        return _batches(route == "block")
    jb, tb = _batches(False, rev_ell_width=0)
    assert tb.rev_nbr_nodes is None and tb.nbr_nodes is not None
    return jb, tb


@pytest.mark.parametrize("conv", CONVS)
@pytest.mark.parametrize("route", ["block", "rev", "csr"])
def test_layer_gradients_match_jax(conv, route):
    jb, tb = _route_batch(route)
    block = route == "block"
    N = tb.num_nodes
    rng = np.random.default_rng(8)
    v, p = _operands(conv, rng, N)
    Fout = _out_width(conv, v, p)
    skip = rng.standard_normal((N, Fout)).astype(np.float32)
    ct = rng.standard_normal((N, Fout)).astype(np.float32)
    # pad rows carry no cotangent: the JAX kernel leaves them unchecked
    ct[~tb.node_mask.numpy()] = 0.0
    eps = 0.15 if conv == "gin" else 0.0
    names = sorted(p)

    calls = {"gather": 0, "csr": 0}
    orig = (mp_layer.fused_gather_backward, mp_layer.fused_gather_backward_csr)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    vt = _t(v).requires_grad_()
    pt = {k: _t(p[k]).requires_grad_() for k in names}
    st = _t(skip).requires_grad_()
    mp_layer.fused_gather_backward = count("gather", orig[0])
    mp_layer.fused_gather_backward_csr = count("csr", orig[1])
    try:
        out = mp_layer.fused_mp_layer_vjp(
            vt, tb.nbr_nodes, tb.in_degree, conv, **pt, eps=eps, skip=st,
            rev_nbr_nodes=tb.rev_nbr_nodes, out_degree=tb.out_degree,
            act="tanh", block_adj=tb.block_adj if block else None)
        out.backward(_t(ct))
    finally:
        (mp_layer.fused_gather_backward,
         mp_layer.fused_gather_backward_csr) = orig
    assert calls == {"gather": int(route == "rev"),
                     "csr": int(route == "csr")}
    ours = [vt.grad, st.grad] + [pt[k].grad for k in names]

    def kern_loss(vv, sk, *pp):
        kw = _jax_kw(jb, block)
        return (jax_layer_vjp(
            vv, None if block else jb.nbr_nodes, jb.in_degree, conv,
            **dict(zip(names, pp)), eps=eps, skip=sk,
            rev_nbr_nodes=jb.rev_nbr_nodes, out_degree=jb.out_degree,
            act="tanh", **kw) * ct).sum()

    def ref_loss(vv, sk, *pp):
        return (mp_layer_reference(vv, jb.nbr_nodes, jb.in_degree, conv,
                                   **dict(zip(names, pp)), eps=eps, skip=sk,
                                   act="tanh") * ct).sum()

    jin = [jnp.asarray(v), jnp.asarray(skip)] + [jnp.asarray(p[k])
                                                 for k in names]
    argnums = tuple(range(len(jin)))
    for name, fn in (("kernel", kern_loss), ("reference", ref_loss)):
        grads = jax.grad(fn, argnums=argnums)(*jin)
        for i, (o, w) in enumerate(zip(ours, grads)):
            _scaled_close(o.numpy(), w, TOL_GRAD, (name, conv, route, i))


ROUTES = {
    "block": dict(block_size=128, node_multiple=128),
    "ell": dict(block_size=None, node_multiple=8),
    "edge_list": dict(block_size=None, node_multiple=8, ell_width=0),
}
SAME_WIDTH = [("lg", {}), ("simple", {"aggregation": "sum"}),
              ("simple", {"aggregation": "mean"}),
              ("simple", {"aggregation": "max"}),
              ("simple", {"aggregation": "min"})]


def _route_batches(route, node_dim=None):
    graphs = load_dataset("qm9", n=20, seed=2)
    if node_dim is not None:
        graphs = [dataclasses.replace(g, x=np.pad(
            g.x, ((0, 0), (0, node_dim - g.x.shape[1])))) for g in graphs]
    kw = ROUTES[route]
    jb = jax_build(graphs, **kw)
    tb = build_graph_batch(graphs, device="cpu", **kw)
    assert (tb.block_adj is not None) == (route == "block")
    assert (tb.nbr_nodes is None) == (route == "edge_list")
    return graphs, jb, tb


@pytest.mark.parametrize("conv,kw", SAME_WIDTH,
                         ids=["lg", "sum", "mean", "max", "min"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_same_width_conv_matches_jax_on_each_route(conv, kw, route):
    _, jb, tb = _route_batches(route)
    rng = np.random.default_rng(4)
    F = 16
    x = rng.standard_normal((tb.num_nodes, F)).astype(np.float32)
    skip = rng.standard_normal((tb.num_nodes, F)).astype(np.float32)
    cls = {"lg": jax_conv.LGConv, "simple": jax_conv.SimpleConv}[conv]
    jc = cls(in_channels=F, out_channels=F, **kw)
    ref = np.asarray(jc.apply({}, jb, x, "relu", skip))
    tc = torch_conv.SUPPORTED_GNN_CONVS[conv](F, F, **kw)
    m = tb.node_mask.numpy()
    for mode in ("auto", "never"):
        dispatch.set_fused_mode(mode)
        try:
            with torch.no_grad():
                ours = tc(tb, torch.from_numpy(x), "relu",
                          torch.from_numpy(skip)).numpy()
        finally:
            dispatch.set_fused_mode("auto")
        np.testing.assert_allclose(ours[m], ref[m], atol=ATOL, rtol=RTOL,
                                   err_msg=mode)
    with pytest.raises(ValueError, match="in_channels == out_channels"):
        torch_conv.SUPPORTED_GNN_CONVS[conv](F, F + 1, **kw)


@pytest.mark.parametrize("conv,kw", SAME_WIDTH[:3],
                         ids=["lg", "sum", "mean"])
@pytest.mark.parametrize("route", ["block", "ell"])
def test_program_matches_jax(conv, kw, route):
    """3-layer LG and Simple models at input = hidden = output = 16 (the
    canonical shape of these convs, features zero-padded), through the
    mp layer kernel's path (block mode, or ELL mode) and the plain path,
    against the JAX Program on the same weights."""
    graphs, jb, tb = _route_batches(route, node_dim=16)
    over = dict(gnn_num_layers=3, gnn_hidden_dim=16, gnn_output_dim=16,
                conv_kwargs=kw)
    cfg = {k: v for k, v in JAX_CANONICAL.items() if k not in over}
    jm = gnnb.GNNModel(graph_input_feature_dim=16, gnn_conv=conv, **cfg,
                       **over)
    tm = canonical_model(conv, "qm9", graphs=graphs, **over)
    assert tm.graph_input_feature_dim == 16
    bs = ROUTES[route]["block_size"] or 0
    size = dict(max_nodes=jb.num_nodes, max_edges=jb.num_edges,
                max_graphs=jb.num_graphs, block_size=bs)
    jprog = gnnb.Program(jm, **size)
    params = jax.tree.map(np.asarray, jprog.init_params(jb))
    tp = Program(tm, **size, device="cpu")
    tp.set_params(params_from_jax(params))
    ref = np.asarray(jprog.forward(jb))
    m = tb.graph_mask.numpy()
    calls = []
    orig = mp_layer.fused_mp_layer

    def counted(*a, **k):
        calls.append(k.get("block_adj") is not None)
        return orig(*a, **k)

    mp_layer.fused_mp_layer = counted
    try:
        for mode in ("auto", "never"):
            dispatch.set_fused_mode(mode)
            try:
                ours = tp.forward(tb).numpy()
            finally:
                dispatch.set_fused_mode("auto")
            assert ours.shape == ref.shape
            assert np.isfinite(ours[m]).all()
            np.testing.assert_allclose(ours[m], ref[m], atol=ATOL,
                                       rtol=RTOL, err_msg=mode)
            err = np.abs(ours[m] - ref[m]).max()
            assert err <= SCALED_TOL * np.abs(ref[m]).max(), (mode, err)
    finally:
        mp_layer.fused_mp_layer = orig
    assert calls == [route == "block"] * 3


def test_canonical_same_width_batches_match_jax():
    """``canonical_batches(node_dim=...)`` pads the features as the JAX
    package does, and the canonical LG model runs at input = hidden =
    output."""
    gj, (jb,) = jax_canonical_batches("qm9", n_graphs=16, batch_size=16,
                                      node_dim=32)
    gt, (tb,) = canonical_batches("qm9", n_graphs=16, batch_size=16,
                                  node_dim=32, device="cpu")
    np.testing.assert_array_equal(tb.node_feat.numpy(),
                                  np.asarray(jb.node_feat))
    m = canonical_model("lg", "qm9", graphs=gt)
    assert m.gnn_layer_sizes == [(128, 128)] * 6
    assert canonical_model("simple", "qm9", gnn_hidden_dim=32
                           ).gnn_layer_sizes == [(32, 32)] * 6


@pytest.mark.parametrize("conv", ["gcn", "gin", "sage"])
def test_adam_loss_curve_matches_jax(conv):
    """Five Adam(1e-3) steps of a 3-layer model from the same weights on
    a standard-packed batch (ELL and reverse tables): every layer of the
    port's step goes through ``MPLayerFunction`` and the loss before each
    step agrees with the JAX ``make_train_step`` to 1e-3 relative."""
    kw = dict(n_graphs=24, batch_size=24)
    gj, (jb,) = jax_canonical_batches("qm9", **kw)
    gt, (tb,) = canonical_batches("qm9", **kw, device="cpu")
    over = dict(gnn_num_layers=3, gnn_hidden_dim=32, gnn_output_dim=16)
    jm = jax_canonical_model(conv, "qm9", graphs=gj, **over)
    tm = canonical_model(conv, "qm9", graphs=gt, **over)
    params = jm.init(jax.random.PRNGKey(0), jb)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    target_np = np.asarray(jax_train.stack_targets(gj, jb.num_graphs, 1))
    target = train.stack_targets(gt, tb.num_graphs, 1, device="cpu")
    np.testing.assert_array_equal(target.numpy(), target_np)

    opt = optax.adam(1e-3)
    jstep = jax_train.make_train_step(jm, opt, donate=False)
    jp, jo = params, opt.init(params)
    step = train.make_train_step(tm, torch.optim.Adam(tm.parameters(),
                                                      lr=1e-3))
    calls = []
    orig = mp_layer.fused_mp_layer_vjp

    def counted(*a, **k):
        calls.append(a[3])
        return orig(*a, **k)

    mp_layer.fused_mp_layer_vjp = counted
    try:
        for i in range(5):
            jp, jo, jl = jstep(jp, jo, jb, jnp.asarray(target_np))
            tl = float(step(tb, target))
            assert abs(tl - float(jl)) <= CURVE_TOL * abs(float(jl)), (
                i, tl, jl)
    finally:
        mp_layer.fused_mp_layer_vjp = orig
    assert calls == [conv] * 15


def test_layer_wrapper_rejects_bad_inputs():
    _, tb = _batches(False)
    N = tb.num_nodes
    v = torch.zeros(N, 16)
    with pytest.raises(ValueError, match="unsupported mp layer conv"):
        mp_layer.fused_mp_layer(v, tb.nbr_nodes, tb.in_degree, "pna")
    with pytest.raises(ValueError, match="activation"):
        mp_layer.fused_mp_layer(v, tb.nbr_nodes, tb.in_degree, "lg",
                                act="elu")
    with pytest.raises(ValueError, match="gcn takes"):
        mp_layer.fused_mp_layer(v, tb.nbr_nodes, tb.in_degree, "gcn")
    with pytest.raises(ValueError, match="w1"):
        mp_layer.fused_mp_layer(v, tb.nbr_nodes, tb.in_degree, "sage",
                                w0=torch.zeros(16, 8), b0=torch.zeros(8),
                                w1=torch.zeros(16, 4))
    with pytest.raises(ValueError, match="block_adj"):
        mp_layer.fused_mp_layer(v, None, tb.in_degree, "lg",
                                block_adj=torch.zeros(1, 128, 128))
    with pytest.raises(ValueError, match="skip"):
        mp_layer.fused_mp_layer(v, tb.nbr_nodes, tb.in_degree, "lg",
                                skip=torch.zeros(N, 8))


def test_layer_gate_routes():
    """``mp_layer_cfg``: block mode for gcn, lg and simple on block
    batches, ELL mode on standard batches with a table, None without one
    and under "never"."""
    _, _, blk = _route_batches("block")
    _, _, std = _route_batches("ell")
    _, _, edge = _route_batches("edge_list")
    for conv in ("gcn", "lg", "simple"):
        assert dispatch.mp_layer_cfg(blk, conv) == {"block": True}
    for conv in ("gin", "sage"):
        assert dispatch.mp_layer_cfg(blk, conv) is None
    for conv in ("gcn", "gin", "sage", "lg", "simple"):
        assert dispatch.mp_layer_cfg(std, conv) == {}
        assert dispatch.mp_layer_cfg(edge, conv) is None
    dispatch.set_fused_mode("never")
    try:
        assert dispatch.mp_layer_cfg(std, "gcn") is None
        assert dispatch.mp_layer_cfg(blk, "gcn") is None
    finally:
        dispatch.set_fused_mode("auto")

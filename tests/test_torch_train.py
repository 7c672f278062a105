"""Training in the port against the JAX package, on the CPU.

* ``PNALayerFunction`` (the plain layer with residuals and the
  hand-written backward) against ``jax.grad`` of ``pna_layer_reference``
  and against the Pallas ``fused_pna_layer_vjp`` in interpret mode.
* Whole-model gradients against ``jax.grad`` of the JAX ``GNNModel`` with
  its kernels (``set_fused_mode("always")``, interpret mode) and without
  (``"never"``), weights carried with ``params_from_jax``; and the port's
  ``"auto"`` against its ``"never"``.
* The readout's backward against the Pallas ``fused_readout_vjp``.
* ``contiguous_segment_max`` splits the gradient of tied maxima evenly,
  as the JAX reduce-max VJP does.
* Five Adam steps of ``make_train_step`` against the JAX
  ``make_train_step(model, optax.adam(1e-3))``, losses, metrics,
  ``stack_targets`` and a checkpoint round trip.

Gradients are sums over all rows with cancellation, so each is held to
max |ours - ref| <= tol * max |ref|: 1e-4 against the JAX references and
the port's own plain path (f32 sums in another order, and the std of
near-constant rows magnifies rounding ~158x), 1e-3 against the JAX
kernels, whose split2 hi/lo gather keeps 16 of v's 24 mantissa bits.
Loss curves agree to 1e-3 relative at every step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnnbuilder_tpu import train as jax_train
from gnnbuilder_tpu.bench.canonical import (
    canonical_batches as jax_canonical_batches,
)
from gnnbuilder_tpu.bench.canonical import (
    canonical_model as jax_canonical_model,
)
from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.ops import dispatch as jax_dispatch
from gnnbuilder_tpu.ops import segment as jax_segment
from gnnbuilder_tpu.ops.pallas.pna_layer import (
    fused_pna_layer_vjp as jax_layer_vjp,
)
from gnnbuilder_tpu.ops.pallas.pna_layer import pna_layer_reference
from gnnbuilder_tpu.ops.pallas.readout import (
    fused_readout_vjp as jax_readout_vjp,
)
from gnnbuilder_tpu_torch import train
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.ops import dispatch, segment
from gnnbuilder_tpu_torch.ops.cuda import pna_layer, readout, scatter_bwd
from gnnbuilder_tpu_torch.port import params_from_jax

TOL_REF, TOL_KERNEL = 1e-4, 1e-3
CURVE_TOL = 1e-3


def assert_scaled_close(ours, ref, tol, what=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    scale = float(np.abs(ref).max())
    assert np.isfinite(ours).all(), what
    assert err <= tol * scale, (what, err, scale)


class _G:
    def __init__(self, n, e, rng, dup):
        self.x = rng.standard_normal((n, 16)).astype(np.float32)
        if dup and n > 3:   # identical rows -> exact ties in max/min
            self.x[1] = self.x[0]
            self.x[3] = self.x[0]
        self.edge_index = rng.integers(0, n, size=(2, e))
        self.edge_attr = None
        self.y = None


@pytest.mark.parametrize("act,use_skip", [("relu", True), ("tanh", False),
                                          ("gelu", True)])
def test_layer_function_gradients_match_jax(act, use_skip):
    rng = np.random.default_rng(11)
    gs = [_G(int(rng.integers(4, 12)), int(rng.integers(4, 20)), rng,
             i % 2 == 0) for i in range(9)]
    g = jax_build(gs)
    x = np.asarray(g.node_feat)
    N, Fin = x.shape
    F, Fout = Fin, 24

    def r(fan_in, *s):
        return (rng.standard_normal(s) / np.sqrt(fan_in)).astype(np.float32)

    p = [r(2 * Fin, 2 * Fin, F), r(2 * Fin, F), r(13 * F, 13 * F, Fout),
         r(13 * F, Fout), r(Fout, Fout, Fout), r(Fout, Fout)]
    skip = rng.standard_normal((N, Fout)).astype(np.float32)
    ct = rng.standard_normal((N, Fout)).astype(np.float32)
    delta = 1.9

    xt = torch.from_numpy(x.copy()).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in p]
    st = torch.from_numpy(skip).requires_grad_() if use_skip else None
    out = pna_layer.fused_pna_layer_vjp(
        xt, torch.from_numpy(np.asarray(g.nbr_nodes)),
        torch.from_numpy(np.asarray(g.in_degree)), *pt, delta, skip=st,
        act=act)
    out.backward(torch.from_numpy(ct))
    ours = [xt.grad] + [q.grad for q in pt] + ([st.grad] if use_skip else [])

    sk = jnp.asarray(skip) if use_skip else None
    nargs = 8 if use_skip else 7

    def ref_loss(xx, *pp):
        s = pp[6] if use_skip else None
        return (pna_layer_reference(xx, g.nbr_nodes, g.in_degree, *pp[:6],
                                    delta, skip=s, act=act)
                * ct).sum()

    def kern_loss(xx, *pp):
        s = pp[6] if use_skip else None
        return (jax_layer_vjp(
            xx, g.nbr_nodes, g.in_degree, *pp[:6], delta, skip=s,
            rev_nbr_nodes=g.rev_nbr_nodes, out_degree=g.out_degree,
            tile_rows=N, window_slack=0, interpret=True,
            gather_mode="highest", mm="f32", act=act) * ct).sum()

    jin = [jnp.asarray(x)] + [jnp.asarray(a) for a in p] + (
        [sk] if use_skip else [])
    argn = tuple(range(nargs))
    for name, fn in (("reference", ref_loss), ("kernel", kern_loss)):
        grads = jax.grad(fn, argnums=argn)(*jin)
        for i, (o, w) in enumerate(zip(ours, grads)):
            assert_scaled_close(o.numpy(), w, TOL_REF, (name, act, i))


def _models(layers=3, n_graphs=24):
    kw = dict(n_graphs=n_graphs, batch_size=n_graphs)
    gj, (jb,) = jax_canonical_batches("qm9", **kw)
    gt, (tb,) = canonical_batches("qm9", **kw, device="cpu")
    jm = jax_canonical_model("pna", "qm9", graphs=gj, gnn_num_layers=layers)
    tm = canonical_model("pna", "qm9", graphs=gt, gnn_num_layers=layers)
    params = jm.init(jax.random.PRNGKey(0), jb)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, jb, params, tm, tb, gt


def _torch_grads(tm, tb, target, mode):
    dispatch.set_fused_mode(mode)
    try:
        tm.zero_grad()
        loss = train.masked_mse_loss(tm(tb), target, tb.graph_mask)
        loss.backward()
    finally:
        dispatch.set_fused_mode("auto")
    return float(loss.detach()), {k: p.grad.numpy().copy()
                                  for k, p in tm.named_parameters()}


def _jax_grads(jm, jb, params, target, mode):
    jax_dispatch.set_fused_mode(mode)
    try:
        def loss_fn(pp):
            return jax_train.masked_mse_loss(jm.apply(pp, jb), target,
                                             jb.graph_mask)
        loss, grads = jax.value_and_grad(loss_fn)(params)
    finally:
        jax_dispatch.set_fused_mode("auto")
    return float(loss), params_from_jax(jax.tree.map(np.asarray, grads))


def test_model_gradients_match_jax():
    """The canonical model at 3 layers on a 24-graph standard-packed
    batch: the port's kernel path ("auto", each PNA layer through
    PNALayerFunction and the readout through ReadoutFunction) and its
    plain path ("never") against jax.grad of the JAX model, with and
    without its Pallas kernels."""
    jm, jb, params, tm, tb, gt = _models()
    target_np = np.random.default_rng(0).standard_normal(
        (tb.num_graphs, 1)).astype(np.float32)
    target = torch.from_numpy(target_np)

    # the batch carries a reverse table, so each layer's dv takes the
    # scatter kernel's cstk mode and the reverse-table gather
    calls = {"layer": 0, "scatter": 0, "gather": 0, "readout": 0}
    orig = (pna_layer.fused_pna_layer, scatter_bwd.fused_pna_scatter_cstk,
            pna_layer.fused_gather_backward, readout.fused_readout)
    assert tb.rev_nbr_nodes is not None

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    pna_layer.fused_pna_layer = count("layer", orig[0])
    pna_layer.fused_pna_scatter_cstk = count("scatter", orig[1])
    pna_layer.fused_gather_backward = count("gather", orig[2])
    readout.fused_readout = count("readout", orig[3])
    try:
        l_auto, g_auto = _torch_grads(tm, tb, target, "auto")
    finally:
        pna_layer.fused_pna_layer = orig[0]
        pna_layer.fused_pna_scatter_cstk = orig[1]
        pna_layer.fused_gather_backward = orig[2]
        readout.fused_readout = orig[3]
    assert calls == {"layer": 3, "scatter": 3, "gather": 3, "readout": 1}
    l_never, g_never = _torch_grads(tm, tb, target, "never")
    jt = jnp.asarray(target_np)
    l_jn, g_jn = _jax_grads(jm, jb, params, jt, "never")
    l_ja, g_ja = _jax_grads(jm, jb, params, jt, "always")
    for ref, tol in ((l_never, 1e-6), (l_jn, 1e-5), (l_ja, 1e-4)):
        assert abs(l_auto - ref) <= tol * abs(ref)
    for k in g_auto:
        assert_scaled_close(g_auto[k], g_never[k], TOL_REF, k)
        assert_scaled_close(g_auto[k], g_jn[k].numpy(), TOL_REF, k)
        assert_scaled_close(g_never[k], g_jn[k].numpy(), TOL_REF, k)
        assert_scaled_close(g_auto[k], g_ja[k].numpy(), TOL_KERNEL, k)


@pytest.mark.parametrize("aggrs,out_act", [(("add", "mean", "max"), None),
                                           (("mean",), "log_softmax")])
def test_readout_gradients_match_jax(aggrs, out_act):
    from gnnbuilder_tpu.data.datasets import FakeDataset

    from gnnbuilder_tpu_torch.core.graph import build_graph_batch

    gs = FakeDataset(num_graphs=40, avg_num_nodes=12, node_dim=8, seed=5)
    b = build_graph_batch(gs, node_multiple=128, device="cpu")
    g = jax_build(gs, node_multiple=128)
    rng = np.random.default_rng(6)
    F = 32
    x = rng.standard_normal((b.num_nodes, F)).astype(np.float32)
    dims, d, ws = (64, 64, 3), len(aggrs) * F, []
    for o in dims:
        ws.append(((rng.standard_normal((d, o)) / np.sqrt(d)).astype(
            np.float32), rng.standard_normal(o).astype(np.float32) * 0.1))
        d = o
    ct = rng.standard_normal((b.num_graphs, 3)).astype(np.float32)
    ct[~b.graph_mask.numpy()] = 0.0
    maxg = b.max_graph_nodes_static

    xt = torch.from_numpy(x).requires_grad_()
    wt = [(torch.from_numpy(w).requires_grad_(),
           torch.from_numpy(c).requires_grad_()) for w, c in ws]
    mx = (segment.contiguous_segment_max(xt, b.graph_starts, b.n_node, maxg)
          if "max" in aggrs else None)
    out = readout.fused_readout_vjp(xt, b.n_node, wt, aggrs=aggrs, mx=mx,
                                    act="relu", out_act=out_act,
                                    starts=b.graph_starts)
    out.backward(torch.from_numpy(ct))
    ours = [xt.grad] + [t.grad for wb in wt for t in wb]

    def loss(xx, *flat):
        jw = tuple((flat[i], flat[i + 1]) for i in range(0, len(flat), 2))
        m = (jax_segment.contiguous_segment_max(xx, g.graph_starts, g.n_node,
                                                maxg)
             if "max" in aggrs else None)
        return (jax_readout_vjp(xx, g.n_node, jw, aggrs=aggrs, mx=m,
                                act="relu", out_act=out_act, tile_graphs=8,
                                maxg=maxg, interpret=True, mm="f32")
                * ct).sum()

    flat = [jnp.asarray(t) for wb in ws for t in wb]
    grads = jax.grad(loss, argnums=tuple(range(1 + len(flat))))(
        jnp.asarray(x), *flat)
    for i, (o, w) in enumerate(zip(ours, grads)):
        assert_scaled_close(o.numpy(), w, TOL_REF, i)


def test_contiguous_segment_max_splits_ties_evenly():
    """Two graphs of 4 rows; graph 0 holds a three-way tie in column 0 and
    a two-way tie in column 1.  The gradient splits evenly among the tied
    rows, as jax.grad of the JAX contiguous_segment_max does."""
    x = np.array([[1, 2], [3, 2], [3, 0], [3, -1],
                  [5, 4], [0, 4], [5, 4], [1, 1],
                  [0, 0]], np.float32)
    starts = np.array([0, 4, 8], np.int32)
    counts = np.array([4, 4, 0], np.int32)
    ct = np.array([[1.0, 2.0], [3.0, 6.0], [5.0, 5.0]], np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = segment.contiguous_segment_max(xt, torch.from_numpy(starts),
                                         torch.from_numpy(counts), 8)
    out.backward(torch.from_numpy(ct))

    def loss(xx):
        return (jax_segment.contiguous_segment_max(
            xx, jnp.asarray(starts), jnp.asarray(counts), 8) * ct).sum()

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy()[1:4, 0], [1 / 3] * 3,
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy()[[4, 6], 0], [1.5, 1.5])


def test_adam_loss_curve_matches_jax():
    """Five Adam(1e-3) steps from the same weights on the same batch and
    targets: the loss before each step agrees to 1e-3 relative."""
    jm, jb, params, tm, tb, gt = _models()
    target_np = np.asarray(jax_train.stack_targets(gt, jb.num_graphs, 1))
    target = train.stack_targets(gt, tb.num_graphs, 1, device="cpu")
    np.testing.assert_array_equal(target.numpy(), target_np)
    assert np.abs(target_np).sum() > 0

    opt = optax.adam(1e-3)
    jstep = jax_train.make_train_step(jm, opt, donate=False)
    jp, jo = params, opt.init(params)
    step = train.make_train_step(tm, torch.optim.Adam(tm.parameters(),
                                                      lr=1e-3))
    for i in range(5):
        jp, jo, jl = jstep(jp, jo, jb, jnp.asarray(target_np))
        tl = float(step(tb, target))
        assert abs(tl - float(jl)) <= CURVE_TOL * abs(float(jl)), (i, tl, jl)


def test_losses_and_metrics_match_jax():
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((9, 2)).astype(np.float32)
    tgt = rng.standard_normal((9, 2)).astype(np.float32)
    lbl = (rng.random((9, 2)) > 0.5).astype(np.float32)
    mask = np.array([True] * 8 + [False])
    pt, mt = torch.from_numpy(pred), torch.from_numpy(mask)
    for ours, theirs, y in (
            (train.masked_mse_loss, jax_train.masked_mse_loss, tgt),
            (train.masked_mae, jax_train.masked_mae, tgt),
            (train.masked_bce_logits_loss, jax_train.masked_bce_logits_loss,
             lbl)):
        got = float(ours(pt, torch.from_numpy(y), mt))
        want = float(theirs(jnp.asarray(pred), jnp.asarray(y),
                            jnp.asarray(mask)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1.0), ours.__name__
    scores = np.array([0.1, 0.4, 0.4, 0.8, 0.3, 0.9, 0.4])
    labels = np.array([0, 1, 0, 1, 0, 1, 1])
    assert train.roc_auc(scores, labels) == jax_train.roc_auc(scores, labels)
    assert np.isnan(train.roc_auc(scores, np.zeros(7)))


def test_checkpoint_round_trip(tmp_path):
    gs, (b,) = canonical_batches("qm9", n_graphs=8, batch_size=8,
                                 device="cpu")
    m1 = canonical_model("pna", "qm9", graphs=gs, gnn_num_layers=2)
    opt1 = torch.optim.Adam(m1.parameters(), lr=1e-3)
    step = train.make_train_step(m1, opt1)
    target = train.stack_targets(gs[:8], b.num_graphs, device="cpu")
    for _ in range(2):
        step(b, target)
    path = train.save_checkpoint(str(tmp_path / "ckpt.pt"), m1, opt1,
                                 step=2)
    m2 = canonical_model("pna", "qm9", graphs=gs, gnn_num_layers=2)
    opt2 = torch.optim.Adam(m2.parameters(), lr=1e-3)
    assert train.load_checkpoint(path, m2, opt2) == 2
    for (k, a), (_, c) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        torch.testing.assert_close(a, c, rtol=0, atol=0, msg=k)
    # the restored optimizer continues exactly as the original
    l1 = step(b, target)
    l2 = train.make_train_step(m2, opt2)(b, target)
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)
    for a, c in zip(m1.parameters(), m2.parameters()):
        torch.testing.assert_close(a, c, rtol=0, atol=0)

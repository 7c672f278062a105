"""GAT in the port (ops, the block and layer kernels' plain versions,
GATConv, the model, training) against the JAX package on the CPU.

* ``segment_softmax``, ``ell_softmax_sum`` (with and without the self
  slot, empty rows) and ``block_gat_attention`` (a block batch with
  parallel edges and empty rows, self loops on and off) against the JAX
  ops.
* ``fused_gat_layer`` (its plain version on the CPU) against the Pallas
  ``fused_gat_layer_vjp(..., interpret=True, gather_mode="highest",
  mm="f32")`` and ``gat_layer_reference``: heads 1 / 2 / 4, self loops on
  and off, skip and relu / tanh / none.
* ``fused_gat_block_layer`` (plain on the CPU) against the Pallas
  ``gat_block_layer_auto(..., interpret=True, mm="f32")`` and
  ``_reference``, concat and head mean.
* ``GATConv`` on the block, ELL and edge-list routes against the JAX
  conv, and the route each takes (``edge_dim``:
  ``tests/test_torch_gat_edge.py``).
* ``GNNModel(gnn_conv="gat")`` at the JAX package's widths (heads 2,
  concat and head mean), ``Program.forward`` of a 3-layer heads-2 model
  in both packings against the JAX ``Program`` under
  ``set_fused_mode("never")`` and ``"always"``, and five Adam steps
  against the JAX ``make_train_step``.

Tolerances: ops, layer and block outputs to max |ours - ref| <= 1e-5 *
max |ref| on real rows (f32 sums in another order); convs and forwards
at atol 5e-4 / rtol 1e-3 and 1e-4 of max on real rows, as
tests/test_torch_mp_layer.py; loss curves to 1e-3 relative per step, as
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
from gnnbuilder_tpu.ops import block as jax_block
from gnnbuilder_tpu.ops import dispatch as jax_dispatch
from gnnbuilder_tpu.ops import ell as jax_ell
from gnnbuilder_tpu.ops import segment as jax_segment
from gnnbuilder_tpu.ops.pallas import gat_block as jax_gat_block
from gnnbuilder_tpu.ops.pallas import gat_layer as jax_gat_layer
from gnnbuilder_tpu_torch import Program, train
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.nn import conv as torch_conv
from gnnbuilder_tpu_torch.ops import block, dispatch, ell, segment
from gnnbuilder_tpu_torch.ops.cuda import gat_block, gat_layer
from gnnbuilder_tpu_torch.port import params_from_jax

TOL_OUT = 1e-5
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


def _graphs():
    """24 small random graphs with parallel edges; every third graph's
    node 0 receives no edge, so degree-0 rows occur."""
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=11, seed=4)
    return [dataclasses.replace(g, edge_index=g.edge_index[
        :, g.edge_index[1] != 0]) if i % 3 == 0 else g
        for i, g in enumerate(gs)]


def _batches(block_packed, **kw):
    kw.update(dict(block_size=128, node_multiple=128) if block_packed
              else dict(node_multiple=8))
    gs = _graphs()
    jb, tb = jax_build(gs, **kw), build_graph_batch(gs, device="cpu", **kw)
    assert (tb.in_degree[tb.node_mask] == 0).any() and tb.multigraph_static
    return jb, tb


def _layer_params(rng, fin, heads, c, concat=True):
    def r(*shape, sc=0.4):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    return dict(w=r(fin, heads * c), att_src=r(1, heads, c),
                att_dst=r(1, heads, c),
                bias=r(heads * c if concat else c, sc=0.1))


# --------------------------------------------------------------- the ops
def test_segment_softmax_matches_jax():
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, 40, size=300)).astype(np.int32)
    ids = ids[ids % 7 != 3]                 # empty segments
    logits = (rng.standard_normal((ids.size, 3)) * 4).astype(np.float32)
    ours = segment.segment_softmax(_t(logits), _t(ids), 40)
    ref = jax_segment.segment_softmax(jnp.asarray(logits), jnp.asarray(ids),
                                      40)
    _scaled_close(ours.numpy(), ref, TOL_OUT)
    one = segment.segment_softmax(_t(logits[:, 0]), _t(ids), 40)
    _scaled_close(one.numpy(), ours.numpy()[:, 0], TOL_OUT)


@pytest.mark.parametrize("extra", [True, False])
def test_ell_softmax_sum_matches_jax(extra):
    rng = np.random.default_rng(1)
    N, W, H, C = 50, 5, 3, 4
    deg = rng.integers(0, W + 1, size=N).astype(np.int32)
    deg[::9] = 0
    mask = np.arange(W)[None, :] < deg[:, None]
    lt = (rng.standard_normal((N, W, H)) * 3).astype(np.float32)
    vt = rng.standard_normal((N, W, H, C)).astype(np.float32)
    el = (rng.standard_normal((N, H)) * 3).astype(np.float32)
    ev = rng.standard_normal((N, H, C)).astype(np.float32)
    args = (el, ev) if extra else ()
    ours = ell.ell_softmax_sum(_t(lt), _t(vt), _t(mask), *map(_t, args))
    ref = jax_ell.ell_softmax_sum(jnp.asarray(lt), jnp.asarray(vt),
                                  jnp.asarray(mask), *map(jnp.asarray, args))
    _scaled_close(ours.numpy(), ref, TOL_OUT)
    if not extra:
        assert (ours.numpy()[deg == 0] == 0).all()


@pytest.mark.parametrize("self_loops", [True, False])
def test_block_gat_attention_matches_jax(self_loops):
    jb, tb = _batches(True)
    assert tb.block_adj.max() > 1         # parallel edges: counts above 1
    rng = np.random.default_rng(2)
    N, H, C = tb.num_nodes, 2, 8
    h = rng.standard_normal((N, H, C)).astype(np.float32)
    a_src = (rng.standard_normal((N, H)) * 2).astype(np.float32)
    a_dst = (rng.standard_normal((N, H)) * 2).astype(np.float32)
    ours = block.block_gat_attention(tb.block_adj, _t(h), _t(a_src),
                                     _t(a_dst), self_loops=self_loops)
    ref = jax_block.block_gat_attention(jb.block_adj, jnp.asarray(h),
                                        jnp.asarray(a_src),
                                        jnp.asarray(a_dst),
                                        self_loops=self_loops)
    m = tb.node_mask.numpy()
    _scaled_close(ours.numpy()[m], np.asarray(ref)[m], TOL_OUT)
    # a boolean adjacency would give other weights on these rows
    flat = block.block_gat_attention(
        (tb.block_adj > 0).float(), _t(h), _t(a_src), _t(a_dst),
        self_loops=self_loops)
    assert not torch.allclose(flat, ours)


# ------------------------------------------ the kernels' plain versions
@pytest.mark.parametrize("heads,C", [(1, 16), (2, 8), (4, 8)])
@pytest.mark.parametrize("self_loops", [True, False])
@pytest.mark.parametrize("act,use_skip", [("relu", True), ("tanh", False),
                                          (None, True)])
def test_gat_layer_matches_jax_kernel_and_reference(heads, C, self_loops,
                                                    act, use_skip):
    jb, tb = _batches(False)
    N = tb.num_nodes
    rng = np.random.default_rng(heads * 10 + C)
    x = rng.standard_normal((N, 11)).astype(np.float32)
    p = _layer_params(rng, 11, heads, C)
    skip = (rng.standard_normal((N, heads * C)).astype(np.float32)
            if use_skip else None)
    ours = gat_layer.fused_gat_layer(
        _t(x), tb.nbr_nodes, tb.in_degree, *(_t(p[k]) for k in p), heads,
        self_loops=self_loops, skip=None if skip is None else _t(skip),
        act=act).numpy()
    jp = [jnp.asarray(p[k]) for k in p]
    jskip = None if skip is None else jnp.asarray(skip)
    kern = jax_gat_layer.fused_gat_layer_vjp(
        jnp.asarray(x), jb.nbr_nodes, jb.in_degree, *jp, heads,
        self_loops=self_loops, skip=jskip, act=act, tile_rows=N,
        window_slack=0, interpret=True, gather_mode="highest", mm="f32")
    ref = jax_gat_layer.gat_layer_reference(
        jnp.asarray(x), jb.nbr_nodes, jb.in_degree, *jp, heads,
        self_loops=self_loops, skip=jskip, act=act)
    m = tb.node_mask.numpy()
    for want in (kern, ref):
        _scaled_close(ours[m], np.asarray(want)[m], TOL_OUT,
                      (heads, C, self_loops, act))


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("self_loops,act,use_skip",
                         [(True, "relu", True), (False, None, False)])
def test_gat_block_layer_matches_jax_kernel_and_reference(
        concat, self_loops, act, use_skip):
    jb, tb = _batches(True)
    N, H, C = tb.num_nodes, 2, 8
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, 11)).astype(np.float32)
    p = _layer_params(rng, 11, H, C, concat)
    out_w = H * C if concat else C
    skip = (rng.standard_normal((N, out_w)).astype(np.float32)
            if use_skip else None)
    with torch.no_grad():
        ours = gat_block.fused_gat_block_layer(
            _t(x), tb.block_adj, *(_t(p[k]) for k in p), H,
            self_loops=self_loops, skip=None if skip is None else _t(skip),
            act=act, concat=concat).numpy()
    jp = [jnp.asarray(p[k]) for k in p]
    jskip = None if skip is None else jnp.asarray(skip)
    kern = jax_gat_block.gat_block_layer_auto(
        jnp.asarray(x), jb.block_adj, *jp, H, self_loops=self_loops,
        skip=jskip, act=act, block_size=128, tile_rows=128, interpret=True,
        mm="f32", concat=concat)
    ref = jax_gat_block._reference(jnp.asarray(x), jb.block_adj, *jp, H,
                                   0.2, self_loops, jskip, act,
                                   concat=concat)
    m = tb.node_mask.numpy()
    for want in (kern, ref):
        _scaled_close(ours[m], np.asarray(want)[m], TOL_OUT, concat)


# ----------------------------------------------------------------- conv
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
    assert (tb.block_adj is not None) == (route == "block")
    assert (tb.nbr_nodes is None) == (route == "edge_list")
    return graphs, jb, tb


class _Calls:
    """Counts the calls of the GAT kernels' entry points."""

    def __enter__(self):
        self.n = {"block": 0, "layer": 0}
        self.orig = (gat_block.fused_gat_block_layer,
                     gat_layer.fused_gat_layer_auto)

        def count(name, fn):
            def wrapped(*a, **k):
                self.n[name] += 1
                return fn(*a, **k)
            return wrapped

        gat_block.fused_gat_block_layer = count("block", self.orig[0])
        gat_layer.fused_gat_layer_auto = count("layer", self.orig[1])
        return self

    def __exit__(self, *exc):
        (gat_block.fused_gat_block_layer,
         gat_layer.fused_gat_layer_auto) = self.orig
        return False


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("kw", [dict(heads=2), dict(heads=2, concat=False),
                                dict(heads=1, add_self_loops=False)],
                         ids=["concat", "mean", "no_loops"])
def test_gat_conv_matches_jax_on_each_route(route, kw):
    _, jb, tb = _route_batches(route)
    rng = np.random.default_rng(4)
    F, C = 11, 8
    x = rng.standard_normal((tb.num_nodes, F)).astype(np.float32)
    jc = jax_conv.GATConv(in_channels=F, out_channels=C, **kw)
    params = jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(3), jb,
                                              jnp.asarray(x)))
    out_w = C * kw["heads"] if kw.get("concat", True) else C
    skip = rng.standard_normal((tb.num_nodes, out_w)).astype(np.float32)
    ref = np.asarray(jc.apply(params, jb, jnp.asarray(x), "relu", skip))
    tc = torch_conv.GATConv(F, C, **kw)
    p = params["params"]
    with torch.no_grad():
        tc.lin.weight.copy_(_t(p["lin"]["kernel"]).T)
        for k in ("att_src", "att_dst", "bias"):
            getattr(tc, k).copy_(_t(p[k]))
    m = tb.node_mask.numpy()
    # the route each scope takes: (inference scope, training scope)
    layer = route != "edge_list" and kw.get("concat", True)
    want = {"auto": ({"block": int(route == "block"),
                      "layer": int(layer and route != "block")},
                     {"block": 0, "layer": int(layer)}),
            "never": ({"block": 0, "layer": 0},) * 2}
    for mode in ("auto", "never"):
        dispatch.set_fused_mode(mode)
        try:
            for scope, counts in zip(("inference", "train"), want[mode]):
                with _Calls() as calls, torch.no_grad():
                    if scope == "inference":
                        with dispatch.inference_mode():
                            ours = tc(tb, _t(x), "relu", _t(skip))
                    else:
                        ours = tc(tb, _t(x), "relu", _t(skip))
                assert calls.n == counts, (mode, scope, calls.n)
                np.testing.assert_allclose(ours.numpy()[m], ref[m],
                                           atol=ATOL, rtol=RTOL,
                                           err_msg=f"{mode} {scope}")
        finally:
            dispatch.set_fused_mode("auto")


def test_gat_gates_route():
    """``gat_block_cfg``: inference scope on a block batch with a kernel
    activation; ``gat_layer_cfg``: an ELL table and a kernel activation,
    in or out of inference scope; None under "never"."""
    _, _, blk = _route_batches("block")
    _, _, std = _route_batches("ell")
    _, _, edge = _route_batches("edge_list")
    assert dispatch.gat_block_cfg(blk, "relu") is None     # not inference
    with dispatch.inference_mode():
        assert dispatch.gat_block_cfg(blk, "relu") == {}
        assert dispatch.gat_block_cfg(blk, "elu") is None
        assert dispatch.gat_block_cfg(std, "relu") is None
    for g in (blk, std):
        assert dispatch.gat_layer_cfg(g, "relu") == {}
        assert dispatch.gat_layer_cfg(g, "elu") is None
    assert dispatch.gat_layer_cfg(edge, "relu") is None
    dispatch.set_fused_mode("never")
    try:
        assert dispatch.gat_layer_cfg(std, "relu") is None
        with dispatch.inference_mode():
            assert dispatch.gat_block_cfg(blk, "relu") is None
    finally:
        dispatch.set_fused_mode("auto")


# ---------------------------------------------------------------- model
@pytest.mark.parametrize("concat", [True, False])
def test_gat_model_widths_match_jax(concat):
    """With concat heads the layers after the first take heads * hidden
    and the MLP heads * output * len(pooling), as flax infers them."""
    gs, (b,) = jax_canonical_batches("qm9", n_graphs=8, batch_size=8)
    over = dict(gnn_num_layers=3, gnn_hidden_dim=16, gnn_output_dim=8,
                conv_kwargs=dict(heads=2, concat=concat))
    jm = jax_canonical_model("gat", "qm9", graphs=gs, **over)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), b))
    sd = params_from_jax(params)
    tm = canonical_model("gat", "qm9", **over)
    ours = tm.state_dict()
    assert set(sd) == set(ours)
    for k in sd:
        assert tuple(sd[k].shape) == tuple(ours[k].shape), k
    k = 2 if concat else 1
    assert [c.lin.in_features for c in tm.gnn_convs] == [11, 16 * k, 16 * k]
    assert tm.mlp_head.linear_layers[0].in_features == 8 * k * 3


def _model_pair(graphs, jb, block_size, node_dim=None):
    over = dict(gnn_num_layers=3, gnn_hidden_dim=16, gnn_output_dim=8,
                conv_kwargs=dict(heads=2))
    cfg = {k: v for k, v in JAX_CANONICAL.items() if k not in over}
    jm = gnnb.GNNModel(graph_input_feature_dim=11, gnn_conv="gat", **cfg,
                       **over)
    tm = canonical_model("gat", "qm9", **over)
    size = dict(max_nodes=jb.num_nodes, max_edges=jb.num_edges,
                max_graphs=jb.num_graphs, block_size=block_size)
    jprog = gnnb.Program(jm, **size)
    params = jax.tree.map(np.asarray, jprog.init_params(jb))
    tp = Program(tm, **size, device="cpu")
    tp.set_params(params_from_jax(params))
    return jprog, tp


@pytest.mark.parametrize("route", ["block", "ell"])
def test_program_matches_jax(route):
    """A 3-layer heads-2 GAT model (hidden 16, output 8) through
    ``Program.forward``: the port's kernel route (row 9 on the block
    batch, row 10 on the standard one) and plain path against the JAX
    Program's plain path ("never") and kernel path ("always", interpret
    mode) on the same weights."""
    graphs, jb, tb = _route_batches(route)
    jprog, tp = _model_pair(graphs, jb, ROUTES[route]["block_size"] or 0)
    refs = {}
    for mode in ("never", "always"):
        jax_dispatch.set_fused_mode(mode)
        try:
            refs[mode] = np.asarray(jprog.forward(jb))
        finally:
            jax_dispatch.set_fused_mode("auto")
    m = tb.graph_mask.numpy()
    for mode in ("auto", "never"):
        dispatch.set_fused_mode(mode)
        try:
            with _Calls() as calls:
                ours = tp.forward(tb).numpy()
        finally:
            dispatch.set_fused_mode("auto")
        kernel = {"block": int(route == "block"),
                  "layer": int(route == "ell")}
        assert calls.n == ({k: 3 * v for k, v in kernel.items()}
                           if mode == "auto" else {"block": 0, "layer": 0})
        for jmode, ref in refs.items():
            assert ours.shape == ref.shape
            assert np.isfinite(ours[m]).all()
            np.testing.assert_allclose(ours[m], ref[m], atol=ATOL,
                                       rtol=RTOL, err_msg=(mode, jmode))
            err = np.abs(ours[m] - ref[m]).max()
            assert err <= SCALED_TOL * np.abs(ref[m]).max(), (mode, jmode,
                                                               err)


def test_adam_loss_curve_matches_jax():
    """Five Adam(1e-3) steps of a 3-layer heads-2 GAT model from the same
    weights on a standard-packed batch: every layer goes through
    ``GATLayerFunction`` (row 10 forward, row 11 backward) and the loss
    before each step agrees with the JAX ``make_train_step`` to 1e-3
    relative."""
    from gnnbuilder_tpu_torch.ops.cuda import gat_bwd

    kw = dict(n_graphs=24, batch_size=24)
    gj, (jb,) = jax_canonical_batches("qm9", **kw)
    gt, (tb,) = canonical_batches("qm9", **kw, device="cpu")
    over = dict(gnn_num_layers=3, gnn_hidden_dim=16, gnn_output_dim=8,
                conv_kwargs=dict(heads=2))
    jm = jax_canonical_model("gat", "qm9", graphs=gj, **over)
    tm = canonical_model("gat", "qm9", graphs=gt, **over)
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
    orig = gat_layer.fused_gat_scatter_backward

    def counted(*a, **k):
        calls.append(k.get("rev_nbr_nodes") is not None)
        return orig(*a, **k)

    gat_layer.fused_gat_scatter_backward = counted
    try:
        for i in range(5):
            jp, jo, jl = jstep(jp, jo, jb, jnp.asarray(target_np))
            tl = float(step(tb, target))
            assert abs(tl - float(jl)) <= CURVE_TOL * abs(float(jl)), (
                i, tl, jl)
    finally:
        gat_layer.fused_gat_scatter_backward = orig
    assert calls == [True] * 15
    assert gat_bwd.fused_gat_scatter_backward is orig


def test_relu_pattern_reference_of_a_path_is_that_path():
    """``grads_on_relu_pattern`` with a path's own ReLU decisions gives
    that path's gradients (the reference the card gates GAT's train
    gradients on), and other decisions give other gradients."""
    from gnnbuilder_tpu_torch.bench.grad_precision import (
        _grads,
        conv_output_masks,
        grads_on_relu_pattern,
    )

    gt, (tb,) = canonical_batches("qm9", n_graphs=24, batch_size=24,
                                  device="cpu")
    tm = canonical_model("gat", "qm9", gnn_num_layers=3, gnn_hidden_dim=16,
                         gnn_output_dim=8, conv_kwargs=dict(heads=2))
    Program(tm, device="cpu", seed=5).init_params()
    target = train.stack_targets(gt, tb.num_graphs, 1, device="cpu")
    masks = conv_output_masks(tm, tb, "never")
    assert len(masks) == 3 and all(mk.any() and not mk.all()
                                   for mk in masks)
    want = _grads(tm, tb, target, "never")[1]
    got = grads_on_relu_pattern(tm, tb, target, masks)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-7, err_msg=k)
    flipped = [mk.clone() for mk in masks]
    flipped[1][tb.node_mask] = ~flipped[1][tb.node_mask]
    other = grads_on_relu_pattern(tm, tb, target, flipped)
    assert not torch.allclose(other["gnn_convs.0.lin.weight"],
                              want["gnn_convs.0.lin.weight"])


def test_leaky_relu_has_the_jax_derivative_at_zero():
    """GAT's logits are exactly 0 where a row's features are all 0 after a
    ReLU, so the derivative there matters: 1, as ``jax.nn.leaky_relu``
    and the kernels have it (``F.leaky_relu`` takes the slope)."""
    from gnnbuilder_tpu_torch.ops.activations import leaky_relu

    z = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
    leaky_relu(z, 0.2).sum().backward()
    want = jax.grad(lambda v: jax.nn.leaky_relu(v, 0.2).sum())(
        jnp.array([-2.0, 0.0, 3.0]))
    np.testing.assert_array_equal(z.grad.numpy(), np.asarray(want))
    assert z.grad[1] == 1.0

"""GAT with edge features (``GATConv(edge_dim=...)``) in the port against
the JAX package on the CPU, on the same numpy inputs and weights.

* ``GATConv._edge_logits`` (the per-edge terms and the self loop's term
  of the mean incoming edge features) against the JAX conv's.
* ``build_block_edge_logits`` bit for bit against the JAX one.
* The edge-logit modes of the block layer (row 9, ``fused_gat_block_layer``
  with ``edge_table`` / ``self_extra``) and of the layer (row 10,
  ``fused_gat_layer`` with ``edge_logits`` / ``self_edge_logit``), whose
  plain versions run here, against the Pallas kernels in interpret mode
  and their references: f32 at 1e-5 of max, bf16 against the JAX kernels'
  ``mm="bf16"`` at 2e-3, int8 (row 10 only) against ``quant=True`` at
  5e-3.
* ``GATConv(edge_dim=4)`` on every route (block-packed simple graphs: the
  block kernel; block-packed with repeated pairs: the layer kernel;
  standard-packed: the layer kernel; no ELL table: the edge list), concat
  and head mean, in inference and training scope, under "auto" and
  "never", against the JAX conv under ``set_fused_mode("always")`` and
  ``"never"`` at 1e-5 of max; the route each takes.
* Gradients of the conv, ``lin_edge`` and ``att_edge`` included, through
  ``GATLayerFunction`` and the plain path, against ``jax.grad`` at
  2e-5 of max.
* ``Program.forward`` of an edge GAT (``conv_kwargs={"heads": 2,
  "edge_dim": 4}``) on both packings against the JAX ``Program`` at atol
  5e-4 / rtol 1e-3 in f32, 5e-3 / 2e-2 of max under bf16 / int8, with the
  kernels reached; three Adam steps against the JAX train step.
* The gates, ``params_from_jax`` of an edge GAT, and a served edge GAT
  against ``Program.forward`` at 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu import train as jax_train
from gnnbuilder_tpu.bench.canonical import CANONICAL as JAX_CANONICAL
from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import load_dataset
from gnnbuilder_tpu.nn import conv as jax_conv
from gnnbuilder_tpu.ops import dispatch as jax_dispatch
from gnnbuilder_tpu.ops.pallas import gat_block as jax_gat_block
from gnnbuilder_tpu.ops.pallas import gat_layer as jax_gat_layer
from gnnbuilder_tpu_torch import Program, train
from gnnbuilder_tpu_torch.bench.canonical import canonical_model
from gnnbuilder_tpu_torch.compile.precision import Precision
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.data.datasets import drop_repeated_edges
from gnnbuilder_tpu_torch.nn import conv as torch_conv
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.ops.cuda import gat_block, gat_layer
from gnnbuilder_tpu_torch.port import params_from_jax, site_to_jax

TOL_OUT = 1e-5
GRAD_TOL = 2e-5
ATOL, RTOL = 5e-4, 1e-3
MODE_TOL = {"bf16": 2e-3, "int8": 5e-3}
PROGRAM_TOL = {"bf16": 5e-3, "int8": 2e-2}
CURVE_TOL = 1e-3
JAX_LAYER_MODE = {"f32": dict(mm="f32"), "bf16": dict(mm="bf16"),
                  "int8": dict(mm="f32", quant=True)}
E_DIM = 4    # QM9's bond one-hot


def _scaled(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _t(a):
    return torch.from_numpy(np.array(a))


KINDS = {
    "block_simple": dict(block_size=128, node_multiple=128),
    "block_multi": dict(block_size=128, node_multiple=128),
    "standard": dict(block_size=None, node_multiple=8),
    "edge_list": dict(block_size=None, node_multiple=8, ell_width=0),
}


def _batches(kind, n=20, seed=2):
    graphs = load_dataset("qm9", n=n, seed=seed)
    if kind == "block_simple":
        graphs = drop_repeated_edges(graphs)
    kw = KINDS[kind]
    jb = jax_build(graphs, **kw)
    tb = build_graph_batch(graphs, device="cpu", **kw)
    assert tb.multigraph_static == (kind != "block_simple")
    assert (tb.block_adj is not None) == kind.startswith("block")
    assert (tb.nbr_nodes is None) == (kind == "edge_list")
    return graphs, jb, tb


def _layer_params(rng, fin, heads, c, concat=True):
    def r(*shape, sc=0.4):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    return dict(w=r(fin, heads * c), att_src=r(1, heads, c),
                att_dst=r(1, heads, c),
                bias=r(heads * c if concat else c, sc=0.1))


def _jax_conv(jb, x, F, C, kw, seed=3):
    jc = jax_conv.GATConv(in_channels=F, out_channels=C, edge_dim=E_DIM,
                          **kw)
    params = jax.tree.map(np.asarray, jc.init(jax.random.PRNGKey(seed), jb,
                                              jnp.asarray(x)))
    return jc, params


def _torch_conv(F, C, kw, params):
    tc = torch_conv.GATConv(F, C, edge_dim=E_DIM, **kw)
    p = params["params"]
    with torch.no_grad():
        tc.lin.weight.copy_(_t(p["lin"]["kernel"]).T)
        tc.lin_edge.weight.copy_(_t(p["lin_edge"]["kernel"]).T)
        for k in ("att_src", "att_dst", "att_edge", "bias"):
            getattr(tc, k).copy_(_t(p[k]))
    return tc


# -------------------------------------------------------- edge terms
@pytest.mark.parametrize("kind", ["block_simple", "standard"])
def test_edge_logits_match_jax(kind):
    _, jb, tb = _batches(kind)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((tb.num_nodes, 11)).astype(np.float32)
    jc, params = _jax_conv(jb, x, 11, 8, dict(heads=2))
    tc = _torch_conv(11, 8, dict(heads=2), params)
    with torch.no_grad():
        ours = tc._edge_logits(tb)
    ref = jc.apply(params, jb, tb.num_nodes, 2, 8,
                   method=jax_conv.GATConv._edge_logits)
    for o, r in zip(ours, ref):
        assert _scaled(o.numpy(), r) <= TOL_OUT
    # an empty row's self term is that of a zero mean: 0
    empty = (tb.in_degree == 0).numpy()
    assert empty.any() and (ours[1].numpy()[empty] == 0).all()


@pytest.mark.parametrize("kind", ["block_simple", "block_multi"])
def test_build_block_edge_logits_is_bit_equal_to_jax(kind):
    _, jb, tb = _batches(kind)
    rng = np.random.default_rng(2)
    a_edge = rng.standard_normal((tb.num_edges, 3)).astype(np.float32)
    ours = gat_block.build_block_edge_logits(
        tb.senders, tb.receivers, tb.edge_mask, _t(a_edge), tb.num_nodes,
        128)
    ref = jax_gat_block.build_block_edge_logits(
        jb.senders, jb.receivers, jb.edge_mask, jnp.asarray(a_edge),
        tb.num_nodes, 128)
    assert ours.is_contiguous()
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ------------------------------------------ the kernels' plain versions
def _edge_inputs(tb, heads, C, seed, concat=True, fin=11):
    rng = np.random.default_rng(seed)
    N = tb.num_nodes
    x = rng.standard_normal((N, fin)).astype(np.float32)
    p = _layer_params(rng, fin, heads, C, concat)
    a_edge = rng.standard_normal((tb.num_edges, heads)).astype(np.float32)
    a_self = rng.standard_normal((N, heads)).astype(np.float32)
    out_w = heads * C if concat else C
    skip = rng.standard_normal((N, out_w)).astype(np.float32)
    return x, p, a_edge, a_self, skip


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("concat", [True, False], ids=["concat", "mean"])
def test_block_edge_mode_matches_jax_kernel(mode, concat):
    _, jb, tb = _batches("block_simple")
    H, C = 2, 8
    x, p, a_edge, a_self, skip = _edge_inputs(tb, H, C, 4, concat)
    table = gat_block.build_block_edge_logits(
        tb.senders, tb.receivers, tb.edge_mask, _t(a_edge), tb.num_nodes,
        128)
    w, wa_src, wa_dst = gat_block.prepare_block(
        _t(p["w"]), _t(p["att_src"]), _t(p["att_dst"]), mode)
    rest = (_t(p["att_src"]), _t(p["att_dst"]), _t(p["bias"]), H)
    kw = dict(act="relu", concat=concat, skip=_t(skip))
    with torch.no_grad():
        ours = gat_block.fused_gat_block_layer(
            _t(x), tb.block_adj, w, *rest, mode=mode, wa_src=wa_src,
            wa_dst=wa_dst, edge_table=table, self_extra=_t(a_self),
            **kw).numpy()
        no_edge = gat_block.fused_gat_block_layer(
            _t(x), tb.block_adj, w, *rest, mode=mode, wa_src=wa_src,
            wa_dst=wa_dst, **kw).numpy()
    jp = [jnp.asarray(p[k]) for k in p]
    jt = jnp.asarray(table.numpy())
    ekw = dict(edge_table=jt, self_extra=jnp.asarray(a_self))
    refs = [jax_gat_block.gat_block_layer_auto(
        jnp.asarray(x), jb.block_adj, *jp, H, skip=jnp.asarray(skip),
        act="relu", block_size=128, tile_rows=128, interpret=True, mm=mode,
        concat=concat, **ekw)]
    if mode == "f32":
        refs.append(jax_gat_block._reference(
            jnp.asarray(x), jb.block_adj, *jp, H, 0.2, True,
            jnp.asarray(skip), "relu", concat=concat, **ekw))
    m = tb.node_mask.numpy()
    for ref in refs:
        assert _scaled(ours[m], np.asarray(ref)[m]) <= (
            TOL_OUT if mode == "f32" else MODE_TOL[mode])
    assert _scaled(no_edge[m], ours[m]) > 1e-2   # the edge terms count


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("heads,C,act,self_loops",
                         [(2, 8, "relu", True), (4, 4, None, False)],
                         ids=["h2-relu", "h4-noloops"])
def test_layer_edge_mode_matches_jax_kernel(mode, heads, C, act,
                                            self_loops):
    _, jb, tb = _batches("standard")
    x, p, a_edge, a_self, skip = _edge_inputs(tb, heads, C, 5)
    # per-slot terms with nonzero pad slots: the kernel reads valid slots
    W = tb.nbr_nodes.shape[1]
    le = np.random.default_rng(6).standard_normal(
        (tb.num_nodes, W, heads)).astype(np.float32)
    w, sw = gat_layer.prepare_layer(_t(p["w"]), mode)
    rest = (_t(p["att_src"]), _t(p["att_dst"]), _t(p["bias"]), heads)
    kw = dict(self_loops=self_loops, act=act, skip=_t(skip))
    ours = gat_layer.fused_gat_layer(
        _t(x), tb.nbr_nodes, tb.in_degree, w, *rest, mode=mode, sw=sw,
        edge_logits=_t(le), self_edge_logit=_t(a_self), **kw).numpy()
    jp = [jnp.asarray(p[k]) for k in p]
    ekw = dict(edge_logits=jnp.asarray(le),
               self_edge_logit=jnp.asarray(a_self))
    # the Pallas function itself: JAX's differentiable wrapper runs an
    # edge conv's projection in float32 whatever ``quant`` says
    refs = [jax_gat_layer.fused_gat_layer(
        jnp.asarray(x), jb.nbr_nodes, jb.in_degree, *jp, heads,
        self_loops=self_loops, skip=jnp.asarray(skip), act=act,
        tile_rows=tb.num_nodes, window_slack=0, interpret=True,
        gather_mode="highest", **JAX_LAYER_MODE[mode], **ekw)]
    if mode == "f32":
        refs.append(jax_gat_layer.gat_layer_reference(
            jnp.asarray(x), jb.nbr_nodes, jb.in_degree, *jp, heads,
            self_loops=self_loops, skip=jnp.asarray(skip), act=act, **ekw))
    m = tb.node_mask.numpy()
    for ref in refs:
        assert _scaled(ours[m], np.asarray(ref)[m]) <= (
            TOL_OUT if mode == "f32" else MODE_TOL[mode]), mode


def test_edge_modes_check_their_operands():
    _, _, tb = _batches("block_simple")
    x, p, a_edge, a_self, _ = _edge_inputs(tb, 2, 8, 7)
    args = (_t(x), tb.block_adj, *(_t(p[k]) for k in p), 2)
    with pytest.raises(ValueError, match="edge_table must be"):
        gat_block.fused_gat_block_layer(
            *args, edge_table=torch.zeros(1, 2, 128, 128))
    with pytest.raises(ValueError, match="self_extra goes with"):
        gat_block.fused_gat_block_layer(*args, self_extra=_t(a_self))
    args = (_t(x), tb.nbr_nodes, tb.in_degree, *(_t(p[k]) for k in p), 2)
    with pytest.raises(ValueError, match="edge_logits must be"):
        gat_layer.fused_gat_layer(*args, edge_logits=_t(a_self))
    with pytest.raises(ValueError, match="self_edge_logit goes with"):
        gat_layer.fused_gat_layer(*args, self_edge_logit=_t(a_self))


# ----------------------------------------------------------------- conv
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


def _jax_refs(jc, params, jb, x, skip):
    """The JAX conv under "never" and under "always" in inference scope
    (its Pallas kernels in interpret mode)."""
    refs = {}
    for mode in ("never", "always"):
        jax_dispatch.set_fused_mode(mode)
        try:
            with jax_dispatch.inference_mode():
                refs[mode] = np.asarray(jc.apply(
                    params, jb, jnp.asarray(x), "relu", jnp.asarray(skip)))
        finally:
            jax_dispatch.set_fused_mode("auto")
    return refs


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("concat", [True, False], ids=["concat", "mean"])
def test_edge_conv_matches_jax_on_each_route(kind, concat):
    _, jb, tb = _batches(kind)
    rng = np.random.default_rng(8)
    F, C, H = 11, 8, 2
    kw = dict(heads=H, concat=concat)
    x = rng.standard_normal((tb.num_nodes, F)).astype(np.float32)
    jc, params = _jax_conv(jb, x, F, C, kw)
    skip = rng.standard_normal(
        (tb.num_nodes, H * C if concat else C)).astype(np.float32)
    refs = _jax_refs(jc, params, jb, x, skip)
    tc = _torch_conv(F, C, kw, params)
    m = tb.node_mask.numpy()
    block = int(kind == "block_simple")
    layer = int(concat and kind != "edge_list")
    # the route each scope takes: (inference scope, training scope)
    want = {"auto": ({"block": block, "layer": layer * (1 - block)},
                     {"block": 0, "layer": layer}),
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
                for jmode, ref in refs.items():
                    err = _scaled(ours.numpy()[m], ref[m])
                    assert err <= TOL_OUT, (mode, scope, jmode, err)
        finally:
            dispatch.set_fused_mode("auto")


@pytest.mark.parametrize("kind", ["standard", "edge_list"])
def test_edge_conv_gradients_match_jax(kind):
    """Every parameter's gradient and x's, ``lin_edge`` and ``att_edge``
    included, through ``GATLayerFunction`` (standard-packed, "auto")
    and the plain paths, against ``jax.grad`` of the JAX conv."""
    _, jb, tb = _batches(kind)
    rng = np.random.default_rng(9)
    F, C, H = 11, 8, 2
    x = rng.standard_normal((tb.num_nodes, F)).astype(np.float32)
    jc, params = _jax_conv(jb, x, F, C, dict(heads=H))
    ct = rng.standard_normal((tb.num_nodes, H * C)).astype(np.float32)
    ct[~tb.node_mask.numpy()] = 0.0

    def loss(p, xx):
        return jnp.sum(jc.apply(p, jb, xx, "tanh") * jnp.asarray(ct))

    jg, jx = jax.grad(loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    jg = jg["params"]
    want = {"lin.weight": np.asarray(jg["lin"]["kernel"]).T,
            "lin_edge.weight": np.asarray(jg["lin_edge"]["kernel"]).T,
            **{k: np.asarray(jg[k]) for k in
               ("att_src", "att_dst", "att_edge", "bias")}}
    tc = _torch_conv(F, C, dict(heads=H), params)
    for mode in ("auto", "never"):
        dispatch.set_fused_mode(mode)
        try:
            with _Calls() as calls:
                xt = _t(x).requires_grad_()
                tc.zero_grad()
                (tc(tb, xt, "tanh") * _t(ct)).sum().backward()
        finally:
            dispatch.set_fused_mode("auto")
        assert calls.n["layer"] == int(mode == "auto" and kind != "edge_list")
        got = dict(tc.named_parameters())
        for k, w_ in want.items():
            assert _scaled(got[k].grad.numpy(), w_) <= GRAD_TOL, (mode, k)
        assert _scaled(xt.grad.numpy(), np.asarray(jx)) <= GRAD_TOL, mode


def test_edge_layer_backward_is_the_plain_layers_gradient():
    """``GATLayerFunction``'s gradients of x, w, the attention
    vectors, bias, skip and both edge-logit inputs equal autograd of the
    plain layer to 1e-6 of max."""
    _, _, tb = _batches("standard")
    x, p, _, a_self, skip = _edge_inputs(tb, 2, 8, 10)
    le = np.random.default_rng(11).standard_normal(
        (tb.num_nodes, tb.nbr_nodes.shape[1], 2)).astype(np.float32)
    grads = []
    for fn in (gat_layer.fused_gat_layer_vjp, gat_layer.gat_layer_plain):
        leaves = [_t(a).requires_grad_() for a in
                  (x, p["w"], p["att_src"], p["att_dst"], p["bias"], skip,
                   le, a_self)]
        out = fn(leaves[0], tb.nbr_nodes, tb.in_degree, *leaves[1:5], 2,
                 skip=leaves[5], act="relu", edge_logits=leaves[6],
                 self_edge_logit=leaves[7])
        (out * out).sum().backward()
        grads.append([t.grad for t in leaves])
    mask = torch.arange(le.shape[1])[None, :] < tb.in_degree[:, None]
    for i, (a, b) in enumerate(zip(*grads)):
        if i == 6:      # pad slots: no gradient on either path
            assert (a[~mask] == 0).all() and (b[~mask] == 0).all()
        assert _scaled(a.numpy(), b.numpy()) <= 1e-6, i


# ---------------------------------------------------------------- gates
def test_gates_with_edge_features():
    _, _, simple = _batches("block_simple")
    _, _, multi = _batches("block_multi")
    _, _, std = _batches("standard")
    with dispatch.inference_mode():
        assert dispatch.gat_block_cfg(simple, "relu", edge=True) == {}
        assert dispatch.gat_block_cfg(multi, "relu", edge=True) is None
        assert dispatch.gat_block_cfg(multi, "relu") == {}
        assert dispatch.gat_block_cfg(
            simple.replace(edge_feat=None), "relu", edge=True) is None
    for g in (multi, std):
        assert dispatch.gat_layer_cfg(g, "relu", edge=True) == {}
        assert dispatch.gat_layer_cfg(g.replace(nbr_edges=None), "relu",
                                      edge=True) is None
    with Precision.int8().activate():
        assert dispatch.gat_layer_cfg(std, "relu", edge=True) is None
        assert dispatch.gat_layer_cfg(std, "relu") == {"mode": "int8"}
    with Precision.bf16().activate():
        assert dispatch.gat_layer_cfg(std, "relu", edge=True) == {
            "mode": "bf16"}
        with dispatch.inference_mode():
            assert dispatch.gat_block_cfg(simple, "relu", edge=True) == {
                "mode": "bf16"}


# ---------------------------------------------------------------- model
OVER = dict(gnn_num_layers=2, gnn_hidden_dim=16, gnn_output_dim=8,
            conv_kwargs=dict(heads=2, edge_dim=E_DIM))


def _programs(kind, precision="f32", n=32):
    graphs, jb, tb = _batches(kind, n=n, seed=5)
    cfg = {k: v for k, v in JAX_CANONICAL.items() if k not in OVER}
    jm = gnnb.GNNModel(graph_input_feature_dim=11, graph_input_edge_dim=4,
                       gnn_conv="gat", **cfg, **OVER)
    tm = canonical_model("gat", "qm9", **OVER)
    size = dict(max_nodes=jb.num_nodes, max_edges=jb.num_edges,
                max_graphs=jb.num_graphs,
                block_size=KINDS[kind]["block_size"] or 0)
    jprog = gnnb.Program(jm, precision=precision, **size)
    params = jax.tree.map(np.asarray, jprog.init_params(jb))
    tp = Program(tm, precision=precision, device="cpu", **size)
    tp.set_params(params_from_jax(params))
    return graphs, jprog, tp, jb, tb, params


def test_params_from_jax_of_an_edge_gat():
    """The flax tree of an edge GAT maps onto the port's model key for
    key and shape, ``lin_edge`` as a Linear without bias, and its int8
    sites map back to the flax paths."""
    _, jprog, tp, _, _, params = _programs("standard")
    sd = params_from_jax(params)
    ours = tp.model.state_dict()
    assert set(sd) == set(ours)
    for k in sd:
        assert tuple(sd[k].shape) == tuple(ours[k].shape), k
    assert "gnn_convs.1.lin_edge.weight" in sd
    assert "gnn_convs.1.lin_edge.bias" not in sd
    assert tuple(sd["gnn_convs.0.att_edge"].shape) == (1, 2, 16)
    assert site_to_jax("gnn_convs.1.lin_edge") == "gnn_convs_1/lin_edge"
    assert "lin_edge" in params["params"]["gnn_convs_1"]


def _count_modes(monkeypatch):
    calls = {"block": [], "layer": []}
    for mod, name, key in ((gat_block, "fused_gat_block_layer", "block"),
                           (gat_layer, "fused_gat_layer", "layer")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _key=key, **k):
            assert (k.get("edge_table") is not None
                    or k.get("edge_logits") is not None)
            calls[_key].append(k.get("mode", "f32"))
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kind", ["block_simple", "standard"])
def test_program_matches_jax(kind, precision, monkeypatch):
    """A 2-layer heads-2 edge GAT through ``Program.forward`` against the
    JAX ``Program`` with its kernels ("always", interpret mode) and its
    plain path ("never"); the port's kernel functions reached: row 9's
    edge mode on the simple block batch (f32, bf16), row 10's on the
    standard one (f32, bf16), none under int8 (the JAX gates decline an
    edge conv there: the plain path quantizes)."""
    _, jprog, tp, jb, tb, _ = _programs(kind, precision)
    refs = {}
    if precision == "int8":
        jax_dispatch.set_kernel_overrides(gather_mode="highest")
    try:
        for mode in ("never", "always"):
            jax_dispatch.set_fused_mode(mode)
            try:
                refs[mode] = np.asarray(jprog.forward(jb))
            finally:
                jax_dispatch.set_fused_mode("auto")
    finally:
        jax_dispatch.set_kernel_overrides(gather_mode=None)
    calls = _count_modes(monkeypatch)
    ours = tp.forward(tb).numpy()
    key = "block" if kind == "block_simple" else "layer"
    want = {"block": [], "layer": []}
    if precision != "int8":
        want[key] = [precision] * 2
    assert calls == want
    m = tb.graph_mask.numpy()
    for jmode, ref in refs.items():
        if precision == "f32":
            np.testing.assert_allclose(ours[m], ref[m], atol=ATOL,
                                       rtol=RTOL, err_msg=jmode)
        else:
            assert _scaled(ours[m], ref[m]) <= PROGRAM_TOL[precision], jmode


def test_adam_loss_curve_matches_jax():
    """Three Adam(1e-3) steps of the edge GAT from the same weights on a
    standard-packed batch, each layer through ``GATLayerFunction``:
    the loss before each step within 1e-3 relative of the JAX train
    step's."""
    graphs, jprog, tp, jb, tb, params = _programs("standard")
    target_np = np.asarray(jax_train.stack_targets(graphs, jb.num_graphs, 1))
    target = train.stack_targets(graphs, tb.num_graphs, 1, device="cpu")
    opt = optax.adam(1e-3)
    jstep = jax_train.make_train_step(jprog.model, opt, donate=False)
    jp = jax.tree.map(jnp.asarray, params)
    jo = opt.init(jp)
    tm = tp.model
    step = train.make_train_step(tm, torch.optim.Adam(tm.parameters(),
                                                      lr=1e-3))
    with _Calls() as calls:
        for i in range(3):
            jp, jo, jl = jstep(jp, jo, jb, jnp.asarray(target_np))
            tl = float(step(tb, target))
            assert abs(tl - float(jl)) <= CURVE_TOL * abs(float(jl)), (
                i, tl, jl)
    assert calls.n == {"block": 0, "layer": 6}
    assert tm.gnn_convs[0].att_edge.grad.abs().max() > 0


def test_served_edge_gat_matches_program():
    """An edge GAT behind ``GNNServer`` (block-packed simple graphs, so
    its micro-batches take row 9's edge mode, and standard-packed): every
    prediction within 2e-5 of max of ``Program.forward`` of the same
    graphs, and a server from ``export_bundle`` gives the same."""
    import tempfile

    from gnnbuilder_tpu_torch.data.datasets import (
        load_dataset as torch_load_dataset,
    )
    from gnnbuilder_tpu_torch.serve import GNNServer

    graphs = drop_repeated_edges(torch_load_dataset("qm9", n=24, seed=7))
    for block in (128, 0):
        prog = Program.from_dataset(canonical_model("gat", "qm9", **OVER),
                                    graphs, batch_size=8, block_size=block,
                                    device="cpu", seed=3)
        example = prog.batch(sorted(graphs, key=lambda g: g.num_nodes)[-8:])
        prog.init_params()
        want = np.concatenate([prog.forward(prog.batch(graphs[i:i + 8]))
                               .numpy()[:8] for i in range(0, 24, 8)])
        with GNNServer.from_program(prog, example, max_batch=8) as srv:
            got = srv.predict(graphs, timeout=120)
        assert _scaled(got, want) <= 2e-5, block
        with tempfile.TemporaryDirectory() as d:
            prog.export_bundle(d, example)
            assert Program.read_exported(f"{d}/model.json")["model"][
                "conv_kwargs"]["edge_dim"] == E_DIM
            with GNNServer.from_bundle(d, max_batch=8, device="cpu") as srv:
                again = srv.predict(graphs, timeout=120)
        assert _scaled(again, got) <= 2e-5, block


@pytest.mark.parametrize("kind", ["block_simple", "standard"])
def test_calibrated_int8_edge_gat_matches_jax(kind):
    """``calibrate_int8`` of an edge GAT records a static scale for every
    ``Linear`` site, ``lin_edge`` included, the JAX package's sites and
    scales (1e-6 relative); the static forward (the plain path in both
    packages) agrees with the JAX one to 1e-5 of max."""
    _, jprog, tp, jb, tb, _ = _programs(kind, "int8")
    js = jprog.calibrate_int8([jb])
    ts = tp.calibrate_int8([tb])
    assert {site_to_jax(k) for k in ts} == set(js)
    assert {"gnn_convs.0.lin_edge", "gnn_convs.1.lin_edge"} <= set(ts)
    for site, s in ts.items():
        np.testing.assert_allclose(s, js[site_to_jax(site)], rtol=1e-6,
                                   err_msg=site)
    ref = np.asarray(jprog.forward(jb))
    ours = tp.forward(tb).numpy()
    m = tb.graph_mask.numpy()
    assert _scaled(ours[m], ref[m]) <= 1e-5

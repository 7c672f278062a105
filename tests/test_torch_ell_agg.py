"""The multi-aggregate kernel's slice (ops/cuda/ell_agg.py, the ELL and
block multi-aggregations, and the convs and models that run it) against
the JAX package on the CPU.

* ``fused_ell_aggregate`` (its plain version on the CPU) for each
  aggregator alone, PNA's four and all five, with and without the
  receiver shift u, against the Pallas ``fused_ell_aggregate(...,
  interpret=True, gather_mode="highest")`` and its ``_reference``.
* ``ELLAggregateFunction``'s gradients on its three routes (the reverse
  table, the reverse CSR of a batch without one, and u) against
  ``jax.grad`` of the Pallas ``fused_ell_aggregate_vjp`` (interpret
  mode), on values with ties and rows without in-edges, and the route
  each takes.
* ``ell_std``, ``ell_multi``, ``block_std`` and ``block_multi`` against
  the JAX package's.
* ``PNAConv`` with all five aggregators on the block, ELL and edge-list
  routes, and ``Program.forward`` of 3-layer Simple (max, min) and
  five-aggregator PNA models against the JAX ``Program`` on the same
  weights (``params_from_jax``), with the kernel's launches per route.

Tolerances: aggregates to max |ours - ref| <= 1e-5 * max |ref| per
aggregator (f32 sums in another order; the JAX kernel adds u after the
reduction, its reference and the port before), except std against the
JAX kernel at 1e-4: on the CPU, XLA contracts that kernel's
E[t^2] - E[t]^2 into a fused multiply-add, so a degree-1 row gets a
variance of one rounding error (~5e-7) where the reference and the port
get 0, and sqrt(var + 1e-5) turns it into ~7e-5; gradients to 2e-5 of max
against ``jax.grad`` of the reference (every route) and of the Pallas
VJP, except the Pallas VJP's with std over the reverse table at 2e-4:
its std coefficients come from that forward's variance and its
v d1 - d2 term is contracted too, which puts it 8e-5 of max off float64
where the port lands 2e-7; du against the larger of max |du| and max
|dv| (std alone is shift-invariant: its du is 0 up to rounding);
ops at atol 1e-5 / rtol 1e-5; convs and forwards at atol 5e-4 / rtol
1e-3 and 1e-4 of max on real rows, as tests/test_torch_mp_layer.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu.bench.canonical import CANONICAL as JAX_CANONICAL
from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset, load_dataset
from gnnbuilder_tpu.nn import conv as jax_conv
from gnnbuilder_tpu.ops import block as jax_block
from gnnbuilder_tpu.ops import ell as jax_ell
from gnnbuilder_tpu.ops.pallas.ell_agg import _reference as jax_reference
from gnnbuilder_tpu.ops.pallas.ell_agg import fused_ell_aggregate as jax_agg
from gnnbuilder_tpu.ops.pallas.ell_agg import (
    fused_ell_aggregate_vjp as jax_agg_vjp,
)
from gnnbuilder_tpu_torch import Program
from gnnbuilder_tpu_torch.bench.canonical import canonical_model
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.nn import conv as torch_conv
from gnnbuilder_tpu_torch.ops import block, dispatch, ell
from gnnbuilder_tpu_torch.ops.cuda import ell_agg
from gnnbuilder_tpu_torch.port import params_from_jax

TOL_OUT, TOL_GRAD = 1e-5, 2e-5
STD_KERNEL_TOL = 1e-4
STD_PALLAS_GRAD_TOL = 2e-4
OP_TOL = 1e-5
ATOL, RTOL, SCALED_TOL = 5e-4, 1e-3, 1e-4
ALL5 = ("sum", "mean", "min", "max", "std")
PNA4 = ("max", "min", "mean", "std")
AGG_SETS = [(a,) for a in ALL5] + [PNA4, ALL5]


def _scaled_close(ours, ref, tol, what="", scale=None):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    assert np.isfinite(ours).all(), what
    err = float(np.abs(ours - ref).max())
    if scale is None:
        scale = float(np.abs(ref).max())
    assert err <= tol * scale, (what, err)


def _graphs():
    """24 small random graphs with multi-edges; every third graph's node 0
    receives no edge, so rows without in-edges occur."""
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=11, seed=4)
    return [dataclasses.replace(g, edge_index=g.edge_index[
        :, g.edge_index[1] != 0]) if i % 3 == 0 else g
        for i, g in enumerate(gs)]


def _batches(**kw):
    gs = _graphs()
    kw.setdefault("node_multiple", 8)
    jb, tb = jax_build(gs, **kw), build_graph_batch(gs, device="cpu", **kw)
    deg = tb.in_degree[tb.node_mask]
    assert (deg == 0).any() and tb.multigraph_static
    return jb, tb


def _values(rng, N, F=16, coarse=False):
    """v (and u) [N, F]; ``coarse`` rounds to halves, so different
    neighbours tie for the max and min."""
    v = rng.standard_normal((N, F)).astype(np.float32)
    if coarse:
        v = np.round(v * 2.0) / 2.0
    return v.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_kw(jb):
    """One Pallas tile over the whole batch, its window the whole array."""
    return dict(tile_rows=jb.num_nodes, window_slack=0, interpret=True,
                gather_mode="highest")


def _per_aggregator(ours, ref, aggs, F, what):
    for i, a in enumerate(aggs):
        sl = slice(i * F, (i + 1) * F)
        tol = STD_KERNEL_TOL if (a, what) == ("std", "kernel") else TOL_OUT
        _scaled_close(ours[:, sl], ref[:, sl], tol, (what, a))


@pytest.mark.parametrize("aggs", AGG_SETS, ids="-".join)
@pytest.mark.parametrize("with_u", [False, True], ids=["v", "u+v"])
def test_plain_matches_jax_kernel_and_reference(aggs, with_u):
    jb, tb = _batches()
    rng = np.random.default_rng(3)
    N, F = tb.num_nodes, 16
    v = _values(rng, N, F)
    u = _values(rng, N, F) if with_u else None
    ours = ell_agg.fused_ell_aggregate(
        _t(v), tb.nbr_nodes, tb.in_degree, aggs,
        u=None if u is None else _t(u)).numpy()
    ju = None if u is None else jnp.asarray(u)
    kern = jax_agg(jnp.asarray(v), jb.nbr_nodes, jb.in_degree, aggs, u=ju,
                   **_jax_kw(jb))
    ref = jax_reference(jnp.asarray(v), ju, jb.nbr_nodes, jb.in_degree,
                        aggs)
    m = tb.node_mask.numpy()
    for name, want in (("kernel", kern), ("reference", ref)):
        _per_aggregator(ours[m], np.asarray(want)[m], aggs, F, name)
    empty = (tb.in_degree == 0).numpy() & m
    for i, a in enumerate(aggs):
        fill = np.sqrt(np.float32(1e-5)) if a == "std" else 0.0
        np.testing.assert_allclose(ours[empty, i * F:(i + 1) * F], fill,
                                   rtol=1e-6)


GRAD_SETS = [("max",), ("min",), ("std",), PNA4, ALL5]


@pytest.mark.parametrize("aggs", GRAD_SETS, ids="-".join)
@pytest.mark.parametrize("route", ["rev", "csr", "u"])
def test_gradients_match_jax_on_each_route(aggs, route):
    """dv (and du) with ties (values rounded to halves) and empty rows."""
    jb, tb = _batches(**({"rev_ell_width": 0} if route == "csr" else {}))
    assert (tb.rev_nbr_nodes is None) == (route == "csr")
    rng = np.random.default_rng(9)
    N, F = tb.num_nodes, 8
    v = _values(rng, N, F, coarse=True)
    u = _values(rng, N, F) if route == "u" else None
    ct = rng.standard_normal((N, len(aggs) * F)).astype(np.float32)
    ct[~tb.node_mask.numpy()] = 0.0

    calls = {"gather": 0, "csr": 0}
    orig = (ell_agg.fused_gather_backward, ell_agg.fused_gather_backward_csr)

    def count(name, fn):
        def wrapped(*a, **k):
            if a[1].data_ptr() == tb.nbr_nodes.data_ptr():
                return fn(*a, **k)     # a tie count over the forward table
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    vt = _t(v).requires_grad_()
    ut = None if u is None else _t(u).requires_grad_()
    ell_agg.fused_gather_backward = count("gather", orig[0])
    ell_agg.fused_gather_backward_csr = count("csr", orig[1])
    try:
        out = ell_agg.fused_ell_aggregate_vjp(
            vt, tb.nbr_nodes, tb.in_degree, aggs, u=ut,
            rev_nbr_nodes=tb.rev_nbr_nodes, out_degree=tb.out_degree)
        out.backward(_t(ct))
    finally:
        (ell_agg.fused_gather_backward,
         ell_agg.fused_gather_backward_csr) = orig
    assert calls == {"gather": int(route == "rev"),
                     "csr": int(route == "csr")}

    def pallas_loss(vv, uu):
        return (jax_agg_vjp(vv, jb.nbr_nodes, jb.in_degree, aggs, u=uu,
                            rev_nbr_nodes=jb.rev_nbr_nodes,
                            out_degree=jb.out_degree, **_jax_kw(jb))
                * ct).sum()

    def ref_loss(vv, uu):
        return (jax_reference(vv, uu, jb.nbr_nodes, jb.in_degree, aggs)
                * ct).sum()

    jv = jnp.asarray(v)
    for name, fn in (("pallas", pallas_loss), ("reference", ref_loss)):
        tol = (STD_PALLAS_GRAD_TOL
               if (name, route) == ("pallas", "rev") and "std" in aggs
               else TOL_GRAD)
        if u is None:
            (dv,) = jax.grad(lambda vv: fn(vv, None), argnums=(0,))(jv)
        else:
            dv, du = jax.grad(fn, argnums=(0, 1))(jv, jnp.asarray(u))
            _scaled_close(ut.grad.numpy(), du, tol, (name, route, "du"),
                          scale=max(float(np.abs(du).max()),
                                    float(np.abs(dv).max())))
        _scaled_close(vt.grad.numpy(), dv, tol, (name, route, "dv"))


@pytest.mark.parametrize("aggs", [("std",), ("sum", "mean", "std"), ALL5],
                         ids="-".join)
def test_ell_and_block_multi_match_jax(aggs):
    jb, tb = _batches(block_size=128, node_multiple=128)
    rng = np.random.default_rng(6)
    x = _values(rng, tb.num_nodes, 16)
    ours = ell.ell_multi(_t(x), tb.nbr_nodes, tb.in_degree, aggs)
    want = jax_ell.ell_multi(jnp.asarray(x), jb.nbr_nodes, jb.in_degree,
                             aggs)
    for a in aggs:
        np.testing.assert_allclose(ours[a].numpy(), np.asarray(want[a]),
                                   atol=OP_TOL, rtol=OP_TOL, err_msg=a)
    np.testing.assert_allclose(
        ell.ell_std(_t(x), tb.nbr_nodes, tb.in_degree).numpy(),
        np.asarray(jax_ell.ell_std(jnp.asarray(x), jb.nbr_nodes,
                                   jb.in_degree)), atol=OP_TOL, rtol=OP_TOL)
    lin = tuple(a for a in aggs if a in ("sum", "mean", "std"))
    ours = block.block_multi(_t(x), tb.block_adj, tb.in_degree, lin)
    want = jax_block.block_multi(jnp.asarray(x), jb.block_adj, jb.in_degree,
                                 lin, mm="highest")
    for a in lin:
        np.testing.assert_allclose(ours[a].numpy(), np.asarray(want[a]),
                                   atol=OP_TOL, rtol=OP_TOL, err_msg=a)
    np.testing.assert_allclose(
        block.block_std(_t(x), tb.block_adj, tb.in_degree).numpy(),
        np.asarray(jax_block.block_std(jnp.asarray(x), jb.block_adj,
                                       jb.in_degree, mm="highest")),
        atol=OP_TOL, rtol=OP_TOL)
    with pytest.raises(ValueError, match="no block form"):
        block.block_multi(_t(x), tb.block_adj, tb.in_degree, ("max",))


ROUTES = {
    "block": dict(block_size=128, node_multiple=128),
    "ell": dict(block_size=None, node_multiple=8),
    "edge_list": dict(block_size=None, node_multiple=8, ell_width=0),
}


def _route_batches(route, node_dim=None, n=20):
    graphs = load_dataset("qm9", n=n, seed=2)
    if node_dim is not None:
        graphs = [dataclasses.replace(g, x=np.pad(
            g.x, ((0, 0), (0, node_dim - g.x.shape[1])))) for g in graphs]
    kw = ROUTES[route]
    jb = jax_build(graphs, **kw)
    tb = build_graph_batch(graphs, device="cpu", **kw)
    assert (tb.nbr_nodes is None) == (route == "edge_list")
    return graphs, jb, tb


class _Calls:
    """Counts ``ell_agg.fused_ell_aggregate`` calls by whether u was given."""

    def __enter__(self):
        self.calls = []
        self.orig = ell_agg.fused_ell_aggregate

        def counted(*a, **k):
            self.calls.append(k.get("u", a[4] if len(a) > 4 else None)
                              is not None)
            return self.orig(*a, **k)

        ell_agg.fused_ell_aggregate = counted
        return self

    def __exit__(self, *exc):
        ell_agg.fused_ell_aggregate = self.orig
        return False


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_pna_five_aggregators_matches_jax_on_each_route(route):
    _, jb, tb = _route_batches(route)
    rng = np.random.default_rng(8)
    F, Fo = 16, 24
    x = rng.standard_normal((tb.num_nodes, F)).astype(np.float32)
    skip = rng.standard_normal((tb.num_nodes, Fo)).astype(np.float32)
    jc = jax_conv.PNAConv(in_channels=F, out_channels=Fo, delta=1.7,
                          aggregators=ALL5)
    params = jc.init(jax.random.PRNGKey(1), jb, x)
    ref = np.asarray(jc.apply(params, jb, x, "relu", skip))
    tc = torch_conv.PNAConv(F, Fo, delta=1.7, aggregators=ALL5)
    sd = params_from_jax({"params": {"gnn_convs_0": params["params"],
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
        want = [] if mode == "never" or route == "edge_list" else (
            [False] if route == "block" else [True])
        assert c.calls == want, (mode, c.calls)


MODELS = [("simple", {"aggregation": "max"}),
          ("simple", {"aggregation": "min"}),
          ("pna", {"aggregators": ALL5})]


@pytest.mark.parametrize("conv,kw", MODELS, ids=["max", "min", "pna5"])
@pytest.mark.parametrize("route", ["block", "ell"])
def test_program_matches_jax(conv, kw, route):
    """3-layer Simple (max, min) at input = hidden = output = 16 and
    five-aggregator PNA models through the kernel's route and the plain
    path against the JAX Program on the same weights."""
    same = conv == "simple"
    graphs, jb, tb = _route_batches(route, node_dim=16 if same else None)
    over = dict(gnn_num_layers=3, gnn_hidden_dim=16,
                gnn_output_dim=16 if same else 8, conv_kwargs=dict(kw))
    if conv == "pna":
        over["conv_kwargs"]["delta"] = 1.3
    cfg = {k: v for k, v in JAX_CANONICAL.items() if k not in over}
    jm = gnnb.GNNModel(graph_input_feature_dim=16 if same else 11,
                       gnn_conv=conv, **cfg, **over)
    tm = canonical_model(conv, "qm9", graphs=graphs, **over)
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
        assert ours.shape == ref.shape
        assert np.isfinite(ours[m]).all()
        np.testing.assert_allclose(ours[m], ref[m], atol=ATOL, rtol=RTOL,
                                   err_msg=mode)
        err = np.abs(ours[m] - ref[m]).max()
        assert err <= SCALED_TOL * np.abs(ref[m]).max(), (mode, err)
        # Simple gives way to the block path on block batches; PNA's
        # block path takes the kernel for max and min without u
        want = {("simple", "ell"): [False] * 3, ("simple", "block"): [],
                ("pna", "ell"): [True] * 3,
                ("pna", "block"): [False] * 3}[conv, route]
        assert c.calls == (want if mode == "auto" else []), mode


def test_agg_gate_and_wrapper_checks():
    _, _, blk = _route_batches("block")
    _, _, std = _route_batches("ell")
    _, _, edge = _route_batches("edge_list")
    assert dispatch.agg_cfg(std) == {} and dispatch.agg_cfg(blk) == {}
    assert dispatch.agg_cfg(edge) is None
    dispatch.set_fused_mode("never")
    try:
        assert dispatch.agg_cfg(std) is None
    finally:
        dispatch.set_fused_mode("auto")
    v = torch.zeros(std.num_nodes, 4)
    for bad in ((), ("max", "max"), ("prod",)):
        with pytest.raises(ValueError, match="aggregators"):
            ell_agg.fused_ell_aggregate(v, std.nbr_nodes, std.in_degree, bad)
    with pytest.raises(ValueError, match="u must be"):
        ell_agg.fused_ell_aggregate(v, std.nbr_nodes, std.in_degree,
                                    ("sum",), u=torch.zeros(3, 4))

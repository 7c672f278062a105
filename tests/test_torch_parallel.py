"""The port's distribution (``gnnbuilder_tpu_torch.parallel``) against the
JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``,
as ``tests/test_train_parallel.py`` does; the port's side on gloo worlds
of 2 and 4 spawned ranks (``torch_parallel_worker``), each world started
once for the module and running all of its cases while the JAX
references compile.  Inputs come from ``FakeDataset`` seeds; the weights
are drawn with numpy from a seed into the JAX tree (its layout from
``port.params_to_jax``) and go to the port through
``port.params_from_jax``.

* placements: each ``GraphBatch`` field's placement is JAX's
  ``batch_shardings`` / ``halo_batch_specs`` spec; a p-factor model's
  ``model_p_factors`` (through ``port.site_to_jax``) and the parameters
  that shard over tp = 2 are JAX's;
* meshes: ``make_multihost_mesh(tp)`` is ``make_mesh(tp=tp)`` on one host;
  a submesh of width 1 in a world of 2 runs on its member;
* sharded aggregation (sum, mean, max, min, std) on dp = 2 and 4 against
  JAX's ``ell_aggregate_sharded`` and the port's single-rank
  ``ell_multi`` at 1e-5 of max; std against the single rank at atol =
  rtol = 1e-5 (as ``test_torch_aggregation.py`` holds ``ell_std``), and
  against JAX at 1e-4 of max, the tolerance ``test_torch_ell_agg.py``
  holds std to against compiled JAX (``STD_KERNEL_TOL``): JAX compiles
  the ``shard_map``, and XLA on the CPU contracts E[x^2] - E[x]^2 into a
  fused multiply-add, so a degree-1 row gets a variance of one rounding
  error where the port gets 0, and sqrt(var + 1e-5) turns it into ~7e-5;
  overlapped and sequential bit for bit; a zero halo and one above the
  local rows raise, as in JAX;
* the halo exchange's gradient against ``jax.vjp`` of JAX's
  ``halo_exchange`` in ``shard_map``, at 1e-6;
* the halo forward of gcn, sage, pna, gat and gine on dp = 2, gcn and pna
  on dp = 4, and the all-gather forward on (dp, tp) = (2, 2), against
  JAX's sharded forward and the port's single-device forward (held
  against JAX's by the port's model tests) at atol 2e-5 /
  rtol 1e-5 (``test_train_parallel.py``'s); each layer of gcn, sage, pna
  and gat through ``halo_wrap_layer`` (the kernel route), gine through
  none (its kernel declines under halo);
* one SGD step of gcn, pna (delta 2) and gine in both strategies on
  dp = 2, and of a p-factor gcn whose interior layers shard over tp on
  (2, 2): the loss at the forwards' tolerance against JAX's sharded
  loss, within 1e-6 between the port's two strategies, every gradient
  within 2e-5 of max of ``jax.grad`` of JAX's sharded loss; the
  window's reverse CSR built at most once a step;
* ``measure_scaling`` on a world of 2 with widths (1, 2);
* the gates under a halo scope: those whose layouts span the batch
  decline (JAX's ``block_cfg``, ``readout_config`` and agg
  ``fused_config`` alike), the layer kernels' stay on, the mp layer in
  its ELL mode on a block-packed batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu.core.graph import build_graph_batch
from gnnbuilder_tpu.data.datasets import FakeDataset
from gnnbuilder_tpu.parallel import halo as jax_halo
from gnnbuilder_tpu.parallel.mesh import make_mesh
from gnnbuilder_tpu.parallel.sharding import (
    batch_shardings,
    halo_batch_specs,
    model_p_factors,
    param_shardings,
    shard_batch,
    shard_params,
)
from gnnbuilder_tpu.parallel.train import _shard_map, make_sharded_forward
from gnnbuilder_tpu.train import masked_mse_loss, stack_targets
from gnnbuilder_tpu_torch.nn.model import GNNModel as PortModel
from gnnbuilder_tpu_torch.port import (
    params_from_jax,
    params_to_jax,
    site_to_jax,
)
from torch_parallel_worker import World

FWD_ATOL, FWD_RTOL = 2e-5, 1e-5
GRAD_TOL = 2e-5
AGG_TOL = 1e-5
STD_TOL = 1e-5
STD_JAX_TOL = 1e-4
EXCHANGE_TOL = 1e-6
STRATEGY_TOL = 1e-6

DATA = dict(num_graphs=32, avg_num_nodes=12, node_dim=8, seed=7)
PACK = dict(node_budget=512)
AGG_DATA = dict(num_graphs=32, avg_num_nodes=14, node_dim=8, seed=6)
AGG_PACK = dict(node_multiple=32)
AGGS = ("sum", "mean", "max", "min", "std")
HALO_CONVS = ("gcn", "sage", "pna", "gat", "gine")
STEP_CONVS = ("gcn", "pna", "gine")
DP4_CONVS = ("gcn", "pna")


def _kw(conv, p_factors=False):
    kw = dict(graph_input_feature_dim=8, gnn_hidden_dim=16,
              gnn_num_layers=3, gnn_output_dim=8, gnn_conv=conv,
              gnn_skip_connection=True, pooling_aggrs=("add", "mean", "max"),
              mlp_hidden_dim=8, mlp_hidden_layers=1)
    if conv == "pna":
        kw["conv_kwargs"] = {"delta": 2.0}
    if conv == "gine":
        kw["graph_input_edge_dim"] = 4
    if p_factors:
        kw.update(gnn_p_hidden=2, gnn_p_out=1, mlp_p_hidden=2, mlp_p_out=1)
    return kw


def _halo(b):
    return ((b.max_graph_nodes_static + 7) // 8) * 8


def _weights(kw, seed):
    """A JAX parameter tree for the model of ``kw``, drawn with numpy:
    U(+-1/sqrt(fan_in)) for every leaf (fan_in the leaf's last dim but
    for kernels, whose first), in the tree ``params_to_jax`` lays out."""
    rng = np.random.default_rng(seed)
    tree = params_to_jax(PortModel(**kw).state_dict())

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) if isinstance(node[k], dict) else
                    _leaf(k, node[k]) for k in sorted(node)}
        raise TypeError(node)

    def _leaf(name, a):
        fan = a.shape[0] if name == "kernel" else a.shape[-1]
        b = 1.0 / np.sqrt(fan)
        return jnp.asarray(rng.uniform(-b, b, a.shape).astype(np.float32))

    return draw(tree)


class _Setup:
    """The JAX models, weights and batches, and the cases of each world."""

    def __init__(self):
        self.graphs = FakeDataset(**DATA)
        self.batch = build_graph_batch(self.graphs, **PACK)
        self.target = stack_targets(self.graphs, self.batch.num_graphs)
        self.models, self.params, self.sd = {}, {}, {}
        for name, conv, pf in [(c, c, False) for c in HALO_CONVS] + [
                ("gcn_pf", "gcn", True)]:
            model = gnnb.GNNModel(**_kw(conv, pf))
            params = _weights(_kw(conv, pf), 0)
            self.models[name], self.params[name] = model, params
            self.sd[name] = {k: v.numpy() for k, v in params_from_jax(
                jax.device_get(params)).items()}
        self.agg_graphs = FakeDataset(**AGG_DATA)
        self.agg_batch = build_graph_batch(self.agg_graphs, **AGG_PACK)
        n = self.agg_batch.num_nodes
        rng = np.random.default_rng(1)
        self.agg_x = rng.standard_normal((n, 8)).astype(np.float32)
        self.ex_halo = 8
        self.ex_ct = rng.standard_normal(
            (n + 2 * 2 * self.ex_halo, 8)).astype(np.float32)

    def model_spec(self, name, **kw):
        conv = name.split("_")[0]
        return dict(data=DATA, pack=PACK, params=self.sd[name],
                    model=_kw(conv, name.endswith("_pf")), **kw)

    def agg_spec(self, dp):
        return dict(case="agg", dp=dp, data=AGG_DATA, pack=AGG_PACK,
                    x=self.agg_x, aggs=AGGS, h=_halo(self.agg_batch))

    def world2_cases(self):
        cases = [self.agg_spec(2),
                 dict(case="exchange", dp=2, x=self.agg_x,
                      h=self.ex_halo, ct=self.ex_ct)]
        cases += [self.model_spec(c, case="forward", dp=2, halo=True)
                  for c in HALO_CONVS]
        cases += [self.model_spec(c, case="step", dp=2, halo=h)
                  for c in STEP_CONVS for h in (True, False)]
        cases += [dict(case="meshes", world=2, tps=(1, 2), data=AGG_DATA,
                       pack=AGG_PACK, x=self.agg_x),
                  self.model_spec("gcn", case="scaling", widths=(1, 2))]
        return cases

    def world4_cases(self):
        cases = [self.agg_spec(4)]
        cases += [self.model_spec(c, case="forward", dp=4, halo=True)
                  for c in DP4_CONVS]
        cases += [self.model_spec("pna", case="forward", dp=2, tp=2,
                                  halo=False),
                  self.model_spec("gcn_pf", case="step", dp=2, tp=2,
                                  halo=False),
                  self.model_spec("gcn_pf", case="placements", dp=2, tp=2),
                  dict(case="meshes", world=4, tps=(1, 2, 4), data=AGG_DATA,
                       pack=AGG_PACK, x=self.agg_x)]
        return cases


def _by_case(results, cases):
    """{key: [per-rank result]} with keys (case, name, dp, tp, halo);
    the meshes cases by (case, world)."""
    out = {}
    for i, spec in enumerate(cases):
        name = "x"
        if "model" in spec:
            name = spec["model"]["gnn_conv"] + (
                "_pf" if spec["model"].get("gnn_p_hidden", 1) > 1 else "")
        key = (spec["case"], name, spec.get("dp"), spec.get("tp", 1),
               spec.get("halo"))
        if spec["case"] == "meshes":
            key = ("meshes", spec["world"])
        out[key] = [r[i] for r in results]
    return out


class _Refs:
    """The JAX references, each computed once."""

    def __init__(self, s: _Setup):
        self.s = s
        self.agg = {dp: self._agg(dp) for dp in (2, 4)}
        self.exchange = self._exchange()
        self.sharded = {}
        for c in STEP_CONVS:
            for h in (True, False):
                self.sharded[(c, 2, 1, h)] = self._value_grad(c, 2, 1, h)
        for c in ("sage", "gat"):
            self.sharded[(c, 2, 1, True)] = (self._forward(c, 2, 1, True),)
        for c in DP4_CONVS:
            self.sharded[(c, 4, 1, True)] = (self._forward(c, 4, 1, True),)
        self.sharded[("pna", 2, 2, False)] = (
            self._forward("pna", 2, 2, False),)
        self.sharded[("gcn_pf", 2, 2, False)] = self._value_grad(
            "gcn_pf", 2, 2, False)

    def _agg(self, dp):
        s = self.s
        b = s.agg_batch
        mesh = make_mesh(dp=dp, tp=1)
        x = jnp.asarray(s.agg_x)
        got = np.asarray(jax.jit(lambda v: jax_halo.ell_aggregate_sharded(
            mesh, v, b.nbr_nodes, b.in_degree, _halo(b), AGGS))(x))
        errors = []
        for bad in (0, b.num_nodes // dp + 1):
            with pytest.raises(AssertionError) as e:
                jax_halo.ell_aggregate_sharded(
                    mesh, x, b.nbr_nodes, b.in_degree, bad, AGGS)
            errors.append(str(e.value))
        return got, errors

    def _exchange(self):
        s = self.s
        mesh = make_mesh(dp=2, tp=1)
        P = jax.sharding.PartitionSpec
        fn = _shard_map()(
            lambda x: jax_halo.halo_exchange(x, s.ex_halo, "dp"), mesh=mesh,
            in_specs=P("dp", None), out_specs=P("dp", None),
            check_vma=False)
        y, dx = jax.jit(lambda x, ct: (fn(x), jax.vjp(fn, x)[1](ct)[0]))(
            jnp.asarray(s.agg_x), jnp.asarray(s.ex_ct))
        return np.asarray(y), np.asarray(dx)

    def _fwd(self, name, dp, tp, halo):
        s = self.s
        mesh = make_mesh(dp=dp, tp=tp)
        model = s.models[name]
        fwd = make_sharded_forward(model, mesh, s.batch, halo=halo)
        sbatch = shard_batch(mesh, s.batch)
        pf = model_p_factors(model) if name.endswith("_pf") else None
        return fwd, sbatch, (shard_params(mesh, s.params[name], pf)
                             if tp > 1 else s.params[name])

    def _forward(self, name, dp, tp, halo):
        fwd, sbatch, params = self._fwd(name, dp, tp, halo)
        return np.asarray(fwd(params, sbatch))

    def _value_grad(self, name, dp, tp, halo):
        fwd, sbatch, params = self._fwd(name, dp, tp, halo)
        s = self.s

        def loss(p):
            pred = fwd(p, sbatch)
            return masked_mse_loss(pred, s.target, s.batch.graph_mask), pred

        (l, pred), g = jax.value_and_grad(loss, has_aux=True)(params)
        grads = {k: v.numpy() for k, v in params_from_jax(
            jax.device_get(g)).items()}
        return np.asarray(pred), float(l), grads


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    s = _Setup()
    tmp = tmp_path_factory.mktemp("gloo")
    c2, c4 = s.world2_cases(), s.world4_cases()
    w2, w4 = World(2, c2, tmp), World(4, c4, tmp)
    try:
        refs = _Refs(s)
        r2, r4 = w2.results(), w4.results()
    finally:
        w2.close()
        w4.close()
    got = _by_case(r2, c2)
    got.update(_by_case(r4, c4))
    return s, refs, got


def _close_of_max(got, want, tol, msg=""):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{msg}: {err:.3e} > {tol} of max {scale:.3e}"


# ------------------------------------------------------------ placements

_FIELDS = ("node_feat", "senders", "receivers", "edge_feat", "node_graph",
           "in_degree", "row_offsets", "n_node", "n_edge", "node_mask",
           "edge_mask", "graph_mask", "nbr_nodes", "nbr_edges",
           "rev_nbr_nodes", "out_degree", "block_adj", "graph_starts")


def _spec_tuple(spec):
    if spec is None:
        return None
    spec = getattr(spec, "spec", spec)
    return tuple(spec)


@pytest.mark.parametrize("halo", [False, True])
def test_batch_placements_match_jax(run, halo):
    s, _, got = run
    ours = got[("placements", "gcn_pf", 2, 2, None)][0]["halo" if halo
                                                      else "batch"]
    mesh = make_mesh(dp=2, tp=2)
    theirs = (halo_batch_specs(s.batch) if halo
              else batch_shardings(mesh, s.batch))
    for f in _FIELDS:
        assert ours[f] == _spec_tuple(getattr(theirs, f)), f


def test_p_factors_and_param_placements_match_jax(run):
    s, _, got = run
    res = got[("placements", "gcn_pf", 2, 2, None)][0]
    model = s.models["gcn_pf"]
    jax_pf = model_p_factors(model)
    assert {(site_to_jax(k) if "linear" in k else k.replace(".", "_")): v
            for k, v in res["p_factors"].items()} == jax_pf
    mesh = make_mesh(dp=2, tp=2)
    sh = param_shardings(mesh, s.params["gcn_pf"], jax_pf)
    P = jax.sharding.PartitionSpec
    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
    jax_tp = set()
    for path, leaf in flat:
        names = [str(getattr(k, "key", k)) for k in path][1:]
        if leaf.spec == P(None, "tp"):
            jax_tp.add("/".join(names[:-1]))
    ours_tp = {site_to_jax(k.rsplit(".", 1)[0]) for k, v in
               res["params"].items() if v == ("tp", None)}
    assert ours_tp == jax_tp and ours_tp, (ours_tp, jax_tp)


# ------------------------------------------------------------ meshes

@pytest.mark.parametrize("world", [2, 4])
def test_multihost_mesh_is_make_mesh_on_one_host(run, world):
    _, _, got = run
    ranks = got[("meshes", world)]
    assert len(ranks) == world
    for r in ranks:
        same = [v for k, v in r.items() if k.startswith("same_")]
        assert same and all(same)


def test_submesh_of_width_one(run):
    _, _, got = run
    r0, r1 = got[("meshes", 2)]
    assert r0["member"] and not r1["member"]
    assert r0["sub_err"] == 0.0
    assert r1["outside_raises"]


# ------------------------------------------------------------ aggregation

@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_aggregation_matches_jax_and_single_rank(run, dp):
    s, refs, got = run
    ranks = got[("agg", "x", dp, 1, None)]
    ovl = np.concatenate([r["ovl"] for r in ranks])
    seq = np.concatenate([r["seq"] for r in ranks])
    single = np.concatenate([r["single"] for r in ranks])
    want, _ = refs.agg[dp]
    np.testing.assert_array_equal(ovl, seq)
    F = s.agg_x.shape[1]
    for i, a in enumerate(AGGS):
        cols = slice(i * F, (i + 1) * F)
        for other, name in ((want, "jax"), (single, "single rank")):
            if (a, name) == ("std", "jax"):
                _close_of_max(ovl[:, cols], other[:, cols], STD_JAX_TOL,
                              f"{a} vs {name}")
            elif a == "std":
                np.testing.assert_allclose(ovl[:, cols], other[:, cols],
                                           atol=STD_TOL, rtol=STD_TOL,
                                           err_msg=f"{a} vs {name}")
            else:
                _close_of_max(ovl[:, cols], other[:, cols], AGG_TOL,
                              f"{a} vs {name}")
    sums = np.concatenate([r["sum"] for r in ranks])
    _close_of_max(sums, want[:, :F], AGG_TOL, "ell_sum_sharded")


@pytest.mark.parametrize("dp", [2, 4])
def test_bad_halo_raises_as_in_jax(run, dp):
    _, refs, got = run
    _, jax_errors = refs.agg[dp]
    for r in got[("agg", "x", dp, 1, None)]:
        assert [r["err_zero"], r["err_big"]] == jax_errors


# ------------------------------------------------------------ exchange

def test_halo_exchange_and_its_gradient_match_jax(run):
    _, refs, got = run
    ranks = got[("exchange", "x", 2, 1, None)]
    y, dx = refs.exchange
    np.testing.assert_array_equal(np.concatenate([r["y"] for r in ranks]), y)
    np.testing.assert_allclose(np.concatenate([r["dx"] for r in ranks]), dx,
                               atol=EXCHANGE_TOL, rtol=0)


# ------------------------------------------------------------ forwards

FORWARDS = ([(c, 2, 1, True) for c in HALO_CONVS]
            + [(c, 4, 1, True) for c in DP4_CONVS]
            + [("pna", 2, 2, False)])


@pytest.mark.parametrize("conv,dp,tp,halo", FORWARDS)
def test_sharded_forward_matches_jax(run, conv, dp, tp, halo):
    s, refs, got = run
    ranks = got[("forward", conv, dp, tp, halo)]
    want = refs.sharded[(conv, dp, tp, halo)][0]
    for r in ranks:
        np.testing.assert_allclose(r["out"], want, atol=FWD_ATOL,
                                   rtol=FWD_RTOL)
        np.testing.assert_allclose(r["out"], r["single"], atol=FWD_ATOL,
                                   rtol=FWD_RTOL)
        # the kernel route: one window a layer where the conv has a
        # layer kernel (rows 4, 5, 10); GINE's declines under halo
        if halo and conv != "gine":
            assert r["calls"] >= s.models[conv].gnn_num_layers, r["calls"]
        else:
            assert r["calls"] == 0


# ------------------------------------------------------------ train step

STEPS = ([(c, 2, 1, h) for c in STEP_CONVS for h in (True, False)]
         + [("gcn_pf", 2, 2, False)])


@pytest.mark.parametrize("name,dp,tp,halo", STEPS)
def test_sharded_step_loss_and_gradients_match_jax(run, name, dp, tp, halo):
    _, refs, got = run
    ranks = got[("step", name, dp, tp, halo)]
    _, loss, grads = refs.sharded[(name, dp, tp, halo)]
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), loss, atol=FWD_ATOL,
                                   rtol=FWD_RTOL)
        assert set(r["grads"]) == set(grads)
        for k, g in grads.items():
            _close_of_max(r["grads"][k], g, GRAD_TOL, k)
        assert r["csr_built"] <= 1
    if tp > 1:
        assert all(r["blocks"] for r in ranks), "no parameter sharded"


@pytest.mark.parametrize("conv", STEP_CONVS)
def test_two_strategies_agree_on_the_loss(run, conv):
    _, _, got = run
    a = got[("step", conv, 2, 1, True)][0]["loss"]
    b = got[("step", conv, 2, 1, False)][0]["loss"]
    assert abs(float(a) - float(b)) <= STRATEGY_TOL


# ------------------------------------------------------------ scaling

def test_measure_scaling_rows(run):
    _, _, got = run
    for r in got[("scaling", "gcn", None, 1, None)]:
        rows = r["rows"]
        assert [row["dp"] for row in rows] == [1, 2]
        for row in rows:
            assert set(row) == {"dp", "latency_s", "graphs_per_s",
                                "efficiency"}
            assert row["latency_s"] > 0
            assert all(np.isfinite(v) for v in row.values())
        assert rows[0]["efficiency"] == 1.0


# ------------------------------------------------------------ gates

def _gate_batches():
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch as port_pack

    graphs = FakeDataset(**DATA)
    jb = build_graph_batch(graphs, block_size=128)
    return jb, port_pack(graphs, block_size=128, device="cpu")


PORT_GATES = {
    "block_cfg": lambda g: dispatch_port().block_cfg(g),
    "mp_stack_cfg": lambda g: dispatch_port().mp_stack_cfg(g, "gcn"),
    "pna_stack_cfg": lambda g: dispatch_port().pna_stack_cfg(g),
    "gat_block_cfg": lambda g: dispatch_port().gat_block_cfg(g, "relu"),
    "agg_cfg": lambda g: dispatch_port().agg_cfg(g),
    "edge_block_cfg": lambda g: dispatch_port().edge_block_cfg(g, "relu"),
    "readout_config": lambda g: dispatch_port().readout_config(
        g, ("add", "mean"), "relu", None),
}


def dispatch_port():
    from gnnbuilder_tpu_torch.ops import dispatch

    return dispatch


@pytest.mark.parametrize("gate", sorted(PORT_GATES))
def test_whole_batch_gates_decline_under_halo(gate):
    """The gates whose layouts span the batch decline under a halo scope,
    as JAX's do (its ``block_cfg``, ``readout_config`` and the agg
    ``fused_config`` checked beside them, in its "always" mode)."""
    from gnnbuilder_tpu.ops import dispatch as jd
    from gnnbuilder_tpu_torch.parallel.halo import halo_scope

    jb, tb = _gate_batches()
    with dispatch_port().inference_mode():
        assert PORT_GATES[gate](tb) is not None
        with halo_scope("dp", 16, None):
            assert PORT_GATES[gate](tb) is None
    jax_gate = {"block_cfg": lambda: jd.block_cfg(jb),
                "readout_config": lambda: jd.readout_config(
                    jb, ("add", "mean"), "relu", None),
                "agg_cfg": lambda: jd.fused_config(jb, kind="agg")}.get(gate)
    if jax_gate is not None:
        jd.set_fused_mode("always")
        try:
            assert jax_gate() is not None
            with jax_halo.halo_scope("dp", 16):
                assert jax_gate() is None
        finally:
            jd.set_fused_mode("auto")


def test_layer_gates_take_the_ranks_rows_under_halo():
    """Under halo the mp layer takes its ELL mode on a block-packed batch
    (JAX's block route declines there), the PNA and GAT layer kernels
    stay on, and GINE's kernel is skipped (``nn.conv``)."""
    from gnnbuilder_tpu_torch.parallel.halo import halo_scope

    d = dispatch_port()
    _, tb = _gate_batches()
    assert d.mp_layer_cfg(tb, "gcn") == {"block": True}
    with halo_scope("dp", 16, None):
        assert d.mp_layer_cfg(tb, "gcn") == {}
        assert d.pna_layer_cfg(tb, "relu") == {}
        assert d.gat_layer_cfg(tb, "relu") == {}
        from gnnbuilder_tpu_torch.nn.conv import _halo_on

        assert _halo_on()

"""The port's measurement layer against the JAX package's, on the CPU:
``bench/timing.py`` (both modules on one deterministic clock),
``bench/roofline.py``, ``bench/energy.py``, ``utils/profiling.py``,
``GraphBatch.with_node_feat``, ``Program.cost_analysis`` (hand counts,
route and policy independence) and ``Program._inner_chain`` /
``benchmark_inner``'s fit (the chain's last forward against the JAX
package's ``_inner_chain_fn`` on the same weights, at the whole-model
tolerance atol 5e-4 / rtol 1e-3, on ``graph_mask`` rows)."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu.bench import energy as jax_energy
from gnnbuilder_tpu.bench import roofline as jax_roofline
from gnnbuilder_tpu.bench import timing as jax_timing
from gnnbuilder_tpu.bench.canonical import (
    canonical_batches as jax_canonical_batches,
)
from gnnbuilder_tpu.bench.canonical import (
    canonical_model as jax_canonical_model,
)
from gnnbuilder_tpu.utils import profiling as jax_profiling
from gnnbuilder_tpu_torch import GNNModel, Program
from gnnbuilder_tpu_torch.bench import energy, roofline, timing
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.compile import program as program_mod
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.port import params_from_jax
from gnnbuilder_tpu_torch.utils import profiling

ATOL, RTOL = 5e-4, 1e-3
H100 = (989e12, 3.35e12)


# ------------------------------------------------------------------ timing
class _Clock:
    """A host clock driven by the calls it times: every ``tick()`` (one
    timed call) adds ``per_call`` seconds, every read adds a fixed
    pseudo-random jitter, so two implementations that make the same calls
    and reads in the same order see the same times."""

    def __init__(self, per_call):
        self.per_call, self.t, self.reads = per_call, 100.0, 0

    def tick(self):
        self.t += self.per_call

    def __call__(self):
        self.reads += 1
        return self.t + 3e-5 * ((self.reads * 7919) % 13)


def _both_marginal(monkeypatch, per_call, **kw):
    """(JAX estimate or exception, port estimate or exception)."""
    res = []
    for mod, fn in ((jax_timing, lambda: jnp.zeros(())),
                    (timing, lambda: torch.zeros(()))):
        clock = _Clock(per_call)
        monkeypatch.setattr(time, "perf_counter", clock)

        def call(_fn=fn, _clock=clock):
            _clock.tick()
            return _fn()

        try:
            res.append(mod.marginal_time(call, **kw))
        except mod.MeasurementUnresolved as e:
            res.append(e)
    return res


@pytest.mark.parametrize("per_call,kw", [
    (1e-3, {}),
    (2e-4, dict(n_lo=3, n_hi=40, warmup=1, repeats=5)),
    (1e-3, dict(n_lo=10, n_hi=8)),        # n_hi <= n_lo: the gap restored
    (1e-3, dict(n_lo=4, n_hi=4, strict=True)),
    (1e-6, dict(strict=True)),            # unresolved in both
    (1e-6, {}),                           # clamped alike without strict
])
def test_marginal_time_matches_jax(monkeypatch, per_call, kw):
    j, t = _both_marginal(monkeypatch, per_call, **kw)
    if isinstance(j, Exception):
        assert isinstance(t, timing.MeasurementUnresolved), t
        return
    assert not isinstance(t, Exception), t
    assert t == j


@pytest.mark.parametrize("per_call,strict", [(1e-3, False), (1e-7, True)])
def test_chained_marginal_time_matches_jax(monkeypatch, per_call, strict):
    res = []
    for mod, x0 in ((jax_timing, jnp.zeros(())), (timing, torch.zeros(()))):
        clock = _Clock(per_call)
        monkeypatch.setattr(time, "perf_counter", clock)

        def step(x, _clock=clock):
            _clock.tick()
            return x + 1

        try:
            res.append(mod.chained_marginal_time(step, x0, strict=strict))
        except mod.MeasurementUnresolved:
            res.append("unresolved")
    assert res[0] == res[1]


def test_timed_fence_reads_the_first_leaf():
    x = torch.arange(4, dtype=torch.float32)
    assert timing.timed_fence(x) == 6.0
    assert timing.timed_fence({"a": (x, None)}) == 6.0
    assert timing.timed_fence([torch.ones(3, dtype=torch.bfloat16)]) == 3.0


# ---------------------------------------------------------------- roofline
@pytest.mark.parametrize("args", [
    dict(measured_latency_s=2e-3, flops=3e11, min_bytes=5e7),
    dict(measured_latency_s=1e-4, flops=1e6, min_bytes=8e9, xla_bytes=2e10,
         num_edges=41_000),
    dict(measured_latency_s=0.0, flops=0.0, min_bytes=0.0, xla_bytes=0.0,
         num_edges=0),
])
def test_roofline_report_matches_jax(monkeypatch, args):
    monkeypatch.setattr(jax_roofline, "chip_peaks", lambda device=None: H100)
    monkeypatch.setattr(roofline, "chip_peaks", lambda device=None: H100)
    assert roofline.roofline_report(**args) == \
        jax_roofline.roofline_report(**args)


def test_chip_peaks_by_card_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert roofline.chip_peaks() == H100
    assert H100 == (roofline.PEAK_BF16_FLOPS, roofline.PEAK_BYTES_PER_S)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100-SXM4-80GB"):
        roofline.chip_peaks()


def _pair(conv, block, layers=2, n_graphs=16, **over):
    """(JAX Program, its batch, port Program, its batch) on the same
    synthetic QM9 graphs and weights."""
    kw = dict(n_graphs=n_graphs, batch_size=n_graphs, block_size=block,
              node_multiple=128)
    gj, (jb,) = jax_canonical_batches("qm9", **kw)
    gt, (tb,) = canonical_batches("qm9", **kw, device="cpu")
    jm = jax_canonical_model(conv, "qm9", graphs=gj, gnn_num_layers=layers,
                             **over)
    tm = canonical_model(conv, "qm9", graphs=gt, gnn_num_layers=layers,
                         **over)
    size = dict(max_nodes=jb.num_nodes, max_edges=jb.num_edges,
                max_graphs=jb.num_graphs, block_size=block)
    jp = gnnb.Program(jm, **size)
    params = jax.tree.map(np.asarray, jp.init_params(jb))
    tp = Program(tm, **size, device="cpu")
    tp.set_params(params_from_jax(params))
    return jp, jb, tp, tb


@pytest.fixture(scope="module")
def gcn_block():
    return _pair("gcn", 128)


@pytest.fixture(scope="module")
def pna_std():
    return _pair("pna", 0)


# the fields whose dtype differs between the two packages' batches: the
# JAX block adjacency is bf16 (exact small counts), the port's float32
DTYPE_DIFFS = {"block_adj": (2, 4)}


@pytest.mark.parametrize("which", ["gcn_block", "pna_std"])
def test_program_min_bytes_matches_jax(request, which):
    jp, jb, tp, tb = request.getfixturevalue(which)
    jbytes = {f.name: getattr(jb, f.name).nbytes
              for f in dataclasses.fields(jb)
              if hasattr(getattr(jb, f.name), "nbytes")}
    tbytes = roofline.batch_nbytes(tb)
    differ = {k for k in set(jbytes) | set(tbytes)
              if jbytes.get(k) != tbytes.get(k)}
    assert differ == (set(DTYPE_DIFFS) if tb.block_adj is not None
                      else set()), differ
    for k in differ:
        jw, tw = DTYPE_DIFFS[k]
        assert jbytes[k] // jw == tbytes[k] // tw
    extra = sum(tbytes[k] - jbytes[k] for k in differ)
    assert roofline.program_min_bytes(tp, tb) == \
        jax_roofline.program_min_bytes(jp, jb) + extra


# ------------------------------------------------------------------ energy
def test_energy_matches_jax(monkeypatch, tmp_path):
    assert energy.energy_bound_j_per_graph(3e-6, 700.0) == \
        jax_energy.energy_bound_j_per_graph(3e-6, 700.0)
    assert energy.CPU_TDP_W == jax_energy.CPU_TDP_W
    assert energy.rapl_available() == jax_energy.rapl_available()
    if not energy.rapl_available():
        assert energy.cpu_energy_j(lambda: 1) is None
    monkeypatch.delenv("GNNB_GPU_TDP_W", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        energy.card_tdp_w()
    monkeypatch.setenv("GNNB_GPU_TDP_W", "350")
    assert energy.card_tdp_w() == 350.0


# -------------------------------------------------------------- profiling
def test_trace_refuses_without_cuda_activity(monkeypatch, tmp_path):
    import torch.profiler as tp

    monkeypatch.setattr(tp, "supported_activities",
                        lambda: {tp.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot trace"):
        with profiling.trace(str(tmp_path)):
            pass


def test_profile_program_has_jax_keys(monkeypatch, gcn_block):
    jp, jb, tp, tb = gcn_block
    fake = {"latency_s": 1e-3, "graphs_per_s": 16e3, "edges_per_s": 3e5}
    monkeypatch.setattr(jp, "benchmark", lambda b, iters=20: dict(fake))
    monkeypatch.setattr(tp, "benchmark", lambda b, iters=20: dict(
        fake, device="card"))
    monkeypatch.setattr(jax_roofline, "chip_peaks", lambda device=None: H100)
    monkeypatch.setattr(roofline, "chip_peaks", lambda device=None: H100)
    want = jax_profiling.profile_program(jp, jb, iters=4)
    got = profiling.profile_program(tp, tb, iters=4)
    assert set(want) <= set(got)
    for key in ("latency_s", "fraction_of_roofline", "edges_per_s", "bound"):
        assert key in got
    assert got["edges_per_s"] == int(tb.edge_mask.sum()) / 1e-3
    assert got["xla_bytes_accessed"] == tp.cost_analysis(tb)["bytes accessed"]
    assert got["device"] == "card"


# ------------------------------------------------------------ with_node_feat
def test_with_node_feat(gcn_block):
    tb = gcn_block[3]
    x = tb.node_feat + 1.0
    nb = tb.with_node_feat(x)
    assert nb.node_feat is x and tb.node_feat is not x
    for f in dataclasses.fields(tb):
        if f.name != "node_feat":
            assert getattr(nb, f.name) is getattr(tb, f.name)


# ------------------------------------------------------------ inner chain
@pytest.mark.parametrize("which", ["gcn_block", "pna_std"])
def test_inner_chain_matches_jax(which, request):
    jp, jb, tp, tb = request.getfixturevalue(which)
    k = 3
    c, out = tp._inner_chain(k)(tb, torch.zeros(()))
    # JAX: the carry after k - 1 forwards, then the k-th forward
    c_prev = jp._inner_chain_fn(k - 1)(jp.params, jb, jnp.zeros(()))
    want = np.asarray(jp.forward(jb.with_node_feat(
        jb.node_feat + c_prev.astype(jb.node_feat.dtype) * 1e-30)))
    m = tb.graph_mask.numpy()
    np.testing.assert_allclose(out.numpy()[m], want[m], atol=ATOL,
                               rtol=RTOL)
    c_jax = jp._inner_chain_fn(k)(jp.params, jb, jnp.zeros(()))
    np.testing.assert_allclose(float(c), float(c_jax), atol=ATOL, rtol=RTOL)
    # dynamic: one forward's chain run k times is the same chain
    one = tp._inner_chain(1)
    cd = torch.zeros(())
    for _ in range(k):
        cd, od = one(tb, cd)
    assert torch.equal(cd, c) and torch.equal(od, out)


def test_inner_fit():
    # a resolved fit: slope and intercept
    lat, over, ok = program_mod._inner_fit({1: 3e-3, 5: 11e-3}, 1, 5)
    assert ok and lat == pytest.approx(2e-3) and over == pytest.approx(1e-3)
    # flat in k, or a negative slope: the t_hi / k_hi upper bound, never
    # a near-zero time
    for times in ({1: 1e-3, 5: 1.1e-3}, {1: 2e-3, 5: 1e-3},
                  {1: 1e-9, 5: 1e-9}):
        lat, over, ok = program_mod._inner_fit(times, 1, 5)
        assert ok is False and lat == times[5] / 5 and over == 0.0


def test_degenerate_fit_is_flagged_not_zeroed(monkeypatch):
    """A clamped marginal estimate (~1e-9) is retried at a widened gap and
    at the widest; still clamped, the fit is unresolved."""
    calls = []

    def clamped(fn, **kw):
        calls.append(kw)
        return 1e-9

    monkeypatch.setattr(timing, "marginal_time", clamped)
    times = {k: program_mod._inner_marginal(lambda: None, 8, 3)
             for k in (1, 5)}
    assert [c.get("n_hi") for c in calls] == [8, 150, 400] * 2
    assert program_mod._inner_fit(times, 1, 5)[2] is False


def test_benchmark_inner_refuses_cpu(gcn_block):
    with pytest.raises(RuntimeError, match="measures the card"):
        gcn_block[2].benchmark_inner(gcn_block[3])


# ------------------------------------------------------------ cost_analysis
def _small(conv, pooling=("add", "mean", "max")):
    gs, (b,) = canonical_batches("qm9", n_graphs=8, batch_size=8,
                                 device="cpu")
    m = GNNModel(graph_input_feature_dim=b.feature_dim, gnn_hidden_dim=16,
                 gnn_num_layers=1, gnn_output_dim=12, gnn_conv=conv,
                 pooling_aggrs=pooling, mlp_hidden_dim=10,
                 mlp_hidden_layers=1, mlp_out_dim=2)
    p = Program(m, max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, device="cpu")
    return p, b


def _head_counts(N, G, F, A, dims):
    """Pooling and MLP (flops, bytes) at f32, by the rules."""
    flops = A * N * F + sum(2 * G * i * o for i, o in zip(dims, dims[1:]))
    nbytes = 4 * N * F + 8 * G + 4 * G * A * F + sum(
        4 * G * i + 4 * (i * o + o) + 4 * G * o
        for i, o in zip(dims, dims[1:]))
    return flops, nbytes


@pytest.mark.parametrize("conv", ["gcn", "pna"])
def test_cost_analysis_hand_counts(conv):
    p, b = _small(conv)
    N, G, Fi, Fo = b.num_nodes, b.num_graphs, b.feature_dim, 12
    E = int(b.edge_mask.sum())
    if conv == "gcn":
        flops = 2 * N * Fi * Fo + E * Fo
        params = Fi * Fo + Fo
    else:
        # pre_nn [Fi, 2 Fi] (u and v), post_nn [Fo, Fi + 12 Fi], lin
        flops = (2 * N * 2 * Fi * Fi + 2 * N * 13 * Fi * Fo
                 + 2 * N * Fo * Fo + 5 * E * Fi)
        params = 2 * Fi * Fi + Fi + 13 * Fi * Fo + Fo + Fo * Fo + Fo
    nbytes = 4 * N * Fi + 4 * (E + N) + 4 * params + 4 * N * Fo
    hf, hb = _head_counts(N, G, Fo, 3, [3 * Fo, 10, 2])
    cost = p.cost_analysis(b)
    assert cost["flops"] == flops + hf
    assert cost["bytes accessed"] == nbytes + hb
    assert cost["output_size_in_bytes"] == 4 * G * 2
    assert cost["argument_size_in_bytes"] == sum(
        roofline.batch_nbytes(b).values()) + 4 * sum(
        v.numel() for v in p.params.values())


@pytest.mark.parametrize("which", ["gcn_block", "pna_std"])
def test_cost_analysis_same_on_every_route(which, request):
    tp, tb = request.getfixturevalue(which)[2:]
    auto = tp.cost_analysis(tb)
    dispatch.set_fused_mode("never")
    try:
        never = tp.cost_analysis(tb)
    finally:
        dispatch.set_fused_mode("auto")
    assert auto == never


@pytest.mark.parametrize("conv", ["gcn", "pna", "gin", "sage", "gat",
                                  "gine", "edge", "lg", "simple"])
def test_cost_analysis_keeps_flops_across_policies(conv):
    gs, (b,) = canonical_batches("qm9", n_graphs=4, batch_size=4,
                                 device="cpu")
    over = dict(gnn_num_layers=2, gnn_hidden_dim=16)
    if conv not in ("lg", "simple"):
        over["gnn_output_dim"] = 8
    if conv == "gat":
        over["conv_kwargs"] = {"heads": 2, "edge_dim": 4}
    costs = {}
    for policy in ("f32", "bf16", "int8"):
        m = canonical_model(conv, "qm9", graphs=gs, **over)
        if conv in ("lg", "simple"):
            _, (bb,) = canonical_batches("qm9", n_graphs=4, batch_size=4,
                                         node_dim=16, device="cpu")
        else:
            bb = b
        p = Program(m, max_nodes=bb.num_nodes, max_edges=bb.num_edges,
                    max_graphs=bb.num_graphs, precision=policy,
                    device="cpu")
        costs[policy] = p.cost_analysis(bb)
    assert costs["f32"]["flops"] == costs["bf16"]["flops"] \
        == costs["int8"]["flops"] > 0
    f32, bf16, int8 = (costs[k]["bytes accessed"]
                       for k in ("f32", "bf16", "int8"))
    assert bf16 < f32 and int8 < f32


def test_cost_analysis_keys(gcn_block):
    jp, jb, tp, tb = gcn_block
    cost = tp.cost_analysis(tb)
    # bench.py's sweep and dse/measure.py read these
    for key in ("flops", "bytes accessed"):
        assert isinstance(cost[key], float) and cost[key] > 0
    assert float(cost.get("peak_hbm_bytes", 0.0)) == 0.0   # CPU: absent
    assert {"argument_size_in_bytes", "output_size_in_bytes"} <= set(cost)
    assert {"flops", "bytes accessed", "argument_size_in_bytes",
            "output_size_in_bytes"} <= set(jp.cost_analysis(jb))
    # the JAX package's example batch when none is given
    assert tp.cost_analysis()["flops"] > 0

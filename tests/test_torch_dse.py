"""The port's design-space exploration (``gnnbuilder_tpu_torch.dse``)
against the JAX package's, on the CPU: the space and its sampling, the
feature vectors (bit for bit), the cost model's fit, predictions and
cross-validation (rtol 1e-12 on the same rows), ``measure_many``'s CSV
(byte for byte), the design point's geometry and forward (atol 5e-4 /
rtol 1e-3 on ``graph_mask`` rows, weights through
``port.params_from_jax``), the knobs (``set_kernel_overrides``,
``set_default_ell_width``), ``DSEEngine.from_pretrained`` on the card
corpus shipped with the package, ``tune_kernels`` and
``dse_speedup_report``.  The JAX fits are shared through module-scoped
fixtures."""

import csv
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.bench.canonical import (
    canonical_batches as jax_canonical_batches,
)
from gnnbuilder_tpu.compile.program import Program as JaxProgram
from gnnbuilder_tpu.data.datasets import DATASET_SPECS as JAX_SPECS
from gnnbuilder_tpu.dse import analysis as jax_analysis
from gnnbuilder_tpu.dse import engine as jax_engine
from gnnbuilder_tpu.dse import measure as jax_measure
from gnnbuilder_tpu.dse import model as jax_model
from gnnbuilder_tpu.dse import space as jax_space
from gnnbuilder_tpu.ops import dispatch as jax_dispatch
from gnnbuilder_tpu_torch.core import graph
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.data.datasets import FakeDataset
from gnnbuilder_tpu_torch.dse import analysis, engine, measure, model, space
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.port import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CORPUS = os.path.join(ROOT, "dse_models", "perf_data.csv")
JAX_CORPUS_R1 = os.path.join(ROOT, "dse_models", "perf_data_r1.csv")
ATOL, RTOL = 5e-4, 1e-3
TPU_KNOBS = ("tile_rows", "gather_mode", "window_mode", "sub_rows")

# tests/test_dse.py's axes
TINY_AXES = {
    "conv": ["gcn", "gin"],
    "gnn_hidden_dim": [16, 32],
    "gnn_output_dim": [8],
    "gnn_num_layers": [2, 3],
    "gnn_skip_connection": [False],
    "mlp_hidden_dim": [8],
    "mlp_hidden_layers": [1],
    "batch_size": [4],
    "precision": ["f32"],
    "ell_width": [None, 0],
}


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _dicts(cfgs):
    return [c.to_dict() for c in cfgs]


def _jax_cfgs(cfgs):
    return [jax_space.DSEConfig(**c.to_dict()) for c in cfgs]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The fits on one BLAS and OpenMP thread.  The Huber fit's L-BFGS-B
    calls scipy's own BLAS thousands of times on tiny vectors; on eight
    threads a call it took ~200x longer when the test workers shared the
    cores.  scipy's BLAS is loaded by the import below, so that the limit
    reaches it."""
    import sklearn.linear_model  # noqa: F401
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1):
        yield


@pytest.fixture(autouse=True)
def _knobs_restored():
    """Every test leaves both packages' knobs at their policies."""
    yield
    dispatch.set_kernel_overrides(None, None, None, None, None, None)
    jax_dispatch.set_kernel_overrides(None, None, None, None, None, None)


# ------------------------------------------------------------------ space
def test_default_axes_are_jax_but_for_the_tpu_schedule_knobs():
    assert list(space.DEFAULT_AXES) == list(jax_space.DEFAULT_AXES)
    for k, v in space.DEFAULT_AXES.items():
        if k in TPU_KNOBS:
            assert v == [None] and len(jax_space.DEFAULT_AXES[k]) > 1, k
        else:
            assert v == jax_space.DEFAULT_AXES[k], k
    assert space.space_size() == 8064 == len(list(space.full_space()))
    assert ([f.name for f in dataclasses.fields(space.DSEConfig)]
            == [f.name for f in dataclasses.fields(jax_space.DSEConfig)])
    assert space.DSEConfig().to_dict() == jax_space.DSEConfig().to_dict()


@pytest.mark.parametrize("axes", ["tiny", "port_default"])
def test_full_space_and_samples_match_jax(axes):
    ax = TINY_AXES if axes == "tiny" else space.DEFAULT_AXES
    assert space.space_size(ax) == jax_space.space_size(ax)
    assert (_dicts(space.full_space(ax))
            == _dicts(jax_space.full_space(ax)))
    for seed in (0, 3):
        n = min(10, space.space_size(ax))
        assert (_dicts(space.sample_space(n, seed=seed, axes=ax))
                == _dicts(jax_space.sample_space(n, seed=seed, axes=ax)))


def test_samples_of_the_jax_default_axes_match_jax():
    ax = jax_space.DEFAULT_AXES
    assert space.space_size(ax) == jax_space.space_size()
    assert (_dicts(space.sample_space(50, seed=1, axes=ax))
            == _dicts(jax_space.sample_space(50, seed=1)))


# --------------------------------------------------------------- features
def test_feature_schema_is_jax():
    assert model.CONV_ONE_HOT == jax_model.CONV_ONE_HOT
    assert model.FEATURE_NAMES == jax_model.FEATURE_NAMES
    assert model._CONV_MM == jax_model._CONV_MM
    assert model._FAST_ROUTE_US == jax_model._FAST_ROUTE_US


@pytest.mark.parametrize("which", ["port_axes", "jax_axes"])
def test_transform_x_bit_equal_on_samples(which):
    if which == "port_axes":
        cfgs = space.sample_space(50, seed=0)
    else:   # the TPU knobs set: their columns must match too
        cfgs = [space.DSEConfig(**c.to_dict())
                for c in jax_space.sample_space(50, seed=2)]
    got = model.transform_x(cfgs)
    want = jax_model.transform_x(_jax_cfgs(cfgs))
    assert got.dtype == want.dtype == np.float64
    assert got.shape == (50, len(model.FEATURE_NAMES))
    assert np.array_equal(got, want)
    for c, x in zip(cfgs, got):
        n, ratio, e = model._padded_geometry(c)
        assert (n, ratio, e) == jax_model._padded_geometry(
            jax_space.DSEConfig(**c.to_dict()))


@pytest.mark.parametrize("path", [JAX_CORPUS, JAX_CORPUS_R1],
                         ids=["perf_data", "perf_data_r1"])
def test_rows_to_configs_and_transform_x_on_the_jax_corpora(path):
    rows = _rows(path)
    cfgs = model.rows_to_configs(rows)
    jcfgs = jax_model.rows_to_configs(rows)
    assert _dicts(cfgs) == _dicts(jcfgs)
    assert np.array_equal(model.transform_x(cfgs),
                          jax_model.transform_x(jcfgs))
    if path == JAX_CORPUS:
        assert len(rows) == 522


# ------------------------------------------------------------- cost model
def _corpus_slice(n_fast, n_slow):
    """Rows of the JAX corpus in file order: the first ``n_fast`` below
    the specialist's 300 us route and the first ``n_slow`` above it."""
    rows = _rows(JAX_CORPUS)
    lat = [float(r["latency_us"]) for r in rows]
    fast = [r for r, t in zip(rows, lat) if t < model._FAST_ROUTE_US]
    slow = [r for r, t in zip(rows, lat) if t >= model._FAST_ROUTE_US]
    return fast[:n_fast] + slow[:n_slow]


@pytest.fixture(scope="module")
def fit60():
    """Both packages' CostModel fit on the same 60 corpus rows (30 fast,
    so the specialist fits), and their predictions over the corpus."""
    rows = _corpus_slice(30, 30)
    y = np.asarray([float(r["latency_us"]) for r in rows])
    ours = model.CostModel().fit(model.rows_to_configs(rows), y)
    ref = jax_model.CostModel().fit(jax_model.rows_to_configs(rows), y)
    allc = model.rows_to_configs(_rows(JAX_CORPUS))
    return dict(ours=ours, ref=ref, cfgs=allc,
                got=ours.predict(allc),
                want=ref.predict(_jax_cfgs(allc)))


def test_cost_model_fit_and_predict_match_jax(fit60):
    assert fit60["ours"].fast_pipeline_ is not None
    assert fit60["ref"].fast_pipeline_ is not None
    assert np.all(np.isfinite(fit60["got"])) and np.all(fit60["got"] > 0)
    np.testing.assert_allclose(fit60["got"], fit60["want"], rtol=1e-12)


def test_cost_model_pickle_round_trip(fit60, tmp_path):
    p = str(tmp_path / "model.pk")
    fit60["ours"].save(p)
    loaded = model.CostModel.load(p)
    assert np.array_equal(loaded.predict(fit60["cfgs"]), fit60["got"])
    pred, floors = loaded.predict_with_noise_floor(fit60["cfgs"][:20])
    assert np.array_equal(pred, fit60["got"][:20])
    assert list(floors) == [model.label_noise_floor(v) for v in pred]


def test_cv_mape_and_banded_match_jax():
    rows = _corpus_slice(20, 20)
    y = np.asarray([float(r["latency_us"]) for r in rows])
    cfgs = model.rows_to_configs(rows)
    jcfgs = jax_model.rows_to_configs(rows)
    np.testing.assert_allclose(model.cv_mape(cfgs, y, folds=2),
                               jax_model.cv_mape(jcfgs, y, folds=2),
                               rtol=1e-12)
    got = model.cv_mape_banded(cfgs, y, folds=2, band_by=y)
    want = jax_model.cv_mape_banded(jcfgs, y, folds=2, band_by=y)
    assert list(got) == list(want) and len(got) >= 2
    for band in want:
        assert got[band]["n"] == want[band]["n"]
        np.testing.assert_allclose(got[band]["mape"], want[band]["mape"],
                                   rtol=1e-12)


def test_dse_speedup_report_has_jax_keys(fit60, monkeypatch):
    """The report on the same rows and the same fitted models (the fit
    and its CV are held above): JAX's keys, counts and measure cost."""
    rows = _corpus_slice(6, 6)
    monkeypatch.setattr(analysis, "fit_cost_model",
                        lambda r: (fit60["ours"], 0.25))
    monkeypatch.setattr(jax_analysis, "fit_cost_model",
                        lambda r: (fit60["ref"], 0.25))
    got = analysis.dse_speedup_report(rows, n_timing_reps=2)
    want = jax_analysis.dse_speedup_report(rows, n_timing_reps=2)
    assert list(got) == list(want)
    for k in ("num_designs", "cv_mape", "measure_s_per_design"):
        assert got[k] == want[k], k
    assert got["predict_s_per_design"] > 0 and got["speedup"] > 0


# ------------------------------------------------------------ measurement
def _fake_measure(extra=False):
    """A stand-in for measure_config: a fixed row per config (a float, a
    bool, None and a string among its values), raising for gin at hidden
    32; ``extra`` adds a column."""
    def fake(cfg, dataset="qm9", iters=15, **kw):
        if cfg.conv == "gin" and cfg.gnn_hidden_dim == 32:
            raise RuntimeError("a design point that fails")
        row = dict(cfg.to_dict())
        row.update(dataset=dataset, num_nodes=8 * cfg.gnn_hidden_dim,
                   latency_us=cfg.gnn_hidden_dim * 1.25 + iters / 3.0,
                   protocol="inner", flops=float(cfg.gnn_num_layers))
        if extra:
            row["overhead_us"] = 0.5 * cfg.gnn_num_layers
        return row
    return fake


def test_measure_many_csv_is_jax_byte_for_byte(tmp_path, monkeypatch,
                                               capsys):
    cfgs = list(space.full_space(TINY_AXES))
    ours, ref = tmp_path / "ours.csv", tmp_path / "ref.csv"
    stages = [(cfgs[:5], False), (cfgs[:9], False), (cfgs, True)]
    for part, extra in stages:
        monkeypatch.setattr(measure, "measure_config", _fake_measure(extra))
        monkeypatch.setattr(jax_measure, "measure_config",
                            _fake_measure(extra))
        got = measure.measure_many(part, dataset="esol", iters=4,
                                   out_csv=str(ours))
        out_ours = capsys.readouterr().out
        want = jax_measure.measure_many(_jax_cfgs(part), dataset="esol",
                                        iters=4, out_csv=str(ref))
        out_ref = capsys.readouterr().out
        # resume: rows read back from the file compare as strings
        assert got == want
        assert out_ours == out_ref
        assert ours.read_bytes() == ref.read_bytes()
    assert "FAILED" in out_ours      # the last stage's gin h32 points
    header = ours.read_text().splitlines()[0].split(",")
    assert header[-1] == "overhead_us"   # the union-schema rewrite
    assert len(_rows(str(ours))) == 12


def test_measure_config_refuses_the_cpu():
    graph.set_default_ell_width(None)
    cfg = space.DSEConfig(conv="gcn", gnn_hidden_dim=16, batch_size=4)
    with pytest.raises(RuntimeError, match="times the card"):
        measure.measure_config(cfg, device="cpu")
    with pytest.raises(ValueError, match="tile_rows"):
        dispatch.set_kernel_overrides(tile_rows=cfg.tile_rows or 256)
    assert graph._DEFAULT_ELL_WIDTH is None and dispatch._BLOCK is None


POINTS = {
    "gcn_block": dict(conv="gcn", block_size=128),
    "pna_ell0": dict(conv="pna", ell_width=0),
}
SMALL = dict(gnn_hidden_dim=16, gnn_output_dim=8, gnn_num_layers=2,
             mlp_hidden_dim=8, mlp_hidden_layers=1, batch_size=8)


def _jax_point(cfg, dataset="qm9", seed=0):
    """The JAX package's measure_config construction, untimed: (model,
    batch, Program with its seeded params)."""
    spec = JAX_SPECS[dataset]
    eq = cfg.conv in ("lg", "simple")
    if eq:
        cfg = dataclasses.replace(cfg, gnn_output_dim=cfg.gnn_hidden_dim)
    node_dim = cfg.gnn_hidden_dim if eq else spec.node_dim
    m = jax_measure._build_model(cfg, node_dim, spec.edge_dim)
    _, batches = jax_canonical_batches(
        dataset, n_graphs=max(cfg.batch_size, 32) * 2,
        batch_size=cfg.batch_size, seed=seed,
        node_multiple=256 if cfg.batch_size >= 64 else 8,
        block_size=cfg.block_size, node_dim=node_dim if eq else None)
    b = batches[0]
    if cfg.ell_width == 0 and b.nbr_nodes is not None:
        b = b.replace(nbr_nodes=None, nbr_edges=None)
    p = JaxProgram(m, max_nodes=b.num_nodes, max_edges=b.num_edges,
                   max_graphs=b.num_graphs, precision=cfg.precision)
    params = jax.tree.map(np.asarray, p.init_params(b))
    return p, b, params


def _forward_pair(cfg):
    jp, jb, params = _jax_point(jax_space.DSEConfig(**cfg.to_dict()))
    ours, prog, batch = measure._design_point(cfg, "qm9", 0, "cpu")
    prog.set_params(params_from_jax(params))
    with torch.no_grad():
        got = prog.forward(batch).numpy()
    want = np.asarray(jp.forward(jb))
    m = np.asarray(jb.graph_mask)
    assert np.array_equal(batch.graph_mask.numpy(), m)
    return ours, batch, got[m], want[m]


@pytest.mark.parametrize("name", list(POINTS))
def test_design_point_matches_jax_measure_config(name):
    """Geometry against a JAX ``measure_config(timing_only=True)`` row;
    the forward against the JAX Program on the same weights."""
    cfg = space.DSEConfig(**SMALL, **POINTS[name])
    row = jax_measure.measure_config(jax_space.DSEConfig(**cfg.to_dict()),
                                     dataset="qm9", iters=3, repeats=1,
                                     timing_only=True)
    ours, batch, got, want = _forward_pair(cfg)
    for k in ("avg_nodes", "avg_edges", "gnn_hidden_dim", "gnn_output_dim",
              "gnn_num_layers", "block_size", "ell_width"):
        assert getattr(ours, k) == row[k], k
    assert (batch.num_nodes, batch.num_edges) == (row["num_nodes"],
                                                  row["num_edges"])
    assert (batch.nbr_nodes is None) == (cfg.ell_width == 0)
    assert (batch.block_adj is not None) == bool(cfg.block_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_same_width_design_point_matches_jax():
    """LG runs at input == hidden == output on zero-padded features."""
    cfg = space.DSEConfig(**dict(SMALL, conv="lg", batch_size=4))
    ours, batch, got, want = _forward_pair(cfg)
    assert ours.gnn_output_dim == ours.gnn_hidden_dim == 16
    assert batch.node_feat.shape[1] == 16
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------ knobs
def test_ell_width_override_reaches_packing():
    """JAX's ``test_ell_width_override_reaches_packing`` on the port:
    ell_width=0 packs no table, None restores the automatic policy, an
    explicit width wins over the default, an omitted knob is left as it
    is (the port's other knob is block_mode)."""
    graphs = FakeDataset(num_graphs=4, avg_num_nodes=8, node_dim=4, seed=0)
    dispatch.set_kernel_overrides(ell_width=0)
    b0 = build_graph_batch(graphs, device="cpu")
    assert b0.nbr_nodes is None and b0.rev_nbr_nodes is None
    dispatch.set_kernel_overrides(ell_width=None)
    b1 = build_graph_batch(graphs, device="cpu")
    assert b1.nbr_nodes is not None
    dispatch.set_kernel_overrides(ell_width=0)
    b2 = build_graph_batch(graphs, ell_width=int(b1.nbr_nodes.shape[1]),
                           device="cpu")
    assert b2.nbr_nodes is not None
    dispatch.set_kernel_overrides(block_mode="off")
    b3 = build_graph_batch(graphs, device="cpu")
    assert b3.nbr_nodes is None and dispatch._BLOCK == "off"
    assert torch.equal(b0.node_feat, b1.node_feat)
    # the JAX package packs the same layouts under the same knob
    from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
    from gnnbuilder_tpu.data.datasets import FakeDataset as JaxFake

    jax_dispatch.set_kernel_overrides(ell_width=0)
    jb = jax_build(JaxFake(num_graphs=4, avg_num_nodes=8, node_dim=4,
                           seed=0))
    assert jb.nbr_nodes is None
    assert np.array_equal(np.asarray(jb.node_feat), b0.node_feat.numpy())


@pytest.mark.parametrize("knob,value", [
    ("tile_rows", 256), ("gather_mode", "bf16"), ("window_mode", "tile"),
    ("sub_rows", 256), ("block_mode", "fused"), ("block_mode", "split2"),
    ("block_mode", "bf16"), ("block_mode", "highest"),
    ("block_mode", "sideways")])
def test_tpu_knobs_raise_and_set_nothing(knob, value):
    dispatch.set_kernel_overrides(ell_width=0, block_mode="off")
    with pytest.raises(ValueError, match=knob):
        dispatch.set_kernel_overrides(
            **{"ell_width": None, "block_mode": None, knob: value})
    assert graph._DEFAULT_ELL_WIDTH == 0 and dispatch._BLOCK == "off"
    dispatch.set_kernel_overrides(**{knob: None})   # None is the policy
    assert graph._DEFAULT_ELL_WIDTH == 0
    assert dispatch._BLOCK == (None if knob == "block_mode" else "off")


def test_block_mode_off_declines_the_block_routes():
    """Under block_mode="off" a block-packed batch takes no block route
    (block product, stacks, block kernels, the mp layer's block mode):
    the convs run as on a standard batch, to the same outputs."""
    for conv in ("gcn", "pna"):
        cfg = space.DSEConfig(**dict(SMALL, conv=conv, block_size=128))
        _, prog, b = measure._design_point(cfg, "qm9", 0, "cpu")
        with torch.no_grad():
            before = prog.forward(b)
            with dispatch.inference_mode():
                assert dispatch.block_cfg(b) is not None
                assert dispatch.mp_layer_cfg(b, "gcn") == {"block": True}
                assert dispatch.pna_stack_cfg(b) is not None
                dispatch.set_kernel_overrides(block_mode="off")
                assert dispatch.block_cfg(b) is None
                assert dispatch.mp_layer_cfg(b, "gcn") == {}
                assert dispatch.mp_layer_cfg(b, "gin") == {}
                for gate in (dispatch.pna_stack_cfg,
                             lambda g: dispatch.mp_stack_cfg(g, "gcn"),
                             lambda g: dispatch.gat_block_cfg(g, "relu"),
                             lambda g: dispatch.edge_block_cfg(g, "relu")):
                    assert gate(b) is None
            after = prog.forward(b)
            dispatch.set_kernel_overrides(block_mode=None)
        m = b.graph_mask
        err = (after[m] - before[m]).abs().max()
        assert err <= 1e-5 * before[m].abs().max(), (conv, float(err))


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """``DSEEngine.from_pretrained()`` on the shipped card corpus, cached
    in a temporary directory, beside a JAX CostModel fit on the same
    rows."""
    mp = pytest.MonkeyPatch()
    mp.setattr(engine, "CACHE_DIR", str(tmp_path_factory.mktemp("dse")))
    try:
        eng = engine.DSEEngine.from_pretrained()
        path = os.path.join(engine.corpus_dir(), "model_direct.pk")
        assert os.path.exists(path)
        # a second engine loads the cache and fits nothing
        mp.setattr(engine, "fit_pretrained", None)
        again = engine.DSEEngine.from_pretrained()
    finally:
        mp.undo()
    rows = _rows(engine.CORPUS_CSV)
    kept = [r for r in rows if float(r["latency_us"]) > 1.0]
    y = np.asarray([float(r["latency_per_graph_us"]) for r in kept])
    ref = jax_model.CostModel(target="latency_per_graph_us").fit(
        jax_model.rows_to_configs(kept), y)
    return dict(eng=eng, again=again, ref=ref, rows=rows)


def test_card_corpus_parses_as_jax(pretrained):
    rows = pretrained["rows"]
    assert len(rows) >= 240
    cfgs = model.rows_to_configs(rows)
    assert _dicts(cfgs) == _dicts(jax_model.rows_to_configs(rows))
    assert all(getattr(c, k) is None for c in cfgs for k in TPU_KNOBS)
    assert {r["dataset"] for r in rows} == {"qm9", "esol", "hiv"}
    assert all(r["protocol"].startswith("inner") for r in rows)


def test_label_noise_bands_are_the_card_retest():
    """``LABEL_NOISE_BANDS`` holds the card's retest medians (to 4
    digits) at JAX's band edges."""
    import json

    with open(os.path.join(os.path.dirname(engine.CORPUS_CSV),
                           "label_retest.json")) as f:
        rt = json.load(f)
    assert "H100" in rt["nvidia_smi"] and not rt["failed"]
    assert len(rt["rows"]) == 24
    bands = rt["by_band_us"]
    meds = [bands[k]["median_rel_spread"]
            for k in ("0-500", "500-2000", ">=2000")]
    edges = [hi for hi, _ in model.LABEL_NOISE_BANDS]
    assert edges == [hi for hi, _ in jax_model.LABEL_NOISE_BANDS]
    np.testing.assert_allclose([v for _, v in model.LABEL_NOISE_BANDS],
                               meds, rtol=5e-4)
    for t, (_, v) in zip((40.0, 900.0, 5000.0), model.LABEL_NOISE_BANDS):
        assert model.label_noise_floor(t) == v


def test_from_pretrained_predicts_a_jax_fit(pretrained):
    cfgs = (model.rows_to_configs(pretrained["rows"])
            + space.sample_space(40, seed=5))
    got = pretrained["eng"].predict(cfgs)
    want = pretrained["ref"].predict(_jax_cfgs(cfgs))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.array_equal(pretrained["again"].predict(cfgs), got)


def test_tune_kernels_ranks_the_card_knobs(pretrained):
    dispatch.set_kernel_overrides(block_mode="off")
    r = pretrained["eng"].tune_kernels("pna", batch_size=1024, apply=True)
    ranked = r["ranked"]
    assert len(ranked) == 4
    assert {(c.ell_width, c.block_size) for c, _ in ranked} == {
        (None, 0), (None, 128), (0, 0), (0, 128)}
    preds = [p for _, p in ranked]
    assert preds == sorted(preds) and r["predicted_us_per_graph"] > 0
    want = pretrained["ref"].predict(_jax_cfgs([c for c, _ in ranked]))
    np.testing.assert_allclose(preds, want, rtol=1e-12)
    assert all(getattr(c, k) is None for c, _ in ranked for k in TPU_KNOBS)
    # the applied knobs: JAX's keys; ell_width reaches packing, the other
    # override is left as it was
    jeng = jax_engine.DSEEngine(dataset="qm9")
    jeng.cost_model = pretrained["ref"]
    jr = jeng.tune_kernels("pna", batch_size=1024, apply=True)
    assert list(r["applied"]) == list(jr["applied"])
    assert r["applied"] == {"tile_rows": None,
                            "ell_width": r["best"].ell_width,
                            "window_mode": None,
                            "block_size": r["best"].block_size}
    assert graph._DEFAULT_ELL_WIDTH == r["best"].ell_width
    assert dispatch._BLOCK == "off"
    r2 = pretrained["eng"].tune_kernels("gcn", apply=False)
    assert r2["applied"] == {} and len(r2["ranked"]) == 4


# ---------------------------------------------------------------- imports
def test_the_port_imports_without_scikit_learn():
    """``import gnnbuilder_tpu_torch`` and the DSE's feature path work
    with scikit-learn absent; fitting then raises ImportError."""
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "import gnnbuilder_tpu_torch as p\n"
        "from gnnbuilder_tpu_torch import dse\n"
        "x = dse.transform_x(dse.sample_space(3, seed=0))\n"
        "assert x.shape == (3, len(dse.model.FEATURE_NAMES))\n"
        "assert p.DSEEngine and p.CostModel and p.DSEConfig\n"
        "try:\n"
        "    p.CostModel().fit(dse.sample_space(3, seed=0), x[:, 0] + 1)\n"
        "except ImportError:\n"
        "    print('fit needs sklearn')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "fit needs sklearn"

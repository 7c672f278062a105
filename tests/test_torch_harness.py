"""The port's benchmark harness and report (``gnnbuilder_tpu_torch.bench.
harness`` / ``report``) against the JAX package's, on the CPU.

* the packing rule: for every default conv x dataset x batch size, the
  arguments that JAX's ``bench_tpu`` passes to ``canonical_batches``
  (captured by replacing that function at run time) are those the port's
  arms pass to its own, and ``_packing`` gives them;
* ``run_grid`` on gcn x esol with the CPU arms writes the same flat files
  (JAX's ``xla_cpu`` is the port's ``cpu``) and rows with the same keys
  as JAX's ``run_grid`` on the same arguments, merges into
  ``results.json`` as JAX's does, and every number is positive and
  finite;
* each arm takes the arguments of its JAX counterpart, with the same
  defaults, and no other; ``bench_gpu`` refuses a machine without a
  card; the CLI's default backend is ``gpu``;
* ``report.load_results``, ``pivot`` and ``dataset_stats_table`` give the
  JAX module's frames and strings on the same results directory, and
  ``plot_runtimes`` writes its figure;
* both modules import without pandas and matplotlib.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from gnnbuilder_tpu.bench import harness as jax_harness
from gnnbuilder_tpu.bench import report as jax_report
from gnnbuilder_tpu_torch.bench import harness
from gnnbuilder_tpu_torch.bench import report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH_SIZES = (1, 4, 256)
GRID = dict(convs=("gcn",), datasets=("esol",), verbose=False, n_graphs=8)
JAX_BACKENDS = ("xla_cpu", "torch_cpu", "torch_cpu_b4")
PORT_BACKENDS = ("cpu", "torch_cpu", "torch_cpu_b4")
JAX_NAME = dict(zip(PORT_BACKENDS, JAX_BACKENDS))


class _Captured(Exception):
    pass


def _capture(monkeypatch, module, call):
    """The keyword arguments of the first ``canonical_batches`` call that
    ``call()`` makes through ``module``'s function, which raises there."""
    seen = {}

    def fake(dataset, **kw):
        seen.update(kw, dataset=dataset)
        raise _Captured

    monkeypatch.setattr(module, "canonical_batches", fake)
    with pytest.raises(_Captured):
        call()
    return seen


@pytest.mark.parametrize("conv", jax_harness.DEFAULT_CONVS)
@pytest.mark.parametrize("dataset", jax_harness.DEFAULT_DATASETS)
def test_packing_matches_jax(monkeypatch, conv, dataset):
    import gnnbuilder_tpu.bench.canonical as jax_canonical
    import gnnbuilder_tpu_torch.bench.canonical as port_canonical

    for bs in BATCH_SIZES:
        want = _capture(monkeypatch, jax_canonical, lambda: jax_harness.
                        bench_tpu(conv, dataset, batch_sizes=(bs,)))
        got = _capture(monkeypatch, port_canonical, lambda: harness.
                       bench_cpu(conv, dataset, batch_sizes=(bs,),
                                 n_graphs=512))
        assert got.pop("device") == "cpu"  # the arm pins the CPU
        assert got == want, (bs, got, want)
        assert harness._packing(conv, dataset, bs) == (
            want["node_multiple"], want["block_size"])


def test_grid_constants_are_jax():
    assert harness.DEFAULT_CONVS == jax_harness.DEFAULT_CONVS
    assert harness.DEFAULT_DATASETS == jax_harness.DEFAULT_DATASETS
    assert harness.FPGA_PAR_BASELINE_S == jax_harness.FPGA_PAR_BASELINE_S
    assert set(harness._BACKENDS) == {"gpu", "cpu", "torch_cpu",
                                      "torch_cpu_b4"}


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """Both packages' grids on the CPU arms, each into its own directory
    (torch's thread count restored after the single-threaded arms)."""
    threads = torch.get_num_threads()
    try:
        jdir = tmp_path_factory.mktemp("jax_results")
        pdir = tmp_path_factory.mktemp("port_results")
        jrows = jax_harness.run_grid(backends=JAX_BACKENDS,
                                     results_dir=str(jdir), **GRID)
        prows = harness.run_grid(backends=PORT_BACKENDS,
                                 results_dir=str(pdir), **GRID)
    finally:
        torch.set_num_threads(threads)
    return jdir, jrows, pdir, prows


def test_run_grid_writes_the_jax_file_set(grids):
    jdir, _, pdir, _ = grids
    want = set()
    for f in os.listdir(jdir):
        for port, jax_name in JAX_NAME.items():
            f = f.replace(f"_{jax_name}_gcn_", f"_{port}_gcn_")
        want.add(f)
    assert set(os.listdir(pdir)) == want
    assert "latency_b4_s_cpu_gcn_esol.txt" in want


def test_run_grid_rows_have_the_jax_keys(grids):
    _, jrows, pdir, prows = grids
    assert [r["backend"] for r in prows] == list(PORT_BACKENDS)
    for jr, pr in zip(jrows, prows):
        assert set(pr) == set(jr), (pr["backend"], set(pr) ^ set(jr))
        for k, v in pr.items():
            if isinstance(v, float):
                assert math.isfinite(v) and v > 0, (pr["backend"], k, v)
    cpu = prows[0]
    assert cpu["best_batch_size"] in BATCH_SIZES
    for bs in BATCH_SIZES:
        assert cpu[f"graphs_per_s_b{bs}"] == pytest.approx(
            bs / cpu[f"latency_b{bs}_s"])
    with open(pdir / "latency_s_cpu_gcn_esol.txt") as f:
        assert float(f.read()) == cpu["latency_s"]
    with open(pdir / "results.json") as f:
        assert json.load(f) == json.loads(json.dumps(prows))


def test_run_grid_merges_results_json(tmp_path):
    prior = [dict(backend="gpu", conv="pna", dataset="qm9", latency_s=1.0),
             dict(backend="torch_cpu", conv="gcn", dataset="esol",
                  latency_s=2.0)]
    (tmp_path / "results.json").write_text(json.dumps(prior))
    threads = torch.get_num_threads()
    try:
        rows = harness.run_grid(backends=("torch_cpu",),
                                results_dir=str(tmp_path), **GRID)
    finally:
        torch.set_num_threads(threads)
    data = json.loads((tmp_path / "results.json").read_text())
    assert data[0] == prior[0]
    assert data[1:] == json.loads(json.dumps(rows))


def test_bench_gpu_refuses_a_machine_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        harness.bench_gpu("gcn", "qm9")


@pytest.mark.parametrize("port,jax_name", [
    ("bench_gpu", "bench_tpu"), ("bench_cpu", "bench_xla_cpu"),
    ("bench_torch_cpu", "bench_torch_cpu")])
def test_arms_take_the_jax_arms_arguments(port, jax_name):
    import inspect

    def params(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(getattr(harness, port)) == params(
        getattr(jax_harness, jax_name))


def test_cli_default_backend_is_the_card(monkeypatch):
    seen = {}
    monkeypatch.setattr(harness, "run_grid", lambda **kw: seen.update(kw))
    monkeypatch.setattr(sys, "argv", ["harness"])
    harness.main()
    assert seen["backends"] == ["gpu"]
    assert tuple(seen["convs"]) == jax_harness.DEFAULT_CONVS
    assert tuple(seen["datasets"]) == jax_harness.DEFAULT_DATASETS
    assert seen["n_graphs"] == 512


# ------------------------------------------------------------ report

def test_load_results_matches_jax(grids):
    import pandas as pd

    for d in (grids[0], grids[2]):
        want = jax_report.load_results(str(d))
        got = report.load_results(str(d))
        assert not got.empty
        pd.testing.assert_frame_equal(got, want)


def test_load_results_reads_results_json_without_flat_files(grids,
                                                            tmp_path):
    import pandas as pd

    (tmp_path / "results.json").write_text(
        (grids[2] / "results.json").read_text())
    pd.testing.assert_frame_equal(report.load_results(str(tmp_path)),
                                  jax_report.load_results(str(tmp_path)))


@pytest.mark.parametrize("metric,backend", [
    ("latency_s", None), ("latency_s", "cpu"), ("graphs_per_s", None),
    ("latency_b4_s", "cpu")])
def test_pivot_matches_jax(grids, metric, backend):
    import pandas as pd

    df = jax_report.load_results(str(grids[2]))
    got = report.pivot(df, metric, backend)
    pd.testing.assert_frame_equal(got, jax_report.pivot(df, metric,
                                                        backend))
    assert not got.empty


def test_plot_runtimes_writes_its_figure(grids, tmp_path):
    df = report.load_results(str(grids[2]))
    out = report.plot_runtimes(df, str(tmp_path / "runtimes.png"))
    assert os.path.getsize(out) > 0
    with pytest.raises(ValueError, match="no rows"):
        report.plot_runtimes(df, str(tmp_path / "none.png"), metric="x")


def test_dataset_stats_table_matches_jax():
    names = ("qm9", "esol", "hiv")
    assert report.dataset_stats_table(names, n=64) == \
        jax_report.dataset_stats_table(names, n=64)


def test_modules_import_without_pandas_and_matplotlib():
    code = ("import sys; sys.modules['pandas'] = None; "
            "sys.modules['matplotlib'] = None; "
            "import gnnbuilder_tpu_torch.bench.report as r; "
            "import gnnbuilder_tpu_torch.bench.harness as h; "
            "print(r.__all__, h.__all__)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "load_results" in res.stdout

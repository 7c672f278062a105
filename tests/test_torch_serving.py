"""The port's serving frontend (``gnnbuilder_tpu_torch/serve.py``
``GNNServer``, ``load_artifact``) and the Program parts it stands on
(``BucketSpec.fits``, ``Program.from_dataset``, ``compile``, ``export``,
``load_exported``, ``export_bundle``, ``load_bundle``), on the CPU.

The cases of the JAX package's ``tests/test_serving.py``: the server
against the direct forward, from an artifact and from a bundle, batches
split on overflow, static int8 calibration (here also frozen into the
bundle), block packing, a pipelined burst, and a deep queue filling
whole micro-batches.  Beside them: strict shapes reject an over-width
request at submit; ``fits`` and ``from_dataset`` against the JAX
package's on the same graphs; and the port's server of a GAT model
under the int8 policy against the JAX ``GNNServer`` with the same
weights (``port.params_from_jax``), at the whole-model tolerance atol
5e-4 / rtol 1e-3, with the int8 mode of the GAT layer kernel's function
reached from the server's thread.

Tolerances: a served prediction against a direct forward of the same
graphs 2e-5 (the JAX test's: another batch composition only reorders
nothing inside a graph's rows, so the values agree to float32 rounding
of the padded sums); a bundle against the live server bit for bit (the
same weights and functions).  Every wait has a timeout."""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu.compile.program import BucketSpec as JaxBucketSpec
from gnnbuilder_tpu.data.datasets import load_dataset as jax_load_dataset
from gnnbuilder_tpu.serve import GNNServer as JaxGNNServer
from gnnbuilder_tpu_torch import GNNModel, Program
from gnnbuilder_tpu_torch.compile.program import BucketSpec
from gnnbuilder_tpu_torch.data.datasets import load_dataset
from gnnbuilder_tpu_torch.ops.cuda import gat_layer
from gnnbuilder_tpu_torch.port import params_from_jax
from gnnbuilder_tpu_torch.serve import GNNServer, load_artifact

WAIT_S = 120.0
ATOL, RTOL = 5e-4, 1e-3


def _gcn(**kw):
    return GNNModel(graph_input_feature_dim=9, gnn_hidden_dim=16,
                    gnn_num_layers=2, gnn_output_dim=8, gnn_conv="gcn",
                    pooling_aggrs=("mean",), mlp_hidden_dim=8,
                    mlp_hidden_layers=1, mlp_out_dim=1, **kw)


@pytest.fixture(scope="module")
def setup():
    graphs = load_dataset("esol", n=24, seed=3)
    prog = Program(_gcn(), max_nodes=512, max_edges=1024, max_graphs=9,
                   device="cpu")
    prog.init_params()
    return graphs, prog


def test_server_matches_direct_forward(setup):
    graphs, prog = setup
    direct = [prog.forward(prog.batch([g])).numpy()[0] for g in graphs[:12]]
    with GNNServer.from_program(prog, prog.batch(graphs[:4])) as server:
        preds = server.predict(graphs[:12], timeout=WAIT_S)
        stats = server.stats()
    np.testing.assert_allclose(preds, np.stack(direct), rtol=2e-5, atol=2e-5)
    assert stats["served"] == 12
    assert stats["batches"] < 12      # micro-batching batched (8 a batch)
    assert stats["p50_ms"] > 0 and stats["p99_ms"] >= stats["p90_ms"] \
        >= stats["p50_ms"]


def test_server_from_artifact(tmp_path, setup):
    graphs, prog = setup
    path = str(tmp_path / "model.json")
    prog.export(path, prog.batch(graphs[:4]))
    direct = prog.forward(prog.batch(graphs[:3])).numpy()[:3]
    with GNNServer.from_artifact(path, prog.params, device="cpu") as server:
        assert server._strict
        preds = server.predict(graphs[:3], timeout=WAIT_S)
    np.testing.assert_allclose(preds, direct, rtol=2e-5, atol=2e-5)
    fn, spec = load_artifact(path, prog.params, device="cpu")
    assert spec["bucket"] == dataclasses.asdict(prog.bucket)
    b = prog.batch(graphs[:3])
    np.testing.assert_array_equal(fn(None, b).numpy(),
                                  prog.forward(b).numpy())


def test_server_from_bundle(tmp_path, setup):
    """The bundle (artifact + state dict) through a fresh server with
    nothing but the path: the live server's predictions, bit for bit."""
    graphs, prog = setup
    d = str(tmp_path / "bundle")
    prog.export_bundle(d, prog.batch(graphs[:4]))
    with GNNServer.from_program(prog, prog.batch(graphs[:4])) as live:
        want = live.predict(graphs[:6], timeout=WAIT_S)
    with GNNServer.from_bundle(d, device="cpu", max_batch=3) as server:
        preds = server.predict(graphs[:6], timeout=WAIT_S)
    np.testing.assert_allclose(preds, want, rtol=2e-5, atol=2e-5)
    fn, params = Program.load_bundle(d, device="cpu")
    assert set(params) == set(prog.params)
    for k, v in prog.params.items():
        assert torch.equal(params[k], v), k


def test_server_overflow_splits_batches(setup):
    graphs, prog = setup
    with GNNServer.from_program(prog, prog.batch(graphs[:4]),
                                max_wait_ms=30.0) as server:
        preds = server.predict(graphs[:20], timeout=WAIT_S)
        stats = server.stats()
    assert preds.shape[0] == 20
    assert stats["batches"] >= 3      # 8 real graphs a batch


def test_int8_static_calibration(tmp_path):
    graphs = load_dataset("esol", n=24, seed=3)
    prog = Program(_gcn(), max_nodes=512, max_edges=1024, max_graphs=9,
                   precision="int8", device="cpu")
    b0, b1 = prog.batch(graphs[:8]), prog.batch(graphs[8:16])
    prog.init_params()
    dyn = prog.forward(b1).numpy()
    scales = prog.calibrate_int8([b0, b1])
    assert scales and all(s > 0 for s in scales.values())
    assert any("mlp" in k for k in scales)
    static = prog.forward(b1).numpy()
    ref_scale = np.abs(dyn).max() + 1e-6
    assert np.abs(static - dyn).max() / ref_scale < 0.1
    f32 = Program(_gcn(), max_nodes=512, max_edges=1024, max_graphs=9,
                  device="cpu")
    f32.set_params(prog.params)
    full = f32.forward(b1).numpy()
    assert np.abs(static - full).max() / (np.abs(full).max() + 1e-6) < 0.15
    # the bundle freezes the scales: a served graph gets the static value
    d = str(tmp_path / "int8")
    prog.export_bundle(d, b0)
    with GNNServer.from_bundle(d, device="cpu") as server:
        preds = server.predict(graphs[8:16], timeout=WAIT_S)
    np.testing.assert_allclose(preds, static[:8], rtol=2e-5, atol=2e-5)
    assert Program.read_exported(f"{d}/model.json")["int8_scales"] == scales


def test_server_block_packed():
    graphs = load_dataset("qm9", n=24, seed=4)
    model = GNNModel(graph_input_feature_dim=11, gnn_hidden_dim=16,
                     gnn_num_layers=2, gnn_output_dim=8, gnn_conv="gin",
                     pooling_aggrs=("mean",), mlp_out_dim=1)
    prog = Program(model, max_nodes=1024, max_edges=2048, max_graphs=25,
                   block_size=128, device="cpu")
    b = prog.batch(graphs)
    prog.init_params()
    golden = prog.forward(b).numpy()[:24]
    with GNNServer.from_program(prog, batch_example=b) as srv:
        assert srv._block == 128
        out = srv.predict(graphs, timeout=WAIT_S)
    np.testing.assert_allclose(out[:, 0], golden[:, 0], atol=1e-5)


def test_server_pipelined_burst_correctness():
    graphs = load_dataset("esol", n=40, seed=7)
    model = GNNModel(graph_input_feature_dim=9, gnn_hidden_dim=16,
                     gnn_num_layers=2, gnn_output_dim=8, gnn_conv="gcn",
                     pooling_aggrs=("mean",), mlp_out_dim=1)
    prog = Program(model, max_nodes=256, max_edges=512, max_graphs=9,
                   device="cpu")
    b0 = prog.batch(graphs[:8])
    prog.init_params()
    goldens = []
    for i in range(0, 40, 8):
        goldens.extend(prog.forward(prog.batch(graphs[i:i + 8])).numpy()[
            :8, 0].tolist())
    with GNNServer.from_program(prog, batch_example=b0,
                                max_wait_ms=1.0) as srv:
        futs = [srv.submit(g) for g in graphs]
        outs = [float(f.result(timeout=WAIT_S)[0]) for f in futs]
        stats = srv.stats()
    assert stats["batches"] >= 2
    np.testing.assert_allclose(outs, goldens, atol=1e-5)


def test_deep_queue_fills_to_max_batch():
    """``max_wait`` bounds the wait for stragglers, not how many queued
    requests one micro-batch takes: behind a slow forward the queue fills,
    and the next batch takes all of it."""
    graphs = load_dataset("esol", n=48, seed=5)

    def slow_fn(batch):
        time.sleep(0.05)
        return torch.zeros((batch.num_graphs, 1))

    with GNNServer(slow_fn, None, node_budget=4096, edge_budget=8192,
                   graph_budget=49, max_wait_ms=0.0, device="cpu") as srv:
        futs = [srv.submit(g) for g in graphs]
        for f in futs:
            f.result(timeout=WAIT_S)
        st = srv.stats()
    assert st["served"] == 48
    assert st["batches"] <= 3, st


def test_close_fails_what_was_never_dispatched():
    """close() stops the threads within its timeout and fails the
    requests still queued."""
    import threading

    gate = threading.Event()
    graphs = load_dataset("esol", n=6, seed=5)

    def blocked(batch):
        gate.wait(timeout=WAIT_S)
        return torch.zeros((batch.num_graphs, 1))

    srv = GNNServer(blocked, None, node_budget=512, edge_budget=1024,
                    graph_budget=3, max_wait_ms=0.0, device="cpu")
    futs = [srv.submit(g) for g in graphs]
    time.sleep(0.2)
    gate.set()
    srv.close(timeout=WAIT_S)
    assert not srv._worker.is_alive() and not srv._resolver.is_alive()
    for f in futs:
        assert f.done()


def test_strict_shapes_reject_an_over_width_request(tmp_path, setup):
    """A request past the artifact's ELL width or largest-graph bound
    fails at submit with the reason, without reaching the queue."""
    graphs, prog = setup
    path = str(tmp_path / "model.json")
    example = prog.batch(graphs[:4])
    prog.export(path, example)
    star = dataclasses.replace(graphs[0], edge_index=np.stack([
        np.arange(1, graphs[0].x.shape[0]),
        np.zeros(graphs[0].x.shape[0] - 1, np.int64)]))
    assert star.edge_index.shape[1] > example.ell_width
    big = dataclasses.replace(graphs[0], x=np.zeros(
        (example.max_graph_nodes_static + 1, 9), np.float32),
        edge_index=np.zeros((2, 0), np.int64))
    with GNNServer.from_artifact(path, prog.params, device="cpu") as server:
        for g, why in ((star, "in-degree"), (big, "nodes")):
            fut = server.submit(g)
            assert fut.done() and server._q.qsize() == 0
            with pytest.raises(ValueError, match=why):
                fut.result(timeout=WAIT_S)
        ok = server.predict(graphs[:2], timeout=WAIT_S)
    assert np.isfinite(ok).all()
    # a live Program's server packs such a request at its own width
    with GNNServer.from_program(prog, example) as live:
        assert np.isfinite(live.predict([star], timeout=WAIT_S)).all()


@pytest.mark.parametrize("block_size", [0, 128])
def test_bucket_fits_and_from_dataset_match_jax(block_size):
    graphs = load_dataset("qm9", n=64, seed=2)
    jgraphs = jax_load_dataset("qm9", n=64, seed=2)
    model = GNNModel(graph_input_feature_dim=11, gnn_hidden_dim=16,
                     gnn_num_layers=1, gnn_output_dim=8, gnn_conv="gcn")
    jmodel = gnnb.GNNModel(graph_input_feature_dim=11, gnn_hidden_dim=16,
                           gnn_num_layers=1, gnn_output_dim=8,
                           gnn_conv="gcn")
    for bs, hr in ((1, 1.0), (16, 1.0), (64, 1.25)):
        ours = Program.from_dataset(model, graphs, batch_size=bs,
                                    headroom=hr, block_size=block_size,
                                    device="cpu")
        theirs = gnnb.Program.from_dataset(jmodel, jgraphs, batch_size=bs,
                                           headroom=hr,
                                           block_size=block_size)
        assert dataclasses.asdict(ours.bucket) == dataclasses.asdict(
            theirs.bucket)
        assert ours.block_size == theirs.block_size
        # every batch of bs graphs drawn from the dataset packs
        ours.batch(graphs[-bs:])
    rng = np.random.default_rng(0)
    for _ in range(200):
        spec = tuple(int(v) for v in rng.integers(1, 60, size=3))
        n, e, g = (int(v) for v in rng.integers(0, 70, size=3))
        assert BucketSpec(*spec).fits(n, e, g) == JaxBucketSpec(
            *spec).fits(n, e, g)


def test_gat_int8_server_matches_jax_server(monkeypatch):
    """A 2-layer GAT (heads 2) under the int8 policy, block-packed, served
    by both packages from the same weights: every prediction within atol
    5e-4 / rtol 1e-3 of the JAX server's, each layer through the int8
    mode of the layer kernel's function in the server's thread."""
    graphs = load_dataset("qm9", n=40, seed=6)
    jgraphs = jax_load_dataset("qm9", n=40, seed=6)
    over = dict(graph_input_feature_dim=11, gnn_hidden_dim=16,
                gnn_num_layers=2, gnn_output_dim=8, gnn_conv="gat",
                pooling_aggrs=("add", "mean", "max"), mlp_out_dim=1,
                conv_kwargs={"heads": 2})
    jprog = gnnb.Program.from_dataset(gnnb.GNNModel(**over), jgraphs,
                                      batch_size=16, block_size=128,
                                      precision="int8")
    jb = jprog.batch(jgraphs[:8])
    jprog.init_params(jb)
    prog = Program.from_dataset(GNNModel(**over), graphs, batch_size=16,
                                block_size=128, precision="int8",
                                device="cpu")
    prog.set_params(params_from_jax(jax.tree.map(np.asarray, jprog.params)))
    with JaxGNNServer.from_program(jprog, jb) as jsrv:
        want = jsrv.predict(jgraphs, timeout=WAIT_S)
    modes = []
    fn = gat_layer.fused_gat_layer

    def counted(*a, **k):
        modes.append(k.get("mode", "f32"))
        return fn(*a, **k)

    with GNNServer.from_program(prog, prog.batch(graphs[:8])) as srv:
        monkeypatch.setattr(gat_layer, "fused_gat_layer", counted)
        got = srv.predict(graphs, timeout=WAIT_S)
        batches = srv.stats()["batches"]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert modes == ["int8"] * (2 * batches), modes

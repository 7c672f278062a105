"""The port's demos (``gnnbuilder_tpu_torch.demos``) against the JAX
package's (``demos/``), on the CPU at a small size.

Each demo's ``main`` runs with ``--device cpu`` from weights drawn with
numpy into the JAX tree (``test_torch_parallel._weights``), carried to
the port by ``port.params_from_jax`` and loaded with ``--params``.  It
must print the lines its JAX counterpart prints (the same leading
words), and its numbers are held against the JAX package's flow on the
same weights and graphs at the ``Program`` tolerance (atol 5e-4 / rtol
1e-3): ``simple_test``'s forward; ``demo``'s per-epoch Adam losses, its
scores and ROC-AUC (atol 1e-3); ``serve_demo``'s served predictions.
Times are printed, not compared.  The parity MAEs are the port's own
golden round trip (0 in both packages' demos), held at 5e-4.
"""

import jax
import numpy as np
import optax
import torch

import gnnbuilder_tpu as jgnnb
from gnnbuilder_tpu.data.datasets import FakeDataset as JaxFakeDataset
from gnnbuilder_tpu.data.datasets import load_dataset as jax_load_dataset
from gnnbuilder_tpu.train import make_train_step as jax_make_train_step
from gnnbuilder_tpu.train import masked_bce_logits_loss, roc_auc
from gnnbuilder_tpu.train import stack_targets as jax_stack_targets
from gnnbuilder_tpu_torch.demos import demo, serve_demo, simple_test
from gnnbuilder_tpu_torch.port import params_from_jax
from test_torch_parallel import _weights

ATOL, RTOL = 5e-4, 1e-3
AUC_TOL = 1e-3

DEMO_ARGS = dict(graphs=64, train=32, batch=16, hidden=16, layers=2,
                 epochs=2, parity=4)


def _save(tmp_path, params):
    path = str(tmp_path / "params.pt")
    torch.save(params_from_jax(jax.device_get(params)), path)
    return path


def _lines(out):
    return [line for line in out.splitlines() if line.strip()]


def _starts(lines, prefixes):
    assert len(lines) == len(prefixes), lines
    for line, p in zip(lines, prefixes):
        assert line.startswith(p), (line, p)


def test_simple_test_demo(tmp_path, capsys):
    kw = dict(graph_input_feature_dim=8, gnn_hidden_dim=16,
              gnn_num_layers=2, gnn_output_dim=8, gnn_conv="gcn",
              gnn_activation="relu", pooling_aggrs=("add", "mean", "max"),
              mlp_hidden_dim=16, mlp_hidden_layers=2, mlp_out_dim=1)
    params = _weights(kw, 0)
    res = simple_test.main(["--device", "cpu", "--params",
                            _save(tmp_path, params), "--iters", "4"])
    _starts(_lines(capsys.readouterr().out),
            ["forward: (17, 1) (last row is the ghost graph)",
             "parity: MAE=", "benchmark: ", "cost analysis: "])
    graphs = JaxFakeDataset(num_graphs=16, avg_num_nodes=20, node_dim=8,
                            seed=0)
    prog = jgnnb.Program(jgnnb.GNNModel(**kw), max_nodes=512,
                         max_edges=1024, max_graphs=17)
    prog.set_params(params)
    b = prog.batch(graphs)
    want = np.asarray(prog.forward(b))
    m = np.asarray(b.graph_mask)
    np.testing.assert_allclose(res["out"][m], want[m], atol=ATOL, rtol=RTOL)
    assert res["parity"]["model_output_mae"] <= ATOL
    assert res["parity"]["num_graphs"] == 16


def test_demo(tmp_path, capsys):
    a = DEMO_ARGS
    graphs = jax_load_dataset("hiv", n=a["graphs"])
    kw = dict(graph_input_feature_dim=graphs[0].x.shape[1],
              gnn_hidden_dim=a["hidden"], gnn_num_layers=a["layers"],
              gnn_output_dim=a["hidden"], gnn_conv="sage",
              gnn_skip_connection=True, pooling_aggrs=("add", "mean", "max"),
              mlp_hidden_dim=a["hidden"], mlp_hidden_layers=2, mlp_out_dim=1)
    params = _weights(kw, 1)
    res = demo.main([
        "--device", "cpu", "--params", _save(tmp_path, params),
        "--graphs", str(a["graphs"]), "--train-graphs", str(a["train"]),
        "--batch", str(a["batch"]), "--hidden", str(a["hidden"]),
        "--layers", str(a["layers"]), "--epochs", str(a["epochs"]),
        "--parity-graphs", str(a["parity"]), "--iters", "4"])
    _starts(_lines(capsys.readouterr().out),
            ["dataset: 64 graphs, max "]
            + [f"epoch {e}: loss " for e in range(a["epochs"])]
            + ["train ROC-AUC: ", "parity MAE: ", "benchmark: "])

    # the JAX demo's flow at the same size, from the same weights
    from gnnbuilder_tpu.utils.stats import compute_max_nodes_and_edges

    max_n, max_e = compute_max_nodes_and_edges(graphs)
    bs = a["batch"]
    model = jgnnb.GNNModel(**kw)
    prog = jgnnb.Program(model, max_nodes=bs * (max_n + 1),
                         max_edges=bs * (max_e + 1), max_graphs=bs + 1)
    spans = range(0, a["train"], bs)
    batches = [prog.batch(graphs[i: i + bs]) for i in spans]
    targets = [jax_stack_targets(graphs[i: i + bs], bs + 1) for i in spans]
    tx = optax.adam(1e-3)
    step = jax_make_train_step(model, tx, loss_fn=masked_bce_logits_loss,
                               donate=False)
    p, s = params, tx.init(params)
    losses = []
    for _ in range(a["epochs"]):
        ls = []
        for b, t in zip(batches, targets):
            p, s, loss = step(p, s, b, t)
            ls.append(float(loss))
        losses.append(float(np.mean(ls)))
    np.testing.assert_allclose(res["losses"], losses, atol=ATOL, rtol=RTOL)
    prog.set_params(p)
    scores, labels = [], []
    for b, t in zip(batches, targets):
        out = np.asarray(prog.forward(b))
        m = np.asarray(b.graph_mask)
        scores.extend(out[m, 0].tolist())
        labels.extend(np.asarray(t)[m, 0].tolist())
    np.testing.assert_allclose(res["scores"], scores, atol=ATOL, rtol=RTOL)
    assert abs(res["auc"] - roc_auc(np.array(scores),
                                    np.array(labels))) <= AUC_TOL
    assert res["parity"]["model_output_mae"] <= ATOL


def test_serve_demo(tmp_path, capsys):
    n_req, bs = 16, 8
    graphs = jax_load_dataset("esol", n=200)
    kw = dict(graph_input_feature_dim=graphs[0].x.shape[1],
              gnn_hidden_dim=64, gnn_num_layers=3, gnn_output_dim=32,
              gnn_conv="gcn", pooling_aggrs=("add", "mean", "max"),
              mlp_hidden_dim=64, mlp_hidden_layers=2, mlp_out_dim=1)
    params = _weights(kw, 2)
    res = serve_demo.main(["--device", "cpu", "--params",
                           _save(tmp_path, params), "--requests",
                           str(n_req), "--batch", str(bs)])
    _starts(_lines(capsys.readouterr().out),
            ["backend: ", "exported artifact: ",
             f"streaming {n_req} requests at ~", "served ",
             "request latency: p50 "])
    prog = jgnnb.Program.from_dataset(jgnnb.GNNModel(**kw), graphs,
                                      batch_size=bs)
    prog.set_params(params)
    want = np.concatenate([
        np.asarray(prog.forward(prog.batch(graphs[i: i + bs])))[:bs]
        for i in range(0, n_req, bs)])
    np.testing.assert_allclose(res["predictions"], want, atol=ATOL,
                               rtol=RTOL)
    assert res["stats"]["served"] >= n_req

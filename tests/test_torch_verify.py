"""The port's golden verification (``gnnbuilder_tpu_torch.verify`` and
``Program.gen_testbench_data`` / ``run_parity_check``) against the JAX
package's ``verify``, on the CPU.

* ``verify.torch_ref`` and ``verify.numpy_oracle`` give the JAX copies'
  outputs bit for bit on the same seeded weights and inputs.
* ``verify.port`` puts a torch_ref model's weights into the port's
  ``GNNModel`` for all nine convs (GAT with and without ``edge_dim``): the
  port's forward within 1e-5 of max |golden| of torch_ref's per-graph
  forward; ``port.params_to_jax`` of those weights maps back unchanged
  and flattens to the JAX writer's parameter names and bytes.
* ``gen_testbench_data`` writes the same files as the JAX package's for
  the same weights, the parameter and graph files byte for byte, the
  model goldens within 1e-5 of max; each package's ``parity_check`` on the
  other's goldens gives an MAE <= 1e-5; the three output encodings on the
  real molecules of ``tests/fixtures/esol.npz`` write JAX's bytes.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu.data.datasets import FakeDataset as JaxFakeDataset
from gnnbuilder_tpu.data.datasets import load_dataset as jax_load_dataset
from gnnbuilder_tpu.verify import golden as jax_golden
from gnnbuilder_tpu.verify import numpy_oracle as jax_oracle
from gnnbuilder_tpu.verify import torch_ref as jax_tr
from gnnbuilder_tpu_torch.compile.program import Program
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.data.datasets import FakeDataset, load_dataset
from gnnbuilder_tpu_torch.nn.model import GNNModel
from gnnbuilder_tpu_torch.port import params_from_jax, params_to_jax
from gnnbuilder_tpu_torch.verify import golden, numpy_oracle, port
from gnnbuilder_tpu_torch.verify import torch_ref as tr

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = 1e-5

# conv -> (conv_kwargs, node width, hidden, output)
CONVS = {
    "gcn": ({}, 8, 16, 12),
    "gin": ({}, 8, 16, 12),
    "gine": ({}, 8, 16, 12),
    "sage": ({}, 8, 16, 12),
    "pna": ({"delta": 2.0}, 8, 16, 12),
    "gat": ({}, 8, 16, 12),
    "gat-edge": ({"edge_dim": 4}, 8, 16, 12),
    "edge": ({}, 8, 16, 12),
    "lg": ({}, 16, 16, 16),
    "simple": ({}, 16, 16, 16),
}


def _kw(name, **extra):
    conv_kwargs, fin, hid, out = CONVS[name]
    return dict(graph_input_feature_dim=fin, gnn_hidden_dim=hid,
                gnn_num_layers=3, gnn_output_dim=out,
                gnn_conv=name.split("-")[0], gnn_skip_connection=True,
                graph_input_edge_dim=4, pooling_aggrs=("add", "mean", "max"),
                mlp_hidden_dim=16, mlp_hidden_layers=2, mlp_out_dim=2,
                conv_kwargs=dict(conv_kwargs), **extra)


def _graphs(fin, pkg=FakeDataset):
    return pkg(num_graphs=6, avg_num_nodes=14, node_dim=fin, edge_dim=4,
               seed=7)


def _golden_forward(tmodel, graphs):
    outs = []
    for g in graphs:
        tea = torch.tensor(g.edge_attr) if g.edge_attr is not None else None
        with torch.no_grad():
            outs.append(tmodel(torch.tensor(g.x), torch.tensor(g.edge_index),
                               num_graphs=1, edge_attr=tea).numpy()[0])
    return np.stack(outs)


@pytest.mark.parametrize("name", sorted(CONVS))
def test_torch_ref_is_jax_copy_and_port_carries_weights(name):
    """Both torch_ref copies from one seed: equal weights and outputs
    bit for bit; the port's GNNModel on ``verify.port``'s weights within
    1e-5 of max of the golden forward."""
    graphs = _graphs(CONVS[name][1])
    torch.manual_seed(42)
    ours = tr.TorchGNNModel(**_kw(name))
    torch.manual_seed(42)
    ref = jax_tr.TorchGNNModel(**_kw(name))
    sd, rsd = ours.state_dict(), ref.state_dict()
    assert list(sd) == list(rsd)
    for k in sd:
        assert torch.equal(sd[k], rsd[k]), k
    want = _golden_forward(ours, graphs)
    np.testing.assert_array_equal(want, _golden_forward(ref, graphs))

    model = GNNModel(**_kw(name))
    sd = port.port_model(name.split("-")[0], ours)
    model.load_state_dict(sd)
    # the golden files' names and bytes of these weights, both packages
    tree = params_to_jax(model.state_dict())
    back = params_from_jax(tree)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k])
                                        for k in sd)
    flat, jflat = golden._flatten_params(sd), jax_golden._flatten_params(
        tree)
    assert sorted(flat) == sorted(jflat)
    assert all(flat[k].tobytes() == jflat[k].tobytes() for k in flat)
    batch = build_graph_batch(graphs, device="cpu")
    with torch.no_grad():
        got = model(batch).numpy()[:len(graphs)]
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), (name, err)


def test_numpy_oracle_is_jax_copy():
    rng = np.random.default_rng(5)
    n, e, fin, H, C, fe = 12, 40, 6, 3, 4, 5
    x = rng.standard_normal((n, fin)).astype(np.float32)
    ei = rng.integers(0, n, size=(2, e))
    ea = rng.standard_normal((e, fe)).astype(np.float32)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    gat = dict(W=r(fin, H * C), att_src=r(H, C), att_dst=r(H, C),
               bias=r(H * C), heads=H, out_channels=C, edge_attr=ea,
               W_edge=r(fe, H * C), att_edge=r(H, C))
    np.testing.assert_array_equal(numpy_oracle.gat_conv_oracle(x, ei, **gat),
                                  jax_oracle.gat_conv_oracle(x, ei, **gat))
    for agg in ("max", "sum", "mean"):
        ec = dict(W0=r(2 * fin, 7), b0=r(7), W1=r(7, 7), b1=r(7),
                  aggregation=agg)
        np.testing.assert_array_equal(
            numpy_oracle.edge_conv_oracle(x, ei, **ec),
            jax_oracle.edge_conv_oracle(x, ei, **ec))


# ------------------------------------------------------------- goldens

def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _read(root, rel):
    with open(os.path.join(root, rel), "rb") as f:
        return f.read()


def _programs(kw, bucket):
    """A JAX and a port Program of one model on the same weights: the
    port's seeded init, carried to the flax tree by ``params_to_jax``
    (and back by ``params_from_jax`` unchanged)."""
    prog = Program(GNNModel(**kw), device="cpu", **bucket)
    params = prog.init_params()
    tree = params_to_jax(params)
    back = params_from_jax(tree)
    assert set(back) == set(params)
    assert all(torch.equal(back[k], params[k]) for k in params)
    jprog = gnnb.Program(gnnb.GNNModel(**kw), **bucket)
    jprog.set_params(jax.tree.map(jnp.asarray, tree))
    return jprog, prog


@pytest.fixture(scope="module")
def goldens(tmp_path_factory):
    """Both packages' testbench data for one PNA model's weights on the
    same six graphs."""
    kw = dict(_kw("pna"), gnn_num_layers=2)
    graphs = _graphs(kw["graph_input_feature_dim"])
    jgraphs = _graphs(kw["graph_input_feature_dim"], JaxFakeDataset)
    bucket = dict(max_nodes=64, max_edges=128, max_graphs=2)
    jprog, prog = _programs(kw, bucket)
    root = tmp_path_factory.mktemp("goldens")
    ours, ref = str(root / "ours"), str(root / "ref")
    info = prog.gen_testbench_data(graphs, ours)
    jinfo = jax_golden.gen_testbench_data(jprog, jgraphs, ref)
    return dict(prog=prog, jprog=jprog, graphs=graphs, jgraphs=jgraphs,
                ours=ours, ref=ref, info=info, jinfo=jinfo)


def test_testbench_files_match_jax(goldens):
    ours, ref = goldens["ours"], goldens["ref"]
    assert goldens["info"] == goldens["jinfo"]
    names = _files(ours)
    assert names == _files(ref)
    params = [n for n in names if n.startswith("model_parameters")]
    assert len(params) == len(goldens["prog"].params)
    assert "model_parameters/gnn_convs_0_pre_nn_kernel.bin" in params
    assert "model_parameters/mlp_head_linear_2_bias.bin" in params
    for n in names:
        if n.endswith("model_golden_output.bin"):
            a = np.fromfile(os.path.join(ours, n), np.float32)
            b = np.fromfile(os.path.join(ref, n), np.float32)
            assert a.shape == b.shape
            assert float(np.abs(a - b).max()) <= TOL * float(
                np.abs(b).max()), n
        else:
            assert _read(ours, n) == _read(ref, n), n
    outs = golden.load_golden_outputs(ours)
    assert len(outs) == len(goldens["graphs"])


def test_parity_check_across_packages(goldens):
    mine = goldens["prog"].run_parity_check(goldens["graphs"],
                                            goldens["ref"])
    theirs = goldens["jprog"].run_parity_check(goldens["jgraphs"],
                                               goldens["ours"])
    own = goldens["prog"].run_parity_check(goldens["graphs"],
                                           goldens["ours"])
    for rep in (mine, theirs, own):
        assert rep["num_graphs"] == len(goldens["graphs"])
        assert rep["model_output_mae"] <= TOL, rep
    assert own["model_output_mae"] == 0.0
    # a perturbed program reports a nonzero MAE (the check checks)
    bumped = {k: v + 0.05 for k, v in goldens["prog"].params.items()}
    prog2 = Program(GNNModel(**dict(_kw("pna"), gnn_num_layers=2)),
                    max_nodes=64, max_edges=128, max_graphs=2, device="cpu")
    prog2.set_params(bumped)
    assert prog2.run_parity_check(goldens["graphs"], goldens["ours"])[
        "model_output_mae"] > 1e-4


def test_output_encodings_on_real_molecules(tmp_path):
    """The reference's pyg_output_encoding switch (code_gen.py:101-109,
    270-277) on the esol fixture's molecules, against the JAX writer's
    bytes: regression writes y, classification_integer expands an integer
    label to one-hot, classification_onehot writes y as-is; bad names and
    a missing num_classes raise."""
    graphs = load_dataset("esol", root=FIXTURES)
    jgraphs = jax_load_dataset("esol", root=FIXTURES)
    assert [g.num_nodes for g in graphs] == [3, 6, 4, 7, 6, 14]
    kw = dict(graph_input_feature_dim=9, gnn_hidden_dim=8, gnn_num_layers=2,
              gnn_output_dim=4, gnn_conv="gcn", pooling_aggrs=("mean",),
              mlp_out_dim=2)
    jprog, prog = _programs(kw, dict(max_nodes=128, max_edges=256,
                                     max_graphs=2))

    def labelled(gs, onehot):
        return [dataclasses.replace(g, y=(
            np.eye(2, dtype=np.float32)[i % 2] if onehot
            else np.asarray([i % 2], np.int64))) for i, g in enumerate(gs)]

    cases = {
        "regression": (graphs, jgraphs, {}),
        "classification_integer": (labelled(graphs, False),
                                   labelled(jgraphs, False),
                                   {"num_classes": 2}),
        "classification_onehot": (labelled(graphs, True),
                                  labelled(jgraphs, True),
                                  {"num_classes": 2}),
    }
    for enc, (gs, jgs, extra) in cases.items():
        ours, ref = str(tmp_path / enc / "ours"), str(tmp_path / enc / "ref")
        prog.gen_testbench_data(gs, ours, output_encoding=enc, **extra)
        jax_golden.gen_testbench_data(jprog, jgs, ref, output_encoding=enc,
                                      **extra)
        tasks = [n for n in _files(ref) if n.endswith("task_golden_output.bin")]
        assert len(tasks) == len(gs)
        assert _files(ours) == _files(ref)
        for n in tasks:
            assert _read(ours, n) == _read(ref, n), (enc, n)
    t = np.fromfile(str(tmp_path / "classification_integer" / "ours" /
                        "graphs" / "graph_1_task_golden_output.bin"),
                    np.float32)
    np.testing.assert_array_equal(t, [0.0, 1.0])
    t = np.fromfile(str(tmp_path / "regression" / "ours" / "graphs" /
                        "graph_1_task_golden_output.bin"), np.float32)
    np.testing.assert_allclose(t, [-1.64], atol=1e-6)
    with pytest.raises(ValueError, match="output_encoding"):
        prog.gen_testbench_data(graphs, str(tmp_path / "bad"),
                                output_encoding="nope")
    with pytest.raises(ValueError, match="num_classes"):
        prog.gen_testbench_data(graphs, str(tmp_path / "bad2"),
                                output_encoding="classification_integer")

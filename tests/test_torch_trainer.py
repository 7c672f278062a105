"""The trainer's pieces in the port against the JAX package, on the CPU.

* ``dispatch.no_fused`` / ``get_fused_mode``: the JAX semantics (every
  kernel gate declines inside the context, the block product's gate does
  not, the mode is untouched), and a forward inside it is the "never"
  forward bit for bit.
* ``train.TrainState``: a capture and restore of a model and its Adam
  state repeats the next steps bit for bit.
* ``GNNModel(remat=True)`` for gcn, pna, gat and gine: the same
  ``state_dict`` keys, a forward bit-equal to ``remat=False``, gradients
  bit-equal to ``remat=False`` and within 2e-5 of max |g| of ``jax.grad``
  of the JAX ``GNNModel(remat=True)`` on the same weights.
* ``data.loader.GraphLoader`` against the JAX ``GraphLoader``: the same
  budgets, the same shuffled chunk order over two epochs, every batch
  field and target bit-equal (standard and block-packed), no thread left
  behind by an abandoned epoch, and a 3-step loader-fed Adam loss curve
  within 1e-3 relative of the JAX one's.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnnbuilder_tpu import train as jax_train
from gnnbuilder_tpu.bench.canonical import (
    canonical_batches as jax_canonical_batches,
)
from gnnbuilder_tpu.bench.canonical import (
    canonical_model as jax_canonical_model,
)
from gnnbuilder_tpu.data.datasets import FakeDataset as JaxFakeDataset
from gnnbuilder_tpu.data.datasets import load_dataset as jax_load_dataset
from gnnbuilder_tpu.data.loader import GraphLoader as JaxGraphLoader
from gnnbuilder_tpu.ops import dispatch as jax_dispatch
from gnnbuilder_tpu_torch import train
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.compile.program import Program
from gnnbuilder_tpu_torch.data.datasets import FakeDataset, load_dataset
from gnnbuilder_tpu_torch.data.loader import GraphLoader
from gnnbuilder_tpu_torch.nn.model import GNNModel
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.port import params_from_jax, params_to_jax
from test_torch_graph import _assert_same_batch

REMAT_TOL = 2e-5
CURVE_TOL = 1e-3


# ------------------------------------------------------------ no_fused

def _port_gates(tb, bb):
    """Every kernel gate of the port on a batch where it gives a route."""
    return {
        "pna_stack": dispatch.pna_stack_cfg(bb),
        "mp_stack": dispatch.mp_stack_cfg(bb, "gcn"),
        "mp_layer": dispatch.mp_layer_cfg(tb, "gcn"),
        "pna_layer": dispatch.pna_layer_cfg(tb, "relu"),
        "gat_block": dispatch.gat_block_cfg(bb, "relu"),
        "gat_layer": dispatch.gat_layer_cfg(tb, "relu"),
        "agg": dispatch.agg_cfg(tb),
        "gine_layer": dispatch.gine_layer_cfg(tb, "relu"),
        "edge_block": dispatch.edge_block_cfg(bb, "relu"),
        "readout": dispatch.readout_config(tb, ("add", "mean"), "relu",
                                           None),
    }


def test_no_fused_declines_every_kernel_gate_as_jax():
    _, (tb,) = canonical_batches("qm9", n_graphs=8, batch_size=8,
                                 device="cpu")
    _, (bb,) = canonical_batches("qm9", n_graphs=8, batch_size=8,
                                 block_size=128, device="cpu")
    _, (jtb,) = jax_canonical_batches("qm9", n_graphs=8, batch_size=8)
    _, (jbb,) = jax_canonical_batches("qm9", n_graphs=8, batch_size=8,
                                      block_size=128)
    assert dispatch.get_fused_mode() == jax_dispatch.get_fused_mode() \
        == "auto"
    # the JAX gates give their kernels on the CPU only under "always"
    jax_dispatch.set_fused_mode("always")
    try:
        with dispatch.inference_mode(), jax_dispatch.inference_mode():
            assert all(v is not None for v in _port_gates(tb, bb).values())
            assert jax_dispatch.fused_config(jtb) is not None
            with dispatch.no_fused(), jax_dispatch.no_fused():
                got = _port_gates(tb, bb)
                assert all(v is None for v in got.values()), got
                assert jax_dispatch.fused_config(jtb) is None
                # the block product is a plain aggregation in both
                assert dispatch.block_cfg(bb) is not None
                assert jax_dispatch.block_cfg(jbb) is not None
                assert dispatch.get_fused_mode() == "auto"
                with dispatch.no_fused():   # nests
                    assert dispatch.agg_cfg(tb) is None
                assert dispatch.agg_cfg(tb) is None
            assert all(v is not None for v in _port_gates(tb, bb).values())
    finally:
        jax_dispatch.set_fused_mode("auto")
    dispatch.set_fused_mode("never")
    try:
        assert dispatch.get_fused_mode() == "never"
    finally:
        dispatch.set_fused_mode("auto")
    assert dispatch.get_fused_mode() == "auto"


def test_no_fused_forward_is_the_never_forward():
    gs, (tb,) = canonical_batches("qm9", n_graphs=16, batch_size=16,
                                  device="cpu")
    prog = Program(canonical_model("pna", "qm9", graphs=gs,
                                   gnn_num_layers=2, gnn_hidden_dim=32,
                                   gnn_output_dim=16),
                   max_nodes=tb.num_nodes, max_edges=tb.num_edges,
                   max_graphs=tb.num_graphs, device="cpu")
    auto = prog.forward(tb)
    with dispatch.no_fused():
        off = prog.forward(tb)
    dispatch.set_fused_mode("never")
    try:
        never = prog.forward(tb)
    finally:
        dispatch.set_fused_mode("auto")
    assert torch.equal(off, never)
    assert float((auto - off).abs().max()) <= 1e-5 * float(
        off.abs().max())


# ----------------------------------------------------------- TrainState

def test_train_state_round_trip():
    gs, (tb,) = canonical_batches("qm9", n_graphs=16, batch_size=16,
                                  device="cpu")
    model = canonical_model("gcn", "qm9", gnn_num_layers=2,
                            gnn_hidden_dim=16, gnn_output_dim=8)
    target = train.stack_targets(gs, tb.num_graphs, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = train.make_train_step(model, opt)
    step(tb, target)
    state = train.TrainState.capture(model, opt, step=1)
    assert state.step == 1 and set(state.params) == set(model.state_dict())
    first = [float(step(tb, target)) for _ in range(2)]
    after = {k: v.clone() for k, v in model.state_dict().items()}
    assert state.restore(model, opt) == 1
    second = [float(step(tb, target)) for _ in range(2)]
    assert first == second
    for k, v in model.state_dict().items():
        assert torch.equal(v, after[k]), k
    # the JAX class's constructor
    s = train.TrainState({"w": 1}, {"m": 2})
    assert (s.params, s.opt_state, s.step) == ({"w": 1}, {"m": 2}, 0)


# ---------------------------------------------------------------- remat

REMAT_CONVS = {"gcn": {}, "pna": {}, "gat": {"heads": 2}, "gine": {}}


@pytest.fixture(scope="module")
def remat_batches():
    kw = dict(n_graphs=24, batch_size=24)
    gj, (jb,) = jax_canonical_batches("qm9", **kw)
    gt, (tb,) = canonical_batches("qm9", **kw, device="cpu")
    target = np.random.default_rng(0).standard_normal(
        (tb.num_graphs, 1)).astype(np.float32)
    return gj, jb, gt, tb, target


def _grads(model, tb, target):
    """Loss and gradients at one CPU thread: the CPU's multithreaded
    products do not fix their order of summation (GAT's first-layer
    gradients moved by ~1e-11 between two runs of one model), while on
    the card no kernel adds floats atomically and steps repeat bit for
    bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model.zero_grad(set_to_none=True)
        loss = train.masked_mse_loss(model(tb), target, tb.graph_mask)
        loss.backward()
    finally:
        torch.set_num_threads(threads)
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()}


@pytest.mark.parametrize("conv", sorted(REMAT_CONVS))
def test_remat_matches_plain_and_jax_remat(conv, remat_batches):
    gj, jb, gt, tb, target_np = remat_batches
    kw = dict(gnn_num_layers=3, gnn_hidden_dim=32, gnn_output_dim=16,
              conv_kwargs=dict(REMAT_CONVS[conv]))
    jm = jax_canonical_model(conv, "qm9", graphs=gj, remat=True, **kw)
    plain = canonical_model(conv, "qm9", graphs=gt, **kw)
    remat = canonical_model(conv, "qm9", graphs=gt, remat=True, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb)
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    assert remat.remat and not plain.remat
    assert list(remat.state_dict()) == list(plain.state_dict())
    plain.load_state_dict(sd)
    remat.load_state_dict(sd)
    with torch.no_grad():
        assert torch.equal(plain(tb), remat(tb))
    target = torch.from_numpy(target_np)
    l0, g0 = _grads(plain, tb, target)
    l1, g1 = _grads(remat, tb, target)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k

    def loss_fn(pp):
        return jax_train.masked_mse_loss(jm.apply(pp, jb),
                                         jnp.asarray(target_np),
                                         jb.graph_mask)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    jg = params_from_jax(jax.tree.map(np.asarray, jg))
    assert abs(float(l1) - float(jl)) <= 1e-5 * abs(float(jl))
    worst = 0.0
    for k, g in g1.items():
        ref = jg[k].numpy()
        err = float(np.abs(g.numpy() - ref).max())
        scale = float(np.abs(ref).max())
        worst = max(worst, err / scale)
        assert err <= REMAT_TOL * scale, (k, err, scale)
    print(f"{conv}: remat gradients {worst:.3e} of max off the JAX remat "
          f"model's")


# --------------------------------------------------------------- loader

def _chunk_ids(loader):
    return [[id(g) for g in c] for c in loader._chunks()]


@pytest.mark.parametrize("block_size", [0, 128])
def test_loader_batches_match_jax(block_size):
    """Budgets, the shuffled chunk order of two epochs, and every batch
    field and target of both epochs, bit for bit."""
    if block_size:
        kw = dict(n=100, seed=2)
        graphs, jgraphs = load_dataset("qm9", **kw), jax_load_dataset(
            "qm9", **kw)
        lkw = dict(batch_size=32, shuffle=True, block_size=128, seed=5)
    else:
        kw = dict(num_graphs=20, avg_num_nodes=12, node_dim=8, seed=1)
        graphs, jgraphs = FakeDataset(**kw), JaxFakeDataset(**kw)
        lkw = dict(batch_size=8, shuffle=True, seed=3)
    ours = GraphLoader(graphs, device="cpu", **lkw)
    ref = JaxGraphLoader(jgraphs, **lkw)
    assert (ours.node_budget, ours.edge_budget, ours.graph_budget) == (
        ref.node_budget, ref.edge_budget, ref.graph_budget)
    assert len(ours) == len(ref)
    index = {id(g): i for i, g in enumerate(graphs)}
    jindex = {id(g): i for i, g in enumerate(jgraphs)}
    orders = []
    for _ in range(2):
        o = [[index[i] for i in c] for c in _chunk_ids(ours)]
        r = [[jindex[i] for i in c] for c in _chunk_ids(ref)]
        assert o == r
        orders.append(o)
        n = 0
        for (b, t), (jb, jt) in zip(ours.epoch(), ref.epoch(), strict=True):
            _assert_same_batch(b, jb)
            np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
            n += 1
        assert n == len(ours)
        assert len(ours.pack_seconds) == n
    assert orders[0] != orders[1]   # reshuffled per epoch


def test_abandoned_epoch_leaks_no_thread():
    graphs = FakeDataset(num_graphs=64, avg_num_nodes=10, node_dim=8,
                         seed=4)
    loader = GraphLoader(graphs, batch_size=4, prefetch=1, device="cpu")
    before = threading.active_count()
    for i, _ in enumerate(loader.epoch()):
        if i == 1:
            break   # abandon mid-epoch with the queue full
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert not any(t.name == "gnnb-loader" for t in threading.enumerate())


def test_loader_fed_loss_curve_matches_jax():
    """Three Adam(1e-2) steps, each on the loaders' next batch (two
    epochs of two shuffled batches), from the same weights."""
    kw = dict(num_graphs=16, avg_num_nodes=10, node_dim=8, seed=3)
    lkw = dict(batch_size=8, shuffle=True)
    ours = GraphLoader(FakeDataset(**kw), device="cpu", **lkw)
    ref = JaxGraphLoader(JaxFakeDataset(**kw), **lkw)
    mkw = dict(graph_input_feature_dim=8, gnn_hidden_dim=8,
               gnn_num_layers=2, gnn_output_dim=8, gnn_conv="gcn",
               pooling_aggrs=("mean",), mlp_out_dim=1)
    import gnnbuilder_tpu as gnnb

    jm = gnnb.GNNModel(**mkw)
    model = GNNModel(**mkw)
    params = jax.tree.map(jnp.asarray, params_to_jax(
        Program(model, device="cpu").init_params()))
    opt = optax.adam(1e-2)
    jstep = jax_train.make_train_step(jm, opt, donate=False)
    jo = opt.init(params)
    step = train.make_train_step(model, torch.optim.Adam(
        model.parameters(), lr=1e-2))

    def feed(loader):
        while True:
            yield from loader.epoch()

    losses = []
    for (b, t), (jb, jt) in zip(feed(ours), feed(ref)):
        params, jo, jl = jstep(params, jo, jb, jt)
        losses.append((float(step(b, t)), float(jl)))
        if len(losses) == 3:
            break
    for i, (tl, jl) in enumerate(losses):
        assert abs(tl - jl) <= CURVE_TOL * abs(jl), (i, tl, jl)

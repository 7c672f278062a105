"""The whole slice: the port's ``Program(device="cpu")`` against the JAX
``Program`` on the same weights (through ``port.params_from_jax``), on
canonical PNA/QM9 block-packed batches at 3 layers, compared on
``graph_mask`` rows.

Both packages run both paths: the JAX one with
``dispatch.set_fused_mode("always")`` (its stack and readout kernels in
interpret mode) and ``"never"`` (per-layer XLA path); the port with its
kernel functions (plain versions on the CPU) and ``"never"`` (per-layer
PNAConv path).  Tolerance atol 5e-4 / rtol 1e-3, the stack kernel's
contract: sums run in another order on each path.  The outputs of a
randomly initialised model are small (~0.1), so each comparison also
holds max |ours - ref| <= 1e-4 * max |ref| (f32 rounding is ~1e-6 of
the largest value)."""

import jax
import numpy as np
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu.bench.canonical import (
    canonical_batches as jax_canonical_batches,
)
from gnnbuilder_tpu.bench.canonical import (
    canonical_model as jax_canonical_model,
)
from gnnbuilder_tpu.ops import dispatch as jax_dispatch
from gnnbuilder_tpu_torch import Program
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.ops.cuda import (
    gat_block,
    gat_layer,
    mp_block,
    mp_layer,
    pna_block,
    pna_layer,
    readout,
)
from gnnbuilder_tpu_torch.port import params_from_jax

ATOL, RTOL = 5e-4, 1e-3
SCALED_TOL = 1e-4


def _jax_forward(p, b, mode):
    jax_dispatch.set_fused_mode(mode)
    try:
        return np.asarray(p.forward(b))
    finally:
        jax_dispatch.set_fused_mode("auto")


def _port_forward(p, b, mode):
    dispatch.set_fused_mode(mode)
    try:
        return p.forward(b).numpy()
    finally:
        dispatch.set_fused_mode("auto")


@pytest.mark.parametrize("layers,out_act", [(3, None), (2, "softmax")])
def test_program_matches_jax_program(layers, out_act):
    kw = dict(n_graphs=64, batch_size=32, block_size=128, node_multiple=128)
    gj, jbs = jax_canonical_batches("qm9", **kw)
    gt, tbs = canonical_batches("qm9", **kw, device="cpu")
    over = dict(gnn_num_layers=layers, output_activation=out_act,
                mlp_out_dim=3 if out_act else 1)
    jm = jax_canonical_model("pna", "qm9", graphs=gj, **over)
    tm = canonical_model("pna", "qm9", graphs=gt, **over)
    b0 = jbs[0]
    jp = gnnb.Program(jm, max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                      max_graphs=b0.num_graphs, block_size=128)
    params = jax.tree.map(np.asarray, jp.init_params(b0))
    tp = Program(tm, max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                 max_graphs=b0.num_graphs, block_size=128, device="cpu")
    tp.set_params(params_from_jax(params))

    calls = {"stack": 0, "readout": 0}
    orig = (pna_block.pna_block_stack_auto, readout.fused_readout)

    for jb, tb in zip(jbs, tbs):
        m = tb.graph_mask.numpy()
        j_fused = _jax_forward(jp, jb, "always")
        j_plain = _jax_forward(jp, jb, "never")

        def count(name, fn):
            def wrapped(*a, **k):
                calls[name] += 1
                return fn(*a, **k)
            return wrapped

        pna_block.pna_block_stack_auto = count("stack", orig[0])
        readout.fused_readout = count("readout", orig[1])
        try:
            t_fused = _port_forward(tp, tb, "auto")
        finally:
            pna_block.pna_block_stack_auto, readout.fused_readout = orig
        t_plain = _port_forward(tp, tb, "never")
        assert t_fused.shape == j_fused.shape
        for ours in (t_fused, t_plain):
            for ref in (j_fused, j_plain):
                np.testing.assert_allclose(ours[m], ref[m], atol=ATOL,
                                           rtol=RTOL)
                err = np.abs(ours[m] - ref[m]).max()
                assert err <= SCALED_TOL * np.abs(ref[m]).max()
        assert np.isfinite(t_fused[m]).all()
    assert calls == {"stack": len(tbs), "readout": len(tbs)}


def test_per_layer_path_outside_inference_scope():
    """Without inference scope (and under "never") the model runs the
    per-layer loop; both give the kernel path's numbers."""
    gs, (b,) = canonical_batches("qm9", n_graphs=16, batch_size=16,
                                 block_size=128, node_multiple=128,
                                 device="cpu")
    m = canonical_model("pna", "qm9", graphs=gs, gnn_num_layers=2)
    p = Program(m, max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, block_size=128, device="cpu")
    p.init_params()
    assert dispatch.pna_stack_cfg(b) is None   # no inference scope
    with dispatch.inference_mode():
        assert dispatch.pna_stack_cfg(b) == {"block_size": 128}
        dispatch.set_fused_mode("never")
        try:
            assert dispatch.pna_stack_cfg(b) is None
        finally:
            dispatch.set_fused_mode("auto")
    with torch.no_grad():
        eager = m(b)
    np.testing.assert_allclose(p.forward(b).numpy(), eager.numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hidden,block_size", [(256, 128), (128, 256)])
def test_stack_gate_takes_any_width_and_block(hidden, block_size):
    """The stack gate takes a block-packed batch at the kernel's block
    size only (``pna_block.BLOCK_ROWS``): a 256-row batch runs per layer,
    each layer through row 5 over the ELL table (the stack's CUDA
    wrapper raises on 256-row blocks); a model wider than the kernel's
    128 features (``pna_block.STACK_WIDTH``) passes the gate and runs per
    layer too (row 5 takes any width; the stack kernel raised on it on
    the card).  Both match the per-layer path."""
    gs, (b,) = canonical_batches("qm9", n_graphs=24, batch_size=24,
                                 block_size=block_size,
                                 node_multiple=block_size, device="cpu")
    m = canonical_model("pna", "qm9", graphs=gs, gnn_num_layers=2,
                        gnn_hidden_dim=hidden)
    p = Program(m, max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, block_size=block_size,
                device="cpu")
    p.init_params()
    with dispatch.inference_mode():
        assert dispatch.pna_stack_cfg(b) == (
            {"block_size": block_size}
            if block_size == pna_block.BLOCK_ROWS else None)
    calls, layers = [], []
    orig = pna_block.pna_block_stack_auto
    orig_layer = pna_layer.fused_pna_layer

    def counted(*a, **k):
        calls.append(k["block_size"])
        return orig(*a, **k)

    def counted_layer(*a, **k):
        layers.append(k.get("mode", "f32"))
        return orig_layer(*a, **k)

    pna_block.pna_block_stack_auto = counted
    pna_layer.fused_pna_layer = counted_layer
    try:
        fused = _port_forward(p, b, "auto")
    finally:
        pna_block.pna_block_stack_auto = orig
        pna_layer.fused_pna_layer = orig_layer
    stacked = (hidden <= pna_block.STACK_WIDTH
               and block_size == pna_block.BLOCK_ROWS)
    assert calls == ([block_size] if stacked else [])
    assert layers == ([] if stacked else ["f32"] * 2)
    plain = _port_forward(p, b, "never")
    msk = b.graph_mask.numpy()
    np.testing.assert_allclose(fused[msk], plain[msk], atol=ATOL, rtol=RTOL)
    assert np.abs(fused[msk] - plain[msk]).max() <= SCALED_TOL * np.abs(
        plain[msk]).max()


# per conv at 256-row blocks: (conv_kwargs, the kernel function its
# layers reach, under inference scope); no stack or block kernel runs
_ROUTES_256 = {
    "pna": (None, "pna_layer"), "gcn": (None, "mp_layer"),
    "gin": (None, "mp_layer"), "sage": (None, "mp_layer"),
    "lg": (None, "mp_layer"), "simple": (None, "mp_layer"),
    "gat": ({"heads": 2}, "gat_layer"),
}


@pytest.mark.parametrize("conv", sorted(_ROUTES_256))
def test_gates_send_256_row_blocks_to_kernels_that_take_them(conv):
    """A batch block-packed at 256 rows, which no block kernel takes
    (each wrapper's ``BLOCK_ROWS`` is 128): the PNA stack goes per layer
    to row 5, GCN, GIN, SAGE, LG and Simple to row 4's ELL mode, GAT to
    row 10, all over the batch's ELL table, and the forward matches the
    per-layer plain path; at 128 rows the gates answer as before.  Every
    gate reads the rows from the wrapper module's constant, and loads no
    library."""
    kw, kernel = _ROUTES_256[conv]
    same = conv in ("lg", "simple")
    gs, (b,) = canonical_batches("qm9", n_graphs=24, batch_size=24,
                                 block_size=256, node_multiple=256,
                                 node_dim=128 if same else None,
                                 device="cpu")
    _, (b128,) = canonical_batches("qm9", n_graphs=24, batch_size=24,
                                   block_size=128, node_multiple=128,
                                   node_dim=128 if same else None,
                                   device="cpu")
    for mod in (pna_block, mp_block, mp_layer, gat_block):
        assert mod.BLOCK_ROWS == 128
    with dispatch.inference_mode():
        assert dispatch.pna_stack_cfg(b) is None
        assert dispatch.mp_stack_cfg(b, "gcn") is None
        assert dispatch.gat_block_cfg(b, "relu") is None
        for c in ("gcn", "gin", "sage", "lg", "simple"):
            assert dispatch.mp_layer_cfg(b, c) == {}
        assert dispatch.gat_layer_cfg(b, "relu") == {}
        assert dispatch.pna_stack_cfg(b128) == {"block_size": 128}
        assert dispatch.mp_stack_cfg(b128, "gcn") == {"block_size": 128}
        assert dispatch.gat_block_cfg(b128, "relu") == {}
        assert dispatch.mp_layer_cfg(b128, "gcn") == {"block": True}
        assert dispatch.mp_layer_cfg(b128, "gin") is None
    m = canonical_model(conv, "qm9", graphs=gs, gnn_num_layers=2,
                        conv_kwargs=dict(kw or {}))
    p = Program(m, max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, block_size=256, device="cpu")
    p.init_params()
    funcs = {"pna_stack": (pna_block, "fused_pna_block_stack"),
             "mp_stack": (mp_block, "fused_mp_block_stack"),
             "gat_block": (gat_block, "fused_gat_block_layer"),
             "pna_layer": (pna_layer, "fused_pna_layer"),
             "mp_layer": (mp_layer, "fused_mp_layer"),
             "gat_layer": (gat_layer, "fused_gat_layer")}
    calls = {k: [] for k in funcs}
    orig = {k: getattr(mod, name) for k, (mod, name) in funcs.items()}

    def counting(key):
        def wrapped(*a, **k):
            calls[key].append(k.get("block_adj") is not None)
            return orig[key](*a, **k)
        return wrapped

    for k, (mod, name) in funcs.items():
        setattr(mod, name, counting(k))
    try:
        fused = _port_forward(p, b, "auto")
    finally:
        for k, (mod, name) in funcs.items():
            setattr(mod, name, orig[k])
    # two layers through the kernel, none in block mode
    assert calls == {k: ([False] * 2 if k == kernel else []) for k in funcs}
    plain = _port_forward(p, b, "never")
    msk = b.graph_mask.numpy()
    assert np.isfinite(fused[msk]).all()
    assert np.abs(fused[msk] - plain[msk]).max() <= SCALED_TOL * np.abs(
        plain[msk]).max()


def test_program_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = canonical_model("pna", "qm9", gnn_num_layers=1,
                        conv_kwargs={"delta": 2.0})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Program(m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Program(m, device="cuda")


def test_benchmark_refuses_cpu():
    m = canonical_model("pna", "qm9", gnn_num_layers=1,
                        conv_kwargs={"delta": 2.0})
    gs, (b,) = canonical_batches("qm9", n_graphs=4, batch_size=4, device="cpu")
    p = Program(m, max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, device="cpu")
    with pytest.raises(RuntimeError, match="measures the card"):
        p.benchmark(b)


def test_init_params_seeded():
    m1 = canonical_model("pna", "qm9", gnn_num_layers=2,
                         conv_kwargs={"delta": 2.0})
    m2 = canonical_model("pna", "qm9", gnn_num_layers=2,
                         conv_kwargs={"delta": 2.0})
    s1 = Program(m1, device="cpu", seed=3).init_params()
    s2 = Program(m2, device="cpu", seed=3).init_params()
    s3 = Program(canonical_model("pna", "qm9", gnn_num_layers=2,
                                 conv_kwargs={"delta": 2.0}),
                 device="cpu", seed=4).init_params()
    for k in s1:
        torch.testing.assert_close(s1[k], s2[k], rtol=0, atol=0)
        bound = 1.0 / np.sqrt(m1.get_submodule(k.rsplit(".", 1)[0])
                              .in_features)
        assert float(s1[k].abs().max()) <= bound
    assert any(not torch.equal(s1[k], s3[k]) for k in s1)


@pytest.mark.parametrize("aggregators,scalers", [
    (("sum", "mean", "max"), ("identity", "amplification")),
    (("min", "std"), ("attenuation",)),
])
def test_pna_conv_nondefault_matches_jax(aggregators, scalers):
    """PNAConv with other aggregators and scalers (the model then keeps the
    per-layer path) against the JAX PNAConv on the same weights."""
    from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
    from gnnbuilder_tpu.data.datasets import FakeDataset
    from gnnbuilder_tpu.nn.conv import PNAConv as JaxPNAConv
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.nn.conv import PNAConv

    gs = FakeDataset(num_graphs=10, avg_num_nodes=10, node_dim=16, seed=4)
    g = jax_build(gs)
    b = build_graph_batch(gs, device="cpu")
    kw = dict(delta=1.7, aggregators=aggregators, scalers=scalers)
    jconv = JaxPNAConv(in_channels=16, out_channels=24, **kw)
    x = np.random.default_rng(0).standard_normal((g.num_nodes, 16)).astype(
        np.float32)
    jp = jconv.init(jax.random.PRNGKey(1), g, x)
    jax_dispatch.set_fused_mode("never")
    try:
        ref = np.asarray(jconv.apply(jp, g, x, "relu", None))
    finally:
        jax_dispatch.set_fused_mode("auto")
    conv = PNAConv(16, 24, **kw)
    sd = {}
    for name in ("pre_nn", "post_nn", "lin"):
        node = jp["params"][name]
        sd[f"{name}.weight"] = torch.tensor(np.asarray(node["kernel"]).T)
        sd[f"{name}.bias"] = torch.tensor(np.asarray(node["bias"]))
    conv.load_state_dict(sd)
    with torch.no_grad():
        ours = conv(b, torch.from_numpy(x), "relu", None).numpy()
    m = b.node_mask.numpy()
    np.testing.assert_allclose(ours[m], ref[m], atol=ATOL, rtol=RTOL)

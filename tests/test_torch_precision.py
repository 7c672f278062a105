"""The port's precision policies (``compile/precision.py``, ``ops/quant.py``,
``nn/linear.Linear``, the gates of ``ops/dispatch.py`` and
``Program(precision=...)``) against the JAX package, on the same numpy
inputs and weights.

* ``ops.quant``: int8 levels, scales and products equal the JAX
  package's bit for bit, rows with exact .5 ties included.
* ``Linear`` under int8 (dynamic, recording and static routes) equals
  JAX ``Linear`` bit for bit, and records the same max.
* ``calibrate_int8`` records one scale per ``Linear`` site, the JAX
  package's sites through ``port.site_to_jax``, equal to 1e-6 relative
  (the activations agree to float32 rounding, not bit for bit).
* ``Program.forward`` of canonical PNA (3 layers, hidden 128, QM9),
  block- and standard-packed, against JAX ``Program`` with the same
  policy and ``set_fused_mode("always")``, on ``graph_mask`` rows, as a
  share of max |value|:
  - bf16 5e-3: on the CPU the JAX gates run their kernels with
    ``mm="f32"`` (``dispatch.py:417, :650``), so JAX rounds the
    parameters, the node features and the gathered rows to bf16 but not
    the activations at each product; the port's bf16 modes round those
    too, as the JAX kernels do on their chip.  Each rounding is <= 2^-9
    of its value (measured ~1.2e-3 of max).
  - int8 2e-2: the JAX stack gathers with its "split2" hi/lo pair
    (~16 bits of each value) where the port gathers exact float32, and
    any ulp of difference before a quantization can move an int8 level
    (the JAX package holds its own int8 stack to 5e-2 of its XLA int8
    path; measured ~4e-3).
  - int8 with static scales 1e-5: both run their plain paths, float32
    apart from the same int8 products.  Where a float32 kernel stays on
    the path under the calibration (GCN's, LG's and Simple's mp layer,
    the multi-aggregate: ``STATIC_KERNEL_MODELS``), 2e-2 as for dynamic
    int8: the JAX kernel sums through its count-matrix product and the
    port over the slots, an ulp apart, and with one scale per site an
    ulp at a .5 boundary moves a level (measured: Simple, a few outputs
    1e-4 off and one 1.4e-3 of 0.17 after such a flip in the first MLP
    layer; every other output within 1e-7).
* The route each conv takes under each policy: the gates, and the
  kernel functions that ``Program.forward`` reaches."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu.bench.canonical import CANONICAL as JAX_CANONICAL
from gnnbuilder_tpu.bench.canonical import (
    canonical_batches as jax_canonical_batches,
)
from gnnbuilder_tpu.bench.canonical import (
    canonical_model as jax_canonical_model,
)
from gnnbuilder_tpu.compile.precision import Precision as JaxPrecision
from gnnbuilder_tpu.nn.linear import Linear as JaxLinear
from gnnbuilder_tpu.ops import dispatch as jax_dispatch
from gnnbuilder_tpu.ops import quant as jax_quant
from gnnbuilder_tpu_torch import Program
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.compile.precision import (
    Precision,
    active_precision,
)
from gnnbuilder_tpu_torch.nn.linear import Linear
from gnnbuilder_tpu_torch.ops import dispatch, quant
from gnnbuilder_tpu_torch.ops.cuda import (
    edge_block,
    ell_agg,
    gat_block,
    gat_layer,
    gine_layer,
    mp_block,
    mp_layer,
    pna_block,
    pna_layer,
    readout,
)
from gnnbuilder_tpu_torch.port import params_from_jax, site_to_jax

PROGRAM_TOL = {"bf16": 5e-3, "int8": 2e-2, "int8_static": 1e-5,
               "int8_static_kernel": 2e-2}
# models whose forward keeps a float32 kernel under an int8 calibration
# (GCN's, LG's and Simple's mp layer, the multi-aggregate), in both
# packages
STATIC_KERNEL_MODELS = ("gcn", "lg", "simple", "simple_max", "pna5")


def _tied(rows, cols, seed):
    """Random values with a row whose scale is exactly 1 (max |x| = 127)
    and exact .5 ties after the division."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, cols)) * 3).astype(np.float32)
    x[0, 0] = 127.0
    x[0, 1:7] = [2.5, -3.5, 0.5, 1.5, -0.5, 126.5]
    return x


def test_quant_functions_match_jax_bit_for_bit():
    x = _tied(33, 64, 0)
    w = _tied(64, 48, 1)                # [in, out]
    w[:, 0] = x[0]                      # ties in column 0
    for ours, theirs in (
            (quant.quantize_rows(torch.from_numpy(x)),
             jax_quant.quantize_rows(jnp.asarray(x))),
            (quant.quantize_weight(torch.from_numpy(w)),
             jax_quant.quantize_weight(jnp.asarray(w)))):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q, _ = quant.quantize_rows(torch.from_numpy(x))
    assert q[0, 1:7].tolist() == [2, -4, 0, 2, 0, 126]   # half to even
    np.testing.assert_array_equal(
        quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jax_quant.int8_matmul(jnp.asarray(x), jnp.asarray(w))))
    for s in (0.0371, 0.5, 1e-3):
        np.testing.assert_array_equal(
            quant.int8_matmul_static(torch.from_numpy(x),
                                     torch.from_numpy(w), s).numpy(),
            np.asarray(jax_quant.int8_matmul_static(
                jnp.asarray(x), jnp.asarray(w), s)))
    rec = {"a": 3.0, "b": 0.0}
    assert quant.scales_from_record(rec) == jax_quant.scales_from_record(rec)


def test_int8_sum_is_exact_past_float32():
    """K = 2048 levels of +-127: a float32 sum of the products is not
    exact there, the port's is."""
    x = torch.full((2, 2048), 127.0)
    x[1, ::2] = -127.0
    w = torch.full((2048, 3), 127.0)
    w[5, 1] = 126.0
    y = quant.int8_matmul(x, w)
    want = torch.tensor([[2048 * 127 * 127, 2047 * 127 * 127 + 127 * 126,
                          2048 * 127 * 127], [0, -127, 0]],
                        dtype=torch.float64)
    np.testing.assert_array_equal(y.numpy(), want.float().numpy())


@pytest.mark.parametrize("use_bias", [True, False])
def test_linear_int8_routes_match_jax(use_bias):
    rng = np.random.default_rng(2)
    x = _tied(40, 24, 3)
    x[5] = 0.0                              # a zero row: scale 1e-12
    jl = JaxLinear(16, use_bias=use_bias)
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
        params)
    tl = Linear(24, 16, bias=use_bias)
    tl.site = ""                    # a bare flax module's path is ""
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(
            params["params"]["kernel"]).T.copy()))
        if use_bias:
            tl.bias.copy_(torch.from_numpy(
                np.array(params["params"]["bias"])))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)

    def both(ctx_t, ctx_j):
        with torch.no_grad(), Precision.int8().activate(), ctx_t:
            ours = tl(xt).numpy()
        with JaxPrecision.int8().activate(), ctx_j:
            theirs = np.asarray(jl.apply(params, xj))
        np.testing.assert_array_equal(ours, theirs)

    null = contextlib.nullcontext
    both(null(), null())                                      # dynamic
    rec_t, rec_j = {}, {}
    both(quant.calibration(record=rec_t),
         jax_quant.calibration(record=rec_j))                 # recording
    assert rec_t == rec_j == {"": float(np.abs(x).max())}
    sc = jax_quant.scales_from_record(rec_j)
    both(quant.calibration(scales=sc),
         jax_quant.calibration(scales=sc))                    # static
    with torch.no_grad():                                     # f32
        f32 = tl(xt)
    np.testing.assert_allclose(f32.numpy(),
                               np.asarray(jl.apply(params, xj)), rtol=1e-5,
                               atol=1e-4)


def test_precision_policy_objects():
    assert Precision.from_name("bf16") == Precision.bf16()
    assert Precision.from_name("int8").accum_dtype == torch.int32
    with pytest.raises(ValueError, match="unknown precision"):
        Precision.from_name("fp8")
    assert active_precision() is None
    with Precision.bf16().activate() as p:
        assert active_precision() is p and dispatch.policy() == "bf16"
    assert dispatch.policy() == "f32"
    sd = {"w": torch.tensor([1.0 + 2 ** -9, 3.0]),
          "i": torch.tensor([1, 2])}
    cast = Precision.bf16().cast_params(sd)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"] is sd["i"]
    assert Precision.int8().cast_params(sd) is sd
    assert site_to_jax("gnn_convs.5.lin_edge") == "gnn_convs_5/lin_edge"
    assert site_to_jax("mlp_head.linear_layers.2") == "mlp_head/linear_2"
    with pytest.raises(ValueError, match="not a Linear site"):
        site_to_jax("gnn_convs.0.pre_nn.weight")


_PARAMS: dict = {}


def _programs(block_size, layers=3, precision="f32", conv="pna",
              conv_kwargs=None, n_graphs=64, batch_size=32):
    """(JAX Program, port Program, JAX batches, port batches, params) of
    the canonical model with ``conv`` (LG and Simple at input = hidden =
    output = 128 on features padded to 128)."""
    same = conv in ("lg", "simple")
    kw = dict(n_graphs=n_graphs, batch_size=batch_size,
              block_size=block_size, node_multiple=128,
              node_dim=128 if same else None)
    gj, jbs = jax_canonical_batches("qm9", **kw)
    gt, tbs = canonical_batches("qm9", **kw, device="cpu")
    over = dict(gnn_num_layers=layers)
    if conv_kwargs:
        over["conv_kwargs"] = dict(conv_kwargs)
    if same:
        cfg = {**JAX_CANONICAL, **over, "gnn_output_dim": 128}
        jm = gnnb.GNNModel(graph_input_feature_dim=128,
                           graph_input_edge_dim=4, gnn_conv=conv, **cfg)
    else:
        jm = jax_canonical_model(conv, "qm9", graphs=gj, **dict(
            over, conv_kwargs=dict(conv_kwargs or {})))
    tm = canonical_model(conv, "qm9", graphs=gt, **dict(
        over, conv_kwargs=dict(conv_kwargs or {})))
    b0 = jbs[0]
    size = dict(max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                max_graphs=b0.num_graphs, block_size=block_size)
    # the weights do not depend on the packing or the policy: one init
    # per model
    key = (conv, repr(conv_kwargs), layers, n_graphs, batch_size)
    if key not in _PARAMS:
        _PARAMS[key] = jax.tree.map(
            np.asarray, gnnb.Program(jm, **size).init_params(b0))
    params = _PARAMS[key]
    jp = gnnb.Program(jm, precision=precision, **size)
    jp.set_params(jax.tree.map(jnp.asarray, params))
    tp = Program(tm, precision=precision, device="cpu", **size)
    tp.set_params(params_from_jax(params))
    return jp, tp, jbs, tbs, params


def _jax_always(jp, jbs):
    jax_dispatch.set_fused_mode("always")
    try:
        return [np.asarray(jp.forward(b)) for b in jbs]
    finally:
        jax_dispatch.set_fused_mode("auto")


def _count_modes(monkeypatch):
    """{kernel function: [mode of each call]} for rows 1, 2 and 5."""
    calls = {"stack": [], "readout": [], "layer": []}
    for mod, name, key in ((pna_block, "fused_pna_block_stack", "stack"),
                           (readout, "fused_readout", "readout"),
                           (pna_layer, "fused_pna_layer", "layer")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _key=key, **k):
            calls[_key].append(k.get("mode", "f32"))
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("block_size", [128, 0])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_program_policy_matches_jax_program(block_size, precision,
                                            monkeypatch):
    jp, tp, jbs, tbs, _ = _programs(block_size, precision=precision)
    refs = _jax_always(jp, jbs)
    calls = _count_modes(monkeypatch)
    for tb, ref in zip(tbs, refs):
        out = tp.forward(tb)
        assert out.dtype == torch.float32
        m = tb.graph_mask.numpy()
        ours = out.numpy()
        rel = float(np.abs(ours[m] - ref[m]).max() / np.abs(ref[m]).max())
        print(f"Program {precision} block={block_size}: {rel:.3e} of max")
        assert np.isfinite(ours[m]).all()
        assert rel <= PROGRAM_TOL[precision], rel
    n = len(tbs)
    want = ({"stack": [precision] * n, "readout": [precision] * n,
             "layer": []} if block_size else
            {"stack": [], "readout": [precision] * n,
             "layer": [precision] * (3 * n)})
    assert calls == want


# the slice's convs under the policies, by test id: (conv, conv_kwargs)
SLICE_MODELS = {
    "gcn": ("gcn", None), "gin": ("gin", None), "sage": ("sage", None),
    "lg": ("lg", None), "simple": ("simple", None), "gine": ("gine", None),
    "edge": ("edge", None),
    "simple_max": ("simple", {"aggregation": "max"}),
    "pna5": ("pna", {"aggregators": ("sum", "mean", "min", "max", "std")}),
}


def check_program_policy_each_conv(name, precision, block_size,
                                    monkeypatch):
    """``test_program_policy_matches_jax_program`` for every other conv
    whose kernels have the policies' modes (``SLICE_MODELS``; 2 layers, a
    batch of 16 graphs), and int8 with static scales from
    ``calibrate_int8``: the output against JAX ``Program`` at
    ``PROGRAM_TOL``, and the kernel functions reached with the modes the
    JAX gates choose.  The JAX int8 runs gather with
    ``gather_mode="highest"``, as the port does.  The cases run from
    ``tests/test_torch_mp_precision.py`` (the mp convs) and
    ``tests/test_torch_edge_precision.py`` (the rest), so that the three
    files share the work."""
    conv, kw = SLICE_MODELS[name]
    pol = "int8" if precision == "int8_static" else precision
    jp, tp, jbs, tbs, _ = _programs(block_size, layers=2, precision=pol,
                                    conv=conv, conv_kwargs=kw, n_graphs=16,
                                    batch_size=16)
    if pol == "int8":
        jax_dispatch.set_kernel_overrides(gather_mode="highest")
    try:
        if precision == "int8_static":
            # both record on their kernel paths: GCN's kernel path
            # transforms before it aggregates, its plain path after
            jax_dispatch.set_fused_mode("always")
            try:
                js = jp.calibrate_int8(jbs)
            finally:
                jax_dispatch.set_fused_mode("auto")
            ts = tp.calibrate_int8(tbs)
            assert {site_to_jax(k) for k in ts} == set(js)
        refs = _jax_always(jp, jbs)
    finally:
        jax_dispatch.set_kernel_overrides(gather_mode=None)
    calls = _count_calls(monkeypatch)
    for tb, ref in zip(tbs, refs):
        out = tp.forward(tb)
        m = tb.graph_mask.numpy()
        ours = out.numpy()
        rel = float(np.abs(ours[m] - ref[m]).max() / np.abs(ref[m]).max())
        print(f"Program {name} {precision} block={block_size}: {rel:.3e}")
        assert np.isfinite(ours[m]).all()
        tol = PROGRAM_TOL[precision + "_kernel" if precision == "int8_static"
                          and name in STATIC_KERNEL_MODELS else precision]
        assert rel <= tol, rel
    n = len(tbs)
    got = {k: v for k, v in calls.items() if v and k != "readout"}
    want = {k: v * n for k, v in _route(conv, block_size, precision,
                                         name=name).items()}
    assert got == want
    assert calls["readout"] == ([] if precision == "int8_static"
                                else [pol] * n)


@pytest.mark.parametrize("block_size", [128, 0])
def test_calibrate_int8_and_static_forward_match_jax(block_size,
                                                     monkeypatch):
    jp, tp, jbs, tbs, _ = _programs(block_size, precision="int8")
    js = jp.calibrate_int8(jbs)
    calls = _count_modes(monkeypatch)
    ts = tp.calibrate_int8(tbs)
    assert {site_to_jax(k) for k in ts} == set(js)
    assert len(ts) == 3 + 5           # every conv's lin, 5 MLP Linears
    for site, s in ts.items():
        np.testing.assert_allclose(s, js[site_to_jax(site)], rtol=1e-6)
    # the static forward: every kernel gate declines, the plain path runs
    refs = _jax_always(jp, jbs)
    for tb, ref in zip(tbs, refs):
        ours = tp.forward(tb).numpy()
        m = tb.graph_mask.numpy()
        rel = float(np.abs(ours[m] - ref[m]).max() / np.abs(ref[m]).max())
        assert rel <= PROGRAM_TOL["int8_static"], rel
    assert calls == {"stack": [], "readout": [], "layer": []}
    with pytest.raises(ValueError, match="int8"):
        _programs(block_size)[1].calibrate_int8(tbs)


def test_bf16_program_keeps_the_f32_master():
    _, tp, _, tbs, params = _programs(128, layers=2, precision="bf16")
    master = {k: v.clone() for k, v in tp.params.items()}
    tp.forward(tbs[0])
    for k, v in tp.params.items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(v, master[k], rtol=0, atol=0)
    cast = tp._policy_model().state_dict()
    jcast = params_from_jax(jax.tree.map(
        np.asarray, JaxPrecision.bf16().cast_params(
            jax.tree.map(jnp.asarray, params))))
    for k, v in cast.items():
        np.testing.assert_array_equal(v.numpy(), jcast[k].numpy())
    # a master parameter changed in place rebuilds the copy
    name, p0 = next(iter(tp.model.named_parameters()))
    with torch.no_grad():
        p0.mul_(3.0)
    torch.testing.assert_close(tp._policy_model().state_dict()[name],
                               p0.detach().to(torch.bfloat16).float(),
                               rtol=0, atol=0)


# ----------------------------------------------------------------- routes

_CONVS = ("pna", "gcn", "gin", "sage", "lg", "simple", "gat", "gine",
          "edge")
_COUNTED = {
    "pna_stack": (pna_block, "fused_pna_block_stack"),
    "pna_layer": (pna_layer, "fused_pna_layer"),
    "mp_stack": (mp_block, "fused_mp_block_stack"),
    "mp_layer": (mp_layer, "fused_mp_layer"),
    "gat_block": (gat_block, "fused_gat_block_layer"),
    "gat_layer": (gat_layer, "fused_gat_layer"),
    "ell_agg": (ell_agg, "fused_ell_aggregate"),
    "gine_layer": (gine_layer, "fused_gine_layer"),
    "edge_block": (edge_block, "fused_edge_block_layer"),
}


def _route(conv, block, precision, layers=2, name=None):
    """The conv-stack kernels one forward of a ``layers``-layer model
    reaches (the readout aside), with their modes: the JAX gates' choices
    ("int8_static" = int8 under a calibration with static scales; ``name``
    "simple_max" / "pna5" for Simple max and five-aggregator PNA)."""
    L = layers
    static = precision == "int8_static"
    pol = "int8" if static else precision
    f32 = pol == "f32"
    # kernels with a bf16 mode and no int8 one keep float32 under int8
    agg = "bf16" if pol == "bf16" else "f32"
    if name == "simple_max":
        return {} if block else {"ell_agg": [agg] * L}
    if name == "pna5":
        return {"ell_agg": [agg] * L}
    if conv == "pna":
        if static:
            return {}
        return {"pna_stack": [pol]} if block else {"pna_layer": [pol] * L}
    if conv in ("gcn", "sage") and block and not static:
        return {"mp_stack": [pol]}
    if conv in ("gcn", "lg", "simple"):
        return {"mp_layer": [agg] * L}
    if conv in ("gin", "sage"):
        return {} if block or static else {"mp_layer": [pol] * L}
    if conv == "gat":
        return ({"gat_block" if block else "gat_layer": ["f32"] * L}
                if f32 else {})
    if conv == "gine":
        return {} if static else {"gine_layer": [pol] * L}
    return {"edge_block": [pol] * L} if block and pol != "int8" else {}


def _count_calls(monkeypatch):
    """{kernel: [mode of each call]} for every counted kernel function
    and the readout."""
    calls = {k: [] for k in (*_COUNTED, "readout")}
    for key, (mod, name) in {**_COUNTED, "readout": (
            readout, "fused_readout")}.items():
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _key=key, **k):
            calls[_key].append(k.get("mode", "f32"))
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("conv", _CONVS)
def test_route_of_each_conv_under_each_policy(conv, precision,
                                              monkeypatch):
    """Program.forward of a 2-layer canonical model (hidden 128) on a
    block- and a standard-packed batch: the kernel functions it reaches,
    and the readout's mode."""
    calls = _count_calls(monkeypatch)
    kw = dict(conv_kwargs={"heads": 2}) if conv == "gat" else {}
    for block in (128, 0):
        nd = 128 if conv in ("lg", "simple") else None
        gs, (b,) = canonical_batches("qm9", n_graphs=16, batch_size=16,
                                     block_size=block, node_multiple=128,
                                     node_dim=nd, device="cpu")
        model = canonical_model(conv, "qm9", graphs=gs, gnn_num_layers=2,
                                **kw)
        prog = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                       max_graphs=b.num_graphs, block_size=block,
                       precision=precision, device="cpu")
        for v in calls.values():
            v.clear()
        out = prog.forward(b)
        assert bool(torch.isfinite(out[b.graph_mask]).all())
        got = {k: v for k, v in calls.items() if v and k != "readout"}
        assert got == _route(conv, block, precision), (block, got)
        assert calls["readout"] == [precision], block


def test_gates_under_each_policy():
    """The gates' answers, kernel by kernel (UNPORTED_MODES and the JAX
    package's own int8 declines), and under an active calibration every
    gate that would give a kernel the int8 mode declining, while GCN's,
    LG's and Simple's mp layer and the multi-aggregate keep float32."""
    _, (blk,) = canonical_batches("qm9", n_graphs=16, batch_size=16,
                                  block_size=128, node_multiple=128,
                                  device="cpu")
    _, (std,) = canonical_batches("qm9", n_graphs=16, batch_size=16,
                                  node_multiple=128, device="cpu")
    aggrs = ("add", "mean", "max")
    convs = ("gcn", "gin", "sage", "lg", "simple")

    def answers():
        with dispatch.inference_mode():
            return {
                "block": dispatch.block_cfg(blk),
                "pna_stack": dispatch.pna_stack_cfg(blk),
                "pna_layer": dispatch.pna_layer_cfg(std, "relu"),
                "readout": None if dispatch.readout_config(
                    std, aggrs, "relu", None) is None else
                dispatch.readout_config(std, aggrs, "relu", None).get(
                    "mode", "f32"),
                "mp_stack": dispatch.mp_stack_cfg(blk, "gcn"),
                **{f"mp_layer_{c}": dispatch.mp_layer_cfg(std, c)
                   for c in convs},
                "mp_layer_gcn_block": dispatch.mp_layer_cfg(blk, "gcn"),
                "gat_block": dispatch.gat_block_cfg(blk, "relu"),
                "gat_layer": dispatch.gat_layer_cfg(std, "relu"),
                "ell_agg": dispatch.agg_cfg(std),
                "gine_layer": dispatch.gine_layer_cfg(std, "relu"),
                "edge_block": dispatch.edge_block_cfg(blk, "relu"),
            }

    f32 = answers()
    assert f32 == {
        "block": {}, "pna_stack": {"block_size": 128}, "pna_layer": {},
        "readout": "f32", "mp_stack": {"block_size": 128},
        **{f"mp_layer_{c}": {} for c in convs},
        "mp_layer_gcn_block": {"block": True},
        "gat_block": {}, "gat_layer": {}, "ell_agg": {},
        "gine_layer": {}, "edge_block": {}}
    with Precision.bf16().activate():
        assert answers() == {
            "block": {"mm": "bf16"},
            "pna_stack": {"block_size": 128, "mode": "bf16"},
            "pna_layer": {"mode": "bf16"}, "readout": "bf16",
            "mp_stack": {"block_size": 128, "mode": "bf16"},
            **{f"mp_layer_{c}": {"mode": "bf16"} for c in convs},
            "mp_layer_gcn_block": {"block": True, "mode": "bf16"},
            "gat_block": None, "gat_layer": None,
            "ell_agg": {"mode": "bf16"}, "gine_layer": {"mode": "bf16"},
            "edge_block": {"mode": "bf16"}}
    with Precision.int8().activate():
        want = {
            "block": {}, "pna_stack": {"block_size": 128, "mode": "int8"},
            "pna_layer": {"mode": "int8"}, "readout": "int8",
            "mp_stack": {"block_size": 128, "mode": "int8"},
            "mp_layer_gcn": {}, "mp_layer_gin": {"mode": "int8"},
            "mp_layer_sage": {"mode": "int8"}, "mp_layer_lg": {},
            "mp_layer_simple": {}, "mp_layer_gcn_block": {"block": True},
            "gat_block": None, "gat_layer": None, "ell_agg": {},
            "gine_layer": {"mode": "int8"}, "edge_block": None}
        assert answers() == want
        for calib in (dict(record={}), dict(scales={})):
            with quant.calibration(**calib):
                got = answers()
            assert got == {**want, "pna_stack": None, "pna_layer": None,
                           "readout": None, "mp_stack": None,
                           "mp_layer_gin": None, "mp_layer_sage": None,
                           "gine_layer": None}
    assert dispatch.UNPORTED_MODES == {
        ("gat_block", "bf16"), ("gat_layer", "bf16"),
        ("gat_layer", "int8")}

"""Gradients under the bf16 and int8 policies through the layer kernels'
autograd Functions, against the JAX package, on the CPU: the model
(the layers: ``tests/test_torch_policy_grad.py``).

``loss.backward()`` of a 2-layer canonical model (hidden 32) on 12 QM9
graphs under ``Precision.from_name(p).activate()`` with the port's
kernel path ("auto") against ``jax.value_and_grad`` of the JAX model
with ``set_fused_mode("always")``: PNA, GIN, SAGE, GCN, GAT
and GINE under both policies, Simple max and min, five-aggregator PNA
and the edge GAT under bf16; bf16 at 5e-3 of max, int8 at 2e-2.  The
batch has 512 rows, from which the JAX gates take their kernels at
unaligned widths; under bf16 they give them ``mm="bf16"``, as on the
TPU (``_bf16_products``; on the CPU they give "f32"); the JAX int8
runs gather with ``gather_mode="highest"``.  Every parameter gets a
gradient, and the kernel functions are reached in the policy's mode,
the backward kernels too.

Each tolerance is max |ours - ref| <= tol * max |ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu import train as jax_train
from gnnbuilder_tpu.bench.canonical import CANONICAL as JAX_CANONICAL
from gnnbuilder_tpu.bench.canonical import (
    canonical_batches as jax_canonical_batches,
)
from gnnbuilder_tpu.bench.canonical import (
    canonical_model as jax_canonical_model,
)
from gnnbuilder_tpu.compile.precision import Precision as JaxPrecision
from gnnbuilder_tpu.ops import dispatch as jax_dispatch
from gnnbuilder_tpu.ops.pallas import gat_layer as jax_gat
from gnnbuilder_tpu_torch import train
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.compile.precision import Precision
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.ops.cuda import (
    ell_agg,
    gat_layer,
    gine_layer,
    mp_layer,
    pna_layer,
    readout,
)
from gnnbuilder_tpu_torch.port import params_from_jax
from test_torch_policy_grad import _rel, _t

TOL_MODEL = {"bf16": 5e-3, "int8": 2e-2}


# ----------------------------------------------------------- the model

# model cases by test id: (conv, conv_kwargs, policies)
MODEL_CASES = {
    "pna": ("pna", None), "gin": ("gin", None), "sage": ("sage", None),
    "gcn": ("gcn", None), "gat": ("gat", {"heads": 2}),
    "gine": ("gine", None),
    "simple_max": ("simple", {"aggregation": "max"}),
    "simple_min": ("simple", {"aggregation": "min"}),
    "pna5": ("pna", {"aggregators": ("sum", "mean", "min", "max", "std")}),
    "gat_edge": ("gat", {"heads": 2, "edge_dim": 4}),
}
MODEL_POLICIES = [(n, "bf16") for n in MODEL_CASES] + [
    (n, "int8") for n in ("pna", "gin", "sage", "gcn", "gat", "gine")]
HIDDEN = 32

# the kernel functions a train step reaches: (module, name, forward?)
_COUNTED = {
    "pna_layer": (pna_layer, "fused_pna_layer", True),
    "mp_layer": (mp_layer, "fused_mp_layer", True),
    "gine_layer": (gine_layer, "fused_gine_layer", True),
    "gat_layer": (gat_layer, "fused_gat_layer", True),
    "ell_agg": (ell_agg, "fused_ell_aggregate", True),
    "readout": (readout, "fused_readout", True),
    "pna_scatter": (pna_layer, "fused_pna_scatter_cstk", False),
    "pna_gather": (pna_layer, "fused_gather_backward", False),
    "mp_gather": (mp_layer, "fused_gather_backward", False),
    "gat_bwd": (gat_layer, "fused_gat_scatter_backward", False),
    "agg_gather": (ell_agg, "fused_gather_backward", False),
}
# (forward kernel, its backward kernels) of each conv's train step
_ROUTE = {"pna": ("pna_layer", ("pna_scatter", "pna_gather")),
          "gin": ("mp_layer", ("mp_gather",)),
          "sage": ("mp_layer", ("mp_gather",)),
          "gcn": ("mp_layer", ("mp_gather",)),
          "gat": ("gat_layer", ("gat_bwd",)),     # bf16; int8: autograd
          "gine": ("gine_layer", ()),
          # Simple has no parameters: no gradient reaches its layers on
          # raw features (row 8's backward is held at the layer above)
          "simple_max": ("ell_agg", ()),
          "simple_min": ("ell_agg", ()),
          "pna5": ("ell_agg", ()),
          "gat_edge": ("gat_layer", ())}


def _models(name):
    conv, kw = MODEL_CASES[name]
    same = conv == "simple"
    # 512 rows: the JAX gates take their kernels on a batch of unaligned
    # widths from 512 rows on (``nn/conv.py`` ``_layer_cfg``)
    bkw = dict(n_graphs=12, batch_size=12, node_multiple=512,
               node_dim=HIDDEN if same else None)
    gj, (jb,) = jax_canonical_batches("qm9", **bkw)
    gt, (tb,) = canonical_batches("qm9", **bkw, device="cpu")
    over = dict(gnn_num_layers=2, gnn_hidden_dim=HIDDEN,
                gnn_output_dim=HIDDEN if same else 16,
                conv_kwargs=dict(kw or {}))
    if name == "gat":
        # at this geometry the JAX GAT VJP takes its float32 reference
        # (``gat_bwd.supports_gat_scatter`` wants 128-wide heads and two
        # tiles), whose ReLU decisions are the recompute's; the port's
        # bf16 backward is JAX's scatter branch (row 11), with the kernel
        # output's, as JAX's on a geometry its kernel takes.  Under ReLU
        # the two sat 2.7e-2 of max apart where a bf16 output's sign is
        # not the float32 one's (the port's autograd fallback matched to
        # 2e-6); tanh's derivative is continuous.  The layer test holds
        # row 11's bf16 branch with ReLU.
        over["gnn_activation"] = "tanh"
    if same:
        cfg = {**JAX_CANONICAL, **over}
        jm = gnnb.GNNModel(graph_input_feature_dim=HIDDEN,
                           graph_input_edge_dim=4, gnn_conv=conv, **cfg)
    else:
        jm = jax_canonical_model(conv, "qm9", graphs=gj, **over)
    tm = canonical_model(conv, "qm9", graphs=gt, **over)
    params = jm.init(jax.random.PRNGKey(0), jb)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    target = np.random.default_rng(0).standard_normal(
        (tb.num_graphs, 1)).astype(np.float32)
    return jm, jb, params, tm, tb, target


def _bf16_products():
    """Make the JAX gates give their kernels ``mm="bf16"``, as they do on
    the TPU, where on the CPU they give ``"f32"`` (and so does JAX's
    GATConv, which picks its own); returns [(module, name, replaced)],
    for the caller to put back.  Under the bf16 policy the port's kernels
    round the products' operands as the JAX kernels do on their chip;
    against JAX's float32 products (its CPU choice) the gradients of the
    first layers sat 3-12 % of max off (PNA, GIN, SAGE, GAT, GINE), where
    the forwards sit within ``Program``'s 5e-3."""
    saved = []

    def pin(mod, name, wrap):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, wrap(fn))

    def gate(fn):
        def pinned(*a, **k):
            cfg = fn(*a, **k)
            if cfg is not None and cfg.get("mm") == "f32":
                cfg = dict(cfg, mm="bf16")
            return cfg
        return pinned

    def layer(fn):
        return lambda *a, **k: fn(*a, **dict(k, mm="bf16"))

    for name in ("fused_config", "readout_config", "block_layer_cfg"):
        pin(jax_dispatch, name, gate)
    pin(jax_gat, "fused_gat_layer_vjp", layer)
    return saved


@pytest.fixture(scope="module")
def jax_model_grads():
    """{(case, policy): (port model, port batch, target, JAX grads as the
    port's state dict)}, each JAX reference taken once."""
    cache = {}

    def get(name, policy):
        if (name, policy) not in cache:
            jm, jb, params, tm, tb, target = _models(name)

            def loss_fn(pp):
                return jax_train.masked_mse_loss(
                    jm.apply(pp, jb), jnp.asarray(target), jb.graph_mask)

            jax_dispatch.set_fused_mode("always")
            if policy == "int8":
                jax_dispatch.set_kernel_overrides(gather_mode="highest")
            pinned = _bf16_products() if policy == "bf16" else []
            try:
                with JaxPrecision.from_name(policy).activate():
                    _, grads = jax.value_and_grad(loss_fn)(params)
            finally:
                jax_dispatch.set_fused_mode("auto")
                jax_dispatch.set_kernel_overrides(gather_mode=None)
                for mod, fname, fn in pinned:
                    setattr(mod, fname, fn)
            cache[name, policy] = (tm, tb, target, params_from_jax(
                jax.tree.map(np.asarray, grads)))
        return cache[name, policy]

    return get


@pytest.mark.parametrize("name,policy", MODEL_POLICIES)
def test_model_gradients_under_policy_match_jax(name, policy,
                                                jax_model_grads,
                                                monkeypatch):
    tm, tb, target, ref = jax_model_grads(name, policy)
    calls = {k: [] for k in _COUNTED}
    for key, (mod, fname, _) in _COUNTED.items():
        fn = getattr(mod, fname)

        def wrapped(*a, _fn=fn, _key=key, **k):
            calls[_key].append(k.get("mode", "f32"))
            return _fn(*a, **k)
        monkeypatch.setattr(mod, fname, wrapped)
    tm.zero_grad()
    with Precision.from_name(policy).activate():
        loss = train.masked_mse_loss(tm(tb), _t(target), tb.graph_mask)
        loss.backward()
    assert dispatch.get_fused_mode() == "auto"
    for k, p in tm.named_parameters():
        assert p.grad is not None, (name, policy, k)
        rel = _rel(p.grad.numpy(), ref[k].numpy())
        assert rel <= TOL_MODEL[policy], (name, policy, k, rel)
    fwd, bwd = _ROUTE[name]
    # the JAX gates' modes: the multi-aggregate has no int8 mode, and
    # under int8 gcn's mp layer runs no product to quantize
    want = ("f32" if policy == "int8" and name == "gcn" else policy)
    assert calls[fwd] and set(calls[fwd]) == {want}, (fwd, calls[fwd])
    assert calls["readout"] == [policy]
    for k in bwd:
        # int8 GAT: autograd of the float32 plain layer, no row 11
        assert bool(calls[k]) != (name == "gat" and policy == "int8"), (
            name, policy, k)

"""The GCN, GIN and SAGE slice against the JAX package on the CPU.

* ``fused_mp_block_stack`` (its plain version ``mp_stack_plain`` on the
  CPU), through ``mp_block_stack_auto``, against the Pallas
  ``mp_block_stack_auto(interpret=True)`` and ``mp_stack_reference`` for
  gcn, gin and sage, non-uniform widths (11 -> 32 -> 16) and skips, at the
  JAX contract atol 1e-3 (tests/test_mp_block_stack.py).
* The port model's stack path against its own per-layer loop, GIN's
  kernel mode included.
* GCNConv, GINConv and SAGEConv, and ``Program.forward`` of the
  canonical-shaped model (3 layers), on the block-packed (block product
  and stack), standard-packed (ELL table) and table-less (edge list)
  routes, against the JAX convs and ``Program.forward`` on the same
  weights (``params_from_jax``); atol 5e-4 / rtol 1e-3 and 1e-4 of max
  |value| on real rows (f32 sums in another order; GCN's stack transforms
  before it aggregates where the per-layer path aggregates first)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnbuilder_tpu as gnnb
from gnnbuilder_tpu.bench.canonical import canonical_model as jax_model
from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset, load_dataset
from gnnbuilder_tpu.nn import conv as jax_conv
from gnnbuilder_tpu.ops.pallas.mp_block import (
    mp_block_stack_auto as jax_stack_auto,
)
from gnnbuilder_tpu.ops.pallas.mp_block import mp_stack_reference
from gnnbuilder_tpu_torch import Program
from gnnbuilder_tpu_torch.bench.canonical import canonical_model
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.nn import conv as torch_conv
from gnnbuilder_tpu_torch.ops import dispatch
from gnnbuilder_tpu_torch.ops.cuda import mp_block
from gnnbuilder_tpu_torch.port import params_from_jax

STACK_ATOL = 1e-3
ATOL, RTOL = 5e-4, 1e-3
SCALED_TOL = 1e-4
CONVS = ("gcn", "gin", "sage")


def _block_batches(node_dim=11, seed=0):
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=node_dim,
                     seed=seed)
    kw = dict(block_size=128, node_multiple=128)
    return jax_build(gs, **kw), build_graph_batch(gs, device="cpu", **kw)


def _layers(conv, rng, dims):
    """(w0, b0, w1, b1) per layer in [in, out] layout, None where the conv
    has no operand."""
    out = []
    for a, b in zip(dims[:-1], dims[1:]):
        s = 0.4 / np.sqrt(a + 1)

        def r(*shape, sc=s):
            return (rng.standard_normal(shape) * sc).astype(np.float32)

        if conv == "gcn":
            out.append((r(a, b), r(b, sc=0.1), None, None))
        elif conv == "gin":
            out.append((r(a, b), r(b, sc=0.1), r(b, b), r(b, sc=0.1)))
        else:
            out.append((r(a, b), r(b, sc=0.1), r(a, b), None))
    return out


@pytest.mark.parametrize("conv", CONVS)
def test_stack_matches_jax_kernel_and_reference(conv):
    jb, tb = _block_batches()
    dims = (11, 32, 32, 16)
    layers = _layers(conv, np.random.default_rng(7), dims)
    x = np.random.default_rng(3).standard_normal(
        (tb.num_nodes, 11)).astype(np.float32)
    epss = (0.1, 0.2, 0.3)
    skips = (False, True, False)
    F_p = 128
    stacked = mp_block.stack_mp_params(
        [tuple(None if t is None else torch.from_numpy(t) for t in l)
         for l in layers], F_p)
    ours = mp_block.mp_block_stack_auto(
        torch.from_numpy(x), tb.block_adj, tb.in_degree, conv, stacked,
        epss=epss, skips=skips, act="relu", out_dim=16).numpy()
    kern = np.asarray(jax_stack_auto(
        jnp.asarray(x), jb.block_adj, jb.in_degree, conv,
        [tuple(None if t is None else jnp.asarray(t) for t in l)
         for l in layers], epss=epss, skips=skips, act="relu", out_dim=16,
        block_size=128, tile_rows=128, interpret=True,
        gather_mode="highest", mm="f32"))
    ref_layers = [(w, b, np.zeros_like(w) if w1 is None else w1,
                   np.zeros_like(b) if b1 is None else b1)
                  for w, b, w1, b1 in layers]
    ref = np.asarray(mp_stack_reference(
        jnp.asarray(x), jb.block_adj, jb.in_degree, conv, ref_layers, epss,
        skips, act="relu"))[:, :16]
    m = tb.node_mask.numpy()
    for want in (kern, ref):
        np.testing.assert_allclose(ours[m], want[m], atol=STACK_ATOL)
    assert np.isfinite(ours[m]).all()


@pytest.mark.parametrize("conv", CONVS)
def test_model_stack_matches_its_per_layer_loop(conv):
    """The canonical-shaped model (3 layers, hidden 32, output 16) on a
    block-packed batch: the stack (gcn and sage through the model's gate,
    gin through ``mp_block_stack_auto`` on the model's stacked weights)
    against the per-layer conv loop."""
    _, tb = _block_batches()
    gs = load_dataset("qm9", n=4)
    m = canonical_model(conv, "qm9", graphs=gs, gnn_num_layers=3,
                        gnn_hidden_dim=32, gnn_output_dim=16)
    p = Program(m, max_nodes=tb.num_nodes, max_edges=tb.num_edges,
                max_graphs=tb.num_graphs, block_size=128, device="cpu")
    p.init_params()
    with torch.no_grad():
        m.gnn_convs[0].get_parameter(
            "bias" if conv == "gcn" else "lin0.bias" if conv == "gin"
            else "lin_l.bias").uniform_(-0.3, 0.3)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (tb.num_nodes, 11)).astype(np.float32))
    dispatch.set_fused_mode("never")
    try:
        with torch.no_grad():
            loop = m._fused_gnn_stack(tb, x)
            assert loop is None
            h = x
            for i, c in enumerate(m.gnn_convs):
                h = c(tb, h, m.gnn_activation, h if i == 1 else None)
    finally:
        dispatch.set_fused_mode("auto")
    with torch.no_grad(), dispatch.inference_mode():
        if conv == "gin":
            assert dispatch.mp_stack_cfg(tb, conv) is None
            stack = mp_block.mp_block_stack_auto(
                x, tb.block_adj, tb.in_degree, "gin",
                m._kernel_params(128)[0], epss=[0.0] * 3,
                skips=[False, True, False], act="relu", out_dim=16)
        else:
            assert dispatch.mp_stack_cfg(tb, conv) == {"block_size": 128}
            stack = m._fused_gnn_stack(tb, x)
    msk = tb.node_mask
    np.testing.assert_allclose(stack[msk].numpy(), h[msk].numpy(),
                               atol=ATOL, rtol=RTOL)


ROUTES = {
    "block": dict(block_size=128, node_multiple=128),
    "ell": dict(block_size=None, node_multiple=8),
    "edge_list": dict(block_size=None, node_multiple=8, ell_width=0),
}
JAX_CONVS = {"gcn": jax_conv.GCNConv, "gin": jax_conv.GINConv,
             "sage": jax_conv.SAGEConv}


def _route_batches(route):
    graphs = load_dataset("qm9", n=20, seed=2)
    kw = ROUTES[route]
    jb = jax_build(graphs, **kw)
    tb = build_graph_batch(graphs, device="cpu", **kw)
    assert (tb.block_adj is not None) == (route == "block")
    assert (tb.nbr_nodes is None) == (route == "edge_list")
    return graphs, jb, tb


@pytest.mark.parametrize("conv", CONVS)
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("fin,fout", [(11, 24), (24, 16)])
def test_conv_matches_jax_on_each_route(conv, route, fin, fout):
    """One conv layer with act and skip; GCN transforms first only when
    fout <= fin, so both orders run."""
    _, jb, tb = _route_batches(route)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((tb.num_nodes, fin)).astype(np.float32)
    skip = rng.standard_normal((tb.num_nodes, fout)).astype(np.float32)
    jc = JAX_CONVS[conv](in_channels=fin, out_channels=fout)
    jp = jc.init(jax.random.PRNGKey(5), jb, x)
    jp = jax.tree.map(np.asarray, jp)
    if conv == "gcn":   # a nonzero bias, so that its place is checked
        jp["params"]["bias"] = rng.standard_normal(fout).astype(np.float32)
    ref = np.asarray(jc.apply(jp, jb, x, "relu", skip))
    tc = torch_conv.SUPPORTED_GNN_CONVS[conv](fin, fout)
    sd = params_from_jax({"params": {"gnn_convs_0": jp["params"],
                                     "mlp_head": {}}})
    tc.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    for mode in ("auto", "never"):
        dispatch.set_fused_mode(mode)
        try:
            with torch.no_grad():
                ours = tc(tb, torch.from_numpy(x), "relu",
                          torch.from_numpy(skip)).numpy()
        finally:
            dispatch.set_fused_mode("auto")
        m = tb.node_mask.numpy()
        np.testing.assert_allclose(ours[m], ref[m], atol=ATOL, rtol=RTOL,
                                   err_msg=mode)


@pytest.mark.parametrize("conv", CONVS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_program_matches_jax_on_each_route(conv, route):
    graphs, jb, tb = _route_batches(route)
    over = dict(gnn_num_layers=3, gnn_hidden_dim=32, gnn_output_dim=16)
    jm = jax_model(conv, "qm9", graphs=graphs, **over)
    tm = canonical_model(conv, "qm9", graphs=graphs, **over)
    bs = ROUTES[route]["block_size"] or 0
    size = dict(max_nodes=jb.num_nodes, max_edges=jb.num_edges,
                max_graphs=jb.num_graphs, block_size=bs)
    jprog = gnnb.Program(jm, **size)
    params = jax.tree.map(np.asarray, jprog.init_params(jb))
    tp = Program(tm, **size, device="cpu")
    tp.set_params(params_from_jax(params))
    ref = np.asarray(jprog.forward(jb))
    m = tb.graph_mask.numpy()
    calls = []
    orig = mp_block.fused_mp_block_stack

    def counted(*a, **k):
        calls.append(k["conv"])
        return orig(*a, **k)

    mp_block.fused_mp_block_stack = counted
    try:
        for mode in ("auto", "never"):
            dispatch.set_fused_mode(mode)
            try:
                ours = tp.forward(tb).numpy()
            finally:
                dispatch.set_fused_mode("auto")
            assert ours.shape == ref.shape
            assert np.isfinite(ours[m]).all()
            np.testing.assert_allclose(ours[m], ref[m], atol=ATOL,
                                       rtol=RTOL, err_msg=mode)
            err = np.abs(ours[m] - ref[m]).max()
            assert err <= SCALED_TOL * np.abs(ref[m]).max(), (mode, err)
    finally:
        mp_block.fused_mp_block_stack = orig
    stacked = route == "block" and conv in dispatch.MP_STACK_CONVS
    assert calls == ([conv] if stacked else [])


def test_stack_wrapper_rejects_bad_inputs():
    _, tb = _block_batches()
    N, F = tb.num_nodes, 128
    z = torch.zeros
    ops = (z(2, F, F), z(2, F), z(2, F, F), z(2, F))
    x = z(N, F)
    kw = dict(epss=(0.0, 0.0), skips=(False, False))
    with pytest.raises(ValueError, match="unsupported stack conv"):
        mp_block.fused_mp_block_stack(x, tb.block_adj, tb.in_degree, *ops,
                                      conv="pna", **kw)
    with pytest.raises(ValueError, match="w1"):
        mp_block.fused_mp_block_stack(x, tb.block_adj, tb.in_degree,
                                      *ops[:2], z(2, F, 64), ops[3],
                                      conv="gin", **kw)
    with pytest.raises(ValueError, match="block_adj"):
        mp_block.fused_mp_block_stack(x, tb.block_adj[1:], tb.in_degree,
                                      *ops, conv="gcn", **kw)
    with pytest.raises(ValueError, match="one eps"):
        mp_block.fused_mp_block_stack(x, tb.block_adj, tb.in_degree, *ops,
                                      conv="sage", epss=(0.0,),
                                      skips=(False, False))

"""The bf16 mode of the port's multi-aggregate (row 8,
``ops/cuda/ell_agg.py``), the bf16 and int8 modes of its GINE layer (row
12, ``ops/cuda/gine_layer.py``) and the bf16 mode of its EdgeConv layer
(row 13, ``ops/cuda/edge_block.py``): each plain version against the JAX
package's Pallas kernel in interpret mode in the same mode, on the same
numpy inputs and weights.

The JAX kernels run their bf16 mode as ``gather_mode="bf16"`` (with
``mm="bf16"`` where they have products) and GINE's int8 mode as
``quant=True, mm="f32"`` with the exact ``gather_mode="highest"``, as the
port gathers exact float32.

Cases: row 8 for each aggregator alone and the five together, with and
without the receiver shift u (applied after the reduction in this mode,
as the TPU kernel does); row 12 with and without a skip, at the first
layer's width 11 and at 32; row 13 for max, sum and mean.

Tolerances, of max |value| of the JAX output: bf16 2e-3, int8 5e-3,
the bounds of the PNA modes' tests (each bf16 rounding is <= 2^-9 of its
value; an ulp before a quantization can move an int8 level, ~1e-3 of
max).  Each case
also checks that the mode moved the result away from the float32 one,
and that a mode the kernel lacks raises, as does a mode meeting a
gradient."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset
from gnnbuilder_tpu.ops.pallas.edge_block import (
    fused_edge_block_layer as jax_edge,
)
from gnnbuilder_tpu.ops.pallas.ell_agg import fused_ell_aggregate as jax_agg
from gnnbuilder_tpu.ops.pallas.gine_layer import fused_gine_layer as jax_gine
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.ops.cuda import edge_block, ell_agg, gine_layer
from gnnbuilder_tpu_torch.ops.cuda.mp_layer import prepare_layer
from gnnbuilder_tpu_torch.ops.quant import quantize_rows
from test_torch_precision import check_program_policy_each_conv

TOL = {"bf16": 2e-3, "int8": 5e-3}
ALL5 = ("sum", "mean", "min", "max", "std")
AGG_SETS = [(a,) for a in ALL5] + [ALL5]


def _rel(ours, ref):
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _check(ours, ref, f32, mode, what):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all(), what
    rel = _rel(ours, ref)
    extra = ""
    if mode == "int8":
        qa, _ = quantize_rows(torch.from_numpy(ours))
        qb, _ = quantize_rows(torch.from_numpy(ref))
        extra = f", {int((qa != qb).sum())} int8 levels differ"
    moved = _rel(ours, np.asarray(f32))
    print(f"{what} {mode}: {rel:.3e} of max{extra}; {moved:.3e} from f32")
    assert rel <= TOL[mode], (what, rel)
    assert moved > 1e-5, (what, "the mode left the float32 result")


def _t(a):
    return torch.from_numpy(np.array(a))


def _graphs():
    """24 small random graphs (multi-edges; every third graph's node 0
    receives no edge)."""
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=11, seed=4)
    return [dataclasses.replace(g, edge_index=g.edge_index[
        :, g.edge_index[1] != 0]) if i % 3 == 0 else g
        for i, g in enumerate(gs)]


def _batches(**kw):
    gs = _graphs()
    jb, tb = jax_build(gs, **kw), build_graph_batch(gs, device="cpu", **kw)
    assert (tb.in_degree[tb.node_mask] == 0).any()
    return jb, tb


# ---------------------------------------------------------------- row 8

@pytest.mark.parametrize("aggs", AGG_SETS, ids="-".join)
@pytest.mark.parametrize("with_u", [False, True], ids=["v", "u+v"])
def test_ell_agg_bf16_matches_jax_kernel(aggs, with_u):
    jb, tb = _batches(node_multiple=8)
    rng = np.random.default_rng(3)
    N, F = tb.num_nodes, 16
    v = rng.standard_normal((N, F)).astype(np.float32)
    u = rng.standard_normal((N, F)).astype(np.float32) if with_u else None
    tu = None if u is None else _t(u)
    ours = ell_agg.fused_ell_aggregate(_t(v), tb.nbr_nodes, tb.in_degree,
                                       aggs, u=tu, mode="bf16").numpy()
    f32 = ell_agg.fused_ell_aggregate(_t(v), tb.nbr_nodes, tb.in_degree,
                                      aggs, u=tu).numpy()
    ref = np.asarray(jax_agg(
        jnp.asarray(v), jb.nbr_nodes, jb.in_degree, aggs,
        u=None if u is None else jnp.asarray(u), tile_rows=N,
        window_slack=0, interpret=True, gather_mode="bf16"))
    m = tb.node_mask.numpy()
    for i, a in enumerate(aggs):
        sl = slice(i * F, (i + 1) * F)
        _check(ours[m][:, sl], ref[m][:, sl], f32[m][:, sl], "bf16",
               f"ell_agg {a} {'u+v' if with_u else 'v'}")
    # empty rows keep their fills
    empty = (tb.in_degree == 0).numpy() & m
    for i, a in enumerate(aggs):
        fill = np.sqrt(np.float32(1e-5)) if a == "std" else 0.0
        np.testing.assert_allclose(ours[empty][:, i * F:(i + 1) * F], fill,
                                   rtol=1e-6)


def test_ell_agg_modes_raise():
    _, tb = _batches(node_multiple=8)
    v = torch.randn(tb.num_nodes, 8)
    with pytest.raises(ValueError, match="modes"):
        ell_agg.fused_ell_aggregate(v, tb.nbr_nodes, tb.in_degree, ("max",),
                                    mode="int8")
    vg = v.clone().requires_grad_()
    with pytest.raises(ValueError, match="modes"):
        ell_agg.fused_ell_aggregate_vjp(vg, tb.nbr_nodes, tb.in_degree,
                                        ("max",), mode="int8")
    # bf16 has a backward (the JAX _pallas_bwd's)
    ell_agg.fused_ell_aggregate_vjp(vg, tb.nbr_nodes, tb.in_degree,
                                    ("max",), mode="bf16").sum().backward()
    assert vg.grad is not None and torch.isfinite(vg.grad).all()


# --------------------------------------------------------------- row 12

def _gine_operands(rng, N, E, F, H=32, Fout=24):
    def r(*shape, sc=0.4):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    return r(N, F, sc=1.0), r(E, F, sc=1.0), dict(
        w0=r(F, H), b0=r(H, sc=0.1), w1=r(H, Fout), b1=r(Fout, sc=0.1))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("F", [11, 32])
@pytest.mark.parametrize("use_skip", [True, False])
def test_gine_mode_matches_jax_kernel(mode, F, use_skip):
    n_edges = sum(g.num_edges for g in _graphs())
    jb, tb = _batches(node_multiple=8, edge_budget=n_edges + 8)
    N, E = tb.num_nodes, tb.num_edges
    rng = np.random.default_rng(5)
    x, pe, p = _gine_operands(rng, N, E, F)
    skip = (rng.standard_normal((N, 24)).astype(np.float32)
            if use_skip else None)
    tp = {k: _t(a) for k, a in p.items()}
    w0, w1, s0, s1 = prepare_layer(tp["w0"], tp["w1"], mode)
    common = dict(eps=0.2, skip=None if skip is None else _t(skip),
                  act="relu")
    ours = gine_layer.fused_gine_layer(
        _t(x), _t(pe), tb.nbr_nodes, tb.nbr_edges, tb.in_degree, w0,
        tp["b0"], w1, tp["b1"], mode=mode, s0=s0, s1=s1, **common).numpy()
    f32 = gine_layer.fused_gine_layer(
        _t(x), _t(pe), tb.nbr_nodes, tb.nbr_edges, tb.in_degree,
        **tp, **common).numpy()
    jmode = (dict(gather_mode="bf16", mm="bf16") if mode == "bf16" else
             dict(gather_mode="highest", mm="f32", quant=True))
    ref = np.asarray(jax_gine(
        jnp.asarray(x), jnp.asarray(pe), jb.nbr_nodes, jb.nbr_edges,
        jb.row_offsets, jb.in_degree,
        **{k: jnp.asarray(a) for k, a in p.items()}, eps=0.2,
        skip=None if skip is None else jnp.asarray(skip), act="relu",
        tile_rows=N, window_slack=0, interpret=True, **jmode))
    m = tb.node_mask.numpy()
    _check(ours[m], ref[m], f32[m], mode, f"gine F={F} skip={use_skip}")


def test_gine_mode_meeting_a_gradient_raises():
    _, tb = _batches(node_multiple=8)
    N, E = tb.num_nodes, tb.num_edges
    x, pe, p = _gine_operands(np.random.default_rng(0), N, E, 8)
    tp = {k: _t(a).requires_grad_() for k, a in p.items()}
    with pytest.raises(ValueError, match="unknown mode"):
        gine_layer.fused_gine_layer_auto(
            _t(x), _t(pe), tb.nbr_nodes, tb.nbr_edges, tb.in_degree, **tp,
            mode="fp8")
    # bf16 and int8 have a backward (the float32 recompute)
    for mode in ("bf16", "int8"):
        gine_layer.fused_gine_layer_auto(
            _t(x), _t(pe), tb.nbr_nodes, tb.nbr_edges, tb.in_degree, **tp,
            mode=mode).sum().backward()
        assert all(t.grad is not None for t in tp.values())


# --------------------------------------------------------------- row 13

@pytest.mark.parametrize("aggr", ["max", "sum", "mean"])
@pytest.mark.parametrize("Fin,use_skip", [(11, True), (16, False)])
def test_edge_bf16_matches_jax_kernel(aggr, Fin, use_skip):
    jb, tb = _batches(block_size=128, node_multiple=128)
    N = tb.num_nodes
    rng = np.random.default_rng(5)

    def r(*shape, sc=0.4):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    x = r(N, Fin, sc=1.0)
    p = dict(w_pair=r(2 * Fin, 24), b0=r(24, sc=0.1), w1=r(24, 24),
             b1=r(24, sc=0.1))
    skip = r(N, 24, sc=1.0) if use_skip else None
    tp = {k: _t(a) for k, a in p.items()}
    common = dict(aggregation=aggr, skip=None if skip is None else _t(skip),
                  act="relu")
    ours = edge_block.fused_edge_block_layer(
        _t(x), tb.nbr_nodes, tb.in_degree, tp["w_pair"].to(torch.bfloat16),
        tp["b0"], tp["w1"].to(torch.bfloat16), tp["b1"], mode="bf16",
        **common).numpy()
    f32 = edge_block.fused_edge_block_layer(
        _t(x), tb.nbr_nodes, tb.in_degree, **tp, **common).numpy()
    ref = np.asarray(jax_edge(
        jnp.asarray(x), jb.nbr_nodes, jb.in_degree,
        **{k: jnp.asarray(a) for k, a in p.items()}, aggregation=aggr,
        skip=None if skip is None else jnp.asarray(skip), act="relu",
        tile_rows=N, interpret=True, gather_mode="bf16", mm="bf16"))
    m = tb.node_mask.numpy()
    _check(ours[m], ref[m], f32[m], "bf16", f"edge {aggr} Fin={Fin}")


def test_edge_has_no_int8_mode():
    _, tb = _batches(block_size=128, node_multiple=128)
    x = torch.randn(tb.num_nodes, 8)
    w = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="no int8 mode"):
        edge_block.fused_edge_block_layer(
            x, tb.nbr_nodes, tb.in_degree, w, torch.zeros(8),
            torch.zeros(8, 8), torch.zeros(8), mode="int8")
    with pytest.raises(ValueError, match="inference mode"):
        edge_block.fused_edge_block_layer_auto(
            x, tb.nbr_nodes, tb.in_degree, w.requires_grad_(),
            torch.zeros(8), torch.zeros(8, 8), torch.zeros(8), mode="bf16")

# ------------------------------------------------- Program under policies

@pytest.mark.parametrize("block_size", [128, 0])
@pytest.mark.parametrize("precision", ["bf16", "int8", "int8_static"])
@pytest.mark.parametrize("name", ["gine", "edge", "simple_max", "pna5"])
def test_program_policy_matches_jax_program_each_conv(name, precision,
                                                      block_size,
                                                      monkeypatch):
    """``Program(precision=...).forward`` of GINE, EdgeConv, Simple max and five-aggregator PNA
    against JAX
    ``Program`` with ``set_fused_mode("always")``, and the kernels it
    reaches in each mode (``test_torch_precision``'s check)."""
    check_program_policy_each_conv(name, precision, block_size, monkeypatch)

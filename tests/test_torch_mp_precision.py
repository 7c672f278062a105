"""The bf16 and int8 modes of the port's mp layer (row 4,
``ops/cuda/mp_layer.py``) and mp stack (row 3, ``ops/cuda/mp_block.py``):
each plain version against the JAX package's Pallas kernel in interpret
mode in the same mode, on the same numpy inputs and weights.

The JAX kernels run their bf16 mode as ``mm="bf16", gather_mode="bf16"``
and their int8 mode as ``quant=True, mm="f32"`` with the exact
``gather_mode="highest"``: the port's int8 modes gather exact float32,
and the JAX default "split2" gather keeps ~16 bits of each value.

Cases: the layer for each conv in its ELL and block modes in bf16, and
for gin and sage (the convs with products to quantize) in int8; the
stack for gcn, gin and sage in both modes, layer by layer on the JAX
stack's input to each layer, and as a 3-layer chain.

Tolerances, of max |value| of the JAX output: bf16 2e-3, int8 5e-3,
held per layer (the bounds of the PNA modes' tests): each bf16 rounding
is <= 2^-9 of its value, and an ulp of float32 difference before a
quantization (sums in another order) can move an int8 level, ~1e-3 of
max of the next product.  The 3-layer chain is held to the bf16 bound,
and in int8 to the JAX package's bound for its int8 stack against its
XLA int8 path (5e-2); each int8 check reports the count of output levels
(``quantize_rows`` of both outputs) that differ.  A mode the kernel
lacks raises, and so does a mode meeting a gradient."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset
from gnnbuilder_tpu.ops.pallas.mp_block import (
    mp_block_stack_auto as jax_stack_auto,
)
from gnnbuilder_tpu.ops.pallas.mp_layer import fused_mp_layer as jax_layer
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.ops.cuda import mp_block, mp_layer
from gnnbuilder_tpu_torch.ops.quant import quantize_rows
from test_torch_precision import check_program_policy_each_conv

TOL = {"bf16": 2e-3, "int8": 5e-3}
CHAIN_TOL = {"bf16": 2e-3, "int8": 5e-2}
JAX_MODE = {"bf16": dict(mm="bf16", gather_mode="bf16"),
            "int8": dict(mm="f32", gather_mode="highest", quant=True),
            "f32": dict(mm="f32", gather_mode="highest")}
CONVS = ("gin", "sage", "gcn", "lg", "simple_sum", "simple_mean")
LAYER_CASES = ([(c, "bf16") for c in CONVS]
               + [(c, "int8") for c in mp_layer.QUANT_CONVS])


def _rel(ours, ref):
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _levels_differ(ours, ref) -> int:
    qa, _ = quantize_rows(torch.from_numpy(np.array(ours)))
    qb, _ = quantize_rows(torch.from_numpy(np.array(ref)))
    return int((qa != qb).sum())


def _check(ours, ref, mode, what, tol=None):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all(), what
    rel = _rel(ours, ref)
    extra = (f", {_levels_differ(ours, ref)} int8 levels of {ours.size} "
             f"differ" if mode == "int8" else "")
    print(f"{what} {mode}: {rel:.3e} of max{extra}")
    assert rel <= (TOL[mode] if tol is None else tol), (what, rel)


def _t(a):
    return torch.from_numpy(np.array(a))


def _batches(block):
    """24 small random graphs (multi-edges; every third graph's node 0
    receives no edge), block-packed at 128 rows or standard-packed."""
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=11, seed=4)
    gs = [dataclasses.replace(g, edge_index=g.edge_index[
        :, g.edge_index[1] != 0]) if i % 3 == 0 else g
        for i, g in enumerate(gs)]
    kw = (dict(block_size=128, node_multiple=128) if block
          else dict(node_multiple=8))
    jb, tb = jax_build(gs, **kw), build_graph_batch(gs, device="cpu", **kw)
    assert (tb.in_degree[tb.node_mask] == 0).any()
    return jb, tb


def _layer_operands(conv, rng, N):
    """(v, params as numpy) for one layer of ``conv``: gin 11 -> 32 -> 32,
    sage 11 -> 16, the rest 16 wide."""
    def r(*shape, sc=0.4):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    if conv == "gin":
        return r(N, 11, sc=1.0), dict(w0=r(11, 32), b0=r(32, sc=0.1),
                                      w1=r(32, 32), b1=r(32, sc=0.1))
    if conv == "sage":
        return r(N, 11, sc=1.0), dict(w0=r(11, 16), b0=r(16, sc=0.1),
                                      w1=r(11, 16))
    if conv == "gcn":
        return r(N, 16, sc=1.0), dict(b0=r(16, sc=0.1))
    return r(N, 16, sc=1.0), {}


def _run_layer(conv, mode, block, act="relu", use_skip=True, f32=False):
    """(ours, JAX) on real rows; with ``f32`` also the port's float32
    output (the mode must move it)."""
    jb, tb = _batches(block)
    N = tb.num_nodes
    rng = np.random.default_rng(5)
    v, p = _layer_operands(conv, rng, N)
    Fout = {"gin": 32, "sage": 16}.get(conv, v.shape[1])
    skip = (rng.standard_normal((N, Fout)).astype(np.float32)
            if use_skip else None)
    eps = 0.15 if conv == "gin" else 0.0
    tp = {k: _t(a) for k, a in p.items()}
    w0, w1, s0, s1 = mp_layer.prepare_layer(tp.get("w0"), tp.get("w1"),
                                            mode)
    ours = mp_layer.fused_mp_layer(
        _t(v), tb.nbr_nodes, tb.in_degree, conv, w0=w0, b0=tp.get("b0"),
        w1=w1, b1=tp.get("b1"), eps=eps,
        skip=None if skip is None else _t(skip), act=act,
        block_adj=tb.block_adj if block else None, mode=mode, s0=s0, s1=s1)
    sched = (dict(block_adj=jb.block_adj) if block
             else dict(window_slack=0))
    ref = jax_layer(
        jnp.asarray(v), None if block else jb.nbr_nodes, jb.in_degree, conv,
        **{k: jnp.asarray(a) for k, a in p.items()}, eps=eps,
        skip=None if skip is None else jnp.asarray(skip), act=act,
        tile_rows=N, interpret=True, **sched, **JAX_MODE[mode])
    m = tb.node_mask.numpy()
    if not f32:
        return ours.numpy()[m], np.asarray(ref)[m]
    plain = mp_layer.fused_mp_layer(
        _t(v), tb.nbr_nodes, tb.in_degree, conv, **tp, eps=eps,
        skip=None if skip is None else _t(skip), act=act,
        block_adj=tb.block_adj if block else None)
    return ours.numpy()[m], np.asarray(ref)[m], plain.numpy()[m]


@pytest.mark.parametrize("conv,mode", LAYER_CASES,
                         ids=[f"{c}-{m}" for c, m in LAYER_CASES])
@pytest.mark.parametrize("packing", ["ell", "block"])
def test_layer_mode_matches_jax_kernel(conv, mode, packing):
    ours, ref, f32 = _run_layer(conv, mode, packing == "block", f32=True)
    _check(ours, ref, mode, f"mp layer {conv} {packing}")
    assert _rel(ours, f32) > 1e-5, "the mode left the float32 result"


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_layer_mode_activations(mode):
    """gin without a skip, under tanh: the epilogue's order in each
    mode."""
    ours, ref = _run_layer("gin", mode, False, act="tanh", use_skip=False)
    _check(ours, ref, mode, "mp layer gin tanh")


def test_prepare_layer_matches_jax_quantization():
    from gnnbuilder_tpu.ops.quant import quantize_weight as jax_qw

    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((11, 32)).astype(np.float32)
    w1 = rng.standard_normal((32, 32)).astype(np.float32)
    q0, q1, s0, s1 = mp_layer.prepare_layer(_t(w0), _t(w1), "int8")
    for q, s, w in ((q0, s0, w0), (q1, s1, w1)):
        jq, js = jax_qw(jnp.asarray(w))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    b0, b1, n0, n1 = mp_layer.prepare_layer(_t(w0), _t(w1), "bf16")
    assert b0.dtype == b1.dtype == torch.bfloat16 and n0 is n1 is None
    np.testing.assert_array_equal(
        b0.float().numpy(),
        np.asarray(jnp.asarray(w0).astype(jnp.bfloat16)
                   .astype(jnp.float32)))


def test_layer_modes_raise_where_the_kernel_has_none():
    _, tb = _batches(False)
    N = tb.num_nodes
    v = torch.randn(N, 16)
    with pytest.raises(ValueError, match="int8 mode exists for"):
        mp_layer.fused_mp_layer(v, tb.nbr_nodes, tb.in_degree, "gcn",
                                b0=torch.zeros(16), mode="int8")
    with pytest.raises(ValueError, match="int8 mode exists for"):
        mp_layer.fused_mp_layer(v, tb.nbr_nodes, tb.in_degree,
                                "simple_sum", save_s=True, mode="int8")
    with pytest.raises(ValueError, match="in mode 'bf16'"):
        mp_layer.fused_mp_layer(v, tb.nbr_nodes, tb.in_degree, "sage",
                                w0=torch.zeros(16, 16), b0=torch.zeros(16),
                                w1=torch.zeros(16, 16), mode="bf16")
    # a mode meeting a gradient: int8 still only for gin and sage, whose
    # backward is the JAX straight-through one
    vg = v.clone().requires_grad_()
    with pytest.raises(ValueError, match="int8 mode exists for"):
        mp_layer.fused_mp_layer_auto(vg, tb.nbr_nodes, tb.in_degree, "gcn",
                                     b0=torch.zeros(16), mode="int8")
    w = torch.zeros(16, 16, requires_grad=True)
    mp_layer.fused_mp_layer_auto(v, tb.nbr_nodes, tb.in_degree, "sage",
                                 w0=w, b0=torch.zeros(16), w1=w,
                                 mode="int8").sum().backward()
    assert w.grad is not None


# ----------------------------------------------------------------- stack

def _stack_layers(conv, rng, dims):
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


def _run_stack(tb, jb, x, layers, conv, mode, epss, skips, act="relu"):
    """The port's stack and the JAX kernel on the same layers."""
    stacked = mp_block.stack_mp_params(
        [tuple(None if a is None else _t(a) for a in lay) for lay in layers],
        128)
    st, sc = mp_block.prepare_mp_stack(stacked, mode)
    out_dim = (layers[-1][2] if conv == "gin" else layers[-1][0]).shape[1]
    ours = mp_block.mp_block_stack_auto(
        _t(x), tb.block_adj, tb.in_degree, conv, st, epss=epss, skips=skips,
        act=act, out_dim=out_dim, mode=mode, scales=sc).numpy()
    ref = np.asarray(jax_stack_auto(
        jnp.asarray(x), jb.block_adj, jb.in_degree, conv,
        [tuple(None if a is None else jnp.asarray(a) for a in lay)
         for lay in layers], epss, skips, act=act, block_size=128,
        tile_rows=tb.num_nodes, interpret=True, **JAX_MODE[mode]))
    return ours, ref


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("conv", ["gcn", "gin", "sage"])
def test_stack_mode_per_layer_and_chain_match_jax_kernel(conv, mode):
    """Each of 3 layers alone (a 1-layer stack) on the JAX stack's input
    to that layer, widths 11 -> 32 -> 32 -> 16 with a skip on the middle
    layer; then the 3-layer chain."""
    jb, tb = _batches(True)
    dims = (11, 32, 32, 16)
    layers = _stack_layers(conv, np.random.default_rng(7), dims)
    x = np.random.default_rng(3).standard_normal(
        (tb.num_nodes, 11)).astype(np.float32)
    epss, skips = (0.1, 0.2, 0.3), (False, True, False)
    m = tb.node_mask.numpy()
    h = x
    for l in range(3):
        ours, ref = _run_stack(tb, jb, h, layers[l:l + 1], conv, mode,
                               epss[l:l + 1], skips[l:l + 1])
        _check(ours[m], ref[m], mode, f"mp stack {conv} layer {l}")
        h = ref
    ours, ref = _run_stack(tb, jb, x, layers, conv, mode, epss, skips)
    _check(ours[m], ref[m], mode, f"mp stack {conv} chain",
           tol=CHAIN_TOL[mode])
    f32, _ = _run_stack(tb, jb, x, layers, conv, "f32", epss, skips)
    moved = _rel(ours[m], f32[m])
    print(f"mp stack {conv} chain {mode} against f32: {moved:.3e} of max")
    assert moved > 1e-5, "the mode left the float32 result"


def test_prepare_mp_stack_matches_jax_wrapper():
    """bf16 rounding and the int8 levels and scales of the padded stacked
    weights equal the JAX wrapper's (``quantize_weight`` per layer; a
    zero w1 quantizes to zero levels)."""
    from gnnbuilder_tpu.ops.quant import quantize_weight as jax_qw

    layers = _stack_layers("gcn", np.random.default_rng(0), (11, 32, 16))
    stacked = mp_block.stack_mp_params(
        [tuple(None if a is None else _t(a) for a in lay) for lay in layers],
        128)
    st, sc = mp_block.prepare_mp_stack(stacked, "int8")
    for k, i in enumerate((0, 2)):
        assert st[i].dtype == torch.int8
        for l in range(len(layers)):
            q, s = jax_qw(jnp.asarray(stacked[i][l].numpy()))
            np.testing.assert_array_equal(st[i][l].numpy(), np.asarray(q))
            np.testing.assert_array_equal(sc[k][l].numpy(), np.asarray(s))
    assert not st[2].any()
    with pytest.raises(ValueError, match="takes scales"):
        mp_block.fused_mp_block_stack(
            torch.zeros(128, 128), torch.zeros(1, 128, 128),
            torch.zeros(128, dtype=torch.int32), *st, conv="gcn",
            epss=(0.0, 0.0), skips=(False, False), mode="int8")
    st, sc = mp_block.prepare_mp_stack(stacked, "bf16")
    assert sc is None and st[0].dtype == torch.bfloat16
    assert st[1].dtype == torch.float32

# ------------------------------------------------- Program under policies

@pytest.mark.parametrize("block_size", [128, 0])
@pytest.mark.parametrize("precision", ["bf16", "int8", "int8_static"])
@pytest.mark.parametrize("name", ["gcn", "gin", "sage", "lg", "simple"])
def test_program_policy_matches_jax_program_each_conv(name, precision,
                                                      block_size,
                                                      monkeypatch):
    """``Program(precision=...).forward`` of the mp convs against JAX
    ``Program`` with ``set_fused_mode("always")``, and the kernels it
    reaches in each mode (``test_torch_precision``'s check)."""
    check_program_policy_each_conv(name, precision, block_size, monkeypatch)

"""The bf16 and int8 modes of the port's PNA stack (row 1), readout (row 2)
and PNA layer (row 5): each plain version against the JAX package's
Pallas kernel in interpret mode in the same mode, and the readout against
``readout_reference(quant=True)``, on the same numpy inputs (3 layers at
hidden 128, the size of ``tests/test_pna_block_stack.py``).

The JAX kernels run their bf16 mode as ``mm="bf16", gather_mode="bf16"``
and their int8 mode as ``quant=True, mm="f32"`` with the exact
``gather_mode="highest"``: the port's int8 modes gather exact float32 v,
and the JAX default "split2" gather keeps ~16 bits of each value.

Tolerances, of max |value| of the JAX output: bf16 2e-3, int8 5e-3, each
held per layer, on the same layer input.  Chained through layers, the
comparison would measure something else: an ulp of float32 difference
before a quantization (the sums run in another order on each side)
moves an int8 level at a rounding boundary, and one level moves the
next layer's output by ~1e-3 of max.  The whole 3-layer stack is held to
the bf16 bound, and in int8 to the JAX package's own bound for its int8
stack against its XLA int8 path (5e-2, ``test_pna_block_stack.py``); each
int8 check reports the count of output int8 levels (``quantize_rows`` of
both outputs) that differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset
from gnnbuilder_tpu.ops.pallas.pna_block import (
    _stack_params as jax_stack_params,
)
from gnnbuilder_tpu.ops.pallas.pna_block import (
    fused_pna_block_stack as jax_fused_stack,
)
from gnnbuilder_tpu.ops.pallas.pna_layer import (
    fused_pna_layer as jax_fused_layer,
)
from gnnbuilder_tpu.ops.pallas.readout import fused_readout as jax_readout
from gnnbuilder_tpu.ops.pallas.readout import readout_reference
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.ops import segment
from gnnbuilder_tpu_torch.ops.cuda import pna_block, pna_layer, readout
from gnnbuilder_tpu_torch.ops.quant import quantize_rows

TOL = {"bf16": 2e-3, "int8": 5e-3}
INT8_CHAIN_TOL = 5e-2
JAX_MODE = {"bf16": dict(mm="bf16", gather_mode="bf16"),
            "int8": dict(mm="f32", gather_mode="highest", quant=True)}


def _rel(ours, ref):
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _levels_differ(ours, ref) -> int:
    qa, _ = quantize_rows(torch.from_numpy(np.array(ours)))
    qb, _ = quantize_rows(torch.from_numpy(np.array(ref)))
    return int((qa != qb).sum())


def _graphs(seed=0):
    return FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=8,
                       edge_dim=4, seed=seed)


def _layer(rng, f_in, f, f_out):
    # the JAX stack tests' scales: 3-layer magnitudes stay O(1)
    s = 0.3 / np.sqrt(f_in + 1)
    n = rng.standard_normal
    arrs = (n((2 * f_in, f)) * s, n(f) * 0.1, n((f_in + 12 * f, f_out)) * s,
            n(f_out) * 0.1, n((f_out, f_out)) * s, n(f_out) * 0.1)
    return tuple(a.astype(np.float32) for a in arrs)


def _stack_setup(seed=1, L=3):
    gs = _graphs()
    b = build_graph_batch(gs, block_size=128, node_multiple=128, device="cpu")
    g = jax_build(gs, block_size=128, node_multiple=128)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b.num_nodes, 128)).astype(np.float32)
    layers = [_layer(rng, 128, 128, 128) for _ in range(L)]
    return b, g, x, layers


def _stacks(layers):
    ours = pna_block.stack_params(
        [tuple(torch.from_numpy(a) for a in lay) for lay in layers], 128)
    ref = jax_stack_params(
        tuple(tuple(jnp.asarray(a) for a in lay) for lay in layers), 128)
    return ours, ref


def _run_stack(b, g, x, layers, mode, deltas, skips, act):
    ours_st, ref_st = _stacks(layers)
    st, sc = pna_block.prepare_stack(ours_st, mode)
    ours = pna_block.fused_pna_block_stack(
        torch.from_numpy(x), b.nbr_nodes, b.in_degree, *st, deltas=deltas,
        skips=skips, act=act, mode=mode, scales=sc).numpy()
    ref = np.asarray(jax_fused_stack(
        jnp.asarray(x), g.nbr_nodes, g.in_degree, *ref_st, deltas=deltas,
        skips=skips, act=act, block_size=128, tile_rows=b.num_nodes,
        interpret=True, **JAX_MODE[mode]))
    return ours, ref


def test_prepare_stack_matches_jax_wrapper():
    """bf16 rounding and the int8 levels and scales of the padded,
    regrouped stacks equal the JAX wrapper's, bit for bit."""
    from gnnbuilder_tpu.ops.quant import quantize_weight as jax_qw

    rng = np.random.default_rng(0)
    layers = [_layer(rng, 11, 128, 128), _layer(rng, 128, 128, 64)]
    ours_st, ref_st = _stacks(layers)
    mats = (0, 1, 3, 4, 6)
    st, _ = pna_block.prepare_stack(ours_st, "bf16")
    for i in mats:
        want = np.asarray(jnp.asarray(ref_st[i]).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        np.testing.assert_array_equal(st[i].float().numpy(), want)
    st, sc = pna_block.prepare_stack(ours_st, "int8")
    for k, i in enumerate(mats):
        for l in range(len(layers)):
            q, s = jax_qw(ref_st[i][l])
            np.testing.assert_array_equal(st[i][l].numpy(), np.asarray(q))
            np.testing.assert_array_equal(sc[k][l].numpy(), np.asarray(s))
        assert st[i].dtype == torch.int8
    for i in (2, 5, 7):     # biases stay float32
        assert st[i].dtype == torch.float32


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("act,skip", [("relu", False), ("relu", True),
                                      ("tanh", False), ("sigmoid", True)])
def test_stack_mode_per_layer_matches_jax_kernel(mode, act, skip):
    """Each of 3 layers alone (a 1-layer stack) on the JAX stack's input
    to that layer, against the JAX kernel in the same mode."""
    b, g, x, layers = _stack_setup()
    deltas = (2.0, 1.5, 2.5)
    h = x
    for l, lay in enumerate(layers):
        ours, ref = _run_stack(b, g, h, [lay], mode, (deltas[l],), (skip,),
                               act)
        rel = _rel(ours, ref)
        print(f"row 1 {mode} {act} skip={skip} layer {l}: {rel:.3e} of "
              f"max, {_levels_differ(ours, ref)} int8 levels differ of "
              f"{ours.size}")
        assert rel <= TOL[mode], (l, rel)
        h = ref


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_stack_mode_whole_matches_jax_kernel(mode):
    b, g, x, layers = _stack_setup()
    ours, ref = _run_stack(b, g, x, layers, mode, (2.0, 1.5, 2.5),
                           (False, True, False), "relu")
    rel = _rel(ours, ref)
    print(f"row 1 {mode}, 3 layers chained: {rel:.3e} of max, "
          f"{_levels_differ(ours, ref)} int8 levels differ of {ours.size}")
    assert np.isfinite(ours).all()
    assert rel <= (TOL["bf16"] if mode == "bf16" else INT8_CHAIN_TOL)


def test_stack_modes_are_their_precision():
    """The modes are not the f32 function: bf16 and int8 differ from f32
    by more than f32 rounding, and by less than their own bound."""
    b, g, x, layers = _stack_setup(L=1)
    ours_st, _ = _stacks(layers)
    outs = {}
    for mode in ("f32", "bf16", "int8"):
        st, sc = pna_block.prepare_stack(ours_st, mode)
        outs[mode] = pna_block.fused_pna_block_stack(
            torch.from_numpy(x), b.nbr_nodes, b.in_degree, *st,
            deltas=(2.0,), skips=(False,), act="relu", mode=mode,
            scales=sc).numpy()
    for mode, bound in (("bf16", 2e-2), ("int8", 5e-2)):
        rel = _rel(outs[mode], outs["f32"])
        assert 1e-5 < rel < bound, (mode, rel)


def _readout_setup(block_size, seed=6):
    gs = FakeDataset(num_graphs=40, avg_num_nodes=12, node_dim=8, seed=5)
    b = build_graph_batch(gs, block_size=block_size, node_multiple=128,
                          device="cpu")
    g = jax_build(gs, block_size=block_size, node_multiple=128)
    rng = np.random.default_rng(seed)
    F = 64
    x = rng.standard_normal((b.num_nodes, F)).astype(np.float32)
    ws, d = [], 3 * F
    for o in (64, 64, 64, 64, 1):
        ws.append(((rng.standard_normal((d, o)) / np.sqrt(d)).astype(
            np.float32), (rng.standard_normal(o) * 0.1).astype(np.float32)))
        d = o
    return b, g, x, ws


@pytest.mark.parametrize("block_size", [None, 128])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_readout_mode_matches_jax_kernel_and_reference(block_size, mode):
    """The canonical head (192-64-64-64-64-1, add|mean|max pooling):
    the JAX kernel in interpret mode in the same mode, and in int8 also
    ``readout_reference(quant=True)``; graph_mask rows."""
    from gnnbuilder_tpu.ops import segment as jax_segment

    b, g, x, ws = _readout_setup(block_size)
    aggrs = ("add", "mean", "max")
    maxg = b.max_graph_nodes_static
    mx_t = segment.contiguous_segment_max(
        torch.from_numpy(x), b.graph_starts, b.n_node, maxg)
    mx_j = jax_segment.contiguous_segment_max(
        jnp.asarray(x), g.graph_starts, g.n_node, maxg)
    tw = [(torch.from_numpy(w), torch.from_numpy(c)) for w, c in ws]
    head, scales = readout.prepare_head(tw, mode)
    ours = readout.fused_readout(
        torch.from_numpy(x), b.n_node, head, aggrs=aggrs, mx=mx_t,
        act="relu", starts=b.graph_starts, mode=mode,
        scales=scales).numpy()
    jw = tuple((jnp.asarray(w), jnp.asarray(c)) for w, c in ws)
    jkw = dict(mm="bf16") if mode == "bf16" else dict(mm="f32", quant=True)
    kern = np.asarray(jax_readout(
        jnp.asarray(x), g.n_node, jw, aggrs=aggrs, mx=mx_j, act="relu",
        maxg=maxg, tile_graphs=8, interpret=True,
        starts=g.graph_starts if block_size else None,
        block_size=block_size or 0, **jkw))
    m = b.graph_mask.numpy()
    refs = {"kernel": kern}
    if mode == "int8":
        refs["reference"] = np.asarray(readout_reference(
            jnp.asarray(x), g.n_node, jw, aggrs=aggrs, mx=mx_j, act="relu",
            quant=True, starts=g.graph_starts if block_size else None))
    for name, ref in refs.items():
        rel = _rel(ours[m], ref[m])
        print(f"row 2 {mode} block={block_size} vs JAX {name}: {rel:.3e} "
              f"of max, {_levels_differ(ours[m], ref[m])} int8 levels "
              f"differ of {ours[m].size}")
        assert rel <= TOL[mode], (name, rel)


def _layer_batch(node_dim=128, seed=11):
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=node_dim,
                     edge_dim=4, seed=seed)
    b = build_graph_batch(gs, node_multiple=8, device="cpu")
    g = jax_build(gs, node_multiple=8)
    return b, g


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("act,use_skip", [("relu", True), ("relu", False),
                                          ("tanh", True)])
def test_layer_mode_matches_jax_kernel(mode, act, use_skip):
    """Row 5 at hidden 128, each of 3 layers on the JAX kernel's output
    of the layer before (the first on the batch's 128-wide features)."""
    b, g = _layer_batch()
    N = b.num_nodes
    rng = np.random.default_rng(3)
    h = np.asarray(g.node_feat)
    for l in range(3):
        p = _layer(rng, 128, 128, 128)
        skip = h if use_skip else None
        tp = [torch.from_numpy(a) for a in p]
        w_pre, k_post, w_lin, s_lin = pna_layer.prepare_layer(
            tp[0], tp[2], tp[4], mode)
        ours = pna_layer.fused_pna_layer(
            torch.from_numpy(np.array(h)), b.nbr_nodes, b.in_degree, w_pre,
            tp[1], k_post, tp[3], w_lin, tp[5], 1.7,
            skip=None if skip is None else torch.from_numpy(np.array(skip)),
            act=act, mode=mode, s_lin=s_lin).numpy()
        ref = np.asarray(jax_fused_layer(
            jnp.asarray(h), g.nbr_nodes, g.in_degree,
            *[jnp.asarray(a) for a in p], 1.7,
            skip=None if skip is None else jnp.asarray(skip), tile_rows=N,
            window_slack=0, interpret=True, act=act, **JAX_MODE[mode]))
        rel = _rel(ours, ref)
        print(f"row 5 {mode} {act} skip={use_skip} layer {l}: {rel:.3e} "
              f"of max, {_levels_differ(ours, ref)} int8 levels differ of "
              f"{ours.size}")
        assert rel <= TOL[mode], (l, rel)
        h = ref


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_layer_auto_pads_in_mode(mode):
    """The zero-padding entry in a mode at the canonical first (11 -> 128)
    and last (128 -> 64) widths equals the unpadded plain layer on the
    padded operands, sliced (pad lanes are inert in both modes)."""
    b, _ = _layer_batch(node_dim=11)
    rng = np.random.default_rng(4)
    x = b.node_feat
    for fin, fout in ((11, 128), (128, 64)):
        if x.shape[1] != fin:
            x = torch.from_numpy(
                rng.standard_normal((b.num_nodes, fin)).astype(np.float32))
        p = [torch.from_numpy(a) for a in _layer(rng, fin, fin, fout)]
        got = pna_layer.fused_pna_layer_auto(
            x, b.nbr_nodes, b.in_degree, *p, 1.3, act="relu", mode=mode)
        ops = pna_layer.pad_operands(x, *p)
        w_pre, k_post, w_lin, s_lin = pna_layer.prepare_layer(
            ops[1], ops[3], ops[5], mode)
        want = pna_layer.pna_layer_plain(
            ops[0], b.nbr_nodes, b.in_degree, w_pre, ops[2], k_post, ops[4],
            w_lin, ops[6], 1.3, act="relu", mode=mode, s_lin=s_lin)
        assert got.shape == (b.num_nodes, fout)
        np.testing.assert_array_equal(got.numpy(), want[:, :fout].numpy())


def test_modes_reject_what_they_do_not_take():
    b, _ = _layer_batch()
    rng = np.random.default_rng(5)
    p = [torch.from_numpy(a) for a in _layer(rng, 128, 128, 128)]
    x = b.node_feat
    with pytest.raises(ValueError, match="unknown mode"):
        pna_layer.fused_pna_layer(x, b.nbr_nodes, b.in_degree, *p, 1.0,
                                  mode="fp8", save_res=True)
    # the modes write the residuals, out the same bits as without
    q = list(p)
    q[0], q[2], q[4], s_lin = pna_layer.prepare_layer(p[0], p[2], p[4],
                                                      "int8")
    res = pna_layer.fused_pna_layer(x, b.nbr_nodes, b.in_degree, *q, 1.0,
                                    mode="int8", s_lin=s_lin, save_res=True)
    assert len(res) == 5
    assert torch.equal(res[0], pna_layer.fused_pna_layer(
        x, b.nbr_nodes, b.in_degree, *q, 1.0, mode="int8", s_lin=s_lin))
    with pytest.raises(ValueError, match="w_lin"):
        pna_layer.fused_pna_layer(x, b.nbr_nodes, b.in_degree, *p, 1.0,
                                  mode="int8", s_lin=torch.ones(128))
    with pytest.raises(ValueError, match="unknown mode"):
        pna_block.prepare_stack(None, "fp8")
    with pytest.raises(ValueError, match="scale"):
        readout.fused_readout(
            torch.zeros(8, 4), torch.tensor([8], dtype=torch.int32),
            [(torch.zeros(4, 2, dtype=torch.int8), torch.zeros(2))],
            mode="int8")

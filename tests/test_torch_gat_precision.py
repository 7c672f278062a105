"""The bf16 mode of the port's GAT block layer (row 9,
``ops/cuda/gat_block.py``) and the bf16 and int8 modes of its GAT layer
(row 10, ``ops/cuda/gat_layer.py``): each plain version against the JAX
package's Pallas kernel in interpret mode in the same mode, on the same
numpy inputs and weights, and the weights' preparation.  GAT's cases of
the per-conv ``Program`` check run from
``tests/test_torch_gat_policy.py``.

The JAX block kernel runs its bf16 mode as ``mm="bf16"``; the JAX layer
kernel as ``mm="bf16"`` or ``quant=True`` (``mm="f32"``), both with the
exact ``gather_mode="highest"``: the layer kernel rounds nothing of the
gathered payload in any gather mode but keeps ~16 bits of it in its
default "split2" pair, and the port gathers exact float32.

Tolerances, of max |value| of the JAX output, per layer: bf16 2e-3, int8
5e-3, the bounds of the other modes' tests (``test_torch_mp_precision``):
each bf16 rounding is <= 2^-9 of its value, and an ulp of float32
difference before a quantization (sums in another order) can move an
int8 level.  Each case must also move the output off float32 by more
than 1e-5 of max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.ops.pallas import gat_block as jax_gat_block
from gnnbuilder_tpu.ops.pallas import gat_layer as jax_gat_layer
from gnnbuilder_tpu.ops.pallas.pna_layer import _dot_mm
from gnnbuilder_tpu.ops.quant import quantize_weight as jax_qw
from gnnbuilder_tpu_torch.ops.cuda import gat_block, gat_layer
from test_torch_gat import _batches, _layer_params, _t
from test_torch_mp_precision import _check, _rel

JAX_LAYER_MODE = {"bf16": dict(mm="bf16"), "int8": dict(mm="f32", quant=True),
                  "f32": dict(mm="f32")}


def _layer_inputs(heads, C, seed, fin=11, concat=True, skip=True,
                  block=False):
    jb, tb = _batches(block)
    N = tb.num_nodes
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, fin)).astype(np.float32)
    p = _layer_params(rng, fin, heads, C, concat)
    out_w = heads * C if concat else C
    sk = (rng.standard_normal((N, out_w)).astype(np.float32) if skip
          else None)
    return jb, tb, x, p, sk


def _run_layer(mode, heads, C, act, use_skip, self_loops=True, seed=0):
    """(ours, JAX, ours in f32) on real rows for row 10 in ``mode``."""
    jb, tb, x, p, sk = _layer_inputs(heads, C, seed, skip=use_skip)
    w, sw = gat_layer.prepare_layer(_t(p["w"]), mode)
    kw = dict(self_loops=self_loops, act=act,
              skip=None if sk is None else _t(sk))
    args = (_t(p["att_src"]), _t(p["att_dst"]), _t(p["bias"]), heads)
    ours = gat_layer.fused_gat_layer(_t(x), tb.nbr_nodes, tb.in_degree, w,
                                     *args, mode=mode, sw=sw, **kw)
    f32 = gat_layer.fused_gat_layer(_t(x), tb.nbr_nodes, tb.in_degree,
                                    _t(p["w"]), *args, **kw)
    ref = jax_gat_layer.fused_gat_layer_vjp(
        jnp.asarray(x), jb.nbr_nodes, jb.in_degree,
        *(jnp.asarray(p[k]) for k in p), heads, self_loops=self_loops,
        skip=None if sk is None else jnp.asarray(sk), act=act,
        tile_rows=tb.num_nodes, window_slack=0, interpret=True,
        gather_mode="highest", **JAX_LAYER_MODE[mode])
    m = tb.node_mask.numpy()
    return ours.numpy()[m], np.asarray(ref)[m], f32.numpy()[m]


LAYER_CASES = [(2, 8, "relu", True, True), (4, 8, "tanh", False, True),
               (1, 16, None, True, False)]


@pytest.mark.parametrize("heads,C,act,use_skip,self_loops", LAYER_CASES,
                         ids=["h2-relu-skip", "h4-tanh", "h1-noloops"])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_layer_mode_matches_jax_kernel(mode, heads, C, act, use_skip,
                                       self_loops):
    ours, ref, f32 = _run_layer(mode, heads, C, act, use_skip, self_loops,
                                seed=heads * 10 + C)
    _check(ours, ref, mode, f"gat layer h{heads} {act}")
    assert _rel(ours, f32) > 1e-5, "the mode left the float32 result"


def _run_block(concat, act, use_skip, self_loops, seed=3):
    jb, tb, x, p, sk = _layer_inputs(2, 8, seed, concat=concat,
                                     skip=use_skip, block=True)
    H = 2
    w, wa_src, wa_dst = gat_block.prepare_block(
        _t(p["w"]), _t(p["att_src"]), _t(p["att_dst"]), "bf16")
    kw = dict(self_loops=self_loops, act=act, concat=concat,
              skip=None if sk is None else _t(sk))
    rest = (_t(p["att_src"]), _t(p["att_dst"]), _t(p["bias"]), H)
    with torch.no_grad():
        ours = gat_block.fused_gat_block_layer(
            _t(x), tb.block_adj, w, *rest, mode="bf16", wa_src=wa_src,
            wa_dst=wa_dst, **kw)
        f32 = gat_block.fused_gat_block_layer(_t(x), tb.block_adj,
                                              _t(p["w"]), *rest, **kw)
    ref = jax_gat_block.gat_block_layer_auto(
        jnp.asarray(x), jb.block_adj, *(jnp.asarray(p[k]) for k in p), H,
        self_loops=self_loops, skip=None if sk is None else jnp.asarray(sk),
        act=act, block_size=128, tile_rows=128, interpret=True, mm="bf16",
        concat=concat)
    m = tb.node_mask.numpy()
    return ours.numpy()[m], np.asarray(ref)[m], f32.numpy()[m]


@pytest.mark.parametrize("concat", [True, False], ids=["concat", "mean"])
@pytest.mark.parametrize("act,use_skip", [("relu", True), (None, False)],
                         ids=["relu-skip", "none"])
def test_block_bf16_matches_jax_kernel(concat, act, use_skip):
    """With self loops (GATConv's default): without them JAX's CPU
    backend cannot run the bf16 block kernel (``DotThunk`` has no bf16 x
    bf16 = f32 product, which the logit terms' dot then reaches
    unfused)."""
    ours, ref, f32 = _run_block(concat, act, use_skip, True)
    _check(ours, ref, "bf16", f"gat block concat={concat}")
    assert _rel(ours, f32) > 1e-5, "the mode left the float32 result"


def test_block_logit_terms_follow_the_jax_order():
    """The bf16 logit terms are x . bf16(bf16(W) A), as the JAX kernel
    forms them, to float32 rounding; h . att_src with h from the bf16
    product is another function in bf16, more than 1e-4 of max away."""
    jb, tb, x, p, _ = _layer_inputs(2, 8, 5, skip=False, block=True)
    w, wa_src, wa_dst = gat_block.prepare_block(
        _t(p["w"]), _t(p["att_src"]), _t(p["att_dst"]), "bf16")
    xb = _t(x).to(torch.bfloat16).float()
    h = (xb @ w.float()).reshape(-1, 2, 8)
    ours = (xb @ wa_src.float()).numpy()
    other = (h * _t(p["att_src"])).sum(-1).numpy()
    dotx = _dot_mm("bf16")
    eye = jnp.eye(2, dtype=jnp.float32)
    bd = (jnp.asarray(p["att_src"]).reshape(2, 8)[:, :, None]
          * eye[:, None, :]).reshape(16, 2)
    ref = np.asarray(dotx(jnp.asarray(x), dotx(jnp.asarray(p["w"]), bd)))
    m = tb.node_mask.numpy()
    assert _rel(ours[m], ref[m]) < 1e-6
    assert _rel(other[m], ref[m]) > 1e-4


def test_prepare_matches_jax():
    """int8 levels and scales bit for bit against JAX ``quantize_weight``;
    bf16 weights and the block kernel's logit weights against the JAX
    wrapper's bf16 rounding of ``w`` and of ``w @ blockdiag(att)``."""
    rng = np.random.default_rng(1)
    p = _layer_params(rng, 11, 4, 8)
    q, s = gat_layer.prepare_layer(_t(p["w"]), "int8")
    jq, js = jax_qw(jnp.asarray(p["w"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    wb, none = gat_layer.prepare_layer(_t(p["w"]), "bf16")
    assert wb.dtype == torch.bfloat16 and none is None
    np.testing.assert_array_equal(
        wb.float().numpy(), np.asarray(jnp.asarray(p["w"]).astype(
            jnp.bfloat16).astype(jnp.float32)))
    w, wa_src, wa_dst = gat_block.prepare_block(
        _t(p["w"]), _t(p["att_src"]), _t(p["att_dst"]), "bf16")
    np.testing.assert_array_equal(w.float().numpy(), wb.float().numpy())
    eye = jnp.eye(4, dtype=jnp.float32)
    for wa, att in ((wa_src, p["att_src"]), (wa_dst, p["att_dst"])):
        assert wa.dtype == torch.bfloat16 and tuple(wa.shape) == (11, 4)
        bd = (jnp.asarray(att).reshape(4, 8)[:, :, None]
              * eye[:, None, :]).reshape(32, 4)
        ref = np.asarray(_dot_mm("bf16")(jnp.asarray(p["w"]), bd).astype(
            jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(wa.float().numpy(), ref)
    assert gat_block.prepare_block(_t(p["w"]), None, None, "f32")[1:] == (
        None, None)
    with pytest.raises(ValueError, match="modes"):
        gat_block.prepare_block(_t(p["w"]), _t(p["att_src"]),
                                _t(p["att_dst"]), "int8")


def test_conv_mode_operands_are_what_the_kernels_take():
    """``GATConv.mode_operands`` (the model's per-mode cache) gives
    contiguous weights of each mode's type: the card's wrappers refuse
    anything else (``lin.weight.t()`` is a strided view)."""
    from gnnbuilder_tpu_torch.nn.conv import GATConv

    conv = GATConv(11, 8, heads=2)
    for mode, want in (("bf16", {"layer": (torch.bfloat16, None),
                                 "block": (torch.bfloat16,) + (
                                     torch.bfloat16,) * 2}),
                       ("int8", {"layer": (torch.int8, torch.float32)})):
        with torch.no_grad():
            ops = conv.mode_operands(mode)
        assert set(ops) == set(want)
        for key, types in want.items():
            for t, dt in zip(ops[key], types):
                assert (t is None) == (dt is None)
                if t is not None:
                    assert t.dtype == dt and t.is_contiguous(), (mode, key)


def test_modes_raise_on_a_gradient_and_on_wrong_operands():
    jb, tb, x, p, _ = _layer_inputs(2, 8, 2, skip=False)
    w = _t(p["w"]).requires_grad_()
    rest = (_t(p["att_src"]), _t(p["att_dst"]), _t(p["bias"]), 2)
    with pytest.raises(ValueError, match="unknown mode"):
        gat_layer.fused_gat_layer_auto(_t(x), tb.nbr_nodes, tb.in_degree, w,
                                       *rest, mode="fp8")
    # the layer's modes have a backward (the JAX _make_vjp_fn's)
    for mode in ("bf16", "int8"):
        w.grad = None
        gat_layer.fused_gat_layer_auto(_t(x), tb.nbr_nodes, tb.in_degree, w,
                                       *rest, mode=mode).sum().backward()
        assert w.grad is not None and torch.isfinite(w.grad).all()
    with pytest.raises(ValueError, match="sw goes with"):
        gat_layer.fused_gat_layer(_t(x), tb.nbr_nodes, tb.in_degree,
                                  *gat_layer.prepare_layer(_t(p["w"]),
                                                           "int8")[:1],
                                  *rest, mode="int8")
    with pytest.raises(ValueError, match="in mode 'bf16'"):
        gat_layer.fused_gat_layer(_t(x), tb.nbr_nodes, tb.in_degree,
                                  _t(p["w"]), *rest, mode="bf16")
    jb, tb, x, p, _ = _layer_inputs(2, 8, 2, skip=False, block=True)
    ops = gat_block.prepare_block(_t(p["w"]), _t(p["att_src"]),
                                  _t(p["att_dst"]), "bf16")
    xg = _t(x).requires_grad_()
    with pytest.raises(ValueError, match="inference mode"):
        gat_block.fused_gat_block_layer(xg, tb.block_adj, ops[0], *rest,
                                        mode="bf16", wa_src=ops[1],
                                        wa_dst=ops[2])
    with pytest.raises(ValueError, match="wa_src and wa_dst"):
        gat_block.fused_gat_block_layer(_t(x), tb.block_adj, ops[0], *rest,
                                        mode="bf16")

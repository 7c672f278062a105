"""The host side of the tensor-core GAT kernels (csrc/gat_common.cuh, the
projection of csrc/gat_layer.cu and csrc/gat_block.cu), against the JAX
package on the same numpy inputs:

* ``stage_projection`` lays the weights out per head, chunk and 32-k tile
  in mma B-fragment order; read back at the byte offsets the kernels read
  (``_kernel_b``, written from the kernels' addressing, not from the
  staging code) they are the JAX weights bit for bit: in f32 their TF32
  halves, in bf16 the bf16 weights with the logit columns bf16(bf16(W)
  A) of the JAX block kernel appended, in int8 the JAX levels (and the
  column scales the kernel reads beside them);
* the f32 mode's split-TF32 products (hi*hi + hi*lo + lo*hi of
  ``split_tf32`` halves, emulated in torch on the weights read back) keep
  a canonical GAT layer (Fin 512, heads 4 x 128) within 1e-5 of max of
  the JAX ``fused_gat_layer`` and ``fused_gat_block_layer`` in interpret
  mode with float32 products; one TF32 pass is logged beside it and lands
  further off;
* the bf16 logit halves as two more MMA columns (the logit tile read
  back) keep the block layer within the bf16 mode's 2e-3 of the JAX block
  kernel with ``mm="bf16"``;
* the model keeps each layer's staged weights under inference and
  rebuilds them when a parameter changes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.ops.pallas import gat_block as jax_gat_block
from gnnbuilder_tpu.ops.pallas import gat_layer as jax_gat_layer
from gnnbuilder_tpu.ops.pallas.pna_layer import _dot_mm
from gnnbuilder_tpu.ops.quant import quantize_weight as jax_qw
from gnnbuilder_tpu_torch.ops import block
from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.cuda import gat_block, gat_layer
from gnnbuilder_tpu_torch.ops.cuda.pna_block import split_tf32
from test_torch_gat import _batches, _layer_params, _t
from test_torch_mp_precision import _check, _rel

TOL_OUT = 1e-5
SHAPES = [(11, 4, 128), (512, 4, 64), (24, 3, 20), (40, 2, 200)]

# the kernels' geometry (csrc/gat_common.cuh)
KDEPTH = {"f32": 8, "bf16": 16, "int8": 32}
PAIR_BYTES = {"f32": 1024, "bf16": 512, "int8": 512}
VALUE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def _a_k(mode, t, reg, e):
    """The k (within a k-step) of value e of A register `reg` of lane
    t, as the kernels load A: f32 a float2 at 2t (reg 0: .x, reg 1: .y);
    bf16 a float4 at 4t packed in pairs; int8 a uint2 at byte 8t."""
    return {"f32": 2 * t + reg, "bf16": 4 * t + 2 * reg + e,
            "int8": 8 * t + 4 * reg + e}[mode]


def _values(raw, mode, offsets):
    """The weights of ``mode`` at byte ``offsets`` of the staged bytes."""
    nb = VALUE_BYTES[mode]
    word = np.zeros(offsets.shape, np.int64)
    for b in range(nb):
        word |= raw[offsets + b].astype(np.int64) << (8 * b)
    if mode == "f32":
        return word.astype(np.uint32).view(np.float32).astype(np.float64)
    if mode == "bf16":
        return (word.astype(np.uint32) << 16).view(np.float32).astype(
            np.float64)
    return word.astype(np.uint8).view(np.int8).astype(np.float64)


def _kernel_b(staged, Fin, H, C, mode, logit=False):
    """Each head's B operand as the kernels read it: [halves, Fin, H*C]
    (f32: hi, lo), and with ``logit`` the logit columns [Fin, H, 2].  Per
    region (head, chunk), 32-k tile, k-step, pair p of n8 tiles and lane
    (g, t) (4 NP pairs a chunk, 2 NP of them a column warp): 16 bytes at
    tile + ks * KSB + p * PB + 16 lane (f32: the lo half 512 bytes on),
    registers (tile0 b0, tile0 b1, tile1 b0, tile1 b1), B column 8 (2 p +
    tile) + g; the logit tile's 8 bytes a lane after the pairs."""
    CW = 64 if C <= 64 else 128
    NP, nch, nk = CW // 64, -(-C // CW), -(-Fin // 32)
    kd = KDEPTH[mode]
    E = {"f32": 1, "bf16": 2, "int8": 4}[mode]
    PB = PAIR_BYTES[mode]
    KSB = 4 * NP * PB + (256 if logit else 0)
    TB = (32 // kd) * KSB
    assert staged.numel() * staged.element_size() == H * nch * nk * TB
    raw = staged.contiguous().view(torch.uint8).numpy()
    halves = 2 if mode == "f32" else 1
    B = np.zeros((halves, nk * 32, H, nch * CW))
    L = np.zeros((nk * 32, H, 8))
    reg_, kc, ks, p, lane, tile, r, e = np.meshgrid(
        np.arange(H * nch), np.arange(nk), np.arange(32 // kd),
        np.arange(4 * NP), np.arange(32), np.arange(2), np.arange(2),
        np.arange(E), indexing="ij")
    g, t = lane // 4, lane % 4
    head, ch = reg_ // nch, reg_ % nch
    base = reg_ * nk * TB + kc * TB + ks * KSB
    off = (base + p * PB + 16 * lane + 4 * (2 * tile + r)
           + VALUE_BYTES[mode] * e)
    k = kc * 32 + ks * kd + _a_k(mode, t, r, e)
    n = ch * CW + 8 * (2 * p + tile) + g
    for half in range(halves):
        B[half, k, head, n] = _values(raw, mode, off + 512 * half)
    if logit:
        sel = tile == 0         # one n8 tile: 8 bytes a lane
        off = base + 4 * NP * PB + 8 * lane + 4 * r + 2 * e
        L[k[sel], head[sel], g[sel]] = _values(raw, mode, off[sel])
        # every chunk of a head carries the same logit tile
    assert not B[:, Fin:].any() and not B[..., C:].any()
    w = B[:, :Fin, :, :C].reshape(halves, Fin, H * C)
    if not logit:
        return w
    assert not L[:, :, 2:].any() and not L[Fin:].any()
    return w, L[:Fin, :, :2]


@pytest.mark.parametrize("Fin,H,C", SHAPES)
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_staged_weights_read_back_as_the_jax_weights(mode, Fin, H, C):
    rng = np.random.default_rng(Fin + H + C)
    p = _layer_params(rng, Fin, H, C)
    jw = jnp.asarray(p["w"])
    w, sw = gat_layer.prepare_layer(_t(p["w"]), mode)
    got = _kernel_b(gat_layer.stage_projection(w, H, mode), Fin, H, C, mode)
    if mode == "f32":        # the TF32 halves of the JAX weights
        want = torch.stack(split_tf32(_t(p["w"]))).double().numpy()
    elif mode == "bf16":
        want = np.asarray(jw.astype(jnp.bfloat16).astype(jnp.float32))[None]
    else:
        jq, js = jax_qw(jw)
        want = np.asarray(jq).astype(np.float64)[None]
        np.testing.assert_array_equal(sw.numpy(), np.asarray(js))
    np.testing.assert_array_equal(got, want)
    back = gat_layer.unstage_projection(
        gat_layer.stage_projection(w, H, mode), Fin, H, C, mode)
    np.testing.assert_array_equal(back.double().numpy(),
                                  want if mode == "f32" else want[0])


@pytest.mark.parametrize("Fin,H,C", SHAPES)
def test_block_bf16_layout_carries_the_jax_logit_weights(Fin, H, C):
    """The block kernel's bf16 layout: the bf16 weights and, in each
    k-step's logit tile, wa_src[:, hd] and wa_dst[:, hd] = the JAX
    wrapper's bf16(bf16(W) blockdiag(att)) (``_dot_mm("bf16")``)."""
    rng = np.random.default_rng(7 * Fin + C)
    p = _layer_params(rng, Fin, H, C)
    w, wa_src, wa_dst = gat_block.prepare_block(
        _t(p["w"]), _t(p["att_src"]), _t(p["att_dst"]), "bf16")
    staged = gat_layer.stage_projection(w, H, "bf16", wa_src, wa_dst)
    got_w, got_l = _kernel_b(staged, Fin, H, C, "bf16", logit=True)
    jw = jnp.asarray(p["w"])
    np.testing.assert_array_equal(
        got_w[0], np.asarray(jw.astype(jnp.bfloat16).astype(jnp.float32)))
    eye = jnp.eye(H, dtype=jnp.float32)
    for i, att in enumerate((p["att_src"], p["att_dst"])):
        bd = (jnp.asarray(att).reshape(H, C)[:, :, None]
              * eye[:, None, :]).reshape(H * C, H)
        ref = np.asarray(_dot_mm("bf16")(jw, bd).astype(jnp.bfloat16)
                         .astype(jnp.float32))
        np.testing.assert_array_equal(got_l[:, :, i], ref)


def _tf32_h(x, w_halves, passes):
    """x @ w in split TF32 (hi*hi + hi*lo + lo*hi, summed in f32) from the
    weights' halves as the kernel reads them; ``passes`` 1: hi*hi."""
    xh, xl = split_tf32(x)
    wh, wl = (torch.from_numpy(a).float() for a in w_halves)
    if passes == 1:
        return xh @ wh
    return xl @ wh + xh @ wl + xh @ wh


def _canonical(block_packed, seed):
    jb, tb = _batches(block_packed)
    N, Fin, H, C = tb.num_nodes, 512, 4, 128
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, Fin)).astype(np.float32)
    p = _layer_params(rng, Fin, H, C)
    p["w"] = p["w"] / np.float32(np.sqrt(Fin))
    sk = rng.standard_normal((N, H * C)).astype(np.float32)
    halves = _kernel_b(gat_layer.stage_projection(_t(p["w"]), H, "f32"),
                       Fin, H, C, "f32")
    return jb, tb, x, p, sk, halves


@pytest.mark.parametrize("passes", [3, 1])
def test_split_tf32_layer_matches_the_jax_layer_kernel(passes, capsys):
    jb, tb, x, p, sk, halves = _canonical(False, 11)
    H = 4
    h = _tf32_h(_t(x), halves, passes).view(-1, H, 128)
    att_s, att_d = _t(p["att_src"]), _t(p["att_dst"])
    orig = gat_layer._project
    gat_layer._project = lambda *a, **k: (h, (h * att_s).sum(-1),
                                          (h * att_d).sum(-1))
    try:
        ours = gat_layer.gat_layer_plain(
            _t(x), tb.nbr_nodes, tb.in_degree, _t(p["w"]), att_s, att_d,
            _t(p["bias"]), H, skip=_t(sk), act="relu").numpy()
    finally:
        gat_layer._project = orig
    kern = jax_gat_layer.fused_gat_layer_vjp(
        jnp.asarray(x), jb.nbr_nodes, jb.in_degree,
        *(jnp.asarray(p[k]) for k in p), H, skip=jnp.asarray(sk),
        act="relu", tile_rows=tb.num_nodes, window_slack=0, interpret=True,
        gather_mode="highest", mm="f32")
    m = tb.node_mask.numpy()
    rel = _rel(ours[m], np.asarray(kern)[m])
    with capsys.disabled():
        print(f"\ngat layer Fin 512, 4 x 128, {passes} TF32 pass(es): "
              f"{rel:.3e} of max against the JAX kernel")
    if passes == 3:
        assert rel <= TOL_OUT
    else:
        assert rel > TOL_OUT, "one TF32 pass should leave the f32 result"


def _block_from_h(tb, h, a_src, a_dst, bias, skip, bf16_sum=False):
    out = block.block_gat_attention(tb.block_adj, h, a_src, a_dst,
                                    bf16_sum=bf16_sum)
    return ACTIVATIONS["relu"](out.reshape(tb.num_nodes, -1) + bias + skip)


@pytest.mark.parametrize("passes", [3, 1])
def test_split_tf32_block_matches_the_jax_block_kernel(passes, capsys):
    jb, tb, x, p, sk, halves = _canonical(True, 12)
    H = 4
    h = _tf32_h(_t(x), halves, passes).view(-1, H, 128)
    ours = _block_from_h(tb, h, (h * _t(p["att_src"])).sum(-1),
                         (h * _t(p["att_dst"])).sum(-1), _t(p["bias"]),
                         _t(sk)).numpy()
    kern = jax_gat_block.gat_block_layer_auto(
        jnp.asarray(x), jb.block_adj, *(jnp.asarray(p[k]) for k in p), H,
        skip=jnp.asarray(sk), act="relu", block_size=128, tile_rows=128,
        interpret=True, mm="f32")
    m = tb.node_mask.numpy()
    rel = _rel(ours[m], np.asarray(kern)[m])
    with capsys.disabled():
        print(f"\ngat block Fin 512, 4 x 128, {passes} TF32 pass(es): "
              f"{rel:.3e} of max against the JAX kernel")
    if passes == 3:
        assert rel <= TOL_OUT
    else:
        assert rel > TOL_OUT, "one TF32 pass should leave the f32 result"


@pytest.mark.parametrize("concat", [True, False], ids=["concat", "mean"])
def test_bf16_logit_columns_match_the_jax_block_kernel(concat):
    """h and the logit halves as the bf16 block kernel forms them: bf16(x)
    against the weights and the logit tile read back from the staged
    layout, both in one product; then the block attention with the
    weighted sum in bf16: within the bf16 mode's 2e-3 of the JAX block
    kernel with mm="bf16"."""
    jb, tb = _batches(True)
    N, H, C = tb.num_nodes, 2, 8
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, 11)).astype(np.float32)
    p = _layer_params(rng, 11, H, C, concat)
    sk = rng.standard_normal((N, H * C if concat else C)).astype(np.float32)
    w, wa_src, wa_dst = gat_block.prepare_block(
        _t(p["w"]), _t(p["att_src"]), _t(p["att_dst"]), "bf16")
    wk, lk = _kernel_b(gat_layer.stage_projection(w, H, "bf16", wa_src,
                                                  wa_dst),
                       11, H, C, "bf16", logit=True)
    xb = _t(x).to(torch.bfloat16).double()
    h = (xb @ torch.from_numpy(wk[0])).float().view(N, H, C)
    a = (xb @ torch.from_numpy(lk.reshape(11, 2 * H))).float().view(N, H, 2)
    out = block.block_gat_attention(tb.block_adj, h, a[..., 0], a[..., 1],
                                    bf16_sum=True)
    out = out.reshape(N, -1) if concat else out.mean(dim=1)
    ours = ACTIVATIONS["relu"](out + _t(p["bias"]) + _t(sk)).numpy()
    ref = jax_gat_block.gat_block_layer_auto(
        jnp.asarray(x), jb.block_adj, *(jnp.asarray(p[k]) for k in p), H,
        skip=jnp.asarray(sk), act="relu", block_size=128, tile_rows=128,
        interpret=True, mm="bf16", concat=concat)
    m = tb.node_mask.numpy()
    _check(ours[m], np.asarray(ref)[m], "bf16", f"logit tile concat={concat}")


def test_model_keeps_the_staged_weights_until_a_parameter_changes():
    """``GNNModel._gat_operands`` under f32 inference: each layer's
    ``mode_operands("f32")`` (one staged layout for both kernels), the
    same tensors on a second call, new ones after an in-place update (an
    optimizer step), and none under a gradient."""
    from gnnbuilder_tpu_torch.bench.canonical import canonical_model

    model = canonical_model("gat", "qm9", conv_kwargs=dict(heads=2))
    with torch.no_grad():
        ops = model._gat_operands()
        assert len(ops) == model.gnn_num_layers
        for conv, o in zip(model.gnn_convs, ops):
            w, sw, staged = o["layer"]
            assert sw is None and o["block"][3] is staged
            np.testing.assert_array_equal(
                gat_layer.unstage_projection(
                    staged, conv.in_channels, conv.heads, conv.out_channels,
                    "f32").numpy(),
                torch.stack(split_tf32(conv.lin.weight.t().contiguous()))
                .numpy())
        assert model._gat_operands()[0]["layer"][2] is ops[0]["layer"][2]
        model.gnn_convs[0].lin.weight.add_(1.0)
        fresh = model._gat_operands()[0]["layer"][2]
        assert fresh is not ops[0]["layer"][2]
        assert not torch.equal(fresh, ops[0]["layer"][2])
    assert model._gat_operands() is None       # grad mode: no cache

"""The host side of the tensor-core PNA layer kernel (csrc/pna_layer.cu),
against the JAX package on the same numpy inputs:

* ``stage_layer`` lays the weights out in sections; read back at the
  byte offsets the kernels read (``_kernel_ks``, written from the
  aggregate kernel's addressing, and the GAT test's ``_kernel_b`` for the
  two projection sections, not from the staging code) they are the JAX
  weights bit for bit: the x products ([Wi | K0], in bf16 [Wj | Wi |
  K0]), k_post's scaler rows and w_lin, in f32 their TF32 halves, in bf16
  the bf16 weights, in int8 the f32 halves of the first two and the JAX
  levels of w_lin; in f32 and int8 Wj, whole, ahead of them (the v
  launch's FMAs read it); ``unstage_layer`` gives them back too;
* the kernel's f32 products emulated in torch (split TF32 in three
  passes, hi*hi + hi*lo + lo*hi, each k-step of 8 a chain from zero added
  in float32, through the plain version's ``_f32_dot`` seam; v a float32
  product, as the kernel's FMAs) keep the layer, residuals included,
  within 2e-5 of max (the std block 2e-4, tie counts and the extrema of
  empty rows exact) of the JAX ``fused_pna_layer`` in interpret mode and
  of ``pna_layer_reference``, at 128 and 256 wide; one TF32 pass is
  logged beside it;
* ``layer_operands`` with a gradient (a train step's operands from its
  live weights, all layers in one gather, the parameters' transposed
  views read in place) gives the differentiable padded weights and the
  bytes of ``stage_layer`` of them;
* ``GNNModel`` keeps each PNA layer's staged weights under inference and
  rebuilds them when a parameter changes; with a gradient it caches
  nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.ops.pallas.pna_layer import (
    fused_pna_layer as jax_fused_layer,
)
from gnnbuilder_tpu.ops.pallas.pna_layer import pna_layer_reference
from gnnbuilder_tpu.ops.quant import quantize_weight as jax_qw
from gnnbuilder_tpu_torch.ops.cuda import pna_layer
from gnnbuilder_tpu_torch.ops.cuda.pna_block import split_tf32
from test_torch_gat_tc import VALUE_BYTES, _a_k, _kernel_b, _values
from test_torch_pna_layer import batch, layer_params

TOL, STD_TOL = 2e-5, 2e-4
# the aggregate kernel's geometry (csrc/pna_layer.cu)
AKD = {"f32": 8, "bf16": 16}
APAIR = {"f32": 1024, "bf16": 512}


def _t(a):
    return torch.from_numpy(np.array(a))


def _kernel_ks(raw, Fin, F, Fout, mode):
    """k_post's scaler rows [halves, 12F, Fout] as the aggregate kernel
    reads them from the Ks section's bytes ``raw``: per column block cb
    of 128 and chunk j (64 k), ring tiles of two k-steps; in a tile, per
    k-step ks and scaler s, 8 pairs of n8 tiles of PB bytes,
    16 bytes a lane (f32: the lo half 512 bytes on), registers (tile0 b0,
    tile0 b1, tile1 b0, tile1 b1); chunk position kk holds aggregate kk //
    16 of feature 16 j + kk % 16 of scaler s's rows of k_post."""
    kd, PB = AKD[mode], APAIR[mode]
    E = 1 if mode == "f32" else 2
    SKB = 8 * PB
    ksteps = 2
    TB = ksteps * 3 * SKB
    tpc = 64 // (kd * ksteps)
    nch = 4 * F // 64
    assert raw.size == Fout // 128 * nch * tpc * TB
    halves = 2 if mode == "f32" else 1
    K = np.zeros((halves, 12 * F, Fout))
    cb, j, kt, ks, s, p, lane, tile, r, e = np.meshgrid(
        np.arange(Fout // 128), np.arange(nch), np.arange(tpc),
        np.arange(ksteps), np.arange(3), np.arange(8), np.arange(32),
        np.arange(2), np.arange(2), np.arange(E), indexing="ij")
    g, t = lane // 4, lane % 4
    off = (((cb * nch + j) * tpc + kt) * TB + ks * 3 * SKB + s * SKB
           + p * PB + 16 * lane + 4 * (2 * tile + r) + VALUE_BYTES[mode] * e)
    kk = (kt * ksteps + ks) * kd + _a_k(mode, t, r, e)
    row = s * 4 * F + kk // 16 * F + 16 * j + kk % 16
    col = cb * 128 + 8 * (2 * p + tile) + g
    for half in range(halves):
        K[half, row, col] = _values(raw, mode, off + 512 * half)
    return K


def _sections(staged, Fin, F, Fout, mode):
    """The sections read back as the kernels read them: (Wj [Fin, F] or
    None (bf16), the x products ([Wi | K0], bf16 [Wj | Wi | K0]), k_post's
    scaler rows, w_lin), the last three [halves, K, N]."""
    fmode = "bf16" if mode == "bf16" else "f32"
    nb = {"f32": 8, "bf16": 2}[fmode]
    u8 = staged.view(torch.uint8)
    wj = None
    if fmode == "f32":
        wj = u8[:Fin * F * 4].view(torch.float32).view(Fin, F)
        u8 = u8[Fin * F * 4:]
    cols = (2 * F if wj is None else F) + Fout
    p_bytes = Fin * cols * nb
    k_bytes = 12 * F * Fout * nb
    xcat = _kernel_b(u8[:p_bytes], Fin, cols // 128, 128, fmode)
    ks = _kernel_ks(u8[p_bytes:p_bytes + k_bytes].numpy(), Fin, F, Fout,
                    fmode)
    lin = _kernel_b(u8[p_bytes + k_bytes:], Fout, Fout // 128, 128, mode)
    return wj, xcat, ks, lin


@pytest.mark.parametrize("Fin,F,Fout", [(128, 128, 128), (256, 128, 384)])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_staged_layer_reads_back_as_the_jax_weights(mode, Fin, F, Fout):
    rng = np.random.default_rng(Fin + F + Fout)
    w_pre, _, k_post, _, w_lin, _ = layer_params(rng, Fin, F, Fout)
    wp, kp, wl, s_lin = pna_layer.prepare_layer(_t(w_pre), _t(k_post),
                                                _t(w_lin), mode)
    staged = pna_layer.stage_layer(wp, kp, wl, mode)
    wj, xcat, ks, lin = _sections(staged, Fin, F, Fout, mode)

    def want(a, m):
        if m == "f32":      # the TF32 halves of the JAX weights
            return torch.stack(split_tf32(_t(a))).double().numpy()
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32))[None]

    fmode = "bf16" if mode == "bf16" else "f32"
    if fmode == "f32":
        assert torch.equal(wj, _t(w_pre[Fin:]))
        cat = np.concatenate([w_pre[:Fin], k_post[:Fin]], axis=1)
    else:
        assert wj is None
        cat = np.concatenate([w_pre[Fin:], w_pre[:Fin], k_post[:Fin]],
                             axis=1)
    np.testing.assert_array_equal(xcat, want(cat, fmode))
    np.testing.assert_array_equal(ks, want(k_post[Fin:], fmode))
    if mode == "int8":
        jq, js = jax_qw(jnp.asarray(w_lin))
        np.testing.assert_array_equal(lin[0], np.asarray(jq))
        np.testing.assert_array_equal(s_lin.numpy(), np.asarray(js))
    else:
        np.testing.assert_array_equal(lin, want(w_lin, mode))
    back = pna_layer.unstage_layer(staged, Fin, F, Fout, mode)
    for i, (got, orig) in enumerate(zip(back, (wp, kp, wl))):
        if got.dim() == orig.dim() + 1:
            want_h = torch.stack(split_tf32(orig))
            if i == 0:      # Wj, held whole: (value, 0)
                want_h[0, Fin:], want_h[1, Fin:] = orig[Fin:], 0.0
            assert torch.equal(got, want_h)
        else:
            assert torch.equal(got, orig)


def test_live_layout_of_a_train_step_is_stage_layer_of_the_padded_weights():
    """``layer_operands`` with a gradient (one gather for all layers, the
    weights given as the transposed views of [out, in] parameters, as
    ``PNAConv._weights`` gives them) keeps each layer's padded weights
    differentiable and gives it the bytes of ``stage_layer`` of them, at
    the canonical widths and at widths that are no multiple of 128."""
    rng = np.random.default_rng(5)
    dims = [(11, 128, 128), (128, 128, 64), (200, 130, 70)]
    layers = []
    for d in dims:
        p = [_t(a) for a in layer_params(rng, *d)]
        layers.append(tuple(
            t.t().contiguous().requires_grad_().t() if t.dim() == 2
            else t.requires_grad_() for t in p))
    got = pna_layer.layer_operands(layers, "f32")
    for lay, ops in zip(layers, got):
        p = pna_layer._pad_weights(*lay)
        for a, w in zip(ops["weights"], p):
            assert a.requires_grad and torch.equal(a, w)
        want = pna_layer.stage_layer(*[p[i].detach().contiguous()
                                       for i in (0, 2, 4)], "f32")
        assert torch.equal(ops["staged"], want)
        assert ops["mode"] == "f32" and ops["s_lin"] is None


def _tc_dot(passes):
    """The kernel's f32 product: split TF32, each k-step of 8 a chain from
    zero (its passes summed exactly, rounded once), the chains added in
    float32 in k order."""
    def dot(a, w):
        ah, al = (h.double() for h in split_tf32(a))
        wh, wl = (h.double() for h in split_tf32(w))
        acc = a.new_zeros((a.shape[0], w.shape[1]))
        for k in range(0, a.shape[1], 8):
            s = slice(k, k + 8)
            p = ah[:, s] @ wh[s]
            if passes == 3:
                p = p + al[:, s] @ wh[s] + ah[:, s] @ wl[s]
            acc = acc + p.float()
        return acc
    return dot


@pytest.fixture(scope="module", params=[128, 256])
def case(request):
    """One layer at Fin = F = Fout = width on a batch with empty, one-slot
    and tied rows, and the JAX kernel's and reference's results."""
    width = request.param
    x, nbr, deg = batch(node_dim=width, seed=3)
    N = x.shape[0]
    rng = np.random.default_rng(width)
    p = layer_params(rng, width, width, width)
    skip = rng.standard_normal((N, width)).astype(np.float32)
    delta = 1.7
    jp = [jnp.asarray(a) for a in p]
    kw = dict(skip=jnp.asarray(skip), act="relu")
    want = jax_fused_layer(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(deg),
                           *jp, delta, tile_rows=N, window_slack=0,
                           interpret=True, gather_mode="highest", mm="f32",
                           save_res=True, **kw)
    ref = pna_layer_reference(jnp.asarray(x), jnp.asarray(nbr),
                              jnp.asarray(deg), *jp, delta, **kw)
    return (x, nbr, deg, p, skip, delta, [np.asarray(w) for w in want],
            np.asarray(ref))


def _emulated(case, passes, monkeypatch):
    x, nbr, deg, p, skip, delta = case[:6]
    monkeypatch.setattr(pna_layer, "_f32_dot", _tc_dot(passes))
    got = pna_layer.fused_pna_layer(_t(x), _t(nbr), _t(deg), *map(_t, p),
                                    delta, skip=_t(skip), act="relu",
                                    save_res=True)
    return [t.numpy() for t in got]


def test_emulated_tf32_layer_matches_jax_kernel_and_reference(case,
                                                              monkeypatch):
    x, nbr, deg, p, skip, delta, want, ref = case
    F = p[0].shape[1]
    got = _emulated(case, 3, monkeypatch)
    one = _emulated(case, 1, monkeypatch)
    errs = {}
    for name, ours, theirs in zip(("out", "v", "agg_cat", "aux", "mid"),
                                  got, want):
        assert ours.shape == theirs.shape, name
        if name == "aux":   # tie counts and the extrema of empty rows exact
            np.testing.assert_array_equal(ours[:, 3 * F:], theirs[:, 3 * F:])
            empty = deg == 0
            np.testing.assert_array_equal(ours[empty, :2 * F],
                                          theirs[empty, :2 * F])
            ours, theirs = ours[~empty, :3 * F], theirs[~empty, :3 * F]
        scale = float(np.abs(theirs).max())
        if name == "agg_cat":
            std = float(np.abs(ours[:, 3 * F:] - theirs[:, 3 * F:]).max())
            assert std <= STD_TOL * scale, (name, std, scale)
            ours, theirs = ours[:, :3 * F], theirs[:, :3 * F]
        errs[name] = float(np.abs(ours - theirs).max()) / scale
        assert errs[name] <= TOL, (name, errs[name])
    out_ref = float(np.abs(got[0] - ref).max()) / float(np.abs(ref).max())
    out_one = float(np.abs(one[0] - want[0]).max()) / float(
        np.abs(want[0]).max())
    print(f"width {F}: 3 x TF32 {errs} of max, against the reference "
          f"{out_ref:.2e}; one TF32 pass {out_one:.2e}")
    assert out_ref <= TOL
    assert out_one > errs["out"]


def test_model_caches_the_staged_layers_and_follows_the_weights():
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.ops import dispatch

    torch.manual_seed(0)
    model = canonical_model("pna", "qm9", gnn_num_layers=2)
    b = canonical_batches("qm9", n_graphs=16, batch_size=16,
                          node_multiple=64, device="cpu")[1][0]
    with torch.no_grad():
        first = model._pna_operands(b)
        assert model._pna_operands(b) is first
        out = model(b)
        w = model.gnn_convs[0].lin.weight
        w.add_(0.5)
        second = model._pna_operands(b)
        assert second is not first
        want = pna_layer.stage_layer(*[
            second[0]["weights"][i] for i in (0, 2, 4)], "f32")
        assert torch.equal(second[0]["staged"], want)
        assert not torch.equal(second[0]["staged"], first[0]["staged"])
        dispatch.set_fused_mode("never")
        try:
            plain = model(b)
        finally:
            dispatch.set_fused_mode("auto")
        torch.testing.assert_close(model(b), plain, atol=1e-5, rtol=1e-4)
        assert not torch.equal(out, plain)
    assert model._pna_operands(b) is None     # grad mode: no cache

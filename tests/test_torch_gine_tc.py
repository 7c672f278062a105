"""The host side of the tensor-core GINE layer kernel (row 12,
csrc/gine_layer.cu on csrc/tc_rows.cuh), against the JAX package on the
same numpy inputs.

What the CPU can hold is the kernel's arithmetic and its weight layout:

* through the plain version's ``_f32_dot`` seam, the f32 products in the
  kernel's order (``_tc_dot`` of tests/test_torch_mp_block_tc.py: each
  k-step of 8 a split-TF32 chain from zero, added into the float32 sum in
  k order; k padded with zeros to whole steps, as the kernel pads it)
  keep the layer at input widths 11 and 128 (hidden and out 128), with
  and without a skip, within the GINE layer tolerance (1e-5 of max,
  tests/test_torch_gine.py) of the Pallas ``fused_gine_layer(
  interpret=True, gather_mode="highest", mm="f32")`` and of
  ``gine_layer_reference``; the seam carries both f32 products;
* the bf16 mode's Z, the float64 product rounded once as the kernel's
  float64 tensor cores form it, keeps the layer within the modes'
  tolerance (2e-3 of max) of the JAX kernel called with ``mm="bf16"``;
* the Ring layout (``stage_weights``, made in one gather for several
  layers) gives the JAX weights back bit for bit in every mode: the TF32
  halves of the float32 weights (``pna_block.split_tf32``, the kernels'
  split), their bf16 rounding, and the int8 levels of the JAX
  ``quantize_weight``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.ops.pallas.gine_layer import fused_gine_layer as jax_layer
from gnnbuilder_tpu.ops.pallas.gine_layer import gine_layer_reference
from gnnbuilder_tpu.ops.quant import quantize_weight as jax_qw
from gnnbuilder_tpu_torch.ops.cuda import gine_layer
from gnnbuilder_tpu_torch.ops.cuda.mp_layer import prepare_layer
from gnnbuilder_tpu_torch.ops.cuda.pna_block import split_tf32
from test_torch_gine import TOL_OUT, _batches, _jax_kw, _scaled_close
from test_torch_mp_layer_tc import _tc_dot_padded

MODE_TOL = 2e-3
CASES = [(F, skip) for F in (11, 128) for skip in (True, False)]


def _operands(rng, N, E, F, H=128, Fout=128):
    def r(*shape, sc):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    return r(N, F, sc=1.0), r(E, F, sc=1.0), dict(
        w0=r(F, H, sc=F ** -0.5), b0=r(H, sc=0.1), w1=r(H, Fout,
                                                       sc=H ** -0.5),
        b1=r(Fout, sc=0.1))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"F{f}-{'skip' if s else 'noskip'}" for f, s in CASES])
def jax_case(request):
    """(F, the port's batch, x, pe, params, skip, the JAX kernel's and the
    reference's outputs) of one layer, eps 0.2, relu."""
    F, use_skip = request.param
    jb, tb = _batches()
    N, E = tb.num_nodes, tb.num_edges
    rng = np.random.default_rng(21 + F)
    x, pe, p = _operands(rng, N, E, F)
    skip = (rng.standard_normal((N, 128)).astype(np.float32)
            if use_skip else None)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jskip = None if skip is None else jnp.asarray(skip)
    kern = np.asarray(jax_layer(
        jnp.asarray(x), jnp.asarray(pe), jb.nbr_nodes, jb.nbr_edges,
        jb.row_offsets, jb.in_degree, **jp, eps=0.2, skip=jskip, act="relu",
        tile_rows=N, **_jax_kw()))
    ref = np.asarray(gine_layer_reference(
        jnp.asarray(x), jnp.asarray(pe), jb.nbr_nodes, jb.nbr_edges,
        jb.in_degree, **jp, eps=0.2, skip=jskip, act="relu"))
    return F, tb, x, pe, p, skip, kern, ref


def _ours(tb, x, pe, p, skip, **kw):
    return gine_layer.fused_gine_layer(
        torch.from_numpy(x), torch.from_numpy(pe), tb.nbr_nodes,
        tb.nbr_edges, tb.in_degree,
        **{k: torch.from_numpy(a) for k, a in p.items()}, eps=0.2,
        skip=None if skip is None else torch.from_numpy(skip), act="relu",
        **kw).numpy()


def test_tensor_core_order_stays_within_the_layer_tolerance(jax_case,
                                                            monkeypatch):
    F, tb, x, pe, p, skip, kern, ref = jax_case
    monkeypatch.setattr(gine_layer, "_f32_dot", _tc_dot_padded)
    got = _ours(tb, x, pe, p, skip)
    m = tb.node_mask.numpy()
    for name, want in (("kernel", kern), ("reference", ref)):
        print(f"gine F={F} vs {name}: max abs "
              f"{np.abs(got[m] - want[m]).max():.3e} of max |value| "
              f"{np.abs(want[m]).max():.3e}")
        _scaled_close(got[m], want[m], TOL_OUT, (F, name))


def test_seam_carries_both_f32_products(monkeypatch):
    """T w0 and Z w1 go through ``_f32_dot``, and the kernel's order moves
    the result off the plain product's (the seam is live) by no more than
    the tolerance."""
    _, tb = _batches()
    rng = np.random.default_rng(3)
    x, pe, p = _operands(rng, tb.num_nodes, tb.num_edges, 128)
    plain = _ours(tb, x, pe, p, None)
    seen = []

    def counted(a, w):
        seen.append((tuple(a.shape), tuple(w.shape)))
        return _tc_dot_padded(a, w)

    monkeypatch.setattr(gine_layer, "_f32_dot", counted)
    got = _ours(tb, x, pe, p, None)
    assert [w for _, w in seen] == [(128, 128), (128, 128)], seen
    m = tb.node_mask.numpy()
    assert not np.array_equal(got[m], plain[m])
    _scaled_close(got[m], plain[m], TOL_OUT, "seam")


@pytest.mark.parametrize("F", [11, 128])
def test_bf16_z_as_float64_product_matches_jax_kernel(F):
    jb, tb = _batches()
    N, E = tb.num_nodes, tb.num_edges
    rng = np.random.default_rng(8 + F)
    x, pe, p = _operands(rng, N, E, F)
    skip = rng.standard_normal((N, 128)).astype(np.float32)
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    w0, w1, _, _ = prepare_layer(tp["w0"], tp["w1"], "bf16")
    ours = gine_layer.fused_gine_layer(
        torch.from_numpy(x), torch.from_numpy(pe), tb.nbr_nodes,
        tb.nbr_edges, tb.in_degree, w0, tp["b0"], w1, tp["b1"], eps=0.2,
        skip=torch.from_numpy(skip), act="relu", mode="bf16").numpy()
    want = np.asarray(jax_layer(
        jnp.asarray(x), jnp.asarray(pe), jb.nbr_nodes, jb.nbr_edges,
        jb.row_offsets, jb.in_degree,
        **{k: jnp.asarray(a) for k, a in p.items()}, eps=0.2,
        skip=jnp.asarray(skip), act="relu", tile_rows=N, window_slack=0,
        interpret=True, gather_mode="bf16", mm="bf16"))
    m = tb.node_mask.numpy()
    err = np.abs(ours[m] - want[m]).max() / np.abs(want[m]).max()
    print(f"gine bf16 F={F}: {err:.3e} of max")
    assert np.isfinite(ours[m]).all()
    assert err <= MODE_TOL, (F, err)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_ring_layout_gives_the_jax_weights_back(mode):
    """Three layers of the canonical widths' kinds (11 -> 128, 128 ->
    128, 128 -> 64; one a width past a 128-column tile) laid out in one
    gather, each layer's w0 and w1 read back from its own bytes."""
    rng = np.random.default_rng(1)
    dims = [(11, 128, 128), (128, 200, 128), (128, 128, 64)]
    ws = [tuple((rng.standard_normal(s) * 0.1).astype(np.float32)
                for s in ((F, H), (H, Fo))) for F, H, Fo in dims]
    prepared = [prepare_layer(torch.from_numpy(a), torch.from_numpy(b),
                              mode)[:2] for a, b in ws]
    staged = gine_layer.stage_weights(prepared, mode)
    for (F, H, Fo), st, (a, b) in zip(dims, staged, ws):
        assert st.dtype == torch.uint8
        assert st.numel() == (gine_layer.ring_chunks(F, H, Fo, mode)
                              * gine_layer.RING_CHUNK[mode])
        first = gine_layer.ring_chunks(F, H, 0, mode)
        back = (gine_layer.unstage_weight(st, F, H, mode),
                gine_layer.unstage_weight(st, H, Fo, mode, first=first))
        for got, w in zip(back, (a, b)):
            if mode == "f32":   # the TF32 halves of the weights
                want = torch.stack(split_tf32(torch.from_numpy(w))).numpy()
            elif mode == "bf16":
                want = np.asarray(jnp.asarray(w).astype(jnp.bfloat16)
                                  .astype(jnp.float32))
            else:
                want = np.asarray(jax_qw(jnp.asarray(w))[0])
            if mode == "int8":
                assert np.array_equal(got.numpy(), want), (mode, F)
            else:
                assert np.array_equal(got.float().numpy().view(np.uint32),
                                      want.view(np.uint32)), (mode, F)

"""The host side of the tensor-core PNA scatter backward
(csrc/scatter_bwd.cu), against the JAX package on the same numpy inputs:

* ``stage_ks_t`` lays ks_t out in the kernel's stream order, and
  ``unstage_ks_t`` gives the TF32 halves of the JAX VJP's ks_t (the
  scaler blocks of k_post side by side, transposed) back bit for bit;
* with d_agg formed in the kernel's order (``_tc_dot``: each k-step of 8
  a split-TF32 chain from zero, the steps added in float32, K = 3Fout =
  384), dv stays within 2e-5 of max |value| of the JAX
  ``fused_pna_scatter_backward`` in interpret mode (the tolerance of
  tests/test_torch_scatter_bwd.py, on its banded batch), and each block
  of the coefficient stack cstk within 2e-5 of its max |value| of the
  JAX VJP's own coefficients (``_make_vjp_fn``'s reverse-table branch,
  evaluated in jnp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.ops.pallas.scatter_bwd import (
    fused_pna_scatter_backward as jax_scatter,
)
from gnnbuilder_tpu_torch.ops.cuda import scatter_bwd
from gnnbuilder_tpu_torch.ops.cuda.pna_block import split_tf32
from test_torch_mp_block_tc import _tc_dot
from test_torch_scatter_bwd import F, TOL, residuals

DELTA = 1.7
JAX_KW = dict(fwd_gather_mode="highest", tile_rows=128, window_slack=16,
              interpret=True)


def test_unstaging_gives_the_jax_ks_t_back():
    rng = np.random.default_rng(1)
    Fin, Fout = 128, 128
    k_post = rng.standard_normal((Fin + 12 * F, Fout)).astype(np.float32)
    ks_t = np.asarray(jnp.concatenate(
        [jnp.asarray(k_post)[Fin + i * 4 * F: Fin + (i + 1) * 4 * F]
         for i in range(3)], axis=1).T)
    staged = scatter_bwd.stage_ks_t(torch.from_numpy(ks_t.copy()))
    assert staged.shape == (2 * 3 * Fout * 4 * F,)
    back = scatter_bwd.unstage_ks_t(staged, 3 * Fout, F)
    want = torch.stack(split_tf32(torch.from_numpy(ks_t)))
    assert torch.equal(back, want)


def test_staged_columns_give_each_thread_four_blocks_of_a_feature():
    """Column group 1, k-step 0, the first pair of n8 tiles of consumer
    column 1: its lane 9 (g = 2, t = 1) holds k = 2, 3 of column 2 of
    tiles 0 and 1, i.e. blocks 0 and 1 (mx, mn) of feature 32 + 16 + 2."""
    K = 3 * 128
    index, half = scatter_bwd._stream_order(K, F)
    group = K * 128 * 2                  # values of one column group
    pair = group + 4 * 256               # pair 4 = consumer column 1's first
    lane = index[pair + 9 * 4: pair + 9 * 4 + 4]
    assert not half[pair: pair + 128].any() and half[pair + 128:
                                                     pair + 256].all()
    k, col = lane // (4 * F), lane % (4 * F)
    assert k.tolist() == [2, 3, 2, 3]
    assert col.tolist() == [50, 50, F + 50, F + 50]


def _jax_cstk(d_mid, aux, agg_cat, deg, ks_t, delta):
    """The JAX PNA VJP's coefficient stack (gnnbuilder_tpu/ops/pallas/
    pna_layer.py, the branch without the scatter kernel), in jnp."""
    d_mid, aux, agg_cat, ks_t = (jnp.asarray(a) for a in
                                 (d_mid, aux, agg_cat, ks_t))
    F = agg_cat.shape[1] // 4
    degf = jnp.asarray(deg).astype(jnp.float32)[:, None]
    denom = jnp.maximum(degf, 1.0)
    nonempty = degf > 0
    log_deg = jnp.log(denom + 1.0)
    dy = jnp.concatenate([d_mid, (log_deg / delta) * d_mid,
                          (delta / log_deg) * d_mid], axis=1)
    d_agg = dy @ ks_t
    ct_mx = jnp.where(nonempty, d_agg[:, 0:F], 0.0)
    ct_mn = jnp.where(nonempty, d_agg[:, F:2 * F], 0.0)
    ct_mean = jnp.where(nonempty, d_agg[:, 2 * F:3 * F], 0.0)
    c_lin = ct_mean / denom
    c_a = d_agg[:, 3 * F:] / (denom * agg_cat[:, 3 * F:])
    c_mx = ct_mx / jnp.maximum(aux[:, 3 * F:4 * F], 1.0)
    c_mn = ct_mn / jnp.maximum(aux[:, 4 * F:], 1.0)
    return np.asarray(jnp.concatenate(
        [c_lin, c_a, c_a * aux[:, 2 * F:3 * F], aux[:, :F], c_mx,
         aux[:, F:2 * F], c_mn], axis=-1))


@pytest.fixture(scope="module")
def jax_refs():
    """The banded batch's residuals, the JAX kernel's dv and the JAX
    VJP's cstk."""
    args = residuals(3, F)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    dv = np.asarray(jax_scatter(*jargs[:6], ks_t=jargs[6], delta=DELTA,
                                **JAX_KW))
    d_mid, aux, agg_cat, deg, _, _, ks_t = (a.numpy() for a in args)
    return args, dv, _jax_cstk(d_mid, aux, agg_cat, deg, ks_t, DELTA)


def test_tensor_core_order_keeps_cstk_and_dv_within_tolerance(jax_refs,
                                                             monkeypatch):
    args, dv_ref, cstk_ref = jax_refs
    d_mid, aux, agg_cat, deg, _, _, ks_t = args
    monkeypatch.setattr(scatter_bwd, "_f32_dot", _tc_dot)
    dv = scatter_bwd.fused_pna_scatter_backward(*args, DELTA).numpy()
    err = np.abs(dv - dv_ref).max()
    print(f"dv: max abs {err:.3e}, {err / np.abs(dv_ref).max():.3e} of max")
    assert err <= TOL * np.abs(dv_ref).max(), err
    cstk = scatter_bwd.fused_pna_scatter_cstk(d_mid, aux, agg_cat, deg, ks_t,
                                              DELTA).numpy()
    for b in range(7):
        got, want = cstk[:, b * F:(b + 1) * F], cstk_ref[:, b * F:(b + 1) * F]
        err = np.abs(got - want).max()
        print(f"cstk block {b}: max abs {err:.3e} of {np.abs(want).max():.3e}")
        assert err <= TOL * np.abs(want).max(), (b, err)

"""The port's PNA aggregation backward (ops/cuda/scatter_bwd.py) against
the JAX package's ``fused_pna_scatter_backward(..., interpret=True)`` on a
multi-tile banded batch (neighbours within +-16 rows, 128-row tiles, so
the TPU kernel's margin overlap-add runs), with degree-0 and degree-1
rows, pad slots, and tied extrema from repeated neighbours and repeated
node rows.

The residuals come from the port's own forward (``pna_layer_plain`` with
save_res), so the tie counts are real; the JAX kernel re-gathers with
fwd_gather_mode="highest" (an exact f32 gather), so its g == mx tests see
the same values.  Tolerance: max |ours - ref| <= 2e-5 * max |ref|; the
TPU kernel forms d_agg as a 3-pass bf16 split product (~1e-7 relative)
and both sum the contributions in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.ops.pallas.scatter_bwd import (
    fused_pna_scatter_backward as jax_scatter,
)
from gnnbuilder_tpu_torch.ops.cuda import pna_layer, scatter_bwd

TOL = 2e-5
F = 128    # the TPU kernel's lane width


def banded(seed, N=512, W=4, SL=16):
    """ELL table with neighbours within +-SL of each row, the windowed
    locality of graph-contiguous packing (as tests/test_scatter_bwd.py)."""
    rng = np.random.default_rng(seed)
    rows = np.arange(N)
    nbr = np.clip(rows[:, None] + rng.integers(-SL + 1, SL, size=(N, W)),
                  0, N - 1).astype(np.int32)
    nbr[::5, 1] = nbr[::5, 0]          # repeated neighbour -> tied slots
    deg = rng.integers(0, W + 1, size=N).astype(np.int32)
    deg[::37] = 0                      # empty rows
    deg[1::41] = 1                     # degree-1 rows
    nbr = np.where(np.arange(W)[None, :] < deg[:, None], nbr, 0)
    return nbr, deg, rng


def residuals(seed, Fout):
    nbr, deg, rng = banded(seed)
    N = nbr.shape[0]
    x = rng.standard_normal((N, F)).astype(np.float32)
    x[1::7] = x[0::7][: len(x[1::7])]  # repeated rows -> tied values
    s = 1.0 / np.sqrt(F)

    def r(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * s).astype(np.float32))

    p = (r(2 * F, F), r(F), r(13 * F, Fout), r(Fout), r(Fout, Fout),
         r(Fout))
    t = (torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(deg))
    _, v, agg_cat, aux, _ = pna_layer.pna_layer_plain(*t, *p, 1.7,
                                                      act="relu",
                                                      save_res=True)
    ks_t = pna_layer.scaler_blocks(p[2], F, F).t().contiguous()
    d_mid = r(N, Fout) * 10.0
    return d_mid, aux, agg_cat, t[2], t[1], v, ks_t


@pytest.mark.parametrize("seed,delta", [(3, 1.7), (8, 2.5)])
def test_plain_scatter_matches_jax_kernel(seed, delta):
    args = residuals(seed, F)
    aux, deg = args[1], args[3]
    ties = aux[:, 3 * F:].numpy()
    assert (ties > 1).any()            # real ties reach the backward
    assert (deg.numpy() == 0).any() and (deg.numpy() == 1).any()
    ours = scatter_bwd.fused_pna_scatter_backward(*args, delta).numpy()
    plain = scatter_bwd.pna_scatter_backward_plain(*args, delta).numpy()
    np.testing.assert_array_equal(ours, plain)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    ref = np.asarray(jax_scatter(
        *jargs[:6], ks_t=jargs[6], delta=delta, fwd_gather_mode="highest",
        tile_rows=128, window_slack=16, interpret=True))
    err = np.abs(ours - ref).max()
    assert err <= TOL * np.abs(ref).max(), err


def test_degree_one_std_term_cancels():
    """On a degree-1 row mean == g bitwise, so its slot's contribution is
    exactly c_lin + the extremum terms: changing the std cotangent of that
    row changes nothing."""
    d_mid, aux, agg_cat, deg, nbr, v, ks_t = residuals(4, F)
    one = torch.nonzero(deg == 1)[0, 0]
    base = scatter_bwd.pna_scatter_backward_plain(
        d_mid, aux, agg_cat, deg, nbr, v, ks_t, 2.0)
    agg2 = agg_cat.clone()
    agg2[one, 3 * F:] *= 0.5           # c_a of that row doubles
    moved = scatter_bwd.pna_scatter_backward_plain(
        d_mid, aux, agg2, deg, nbr, v, ks_t, 2.0)
    torch.testing.assert_close(moved, base, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    d_mid, aux, agg_cat, deg, nbr, v, ks_t = residuals(5, F)
    with pytest.raises(ValueError, match="aux"):
        scatter_bwd.fused_pna_scatter_backward(d_mid, aux[:, :-1], agg_cat,
                                               deg, nbr, v, ks_t, 1.0)
    with pytest.raises(ValueError, match="ks_t"):
        scatter_bwd.fused_pna_scatter_backward(d_mid, aux, agg_cat, deg, nbr,
                                               v, ks_t.t(), 1.0)
    with pytest.raises(ValueError, match="in_degree"):
        scatter_bwd.fused_pna_scatter_backward(d_mid, aux, agg_cat, deg[1:],
                                               nbr, v, ks_t, 1.0)


@pytest.mark.parametrize(
    "hl,hd,nc",
    [(True, True, 2), (True, False, 0), (False, True, 0),
     (False, False, 1)],
)
def test_generic_scatter_matches_jax_kernel(hl, hd, nc):
    """``fused_scatter_backward`` (the generic entry: reverse CSR, then
    the gather's CSR mode) and ``scatter_backward_plain`` against the
    JAX ``fused_scatter_backward(..., interpret=True)`` over the term
    combinations of ``tests/test_scatter_bwd.py``; the JAX kernel
    re-gathers exactly (``fwd_gather_mode="highest"``), and every cmp
    reference is a real neighbour's row so its compares fire."""
    from gnnbuilder_tpu.ops.pallas.scatter_bwd import (
        fused_scatter_backward as jax_generic,
    )

    nbr, deg, rng = banded(3)
    N = nbr.shape[0]
    v = rng.standard_normal((N, F)).astype(np.float32)
    blocks = []
    if hl:
        blocks.append(rng.standard_normal((N, F)).astype(np.float32) * 0.3)
    if hd:
        ca = rng.standard_normal((N, F)).astype(np.float32) * 0.2
        blocks += [ca, ca * (v[nbr[:, 0]] * 0.5)]
    for c in range(nc):
        blocks += [v[nbr[:, min(c, nbr.shape[1] - 1)]],
                   rng.standard_normal((N, F)).astype(np.float32) * 0.1]
    cstk = np.concatenate(blocks, axis=1)
    terms = dict(has_lin=hl, has_dev=hd, n_cmp=nc)
    t = [torch.from_numpy(a) for a in (cstk, nbr, deg, v)]
    ours = scatter_bwd.fused_scatter_backward(*t, **terms).numpy()
    plain = scatter_bwd.scatter_backward_plain(*t, **terms).numpy()
    ref = np.asarray(jax_generic(
        jnp.asarray(cstk), jnp.asarray(nbr), jnp.asarray(deg),
        jnp.asarray(v), **terms, fwd_gather_mode="highest", tile_rows=128,
        window_slack=16, interpret=True))
    scale = np.abs(ref).max()
    assert scale > 0
    for name, got in (("entry", ours), ("plain", plain)):
        err = float(np.abs(got - ref).max())
        assert err <= TOL * scale, (name, hl, hd, nc, err)


def test_generic_scatter_needs_a_term():
    nbr, deg, _ = banded(0, N=16)
    t = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="no terms"):
        scatter_bwd.fused_scatter_backward(
            t, torch.from_numpy(nbr), torch.from_numpy(deg), t,
            has_lin=False)

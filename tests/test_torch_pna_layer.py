"""The port's PNA layer (ops/cuda/pna_layer.py) against the JAX package:
its plain version, with and without residuals, vs the Pallas
``fused_pna_layer(..., interpret=True)`` and ``pna_layer_reference`` on
the same numpy inputs, and the zero-padding entry at the canonical first
(11 -> 128) and last (128 -> 64) widths.

The batch holds degree-0 and degree-1 rows, a pair of identical node rows
(exact ties in max and min) and a repeated neighbour.  The JAX kernel
gathers with gather_mode="highest" (an exact f32 gather), so both sides
aggregate the same v.  Tolerance atol 1e-5 / rtol 1e-4: the products and
the slot sums run in another order on each side.  The std block of
agg_cat is held to atol 2e-4: on a row whose slots hold (nearly) one
value, E[v^2] - E[v]^2 is pure rounding, which XLA contracts into an FMA
and torch does not, and sqrt(var + 1e-5) magnifies it by up to
1 / (2 sqrt(1e-5)) ~ 158.  Tie counts are compared exactly, and so are
the -+3e38 extrema of empty rows.  Gradients are sums over all rows with
cancellation, so they are held to max |ours - ref| <= 1e-4 * max |ref|
against JAX, and to 1e-5 of max against torch autograd of the port's own
plain layer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.ops.pallas.pna_layer import (
    fused_pna_layer as jax_fused_layer,
)
from gnnbuilder_tpu.ops.pallas.pna_layer import (
    fused_pna_layer_auto as jax_layer_auto,
)
from gnnbuilder_tpu.ops.pallas.pna_layer import pna_layer_reference
from gnnbuilder_tpu_torch.ops.cuda import pna_layer

ATOL, RTOL = 1e-5, 1e-4
STD_ATOL = 2e-4
GRAD_TOL_JAX, GRAD_TOL_TORCH = 1e-4, 1e-5


def assert_scaled_close(ours, ref, tol, what=""):
    err = float(np.abs(ours - ref).max())
    scale = float(np.abs(ref).max())
    assert err <= tol * scale, (what, err, scale)


class _G:
    def __init__(self, n, e, rng, dup, node_dim):
        self.x = rng.standard_normal((n, node_dim)).astype(np.float32)
        if dup and n > 3:   # identical rows -> exact ties in max/min
            self.x[1] = self.x[0]
            self.x[3] = self.x[0]
        ei = rng.integers(0, n, size=(2, e))
        ei[:, 0] = ei[:, 1] = (1, 2)   # a repeated neighbour of node 2
        self.edge_index = ei
        self.edge_attr = None
        self.y = None


def batch(node_dim=16, seed=11):
    """The same graphs packed by the JAX package, as numpy arrays."""
    rng = np.random.default_rng(seed)
    gs = [_G(int(rng.integers(4, 12)), int(rng.integers(4, 20)), rng,
             i % 2 == 0, node_dim) for i in range(9)]
    g = jax_build(gs)
    deg = np.asarray(g.in_degree)
    real = np.asarray(g.node_mask)
    assert (deg[real] == 0).any() and (deg[real] == 1).any()
    return (np.asarray(g.node_feat), np.asarray(g.nbr_nodes), deg)


def layer_params(rng, Fin, F, Fout):
    """(w_pre, b_pre, k_post, b_post, w_lin, b_lin) in [in, out] layout,
    scaled like torch.nn.Linear's init so values stay O(1)."""
    def r(fan_in, *s):
        return (rng.standard_normal(s) / np.sqrt(fan_in)).astype(np.float32)
    return (r(2 * Fin, 2 * Fin, F), r(2 * Fin, F),
            r(Fin + 12 * F, Fin + 12 * F, Fout), r(Fin + 12 * F, Fout),
            r(Fout, Fout, Fout), r(Fout, Fout))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("act,use_skip", [
    (None, False), ("relu", True), ("gelu", True), ("sigmoid", False),
    ("tanh", True)])
def test_plain_layer_matches_jax_kernel_and_reference(act, use_skip):
    x, nbr, deg = batch()
    N, Fin = x.shape
    F, Fout = Fin, 24
    rng = np.random.default_rng(2)
    p = layer_params(rng, Fin, F, Fout)
    skip = rng.standard_normal((N, Fout)).astype(np.float32)
    sk = skip if use_skip else None
    delta = 1.7

    got = pna_layer.fused_pna_layer(
        _t(x), _t(nbr), _t(deg), *map(_t, p), delta,
        skip=_t(skip) if use_skip else None, act=act, save_res=True)
    plain_out = pna_layer.fused_pna_layer(
        _t(x), _t(nbr), _t(deg), *map(_t, p), delta,
        skip=_t(skip) if use_skip else None, act=act)
    jp = [jnp.asarray(a) for a in p]
    want = jax_fused_layer(
        jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(deg), *jp, delta,
        skip=None if sk is None else jnp.asarray(sk), tile_rows=N,
        window_slack=0, interpret=True, gather_mode="highest", mm="f32",
        act=act, save_res=True)
    ref = pna_layer_reference(
        jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(deg), *jp, delta,
        skip=None if sk is None else jnp.asarray(sk), act=act)

    names = ("out", "v", "agg_cat", "aux", "mid")
    for name, ours, theirs in zip(names, got, want):
        ours, theirs = ours.numpy(), np.asarray(theirs)
        assert ours.shape == theirs.shape, name
        if name == "aux":
            np.testing.assert_array_equal(ours[:, 3 * F:], theirs[:, 3 * F:])
            empty = deg == 0
            np.testing.assert_array_equal(ours[empty, :2 * F],
                                          theirs[empty, :2 * F])
        if name == "agg_cat":
            np.testing.assert_allclose(ours[:, 3 * F:], theirs[:, 3 * F:],
                                       atol=STD_ATOL, rtol=RTOL)
            ours, theirs = ours[:, :3 * F], theirs[:, :3 * F]
        np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(plain_out.numpy(), got[0].numpy())
    ties = got[3][:, 3 * F:].numpy()
    assert (ties[deg > 0] >= 1).all() and (ties[deg == 0] == 0).all()
    assert (ties > 1).any()    # the batch has real ties


def test_auto_padding_canonical_widths():
    """First layer 11 -> 128 and last layer 128 -> 64, zero-padded to 128
    outside the autograd Function: output and gradients at the unpadded
    widths against JAX's fused_pna_layer_auto, jax.grad of the reference
    and torch autograd of the unpadded plain layer."""
    import jax

    x11, nbr, deg = batch(node_dim=11, seed=5)
    N = x11.shape[0]
    rng = np.random.default_rng(9)
    h = rng.standard_normal((N, 128)).astype(np.float32)
    cases = [(x11, layer_params(rng, 11, 11, 128), "relu"),
             (h, layer_params(rng, 128, 128, 64), None)]
    for x, p, act in cases:
        kw = dict(delta=2.1, act=act)
        xt = _t(x).requires_grad_()
        pt = [_t(a).requires_grad_() for a in p]
        ours = pna_layer.fused_pna_layer_auto(xt, _t(nbr), _t(deg), *pt,
                                              **kw)
        jargs = (jnp.asarray(nbr), jnp.asarray(deg))
        jp = [jnp.asarray(a) for a in p]
        kern = jax_layer_auto(jnp.asarray(x), *jargs, *jp, tile_rows=N,
                              window_slack=0, interpret=True,
                              gather_mode="highest", mm="f32", **kw)
        assert ours.shape == kern.shape == (N, p[4].shape[1])
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(kern),
                                   atol=ATOL, rtol=RTOL)
        ct = rng.standard_normal(ours.shape).astype(np.float32)
        ours.backward(_t(ct))
        xa = _t(x).requires_grad_()
        pa = [_t(a).requires_grad_() for a in p]
        pna_layer.pna_layer_plain(xa, _t(nbr), _t(deg), *pa, **kw).backward(
            _t(ct))

        def loss(xx, *pp):
            return (pna_layer_reference(xx, *jargs, *pp, **kw)
                    * jnp.asarray(ct)).sum()

        grads = jax.grad(loss, argnums=tuple(range(7)))(jnp.asarray(x), *jp)
        ours_g = [xt.grad] + [q.grad for q in pt]
        auto_g = [xa.grad] + [q.grad for q in pa]
        for i, (o, a, r) in enumerate(zip(ours_g, auto_g, grads)):
            r = np.asarray(r)
            assert o.shape == r.shape
            assert_scaled_close(o.numpy(), r, GRAD_TOL_JAX, (act, i))
            assert_scaled_close(o.numpy(), a.numpy(), GRAD_TOL_TORCH,
                                (act, i))


def test_wrapper_rejects_bad_inputs():
    x, nbr, deg = batch()
    rng = np.random.default_rng(0)
    N, Fin = x.shape
    p = [_t(a) for a in layer_params(rng, Fin, Fin, 8)]
    args = (_t(x), _t(nbr), _t(deg))
    with pytest.raises(ValueError, match="w_pre"):
        pna_layer.fused_pna_layer(*args, p[0][:-1], *p[1:], 1.0)
    with pytest.raises(ValueError, match="skip"):
        pna_layer.fused_pna_layer(*args, *p, 1.0, skip=torch.zeros(N, 7))
    with pytest.raises(ValueError, match="activation"):
        pna_layer.fused_pna_layer(*args, *p, 1.0, act="elu")
    with pytest.raises(ValueError, match="float32"):
        pna_layer.fused_pna_layer(args[0].double(), *args[1:], *p, 1.0)

"""The reverse-table gather backward (ops/cuda/ell_bwd.py) and the PNA
layer's dv through it, against the JAX package on the CPU.

* ``ell_gather_backward_plain`` against the Pallas
  ``fused_gather_backward(..., interpret=True)`` on the same coefficient
  stack, for the lin-only, lin+dev and full PNA term sets.
* Against ``jax.vjp`` of ``ops/ell.py`` sum, mean, std, max and min: the
  cotangent turned into each aggregator's coefficients (max/min divided
  by the forward's tie count, as XLA's reduce-max VJP splits the
  gradient evenly among tied slots), gathered over the reverse table.
* The coefficient stack of the PNA scatter (``pna_scatter_cstk_plain``)
  gathered over the reverse table gives the scatter route's dv.
* ``PNALayerFunction`` with the batch's reverse table against autograd
  of the plain layer in float64, and against the JAX
  ``fused_pna_layer_vjp`` (interpret mode, with the reverse table) and
  ``jax.grad`` of ``pna_layer_reference``.

Batches carry degree-0 and degree-1 rows and tied extrema (duplicated
node rows).  Tolerance: max |ours - ref| <= 2e-5 * max |ref| (f32 sums in
another order), for the gather and, for the layer's gradients, against
the float64 reference.  The layer's gradients are held to 1e-4 against
the JAX paths, as in test_torch_train.py: on this batch the JAX kernel's
own dx lands 2.2e-5 of max off the float64 reference (tanh), where the
port's lands 9e-6, so the two cannot agree to 2e-5 of each other.  The
degree-1 std cancellation is held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.ops import ell as jax_ell
from gnnbuilder_tpu.ops.pallas.ell_bwd import (
    fused_gather_backward as jax_gather,
)
from gnnbuilder_tpu.ops.pallas.pna_layer import (
    fused_pna_layer_vjp as jax_layer_vjp,
)
from gnnbuilder_tpu.ops.pallas.pna_layer import pna_layer_reference
from gnnbuilder_tpu_torch.ops.cuda import ell_bwd, pna_layer, scatter_bwd

TOL = 2e-5
TOL_REF = 1e-4


class _G:
    def __init__(self, n, e, rng, F, dup):
        self.x = rng.standard_normal((n, F)).astype(np.float32)
        if dup and n > 3:   # identical rows -> exact ties in max/min
            self.x[1] = self.x[0]
            self.x[3] = self.x[0]
        self.edge_index = rng.integers(0, n, size=(2, e))
        self.edge_attr = None
        self.y = None


def _batch(seed=11, F=8):
    rng = np.random.default_rng(seed)
    gs = [_G(int(rng.integers(4, 12)), int(rng.integers(4, 20)), rng, F,
             i % 2 == 0) for i in range(9)]
    b = jax_build(gs)
    deg = np.asarray(b.in_degree)[np.asarray(b.node_mask)]
    assert (deg == 0).any() and (deg == 1).any()
    assert b.rev_nbr_nodes is not None
    return b


def _t(a):
    return torch.from_numpy(np.array(a))


def _scaled_close(ours, ref, what="", tol=TOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    err = float(np.abs(ours - ref).max())
    assert np.isfinite(ours).all(), what
    assert err <= tol * float(np.abs(ref).max()), (what, err)


@pytest.mark.parametrize("has_lin,has_dev,n_cmp", [
    (True, False, 0), (True, True, 0), (True, True, 2), (False, False, 1)])
def test_plain_gather_matches_jax_kernel(has_lin, has_dev, n_cmp):
    b = _batch()
    N = b.num_nodes
    F = 8
    rng = np.random.default_rng(5)
    K = ell_bwd.n_blocks(has_lin, has_dev, n_cmp)
    v = rng.standard_normal((N, F)).astype(np.float32)
    cstk = rng.standard_normal((N, K * F)).astype(np.float32)
    o = int(has_lin) + 2 * int(has_dev)
    for k in range(n_cmp):   # refs that hit: some v values of each row
        ref = cstk[:, (o + 2 * k) * F:(o + 2 * k + 1) * F]
        take = rng.random((N, F)) < 0.5
        ref[take] = v[np.asarray(b.rev_nbr_nodes)[:, 0]][take]
    args = (cstk, b.rev_nbr_nodes, b.out_degree)
    ours = ell_bwd.fused_gather_backward(
        *map(_t, args), v=_t(v) if has_dev or n_cmp else None,
        has_lin=has_lin, has_dev=has_dev, n_cmp=n_cmp).numpy()
    want = np.asarray(jax_gather(
        jnp.asarray(cstk), b.rev_nbr_nodes, b.out_degree,
        v=jnp.asarray(v) if has_dev or n_cmp else None, has_lin=has_lin,
        has_dev=has_dev, n_cmp=n_cmp, fwd_gather_mode="highest",
        tile_rows=N, window_slack=0, interpret=True))
    _scaled_close(ours, want)


@pytest.mark.parametrize("agg", ["sum", "mean", "std", "max", "min"])
def test_gather_gives_the_vjp_of_ell_aggregations(agg):
    b = _batch()
    nbr, deg = b.nbr_nodes, b.in_degree
    v = np.asarray(b.node_feat)
    F = v.shape[1]
    ct = np.random.default_rng(3).standard_normal(
        (b.num_nodes, F)).astype(np.float32)
    fwd = getattr(jax_ell, f"ell_{agg}")
    out, vjp = jax.vjp(lambda t: fwd(t, nbr, deg), jnp.asarray(v))
    (want,) = vjp(jnp.asarray(ct))
    degf = np.maximum(np.asarray(deg, np.float32), 1.0)[:, None]
    nonempty = (np.asarray(deg) > 0)[:, None]
    ct = np.where(nonempty, ct, 0.0).astype(np.float32)
    kw = dict(has_lin=False, has_dev=False, n_cmp=0)
    if agg in ("sum", "mean"):
        cstk = ct if agg == "sum" else ct / degf
        kw["has_lin"] = True
    elif agg == "std":
        g = v[np.asarray(nbr)]
        m = np.asarray(jax_ell.ell_mask(nbr, deg))[..., None]
        mean = np.where(m, g, 0).sum(1) / degf
        c_a = ct / (degf * np.asarray(out))
        cstk = np.concatenate([c_a, c_a * mean], axis=1)
        kw["has_dev"] = True
    else:
        g = v[np.asarray(nbr)]
        m = np.asarray(jax_ell.ell_mask(nbr, deg))[..., None]
        ext = np.asarray(out)
        ties = (m & (g == ext[:, None])).sum(1)
        assert (ties > 1).any()             # ties reach the backward
        cstk = np.concatenate([ext, ct / np.maximum(ties, 1)], axis=1)
        kw["n_cmp"] = 1
    ours = ell_bwd.fused_gather_backward(
        _t(cstk.astype(np.float32)), _t(b.rev_nbr_nodes), _t(b.out_degree),
        v=_t(v), **kw).numpy()
    _scaled_close(ours, want, agg)


def test_degree_one_dev_term_cancels_exactly():
    """A degree-1 receiver's mean is its neighbour's v bitwise, so its dev
    term v * c_a - c_a * mean is an exact zero: scaling that receiver's
    c_a changes no bit of dv."""
    b = _batch()
    nbr, deg = np.asarray(b.nbr_nodes), np.asarray(b.in_degree)
    v = np.asarray(b.node_feat)
    rng = np.random.default_rng(9)
    c_a = rng.standard_normal(v.shape).astype(np.float32)
    mean = np.where(deg[:, None] == 1, v[nbr[:, 0]], 0).astype(np.float32)

    def dv(c):
        cstk = np.concatenate([c, c * mean], axis=1)
        return ell_bwd.ell_gather_backward_plain(
            _t(cstk), _t(b.rev_nbr_nodes), _t(b.out_degree), v=_t(v),
            has_lin=False, has_dev=True)

    one = deg == 1
    assert one.any()
    c2 = c_a.copy()
    c2[one] *= 3.7
    torch.testing.assert_close(dv(c2), dv(c_a), rtol=0, atol=0)


def test_cstk_gather_matches_scatter_route():
    """The scatter kernel's coefficient stack, gathered over the reverse
    table, gives the dv its scatter mode adds into the senders."""
    b = _batch(F=16)
    x = np.asarray(b.node_feat)
    N, F = x.shape
    rng = np.random.default_rng(4)
    s = 1.0 / np.sqrt(F)
    p = [_t((rng.standard_normal(sh) * s).astype(np.float32))
         for sh in ((2 * F, F), (F,), (13 * F, F), (F,), (F, F), (F,))]
    nbr, deg = _t(b.nbr_nodes), _t(b.in_degree)
    _, v, agg_cat, aux, _ = pna_layer.pna_layer_plain(
        _t(x), nbr, deg, *p, 1.7, act="relu", save_res=True)
    ks_t = pna_layer.scaler_blocks(p[2], F, F).t().contiguous()
    d_mid = _t(rng.standard_normal((N, F)).astype(np.float32))
    cstk = scatter_bwd.fused_pna_scatter_cstk(d_mid, aux, agg_cat, deg, ks_t,
                                              1.7)
    torch.testing.assert_close(
        cstk, scatter_bwd.pna_scatter_cstk_plain(d_mid, aux, agg_cat, deg,
                                                 ks_t, 1.7), rtol=0, atol=0)
    assert cstk.shape == (N, 7 * F)
    ours = ell_bwd.fused_gather_backward(
        cstk, _t(b.rev_nbr_nodes), _t(b.out_degree), v, has_lin=True,
        has_dev=True, n_cmp=2)
    want = scatter_bwd.pna_scatter_backward_plain(d_mid, aux, agg_cat, deg,
                                                  nbr, v, ks_t, 1.7)
    _scaled_close(ours.numpy(), want.numpy())


@pytest.mark.parametrize("act,use_skip", [("relu", True), ("tanh", False)])
def test_layer_gradients_through_reverse_table_match_jax(act, use_skip):
    b = _batch(F=16)
    x = np.asarray(b.node_feat)
    N, Fin = x.shape
    F, Fout = Fin, 24
    rng = np.random.default_rng(8)

    def r(fan_in, *s):
        return (rng.standard_normal(s) / np.sqrt(fan_in)).astype(np.float32)

    p = [r(2 * Fin, 2 * Fin, F), r(2 * Fin, F), r(13 * F, 13 * F, Fout),
         r(13 * F, Fout), r(Fout, Fout, Fout), r(Fout, Fout)]
    skip = rng.standard_normal((N, Fout)).astype(np.float32)
    ct = rng.standard_normal((N, Fout)).astype(np.float32)
    delta = 1.9

    calls = {"cstk": 0, "gather": 0, "scatter": 0}
    orig = (pna_layer.fused_pna_scatter_cstk, pna_layer.fused_gather_backward,
            pna_layer.fused_pna_scatter_backward)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    xt = _t(x).requires_grad_()
    pt = [_t(a).requires_grad_() for a in p]
    st = _t(skip).requires_grad_() if use_skip else None
    pna_layer.fused_pna_scatter_cstk = count("cstk", orig[0])
    pna_layer.fused_gather_backward = count("gather", orig[1])
    pna_layer.fused_pna_scatter_backward = count("scatter", orig[2])
    try:
        out = pna_layer.fused_pna_layer_vjp(
            xt, _t(b.nbr_nodes), _t(b.in_degree), *pt, delta, skip=st,
            act=act, rev_nbr_nodes=_t(b.rev_nbr_nodes),
            out_degree=_t(b.out_degree))
        out.backward(_t(ct))
    finally:
        (pna_layer.fused_pna_scatter_cstk, pna_layer.fused_gather_backward,
         pna_layer.fused_pna_scatter_backward) = orig
    assert calls == {"cstk": 1, "gather": 1, "scatter": 0}
    ours = [xt.grad] + [q.grad for q in pt] + ([st.grad] if use_skip else [])

    nargs = 8 if use_skip else 7

    def ref_loss(xx, *pp):
        s = pp[6] if use_skip else None
        return (pna_layer_reference(xx, b.nbr_nodes, b.in_degree, *pp[:6],
                                    delta, skip=s, act=act) * ct).sum()

    def kern_loss(xx, *pp):
        s = pp[6] if use_skip else None
        return (jax_layer_vjp(
            xx, b.nbr_nodes, b.in_degree, *pp[:6], delta, skip=s,
            rev_nbr_nodes=b.rev_nbr_nodes, out_degree=b.out_degree,
            tile_rows=N, window_slack=0, interpret=True,
            gather_mode="highest", mm="f32", act=act) * ct).sum()

    jin = [jnp.asarray(x)] + [jnp.asarray(a) for a in p] + (
        [jnp.asarray(skip)] if use_skip else [])
    x64 = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    p64 = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
           for a in p]
    s64 = (torch.tensor(skip, dtype=torch.float64, requires_grad=True)
           if use_skip else None)
    out64 = pna_layer.pna_layer_plain(x64, _t(b.nbr_nodes), _t(b.in_degree),
                                      *p64, delta, skip=s64, act=act)
    out64.backward(torch.tensor(ct, dtype=torch.float64))
    want64 = [x64.grad] + [q.grad for q in p64] + (
        [s64.grad] if use_skip else [])
    for i, (o, w) in enumerate(zip(ours, want64)):
        _scaled_close(o.numpy(), w.numpy(), ("float64", act, i))
    for name, fn, tol in (("reference", ref_loss, TOL_REF),
                          ("kernel", kern_loss, TOL_REF)):
        grads = jax.grad(fn, argnums=tuple(range(nargs)))(*jin)
        for i, (o, w) in enumerate(zip(ours, grads)):
            _scaled_close(o.numpy(), w, (name, act, i), tol)

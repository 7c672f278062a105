"""The GAT layer's backward in the port (ops/cuda/gat_bwd.py, row 11, and
``GATLayerFunction`` in ops/cuda/gat_layer.py) against the JAX package
on the CPU.

* ``fused_gat_scatter_backward`` (its plain version on the CPU): all six
  outputs against the Pallas ``fused_gat_scatter_backward(...,
  interpret=True)`` on the JAX test's banded geometry (tests/
  test_gat_bwd.py: N 512, ELL width 4, 128-row tiles, slack 16, empty
  and degree-1 rows), heads 1 x 128, 4 x 32 and the main path's last
  layer's 4 x 64, self loops on and off; its entry refuses what 32-bit
  index math does not take (N x HC from 2^31).
* ``ops.ell.reverse_csr(..., positions=True)``: each forward slot's CSR
  position, where the kernel's sender pass finds the slot's edge; a
  train step without a reverse table hands every layer's backward the
  one that the batch keeps (``GraphBatch.rev_csr``).
* ``GATLayerFunction``'s gradients (x, skip, W, att_src, att_dst, bias)
  against ``jax.grad`` of the Pallas ``fused_gat_layer_vjp`` (interpret
  mode) and of ``gat_layer_reference``, and against autograd of the
  port's plain layer in float64, on four tables: a standard-packed
  batch with its reverse table, the same batch built without one
  (``rev_ell_width=0``: the reverse CSR), a batch whose one-way 70-leaf
  star has an out-degree over 64 (no reverse table), and the banded
  table with a reverse table, where the JAX layer's own backward runs
  its scatter kernel.
* The gate of the hand-written backward (the JAX ``_scatter_ok``): no
  self loops, or gelu, take autograd of the plain layer instead.

Tolerances: row 11's outputs to 2e-5 of max |value| (the Pallas kernel
gathers and scatters through hi/lo bf16 passes, ~4e-6 of max here);
gradients to 2e-5 of max against the JAX paths and to 1e-5 against
float64."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset
from gnnbuilder_tpu.ops.pallas import gat_bwd as jax_gat_bwd
from gnnbuilder_tpu.ops.pallas import gat_layer as jax_gat_layer
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.ops.cuda import gat_bwd, gat_layer
from gnnbuilder_tpu_torch.ops.ell import reverse_csr
from tests.test_scatter_bwd import _banded, _reverse

TOL_BWD, TOL_GRAD, TOL_F64 = 2e-5, 2e-5, 1e-5
N_BAND, W_BAND, SL_BAND, TN_BAND = 512, 4, 16, 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.isfinite(ours).all()
    return float(np.abs(ours - ref).max()) / max(float(np.abs(ref).max()),
                                                 1e-30)


@pytest.mark.parametrize("heads,C", [(1, 128), (4, 32), (4, 64)])
@pytest.mark.parametrize("self_loops", [True, False])
def test_scatter_backward_matches_jax_kernel(heads, C, self_loops):
    nbr, deg, rng = _banded(11, N=N_BAND, W=W_BAND, SL=SL_BAND)
    N, HC = N_BAND, heads * C
    dz = rng.standard_normal((N, HC)).astype(np.float32)
    h = (rng.standard_normal((N, HC)) * 0.5).astype(np.float32)
    a_src = rng.standard_normal((N, heads)).astype(np.float32)
    a_dst = rng.standard_normal((N, heads)).astype(np.float32)
    ours = gat_bwd.fused_gat_scatter_backward(
        _t(dz), _t(h), _t(a_src), _t(a_dst), _t(nbr), _t(deg), heads,
        self_loops=self_loops)
    ref = jax_gat_bwd.fused_gat_scatter_backward(
        dz, h, a_src, a_dst, jnp.asarray(nbr), jnp.asarray(deg), heads,
        self_loops=self_loops, tile_rows=TN_BAND, window_slack=SL_BAND,
        interpret=True)
    names = ("dh_val", "da_src_nbr", "dsum", "s", "m", "den")
    live = (deg > 0) | self_loops
    for name, o, r in zip(names, ours, ref):
        o, r = o.numpy(), np.asarray(r)
        if name == "m":   # rows without a slot hold the clamp, -BIG / 2
            np.testing.assert_array_equal(o[~live], r[~live])
            o, r = o[live], r[live]
        assert _rel(o, r) <= TOL_BWD, (name, _rel(o, r))


def test_entry_refuses_what_32_bit_indices_do_not_take():
    N, H, C = 2 ** 16, 4, 2 ** 13
    f = dict(device="meta")
    dz, h = torch.empty((N, H * C), **f), torch.empty((N, H * C), **f)
    a_s, a_d = torch.empty((N, H), **f), torch.empty((N, H), **f)
    nbr = torch.empty((N, 4), dtype=torch.int32, **f)
    deg = torch.empty((N,), dtype=torch.int32, **f)
    with pytest.raises(ValueError, match="2\\^31"):
        gat_bwd.fused_gat_scatter_backward(dz, h, a_s, a_d, nbr, deg, H)


@pytest.mark.parametrize("case", ["rev", "star"])
def test_reverse_csr_positions_point_at_each_slots_edge(case):
    """The CSR position of every valid forward slot (i, w) lies in its
    sender's segment and holds receiver i; the positions are a
    permutation of the CSR (a pair's repeats take distinct positions);
    the other slots hold -1."""
    nbr, deg, *_ = _table(case)
    ptr, idx, pos = reverse_csr(nbr, deg, positions=True)
    m = torch.arange(nbr.shape[1])[None, :] < deg[:, None].long()
    p = pos[m].long()
    assert (pos[~m] == -1).all() and pos.dtype == torch.int32
    assert torch.equal(torch.sort(p).values, torch.arange(idx.shape[0]))
    recv = torch.arange(nbr.shape[0])[:, None].expand_as(nbr)[m]
    send = nbr[m].long()
    assert torch.equal(idx[p].long(), recv)
    assert ((ptr[send] <= p) & (p < ptr[send + 1])).all()



@pytest.mark.parametrize("case", ["rev", "csr"])
def test_train_steps_share_the_batch_reverse_csr(case):
    """Two Adam steps of a 3-layer GAT model on one batch: without a
    reverse table every layer's backward gets the batch's one reverse
    CSR (``GraphBatch.rev_csr``: ``reverse_csr(..., positions=True)``,
    built at first use and kept); with one, none is built.  A batch made
    by ``replace`` builds its own."""
    from gnnbuilder_tpu_torch import train
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )

    gs, (tb,) = canonical_batches("qm9", n_graphs=12, batch_size=12,
                                  device="cpu")
    if case == "csr":
        tb = tb.replace(rev_nbr_nodes=None, out_degree=None)
    model = canonical_model("gat", "qm9", graphs=gs, gnn_num_layers=3,
                            gnn_hidden_dim=16, gnn_output_dim=8,
                            conv_kwargs=dict(heads=2))
    step = train.make_train_step(model, torch.optim.Adam(
        model.parameters(), lr=1e-3))
    target = train.stack_targets(gs, tb.num_graphs, 1, device="cpu")
    got = []
    orig = gat_layer.fused_gat_scatter_backward

    def spy(*a, **k):
        got.append(k.get("rev_csr"))
        return orig(*a, **k)

    gat_layer.fused_gat_scatter_backward = spy
    try:
        for _ in range(2):
            step(tb, target)
    finally:
        gat_layer.fused_gat_scatter_backward = orig
    assert len(got) == 6
    if case == "rev":
        assert got == [None] * 6 and "rev_csr" not in vars(tb)
        return
    assert all(c is tb.rev_csr for c in got)
    for a, b in zip(tb.rev_csr, reverse_csr(tb.nbr_nodes, tb.in_degree,
                                            positions=True)):
        assert torch.equal(a, b)
    other = tb.replace()
    assert other.rev_csr is not tb.rev_csr

def _graphs():
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=11, seed=4)
    return [dataclasses.replace(g, edge_index=g.edge_index[
        :, g.edge_index[1] != 0]) if i % 3 == 0 else g
        for i, g in enumerate(gs)]


def _star_graphs():
    """Small random graphs around a one-way 71-node star: every in-degree
    stays small, the hub's out-degree is 70 (over 64)."""
    gs = _graphs()[:4]
    rng = np.random.default_rng(2)
    leaves = np.arange(1, 71)
    ea = gs[0].edge_attr
    star = dataclasses.replace(
        gs[0], x=rng.standard_normal((71, 11)).astype(np.float32),
        edge_index=np.stack([0 * leaves, leaves]),
        edge_attr=None if ea is None else np.zeros((70, ea.shape[1]),
                                                   ea.dtype))
    return gs[:2] + [star] + gs[2:]


def _table(case):
    """(nbr, deg, rev, out_degree, jax kwargs) of a test table; rev and
    out_degree None where the batch has no reverse table."""
    jkw = dict(tile_rows=None, window_slack=0)
    if case == "banded":
        nbr, deg, _ = _banded(3, N=N_BAND, W=W_BAND, SL=SL_BAND)
        rev, od = _reverse(nbr, deg)
        jkw = dict(tile_rows=TN_BAND, window_slack=SL_BAND)
        return _t(nbr), _t(deg), _t(rev), _t(od), jkw
    gs = _star_graphs() if case == "star" else _graphs()
    kw = dict(node_multiple=8)
    if case == "csr":
        kw["rev_ell_width"] = 0
    tb = build_graph_batch(gs, device="cpu", **kw)
    jb = jax_build(gs, **kw)
    np.testing.assert_array_equal(tb.nbr_nodes.numpy(),
                                  np.asarray(jb.nbr_nodes))
    if case == "rev":
        assert tb.rev_nbr_nodes is not None
    else:
        assert tb.rev_nbr_nodes is None and tb.nbr_nodes is not None
    if case == "star":
        ptr, _ = reverse_csr(tb.nbr_nodes, tb.in_degree)
        assert int((ptr[1:] - ptr[:-1]).max()) == 70
    return tb.nbr_nodes, tb.in_degree, tb.rev_nbr_nodes, tb.out_degree, jkw


@pytest.mark.parametrize("case", ["rev", "csr", "star", "banded"])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_layer_gradients_match_jax_and_float64(case, act):
    nbr, deg, rev, od, jkw = _table(case)
    N = nbr.shape[0]
    jkw["tile_rows"] = jkw["tile_rows"] or N
    H, C, Fin = (2, 64, 32) if case == "banded" else (2, 8, 11)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, Fin)).astype(np.float32)
    w = (rng.standard_normal((Fin, H * C)) / Fin ** 0.5).astype(np.float32)
    att_src, att_dst = [(rng.standard_normal((1, H, C)) * 0.3)
                        .astype(np.float32) for _ in range(2)]
    bias = (rng.standard_normal(H * C) * 0.1).astype(np.float32)
    skip = (rng.standard_normal((N, H * C)) * 0.5).astype(np.float32)
    ct = rng.standard_normal((N, H * C)).astype(np.float32)
    args = (x, skip, w, att_src, att_dst, bias)

    calls = []
    orig = gat_layer.fused_gat_scatter_backward

    def counted(*a, **k):
        calls.append(k.get("rev_nbr_nodes") is not None)
        return orig(*a, **k)

    leaves = [_t(a).requires_grad_() for a in args]
    gat_layer.fused_gat_scatter_backward = counted
    try:
        out = gat_layer.fused_gat_layer_vjp(
            leaves[0], nbr, deg, *leaves[2:], H, skip=leaves[1], act=act,
            rev_nbr_nodes=rev, out_degree=od)
        out.backward(_t(ct))
    finally:
        gat_layer.fused_gat_scatter_backward = orig
    assert calls == [rev is not None]
    ours = [t.grad.numpy() for t in leaves]

    d64 = [_t(a).double().requires_grad_() for a in args]
    o64 = gat_layer.gat_layer_plain(d64[0], nbr, deg, *d64[2:], H,
                                    skip=d64[1], act=act)
    o64.backward(_t(ct).double())
    for i, t in enumerate(d64):
        assert _rel(ours[i], t.grad.numpy()) <= TOL_F64, (case, i)

    jn, jd = jnp.asarray(nbr.numpy()), jnp.asarray(deg.numpy())

    def kern_loss(xx, sk, *pp):
        return (jax_gat_layer.fused_gat_layer_vjp(
            xx, jn, jd, *pp, H, skip=sk, act=act, interpret=True,
            gather_mode="highest", mm="f32", **jkw) * ct).sum()

    def ref_loss(xx, sk, *pp):
        return (jax_gat_layer.gat_layer_reference(
            xx, jn, jd, *pp, H, skip=sk, act=act) * ct).sum()

    jin = [jnp.asarray(a) for a in args]
    for name, fn in (("kernel", kern_loss), ("reference", ref_loss)):
        grads = jax.grad(fn, argnums=tuple(range(6)))(*jin)
        for i, (o, g) in enumerate(zip(ours, grads)):
            assert _rel(o, g) <= TOL_GRAD, (name, case, i, _rel(o, g))


@pytest.mark.parametrize("self_loops,act", [(False, "relu"),
                                            (True, "gelu")])
def test_backward_gate_takes_autograd_of_the_plain_layer(self_loops, act):
    """Where the JAX ``_scatter_ok`` refuses (no self loops, or an
    activation whose derivative the saved output does not give), the
    backward is autograd of the plain layer, and matches ``jax.grad`` of
    the reference."""
    nbr, deg, rev, od, _ = _table("rev")
    assert not gat_layer.scatter_ok(self_loops, act)
    assert gat_layer.scatter_ok(True, "relu")
    N = nbr.shape[0]
    H, C = 2, 8
    rng = np.random.default_rng(8)
    x = rng.standard_normal((N, 11)).astype(np.float32)
    w = (rng.standard_normal((11, H * C)) * 0.3).astype(np.float32)
    att_src, att_dst = [(rng.standard_normal((1, H, C)) * 0.3)
                        .astype(np.float32) for _ in range(2)]
    bias = (rng.standard_normal(H * C) * 0.1).astype(np.float32)
    ct = rng.standard_normal((N, H * C)).astype(np.float32)
    args = (x, w, att_src, att_dst, bias)
    leaves = [_t(a).requires_grad_() for a in args]
    orig = gat_layer.fused_gat_scatter_backward

    def refuse(*a, **k):
        raise AssertionError("the hand-written backward ran")

    gat_layer.fused_gat_scatter_backward = refuse
    try:
        out = gat_layer.fused_gat_layer_vjp(
            leaves[0], nbr, deg, *leaves[1:], H, self_loops=self_loops,
            act=act, rev_nbr_nodes=rev, out_degree=od)
        out.backward(_t(ct))
    finally:
        gat_layer.fused_gat_scatter_backward = orig
    jn, jd = jnp.asarray(nbr.numpy()), jnp.asarray(deg.numpy())

    def ref_loss(xx, *pp):
        return (jax_gat_layer.gat_layer_reference(
            xx, jn, jd, *pp, H, self_loops=self_loops, act=act) * ct).sum()

    grads = jax.grad(ref_loss, argnums=tuple(range(5)))(
        *[jnp.asarray(a) for a in args])
    for i, (t, g) in enumerate(zip(leaves, grads)):
        assert _rel(t.grad.numpy(), g) <= TOL_GRAD, i

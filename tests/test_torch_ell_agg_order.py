"""The host side of the redesigned multi-aggregate (rows 8, 8b,
csrc/ell_agg.cu), against the JAX package on the same numpy inputs.

The kernel forms every output element with the parent kernel's
operations in the parent kernel's order: the slot terms added one at a
time in slot order, each sum and product rounded on its own, then the
aggregators from the sums, with IEEE divisions and square root.
``ell_aggregate_ordered`` forms the same sums the same way in torch, and
the card tests hold the kernel's outputs to it bit for bit.  Here the
slot-ordered loop stays within 1e-6 of max of ``ell_aggregate_plain``
(another sum order) and within 1e-5 of the Pallas
``fused_ell_aggregate(interpret=True, gather_mode="highest")`` and of its
``_reference``, per aggregator, except std against the Pallas kernel at
1e-4 (on the CPU XLA contracts that kernel's E[t^2] - E[t]^2 into a fused
multiply-add: tests/test_torch_ell_agg.py).  With u, std is held to
``_reference`` and the plain version only: the Pallas kernel forms std
of v alone, after the reduction (shift-free in exact arithmetic), where
the port, like ``_reference``, forms it over t = u + v per slot, so the
two differ by E[t^2] - E[t]^2's float32 cancellation at |u + v| (1.2e-4
of max on these tied values), not by the port.  In bf16, within 2e-3 of
the Pallas kernel with ``gather_mode="bf16"`` (the port forms std of v
alone there too).  Every aggregator set of
``AGG_SETS``, with and without u, at F = 11 and 128, on a batch with
degree-0 and degree-1 rows and values rounded to halves (ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu_torch.ops.cuda import ell_agg
from test_torch_ell_agg import (
    AGG_SETS,
    STD_KERNEL_TOL,
    TOL_OUT,
    _batches,
    _jax_kw,
    _scaled_close,
    _t,
    _values,
    jax_agg,
    jax_reference,
)

ORDER_TOL, BF16_TOL = 1e-6, 2e-3


@pytest.fixture(scope="module")
def batch():
    jb, tb = _batches()
    deg = tb.in_degree[tb.node_mask]
    assert (deg == 0).any() and (deg == 1).any()
    return jb, tb


def _inputs(tb, F, with_u):
    rng = np.random.default_rng(17 + F)
    v = _values(rng, tb.num_nodes, F, coarse=True)
    u = _values(rng, tb.num_nodes, F) if with_u else None
    return v, u


def _each(ours, want, aggs, F, m, what, tol_of):
    for i, a in enumerate(aggs):
        sl = slice(i * F, (i + 1) * F)
        _scaled_close(ours[m, sl], np.asarray(want)[m, sl], tol_of(a),
                      (what, a))


@pytest.mark.parametrize("aggs", AGG_SETS, ids="-".join)
@pytest.mark.parametrize("with_u", [False, True], ids=["v", "u+v"])
@pytest.mark.parametrize("F", [11, 128])
def test_slot_ordered_loop_matches_plain_and_jax(batch, aggs, with_u, F):
    jb, tb = batch
    v, u = _inputs(tb, F, with_u)
    tu = None if u is None else _t(u)
    got = ell_agg.ell_aggregate_ordered(_t(v), tb.nbr_nodes, tb.in_degree,
                                        aggs, tu)
    plain = ell_agg.ell_aggregate_plain(_t(v), tb.nbr_nodes, tb.in_degree,
                                        aggs, tu)
    m = tb.node_mask.numpy()
    got, plain = got.numpy(), plain.numpy()
    _each(got, plain, aggs, F, m, "plain", lambda a: ORDER_TOL)
    ju = None if u is None else jnp.asarray(u)
    kern = np.asarray(jax_agg(jnp.asarray(v), jb.nbr_nodes, jb.in_degree,
                              aggs, u=ju, **_jax_kw(jb)))
    # the Pallas kernel forms std of v alone (u after the reduction): with
    # u it is another formula (module docstring); _reference holds it
    held = [a for a in aggs if not (a == "std" and u is not None)]
    for i, a in enumerate(aggs):
        if a in held:
            sl = slice(i * F, (i + 1) * F)
            _scaled_close(got[m, sl], kern[m, sl],
                          STD_KERNEL_TOL if a == "std" else TOL_OUT,
                          ("kernel", a))
    ref = jax_reference(jnp.asarray(v), ju, jb.nbr_nodes, jb.in_degree,
                        aggs)
    _each(got, ref, aggs, F, m, "reference", lambda a: TOL_OUT)
    empty = (tb.in_degree == 0).numpy() & m
    for i, a in enumerate(aggs):
        fill = np.sqrt(np.float32(1e-5)) if a == "std" else 0.0
        np.testing.assert_array_equal(got[empty, i * F:(i + 1) * F],
                                      np.float32(fill))


@pytest.mark.parametrize("aggs", AGG_SETS, ids="-".join)
@pytest.mark.parametrize("with_u", [False, True], ids=["v", "u+v"])
@pytest.mark.parametrize("F", [11, 128])
def test_bf16_slot_ordered_loop_matches_jax_kernel(batch, aggs, with_u, F):
    """The bf16 mode: the rounded v reduced alone, u after the reduction,
    as the TPU kernel does."""
    jb, tb = batch
    v, u = _inputs(tb, F, with_u)
    got = ell_agg.ell_aggregate_ordered(
        _t(v), tb.nbr_nodes, tb.in_degree, aggs,
        None if u is None else _t(u), mode="bf16").numpy()
    kw = dict(_jax_kw(jb), gather_mode="bf16")
    kern = jax_agg(jnp.asarray(v), jb.nbr_nodes, jb.in_degree, aggs,
                   u=None if u is None else jnp.asarray(u), **kw)
    _each(got, kern, aggs, F, tb.node_mask.numpy(), "bf16 kernel",
          lambda a: BF16_TOL)


def test_slot_ordered_loop_keeps_the_kernels_order():
    """Each slot's term is added into the running float32 sum on its own:
    on a row whose three slots carry 1e8, 1 and -1e8 the slot order
    decides the bits of sum and mean; an empty row gives 0, and std
    sqrt(1e-5)."""
    v = torch.tensor([[1e8], [1.0], [-1e8], [0.0]])
    deg = torch.tensor([3, 0, 0, 0], dtype=torch.int32)
    aggs = ("sum", "mean", "std")
    nbr = torch.tensor([[0, 1, 2]] + [[0, 0, 0]] * 3, dtype=torch.int32)
    got = ell_agg.ell_aggregate_ordered(v, nbr, deg, aggs)
    assert got[0, 0].item() == 0.0 and got[0, 1].item() == 0.0
    nbr2 = torch.tensor([[0, 2, 1]] + [[0, 0, 0]] * 3, dtype=torch.int32)
    got2 = ell_agg.ell_aggregate_ordered(v, nbr2, deg, aggs)
    assert got2[0, 0].item() == 1.0
    assert got[1, 2].item() == np.sqrt(np.float32(1e-5))
    assert got[1, 0].item() == 0.0 and got[1, 1].item() == 0.0

"""The host side of the redesigned reverse-table gather (row 7,
csrc/ell_bwd.cu), against the JAX package on the same numpy inputs.

The kernel sums each element in slot order and, within a slot, term by
term, in one lane; ``ell_gather_backward_ordered`` (table) and
``ell_gather_backward_csr_ordered`` (reverse CSR) form the same sums the
same way in torch, and the card tests hold the kernel's dv to them bit
for bit.  Here the slot-ordered loop stays within 1e-6 of max of
``ell_gather_backward_plain`` (another sum order) and within 2e-5 (the
gather tolerance, tests/test_torch_ell_bwd.py) of the Pallas
``fused_gather_backward(interpret=True)``, for the term sets the kernel
instantiates (lin-only, PNA's lin + dev + 2 compares, cmp-only) and one
it takes at run time (lin + dev + 1 compare), over the table and over
``reverse_csr``, on batches with degree-0 and degree-1 rows, tied
extrema and a 70-out-degree hub.  The entry refuses N * K * F past 2^31.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.ops.pallas.ell_bwd import (
    fused_gather_backward as jax_gather,
)
from gnnbuilder_tpu_torch.ops import ell
from gnnbuilder_tpu_torch.ops.cuda import ell_bwd
from test_torch_ell_bwd import TOL, _batch, _hub_graphs, _scaled_close

TERMS = [(True, False, 0), (True, True, 2), (False, False, 1),
         (True, True, 1)]
ORDER_TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=["mixed", "hub"])
def batch(request):
    """(a packed JAX batch, its reverse table, out-degrees): 9 small graphs
    with duplicated rows (ties) and degree-0 / degree-1 rows, or QM9-sized
    graphs around a one-way 71-node star, whose hub sends to 70 rows (its
    batch carries no reverse table: the table is laid out from
    ``reverse_csr``, 70 wide)."""
    if request.param == "mixed":
        b = _batch()
        return b, np.asarray(b.rev_nbr_nodes), np.asarray(b.out_degree)
    b = jax_build(_hub_graphs())
    ptr, idx = ell.reverse_csr(_t(b.nbr_nodes), _t(b.in_degree))
    odeg = (ptr[1:] - ptr[:-1]).numpy().astype(np.int32)
    assert odeg.max() == 70
    rev = np.zeros((odeg.shape[0], int(odeg.max())), np.int32)
    rev[np.arange(rev.shape[1]) < odeg[:, None]] = idx.numpy()
    return b, rev, odeg


@pytest.fixture(scope="module", params=TERMS,
                ids=["lin", "pna", "cmp", "lin-dev-cmp1"])
def case(request, batch):
    """(terms, batch, cstk, v, the JAX kernel's dv) at F = 12 (float4
    columns on the card) with half the extremum refs hitting v."""
    has_lin, has_dev, n_cmp = request.param
    b, rev, odeg = batch
    N, F = b.num_nodes, 12
    rng = np.random.default_rng(9)
    K = ell_bwd.n_blocks(has_lin, has_dev, n_cmp)
    v = rng.standard_normal((N, F)).astype(np.float32)
    cstk = rng.standard_normal((N, K * F)).astype(np.float32)
    o = int(has_lin) + 2 * int(has_dev)
    for k in range(n_cmp):
        ref = cstk[:, (o + 2 * k) * F:(o + 2 * k + 1) * F]
        take = rng.random((N, F)) < 0.5
        ref[take] = v[rev[:, 0]][take]
    need_v = has_dev or n_cmp
    want = np.asarray(jax_gather(
        jnp.asarray(cstk), jnp.asarray(rev), jnp.asarray(odeg),
        v=jnp.asarray(v) if need_v else None, has_lin=has_lin,
        has_dev=has_dev, n_cmp=n_cmp, fwd_gather_mode="highest",
        tile_rows=N, window_slack=0, interpret=True))
    return request.param, (b, rev, odeg), cstk, v if need_v else None, want


@pytest.mark.parametrize("mode", ["table", "csr"])
def test_slot_ordered_loop_matches_plain_and_jax(case, mode):
    (has_lin, has_dev, n_cmp), (b, rev, odeg), cstk, v, want = case
    kw = dict(has_lin=has_lin, has_dev=has_dev, n_cmp=n_cmp)
    c, vt = _t(cstk), None if v is None else _t(v)
    plain = ell_bwd.ell_gather_backward_plain(c, _t(rev), _t(odeg), vt, **kw)
    if mode == "table":
        got = ell_bwd.ell_gather_backward_ordered(c, _t(rev), _t(odeg), vt,
                                                  **kw)
    else:
        ptr, idx = ell.reverse_csr(_t(b.nbr_nodes), _t(b.in_degree))
        got = ell_bwd.ell_gather_backward_csr_ordered(c, ptr, idx, vt, **kw)
    _scaled_close(got.numpy(), plain.numpy(), (mode, "plain"), ORDER_TOL)
    _scaled_close(got.numpy(), want, (mode, "jax"), TOL)


def test_slot_ordered_loop_keeps_the_kernels_order():
    """Per slot the terms add one at a time into the running sum, and a
    compare that misses leaves it untouched: on a row whose two slots
    carry 1e8, then 1, then -1e8 the slot order decides the bits."""
    cstk = torch.tensor([[1e8], [1.0], [-1e8], [0.0]])
    rev = torch.tensor([[0, 1, 2], [0, 0, 0], [0, 0, 0], [0, 0, 0]],
                       dtype=torch.int32)
    odeg = torch.tensor([3, 0, 0, 0], dtype=torch.int32)
    got = ell_bwd.ell_gather_backward_ordered(cstk, rev, odeg)
    assert got[0, 0].item() == 0.0          # (1e8 + 1) - 1e8 in float32
    rev2 = torch.tensor([[0, 2, 1], [0, 0, 0], [0, 0, 0], [0, 0, 0]],
                        dtype=torch.int32)
    assert ell_bwd.ell_gather_backward_ordered(
        cstk, rev2, odeg)[0, 0].item() == 1.0
    v = torch.tensor([[-0.0], [5.0], [5.0], [5.0]])
    cmp = torch.cat([torch.full((4, 1), 7.0), torch.ones(4, 1)], 1)
    miss = ell_bwd.ell_gather_backward_ordered(cmp, rev, odeg, v,
                                               has_lin=False, n_cmp=1)
    assert miss[0, 0].item() == 0.0 and not torch.signbit(miss[0, 0])


def test_entry_refuses_what_32_bit_indices_do_not_take():
    N, F = 2 ** 16, 2 ** 15
    cstk = torch.empty((N, F), device="meta")
    rev = torch.empty((N, 4), dtype=torch.int32, device="meta")
    odeg = torch.empty((N,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        ell_bwd.fused_gather_backward(cstk, rev, odeg)

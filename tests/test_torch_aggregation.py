"""The port's plain aggregation ops against the JAX package's on the CPU:
``ops/segment.py`` (the edge-list path), ``ops/block.py`` (the block
product) and ``ops/ell.py`` sum and mean, on the same numpy inputs.

Empty segments and rows give 0 and std uses eps 1e-5 in both packages.
Tolerance atol 1e-5 / rtol 1e-5: the same f32 sums, taken in another
order on each side."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.ops import block as jax_block
from gnnbuilder_tpu.ops import ell as jax_ell
from gnnbuilder_tpu.ops import segment as jax_segment
from gnnbuilder_tpu_torch.ops import block, ell, segment

ATOL = RTOL = 1e-5


def _segments(seed, E=300, S=40, F=6):
    """Sorted segment ids over S segments with some segments empty, and
    repeated values so extrema tie."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, S, E)).astype(np.int32)
    ids[ids % 7 == 3] = 4                 # segments 3, 10, ... stay empty
    ids = np.sort(ids)
    data = rng.standard_normal((E, F)).astype(np.float32)
    data[1::5] = data[0::5][: len(data[1::5])]
    return data, ids, S


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_ops_match_jax(seed):
    data, ids, S = _segments(seed)
    t, ti = torch.from_numpy(data), torch.from_numpy(ids)
    j, ji = jnp.asarray(data), jnp.asarray(ids)
    cnt = np.asarray(jax_segment.segment_count(ji, S))
    assert (cnt == 0).any()
    np.testing.assert_array_equal(segment.segment_count(ti, S).numpy(), cnt)
    for name in ("segment_sum", "segment_mean", "segment_max",
                 "segment_min", "segment_std"):
        ours = getattr(segment, name)(t, ti, S).numpy()
        ref = np.asarray(getattr(jax_segment, name)(j, ji, S))
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    aggs = ("sum", "mean", "std", "max", "min")
    count = torch.from_numpy(cnt.copy())
    ours = segment.segment_multi(t, ti, S, aggs, count=count)
    ref = jax_segment.segment_multi(j, ji, S, aggs, count=jnp.asarray(cnt))
    for a in aggs:
        np.testing.assert_allclose(ours[a].numpy(), np.asarray(ref[a]),
                                   atol=ATOL, rtol=RTOL, err_msg=a)
        assert np.all(ours[a].numpy()[cnt[:, 0] == 0]
                      == (np.sqrt(np.float32(1e-5)) if a == "std" else 0))


def _block_case(seed, T=3, B=16, F=5):
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, 3, (T, B, B)).astype(np.float32)
    adj *= rng.random((T, B, B)) < 0.2     # mostly zeros, some multi-edges
    adj[0, 2] = 0.0                        # an empty row
    x = rng.standard_normal((T * B, F)).astype(np.float32)
    deg = adj.sum(-1).reshape(-1).astype(np.int32)
    return adj, x, deg


@pytest.mark.parametrize("transpose", [False, True])
def test_block_ops_match_jax(transpose):
    adj, x, deg = _block_case(2)
    ta, tx, td = map(torch.from_numpy, (adj, x, deg))
    ja, jx, jdg = map(jnp.asarray, (adj, x, deg))
    np.testing.assert_allclose(
        block.block_spmm(ta, tx, transpose=transpose).numpy(),
        np.asarray(jax_block.block_spmm(ja, jx, mm="highest",
                                        transpose=transpose)),
        atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        block.block_sum(tx, ta).numpy(),
        np.asarray(jax_block.block_sum(jx, ja, mm="highest")),
        atol=ATOL, rtol=RTOL)
    mean = block.block_mean(tx, ta, td).numpy()
    np.testing.assert_allclose(
        mean, np.asarray(jax_block.block_mean(jx, ja, jdg, mm="highest")),
        atol=ATOL, rtol=RTOL)
    assert np.all(mean[2] == 0)
    with pytest.raises(ValueError, match="rows"):
        block.block_spmm(ta, tx[:-1])


def test_ell_sum_mean_match_jax():
    rng = np.random.default_rng(3)
    N, W, F = 50, 4, 6
    nbr = rng.integers(0, N, (N, W)).astype(np.int32)
    deg = rng.integers(0, W + 1, N).astype(np.int32)
    deg[:3] = 0
    x = rng.standard_normal((N, F)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (x, nbr, deg)]
    j = [jnp.asarray(a) for a in (x, nbr, deg)]
    for name in ("ell_sum", "ell_mean"):
        ours = getattr(ell, name)(*t).numpy()
        np.testing.assert_allclose(ours, np.asarray(getattr(jax_ell, name)(*j)),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
        assert np.all(ours[:3] == 0)

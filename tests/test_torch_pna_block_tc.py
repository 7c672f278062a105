"""The host side of the tensor-core PNA stack kernel (csrc/pna_block.cu),
against the JAX package on the same numpy inputs:

* ``stage_stack`` lays the weights out in the kernel's stream order;
  ``unstage_stack`` gives the JAX package's stacked weights back bit for
  bit in every mode (f32 as their TF32 halves, bf16 rounding, int8
  levels);
* the f32 mode's split-TF32 products (hi*hi + hi*lo + lo*hi of
  ``split_tf32`` halves, emulated in torch) keep the canonical six-layer
  stack at F = 128 within the stack tolerance (atol 5e-4 / rtol 1e-3, as
  ``tests/test_torch_pna_block.py``) of the JAX kernel in interpret mode
  with precision=HIGHEST products, and one TF32 pass does not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset
from gnnbuilder_tpu.ops.pallas.pna_block import (
    _stack_params as jax_stack_params,
)
from gnnbuilder_tpu.ops.pallas.pna_block import (
    fused_pna_block_stack as jax_fused_stack,
)
from gnnbuilder_tpu.ops.quant import quantize_weight as jax_qw
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.ops.cuda import pna_block

ATOL, RTOL = 5e-4, 1e-3
MATS = (0, 1, 3, 4, 6)          # wi, wj, k0, ks, w_lin in the 8-tuple


def _layer(rng, f_in, f, f_out):
    s = 0.3 / np.sqrt(f_in + 1)
    n = rng.standard_normal
    arrs = (n((2 * f_in, f)) * s, n(f) * 0.1, n((f_in + 12 * f, f_out)) * s,
            n(f_out) * 0.1, n((f_out, f_out)) * s, n(f_out) * 0.1)
    return tuple(a.astype(np.float32) for a in arrs)


def _canonical_layers(rng):
    """The canonical PNA widths: 11 -> 128 -> ... -> 64, six layers."""
    dims = [(11, 128, 128)] + [(128, 128, 128)] * 4 + [(128, 128, 64)]
    return [_layer(rng, *d) for d in dims]


def _stacks(layers, F=128):
    ours = pna_block.stack_params(
        [tuple(torch.from_numpy(a) for a in lay) for lay in layers], F)
    ref = jax_stack_params(
        tuple(tuple(jnp.asarray(a) for a in lay) for lay in layers), F)
    return ours, [np.asarray(r) for r in ref]


@pytest.mark.parametrize("mode,per_reg", [("f32", 1), ("bf16", 2),
                                          ("int8", 4)])
@pytest.mark.parametrize("K", [128, 512])
def test_fragment_index_is_a_permutation(mode, per_reg, K):
    idx = pna_block._fragment_index(K, 128, per_reg)
    assert idx.shape == (K * 128,)
    assert torch.equal(torch.sort(idx).values, torch.arange(K * 128))
    # lane 5 (g = 1, t = 1) of the first k-step's first tile pair: its
    # first register holds column 1, rows 2 E t .. 2 E t + E - 1
    E = per_reg
    first = idx[5 * 4 * E: 5 * 4 * E + E]
    want = [(2 * E * 1 + e) * 128 + 1 for e in range(E)]
    assert first.tolist() == want


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_ks_rows_cover_the_aggregate_once(mode):
    rows = pna_block._ks_rows(mode, 128)
    assert torch.equal(torch.sort(rows).values, torch.arange(512))
    if mode != "int8":
        # chunk j, column p * 16 + cc: aggregate p of feature 16 j + cc
        j, p, cc = 3, 2, 5
        assert rows[64 * j + 16 * p + cc] == p * 128 + 16 * j + cc


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_unstaging_gives_the_jax_layout_back(mode):
    rng = np.random.default_rng(0)
    layers = [_layer(rng, 11, 128, 128), _layer(rng, 128, 128, 64)]
    ours, ref = _stacks(layers)
    st, _ = pna_block.prepare_stack(ours, mode)
    staged = pna_block.stage_stack(st, mode)
    L, F = 2, 128
    assert staged.shape == (L * 16 * F * F * (2 if mode == "f32" else 1),)
    assert staged.dtype == st[0].dtype
    back = pna_block.unstage_stack(staged, mode, L, F)
    for got, i in zip(back, MATS):
        if mode == "f32":   # the TF32 halves of the JAX weights
            want = torch.stack(pna_block.split_tf32(torch.from_numpy(
                ref[i].reshape(got.shape[1:])))).numpy()
        elif mode == "bf16":
            want = np.asarray(jnp.asarray(ref[i]).astype(jnp.bfloat16)
                              .astype(jnp.float32))
        else:
            want = np.stack([np.asarray(jax_qw(jnp.asarray(ref[i][l]))[0])
                             for l in range(L)])
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.reshape(got.shape))


def test_split_tf32_halves():
    x = torch.tensor([1.0, -1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10,
                      1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11), 3.14159265])
    hi, lo = pna_block.split_tf32(x)
    # ties round away from zero; 10 mantissa bits remain
    assert hi[2] == 1.0 + 2.0 ** -10 and hi[5] == -(1.0 + 2.0 ** -10)
    assert hi[3] == 1.0 + 2.0 ** -10 and hi[4] == 1.0 + 2.0 ** -9
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi.double() + lo.double() - x.double()).abs()
            <= x.double().abs() * 2.0 ** -21).all()


def _tf32_dot(passes):
    def dot(a, w):
        ah, al = pna_block.split_tf32(a)
        wh, wl = pna_block.split_tf32(w)
        if passes == 1:
            return ah @ wh
        return al @ wh + ah @ wl + ah @ wh
    return dot


def _canonical_case():
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=11,
                     edge_dim=4, seed=5)
    b = build_graph_batch(gs, block_size=128, node_multiple=128,
                          device="cpu")
    g = jax_build(gs, block_size=128, node_multiple=128)
    rng = np.random.default_rng(6)
    layers = _canonical_layers(rng)
    x = np.zeros((b.num_nodes, 128), np.float32)
    x[:, :11] = rng.standard_normal((b.num_nodes, 11))
    deltas = (2.0, 1.5, 2.5, 2.0, 1.8, 2.2)
    skips = (False, True, True, True, True, False)
    ours, ref = _stacks(layers)
    kern = np.asarray(jax_fused_stack(
        jnp.asarray(x), g.nbr_nodes, g.in_degree,
        *[jnp.asarray(r) for r in ref], deltas=deltas, skips=skips,
        act="relu", block_size=128, tile_rows=128, interpret=True,
        gather_mode="highest", mm="f32"))
    return b, x, ours, deltas, skips, kern


@pytest.fixture(scope="module")
def canonical_case():
    return _canonical_case()


@pytest.mark.parametrize("passes", [3, 1])
def test_split_tf32_stack_against_jax_kernel(canonical_case, passes,
                                             monkeypatch):
    """Three passes hold the stack tolerance; one pass misses it (the
    numbers are in ``split_tf32``'s docstring)."""
    b, x, ours, deltas, skips, kern = canonical_case
    monkeypatch.setattr(pna_block, "_f32_dot", _tf32_dot(passes))
    got = pna_block.pna_block_stack_plain(
        torch.from_numpy(x), b.nbr_nodes, b.in_degree, *ours,
        deltas=deltas, skips=skips, act="relu").numpy()
    err = np.abs(got - kern).max()
    print(f"{passes} TF32 pass(es): max abs {err:.3e}, "
          f"{err / np.abs(kern).max():.3e} of max |value|")
    close = np.allclose(got, kern, atol=ATOL, rtol=RTOL)
    assert close == (passes == 3)

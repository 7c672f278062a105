"""The host side of the tensor-core mp stack kernel (csrc/mp_block.cu),
against the JAX package on the same numpy inputs:

* ``stage_mp_stack`` lays w0 and w1 out in the kernel's stream order;
  ``unstage_mp_stack`` gives the JAX package's stacked weights back bit
  for bit in every mode (f32 as their TF32 halves, bf16 rounding, int8
  levels), at a width of two column tiles;
* the f32 mode's products in the kernel's order (``_tc_dot``: each k-step
  of 8 a split-TF32 chain from zero, hi*hi + hi*lo + lo*hi, added into
  the float32 sum; sage's two products one chain over [mean | h]) keep
  the six-layer gcn, gin and sage stacks at F = 128 within the stack
  tolerance (1e-3 abs, tests/test_torch_mp_block.py) of the JAX kernel in
  interpret mode with precision=HIGHEST products and of
  ``mp_stack_reference``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.core.graph import build_graph_batch as jax_build
from gnnbuilder_tpu.data.datasets import FakeDataset
from gnnbuilder_tpu.ops.pallas.mp_block import (
    mp_block_stack_auto as jax_stack_auto,
)
from gnnbuilder_tpu.ops.pallas.mp_block import mp_stack_reference
from gnnbuilder_tpu.ops.quant import quantize_weight as jax_qw
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.ops.cuda import mp_block
from gnnbuilder_tpu_torch.ops.cuda.pna_block import split_tf32
from test_torch_mp_block import _layers

STACK_ATOL = 1e-3
DIMS = (11, 128, 128, 128, 128, 128, 64)   # the canonical six layers
EPSS = (0.1, 0.2, 0.0, 0.3, 0.1, 0.2)
SKIPS = (False, True, True, True, True, False)


def _tc_dot(a, w):
    """a @ w as the kernel's f32 mode forms it: per k-step of 8, the three
    TF32 products of the split halves summed (in float64, rounded once:
    the tensor cores' chain), the steps added in float32 in k order."""
    ah, al = split_tf32(a)
    wh, wl = split_tf32(w)
    n, k = a.shape
    s = k // 8

    def steps(x, y):
        return torch.einsum("nsk,sko->nso", x.double().view(n, s, 8),
                            y.double().view(s, 8, -1))

    chains = (steps(al, wh) + steps(ah, wl) + steps(ah, wh)).float()
    acc = torch.zeros(n, w.shape[1])
    for i in range(s):
        acc = acc + chains[:, i]
    return acc


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_unstaging_gives_the_jax_weights_back(mode):
    rng = np.random.default_rng(0)
    L, F = 2, 256
    w0, w1 = (rng.standard_normal((2, L, F, F)) * 0.1).astype(np.float32)
    b = torch.zeros(L, F)
    st, _ = mp_block.prepare_mp_stack(
        (torch.from_numpy(w0), b, torch.from_numpy(w1), b), mode)
    staged = mp_block.stage_mp_stack(st, mode)
    assert staged.shape == (L * 2 * F * F * (2 if mode == "f32" else 1),)
    assert staged.dtype == st[0].dtype
    back = mp_block.unstage_mp_stack(staged, mode, L, F)
    for got, w in zip(back, (w0, w1)):
        if mode == "f32":   # the TF32 halves of the weights
            want = torch.stack(split_tf32(torch.from_numpy(w))).numpy()
        elif mode == "bf16":
            want = np.asarray(jnp.asarray(w).astype(jnp.bfloat16)
                              .astype(jnp.float32))
        else:
            want = np.stack([np.asarray(jax_qw(jnp.asarray(w[l]))[0])
                             for l in range(L)])
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_stream_order_is_the_kernel_tile_order():
    """Block (layer, matrix, column tile) after block, each F x 128
    weights: the first value of w1's second column tile of layer 1 sits at
    ((2 * 1 + 1) * 2 + 1) * F * 128 in "int8"."""
    L, F = 2, 256
    index, half = mp_block._stream_order("int8", L, F)
    assert torch.equal(torch.sort(index).values, torch.arange(L * 2 * F * F))
    assert not half.any()
    blk = ((2 * 1 + 1) * 2 + 1) * F * 128
    first = index[blk:blk + F * 128]
    lm, k, n = first // (F * F), first % (F * F) // F, first % F
    assert (lm == 3).all() and (n >= 128).all() and (k < F).all()


@pytest.fixture(scope="module", params=["gcn", "gin", "sage"])
def jax_stack(request):
    """(conv, the port's batch, x, the layers, the JAX kernel's and the
    reference's outputs) of the six-layer stack at F = 128."""
    conv = request.param
    gs = FakeDataset(num_graphs=24, avg_num_nodes=12, node_dim=11, seed=5)
    kw = dict(block_size=128, node_multiple=128)
    jb, tb = jax_build(gs, **kw), build_graph_batch(gs, device="cpu", **kw)
    layers = _layers(conv, np.random.default_rng(8), DIMS)
    x = np.random.default_rng(9).standard_normal(
        (tb.num_nodes, 11)).astype(np.float32)
    kern = np.asarray(jax_stack_auto(
        jnp.asarray(x), jb.block_adj, jb.in_degree, conv,
        [tuple(None if t is None else jnp.asarray(t) for t in l)
         for l in layers], epss=EPSS, skips=SKIPS, act="relu", out_dim=64,
        block_size=128, tile_rows=128, interpret=True,
        gather_mode="highest", mm="f32"))
    ref_layers = [(w, b, np.zeros_like(w) if w1 is None else w1,
                   np.zeros_like(b) if b1 is None else b1)
                  for w, b, w1, b1 in layers]
    ref = np.asarray(mp_stack_reference(
        jnp.asarray(x), jb.block_adj, jb.in_degree, conv, ref_layers, EPSS,
        SKIPS, act="relu"))[:, :64]
    return conv, tb, x, layers, kern, ref


def test_tensor_core_order_stays_within_the_stack_tolerance(jax_stack,
                                                            monkeypatch):
    conv, tb, x, layers, kern, ref = jax_stack
    monkeypatch.setattr(mp_block, "_f32_dot", _tc_dot)
    stacked = mp_block.stack_mp_params(
        [tuple(None if t is None else torch.from_numpy(t) for t in l)
         for l in layers], 128)
    got = mp_block.mp_block_stack_auto(
        torch.from_numpy(x), tb.block_adj, tb.in_degree, conv, stacked,
        epss=EPSS, skips=SKIPS, act="relu", out_dim=64).numpy()
    m = tb.node_mask.numpy()
    assert np.isfinite(got[m]).all()
    for want in (kern, ref):
        err = np.abs(got[m] - want[m]).max()
        print(f"{conv}: max abs {err:.3e} of max |value| "
              f"{np.abs(want[m]).max():.3e}")
        np.testing.assert_allclose(got[m], want[m], atol=STACK_ATOL)

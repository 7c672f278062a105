"""The port's PNA stack (ops/cuda/pna_block.py) against the JAX package:
its plain version vs ``fused_pna_block_stack(..., interpret=True)`` and
``pna_stack_reference`` on the same numpy inputs, 3 layers at F = 128.

Tolerance atol 5e-4 / rtol 1e-3, the JAX stack tests' contract: both
sides sum in another order, and the kernel arithmetic takes the receiver
term outside the reduce where the reference reduces u + v_j."""

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
from gnnbuilder_tpu.ops.pallas.pna_block import pna_stack_reference
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.ops.cuda import pna_block

ATOL, RTOL = 5e-4, 1e-3


def _graphs(num_graphs=24, node_dim=8, seed=0):
    return FakeDataset(num_graphs=num_graphs, avg_num_nodes=12,
                       node_dim=node_dim, edge_dim=4, seed=seed)


def _layer(rng, f_in, f, f_out):
    # modest scales keep 3-layer magnitudes O(1)
    s = 0.3 / np.sqrt(f_in + 1)
    n = rng.standard_normal
    arrs = (n((2 * f_in, f)) * s, n(f) * 0.1, n((f_in + 12 * f, f_out)) * s,
            n(f_out) * 0.1, n((f_out, f_out)) * s, n(f_out) * 0.1)
    return tuple(a.astype(np.float32) for a in arrs)


def _to_torch(layers):
    return [tuple(torch.from_numpy(a) for a in lay) for lay in layers]


def _to_jax(layers):
    return [tuple(jnp.asarray(a) for a in lay) for lay in layers]


def test_stack_params_match_jax():
    rng = np.random.default_rng(0)
    layers = [_layer(rng, 11, 11, 128), _layer(rng, 128, 128, 64)]
    ours = pna_block.stack_params(_to_torch(layers), 128)
    ref = jax_stack_params(tuple(_to_jax(layers)), 128)
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        np.testing.assert_array_equal(a.numpy(), b.reshape(a.shape))


@pytest.mark.parametrize("act,skips", [
    ("relu", (False, True, False)),
    ("tanh", (True, True, True)),
    (None, (False, False, False)),
])
def test_plain_stack_matches_jax_kernel_and_reference(act, skips):
    gs = _graphs()
    b = build_graph_batch(gs, block_size=128, node_multiple=128, device="cpu")
    g = jax_build(gs, block_size=128, node_multiple=128)
    N, F, L = b.num_nodes, 128, 3
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, F)).astype(np.float32)
    layers = [_layer(rng, F, F, F) for _ in range(L)]
    deltas = (2.0, 1.5, 2.5)

    stacked = pna_block.stack_params(_to_torch(layers), F)
    ours = pna_block.fused_pna_block_stack(
        torch.from_numpy(x), b.nbr_nodes, b.in_degree, *stacked,
        deltas=deltas, skips=skips, act=act,
    ).numpy()
    jstacked = jax_stack_params(tuple(_to_jax(layers)), F)
    kern = jax_fused_stack(
        jnp.asarray(x), g.nbr_nodes, g.in_degree, *jstacked, deltas=deltas,
        skips=skips, act=act, block_size=128, tile_rows=128,
        interpret=True, gather_mode="split2", mm="f32",
    )
    ref = pna_stack_reference(jnp.asarray(x), g.nbr_nodes, g.in_degree,
                              _to_jax(layers), deltas, skips, act=act)
    np.testing.assert_allclose(ours, np.asarray(kern), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_auto_padding_canonical_dims():
    """11-wide input -> 128 hidden -> 64 output, zero-padded to 128."""
    gs = _graphs(node_dim=11, seed=2)
    b = build_graph_batch(gs, block_size=128, node_multiple=128, device="cpu")
    g = jax_build(gs, block_size=128, node_multiple=128)
    rng = np.random.default_rng(3)
    layers = [_layer(rng, 11, 11, 128), _layer(rng, 128, 128, 128),
              _layer(rng, 128, 128, 64)]
    deltas, skips = (2.0, 2.0, 2.0), (False, True, False)
    x = b.node_feat
    out = pna_block.pna_block_stack_auto(
        x, b.nbr_nodes, b.in_degree,
        pna_block.stack_params(_to_torch(layers), 128), deltas, skips,
        act="relu", out_dim=64,
    )
    ref = pna_stack_reference(g.node_feat, g.nbr_nodes, g.in_degree,
                              _to_jax(layers), deltas, skips, act="relu")
    assert out.shape == (b.num_nodes, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


def test_empty_rows_fill():
    """deg-0 rows: max = min = mean = 0 and std = sqrt(1e-5) before the
    epilogue — checked through a one-layer stack whose only nonzero
    post-scaler block reads the std lanes."""
    N, F = 128, 128
    x = torch.randn(N, F)
    nbr = torch.full((N, 4), N - 1, dtype=torch.int32)
    deg = torch.zeros(N, dtype=torch.int32)
    z = torch.zeros
    eye = torch.eye(F)
    ks = z(1, 4 * F, 3 * F)
    ks[0, 3 * F:, :F] = eye                      # y_id = std
    out = pna_block.fused_pna_block_stack(
        x, nbr, deg, z(1, F, F), z(1, F, F), z(1, F), z(1, F, F), ks,
        z(1, F), eye[None].clone(), z(1, F), deltas=(1.0,), skips=(False,),
        act=None,
    )
    torch.testing.assert_close(out, torch.full((N, F), 1e-5 ** 0.5))


def test_wrapper_rejects_bad_inputs():
    N, F = 128, 128
    x = torch.randn(N, F)
    nbr = torch.zeros((N, 4), dtype=torch.int32)
    deg = torch.zeros(N, dtype=torch.int32)
    z = torch.zeros
    args = [z(1, F, F), z(1, F, F), z(1, F), z(1, F, F), z(1, 4 * F, 3 * F),
            z(1, F), z(1, F, F), z(1, F)]
    with pytest.raises(ValueError):
        pna_block.fused_pna_block_stack(x, nbr, deg, *args, deltas=(1.0,),
                                        skips=(False,), act="elu")
    with pytest.raises(ValueError):
        pna_block.fused_pna_block_stack(x.double(), nbr, deg, *args,
                                        deltas=(1.0,), skips=(False,))
    with pytest.raises(ValueError):
        pna_block.fused_pna_block_stack(x, nbr, deg, *args, deltas=(),
                                        skips=())
    with pytest.raises(ValueError, match="block_size"):  # N % block_size
        pna_block.fused_pna_block_stack(x, nbr, deg, *args, deltas=(1.0,),
                                        skips=(False,), block_size=256)

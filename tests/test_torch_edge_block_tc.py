"""The host side of the tensor-core EdgeConv kernel (csrc/edge_block.cu on
csrc/tc_rows.cuh), against the JAX package on the same numpy inputs.

The kernel reads the caller's weights as they are (no staged layout), so
what the CPU can hold is its arithmetic: through the plain version's
``_f32_dot`` seam, the f32 products in the kernel's order (each k-step
of 8 a split-TF32 chain from zero, added into the float32 sum in k
order; ``test_torch_mp_layer_tc._tc_dot_padded``) keep EdgeConv max, sum
and mean, at input widths 11 and 128 (hidden and out 128), within the
row 13 tolerance (1e-5 of max, tests/test_torch_edge_conv.py) of the
Pallas ``fused_edge_block_layer(interpret=True, gather_mode="highest",
mm="f32")`` and of ``edge_block_reference``; the seam carries lin0's two
products and lin1's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.ops.pallas.edge_block import edge_block_reference
from gnnbuilder_tpu.ops.pallas.edge_block import (
    fused_edge_block_layer as jax_layer,
)
from gnnbuilder_tpu_torch.ops.cuda import edge_block
from test_torch_edge_conv import TOL_OUT, _batches, _scaled_close
from test_torch_mp_layer_tc import _tc_dot_padded

CASES = [(aggr, fin) for aggr in ("max", "sum", "mean") for fin in (11, 128)]


def _operands(rng, N, Fin):
    def r(*shape, sc):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    return r(N, Fin, sc=1.0), dict(w_pair=r(2 * Fin, 128, sc=(2 * Fin) ** -0.5),
                                   b0=r(128, sc=0.1),
                                   w1=r(128, 128, sc=128 ** -0.5),
                                   b1=r(128, sc=0.1))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-Fin{f}" for a, f in CASES])
def jax_edge_case(request):
    """(case, the port's batch, x, params, skip, the JAX kernel's and the
    reference's outputs) of one layer with a skip."""
    aggr, fin = request.param
    jb, tb = _batches()
    N = tb.num_nodes
    rng = np.random.default_rng(7 + fin)
    x, p = _operands(rng, N, fin)
    skip = rng.standard_normal((N, 128)).astype(np.float32)
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    kern = np.asarray(jax_layer(jnp.asarray(x), jb.nbr_nodes, jb.in_degree,
                                **jp, aggregation=aggr,
                                skip=jnp.asarray(skip), act="relu",
                                tile_rows=N, interpret=True,
                                gather_mode="highest", mm="f32"))
    ref = np.asarray(edge_block_reference(
        jnp.asarray(x), jb.nbr_nodes, jb.in_degree, **jp, aggregation=aggr,
        skip=jnp.asarray(skip), act="relu"))
    return request.param, tb, x, p, skip, kern, ref


def _ours(tb, x, p, aggr, skip):
    return edge_block.fused_edge_block_layer(
        torch.from_numpy(x), tb.nbr_nodes, tb.in_degree,
        **{k: torch.from_numpy(a) for k, a in p.items()}, aggregation=aggr,
        skip=torch.from_numpy(skip), act="relu").numpy()


def test_tensor_core_order_stays_within_the_layer_tolerance(jax_edge_case,
                                                            monkeypatch):
    (aggr, fin), tb, x, p, skip, kern, ref = jax_edge_case
    monkeypatch.setattr(edge_block, "_f32_dot", _tc_dot_padded)
    got = _ours(tb, x, p, aggr, skip)
    m = tb.node_mask.numpy()
    for name, want in (("kernel", kern), ("reference", ref)):
        print(f"{aggr} Fin={fin} vs {name}: max abs "
              f"{np.abs(got[m] - want[m]).max():.3e} of max |value| "
              f"{np.abs(want[m]).max():.3e}")
        _scaled_close(got[m], want[m], TOL_OUT, (aggr, fin, name))


def test_seam_carries_every_f32_product(monkeypatch):
    """lin0's self and diff products and lin1's (over every slot of the
    table) go through ``_f32_dot``; the kernel's order moves the result
    off the plain product's by no more than the tolerance."""
    _, tb = _batches()
    rng = np.random.default_rng(4)
    x, p = _operands(rng, tb.num_nodes, 128)
    skip = np.zeros((tb.num_nodes, 128), np.float32)
    plain = _ours(tb, x, p, "max", skip)
    seen = []

    def counted(a, w):
        seen.append(tuple(w.shape))
        return _tc_dot_padded(a, w)

    monkeypatch.setattr(edge_block, "_f32_dot", counted)
    got = _ours(tb, x, p, "max", skip)
    assert seen == [(128, 128)] * 3
    m = tb.node_mask.numpy()
    assert not np.array_equal(got[m], plain[m])
    _scaled_close(got[m], plain[m], TOL_OUT, "seam")

"""The host side of the tensor-core gin / sage path of the mp layer kernel
(csrc/mp_layer.cu on csrc/tc_rows.cuh), against the JAX package on the
same numpy inputs.

The kernel reads the caller's weights as they are (no staged layout), so
what the CPU can hold is its arithmetic: through the plain version's
``_f32_dot`` seam, the f32 products in the kernel's order (``_tc_dot``:
each k-step of 8 a split-TF32 chain from zero, hi*hi + hi*lo + lo*hi,
added into the float32 sum in k order; k padded with zeros to whole
steps, as the kernel pads it; sage's two products one chain over [mean |
v] with [w0; w1]) keep gin and sage in ELL mode, at input widths 11 and
128 (hidden and out 128), with and without a skip, within the mp layer
tolerance (1e-5 of max, tests/test_torch_mp_layer.py) of the Pallas
``fused_mp_layer(interpret=True, gather_mode="highest", mm="f32")`` and
of ``mp_layer_reference``; the seam carries every f32 product of the
plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnbuilder_tpu.ops.pallas.mp_layer import fused_mp_layer as jax_layer
from gnnbuilder_tpu.ops.pallas.mp_layer import mp_layer_reference
from gnnbuilder_tpu_torch.ops.cuda import mp_layer
from test_torch_mp_block_tc import _tc_dot
from test_torch_mp_layer import TOL_OUT, _batches, _jax_kw, _scaled_close

CASES = [(conv, F, skip) for conv in ("gin", "sage") for F in (11, 128)
         for skip in (True, False)]


def _tc_dot_padded(a, w):
    """``_tc_dot`` with k padded by zeros to whole k-steps of 8."""
    pad = -a.shape[1] % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    return _tc_dot(a, w)


def _operands(conv, F, N, rng):
    def r(*shape, sc):
        return (rng.standard_normal(shape) * sc).astype(np.float32)

    v = r(N, F, sc=1.0)
    if conv == "gin":
        return v, dict(w0=r(F, 128, sc=F ** -0.5), b0=r(128, sc=0.1),
                       w1=r(128, 128, sc=128 ** -0.5), b1=r(128, sc=0.1))
    return v, dict(w0=r(F, 128, sc=F ** -0.5), b0=r(128, sc=0.1),
                   w1=r(F, 128, sc=F ** -0.5))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{c}-F{f}-{'skip' if s else 'noskip'}"
                     for c, f, s in CASES])
def jax_layer_case(request):
    """(case, the port's batch, v, params, skip, the JAX kernel's and the
    reference's outputs) of one ELL layer."""
    conv, F, use_skip = request.param
    jb, tb = _batches(False)
    N = tb.num_nodes
    rng = np.random.default_rng(11 + F)
    v, p = _operands(conv, F, N, rng)
    skip = (rng.standard_normal((N, 128)).astype(np.float32)
            if use_skip else None)
    eps = 0.15 if conv == "gin" else 0.0
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jskip = None if skip is None else jnp.asarray(skip)
    kern = np.asarray(jax_layer(jnp.asarray(v), jb.nbr_nodes, jb.in_degree,
                                conv, **jp, eps=eps, skip=jskip, act="relu",
                                **_jax_kw(jb, False)))
    ref = np.asarray(mp_layer_reference(jnp.asarray(v), jb.nbr_nodes,
                                        jb.in_degree, conv, **jp, eps=eps,
                                        skip=jskip, act="relu"))
    return request.param, tb, v, p, skip, eps, kern, ref


def _ours(tb, conv, v, p, skip, eps):
    return mp_layer.fused_mp_layer(
        torch.from_numpy(v), tb.nbr_nodes, tb.in_degree, conv,
        **{k: torch.from_numpy(a) for k, a in p.items()}, eps=eps,
        skip=None if skip is None else torch.from_numpy(skip),
        act="relu").numpy()


def test_tensor_core_order_stays_within_the_layer_tolerance(jax_layer_case,
                                                            monkeypatch):
    (conv, F, _), tb, v, p, skip, eps, kern, ref = jax_layer_case
    monkeypatch.setattr(mp_layer, "_f32_dot", _tc_dot_padded)
    got = _ours(tb, conv, v, p, skip, eps)
    m = tb.node_mask.numpy()
    for name, want in (("kernel", kern), ("reference", ref)):
        print(f"{conv} F={F} vs {name}: max abs "
              f"{np.abs(got[m] - want[m]).max():.3e} of max |value| "
              f"{np.abs(want[m]).max():.3e}")
        _scaled_close(got[m], want[m], TOL_OUT, (conv, F, name))


@pytest.mark.parametrize("conv,n_calls", [("gin", 2), ("sage", 1)])
def test_seam_carries_every_f32_product(conv, n_calls, monkeypatch):
    """gin's two products and sage's one chain over [mean | v] go through
    ``_f32_dot``, and the kernel's order moves the result off the plain
    product's (the seam is live) by no more than the tolerance."""
    _, tb = _batches(False)
    rng = np.random.default_rng(3)
    v, p = _operands(conv, 128, tb.num_nodes, rng)
    plain = _ours(tb, conv, v, p, None, 0.1)
    seen = []

    def counted(a, w):
        seen.append((tuple(a.shape), tuple(w.shape)))
        return _tc_dot_padded(a, w)

    monkeypatch.setattr(mp_layer, "_f32_dot", counted)
    got = _ours(tb, conv, v, p, None, 0.1)
    assert len(seen) == n_calls, seen
    if conv == "sage":
        assert seen[0][1] == (256, 128)
    m = tb.node_mask.numpy()
    assert not np.array_equal(got[m], plain[m])
    _scaled_close(got[m], plain[m], TOL_OUT, conv)

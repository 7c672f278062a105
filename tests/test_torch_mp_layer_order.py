"""The host side of row 4's redesigned elementwise convs (gcn, lg,
simple_sum, simple_mean; csrc/mp_layer.cu ``mp_layer_ew_kernel`` and
``mp_layer_ew_block_kernel``) against the JAX package on the same numpy
inputs.

The kernels add each row's neighbours in slot order (ELL) or list order
(block, fmaf(count, v, s)) from +0, one element in one lane, and run the
parent kernel's epilogue.  ``mp_layer_ew_ordered`` forms the same sums and
epilogue in torch, and the card tests hold the kernels' s (and out under
relu or no activation) to it bit for bit.  Here the ordered version stays
within 1e-6 of max of ``mp_layer_plain`` (another sum order, in f32 and
bf16) and within 1e-5 (outputs) / 2e-5 (s) of max of the Pallas
``fused_mp_layer(interpret=True, gather_mode="highest", mm="f32")`` and of
``mp_layer_reference``, on the batches of tests/test_torch_mp_layer.py
(degree-0 rows, multi-edges), with a skip and relu and without them
(tanh).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gnnbuilder_tpu.ops.pallas.mp_layer import mp_layer_reference
from gnnbuilder_tpu_torch.ops.cuda import mp_layer
from test_torch_mp_layer import (
    TOL_GRAD,
    TOL_OUT,
    _batches,
    _jax_kw,
    _operands,
    _scaled_close,
    _t,
    jax_layer,
)

ORDER_TOL = 1e-6


@pytest.fixture(scope="module", params=["ell", "block"])
def packing(request):
    block = request.param == "block"
    jb, tb = _batches(block)
    return block, jb, tb


def _case(tb, conv, act, use_skip):
    rng = np.random.default_rng(23)
    v, p = _operands(conv, rng, tb.num_nodes)
    skip = (rng.standard_normal(v.shape).astype(np.float32)
            if use_skip else None)
    return v, p, skip


@pytest.mark.parametrize("conv", mp_layer.EW_CONVS)
@pytest.mark.parametrize("act,use_skip", [("relu", True), ("tanh", False)])
def test_ordered_layer_matches_plain_and_jax(packing, conv, act, use_skip):
    block, jb, tb = packing
    v, p, skip = _case(tb, conv, act, use_skip)
    kw = dict(b0=_t(p["b0"]) if "b0" in p else None,
              skip=None if skip is None else _t(skip), act=act,
              block_adj=tb.block_adj if block else None)
    out, s = mp_layer.mp_layer_ew_ordered(_t(v), tb.nbr_nodes, tb.in_degree,
                                          conv, **kw)
    pout, ps = mp_layer.mp_layer_plain(_t(v), tb.nbr_nodes, tb.in_degree,
                                       conv, save_s=True, **kw)
    m = tb.node_mask.numpy()
    _scaled_close(out.numpy()[m], pout.numpy()[m], ORDER_TOL, "out plain")
    _scaled_close(s.numpy()[m], ps.numpy()[m], ORDER_TOL, "s plain")
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jskip = None if skip is None else jnp.asarray(skip)
    kern, ks = jax_layer(
        jnp.asarray(v), None if block else jb.nbr_nodes, jb.in_degree, conv,
        **jp, skip=jskip, act=act, save_s=True, **_jax_kw(jb, block))
    ref = mp_layer_reference(jnp.asarray(v), jb.nbr_nodes, jb.in_degree,
                             conv, **jp, skip=jskip, act=act)
    for want in (kern, ref):
        _scaled_close(out.numpy()[m], np.asarray(want)[m], TOL_OUT,
                      (conv, "out"))
    _scaled_close(s.numpy()[m], np.asarray(ks)[m], TOL_GRAD, (conv, "s"))


@pytest.mark.parametrize("conv", mp_layer.EW_CONVS)
def test_ordered_bf16_sum_matches_plain(packing, conv):
    """The bf16 mode: each gathered v rounded to bf16, the sums float32."""
    block, _, tb = packing
    v, p, skip = _case(tb, conv, "relu", True)
    kw = dict(b0=_t(p["b0"]) if "b0" in p else None, skip=_t(skip),
              act="relu", block_adj=tb.block_adj if block else None)
    out, _ = mp_layer.mp_layer_ew_ordered(_t(v), tb.nbr_nodes, tb.in_degree,
                                          conv, mode="bf16", **kw)
    want = mp_layer.mp_layer_plain(_t(v), tb.nbr_nodes, tb.in_degree, conv,
                                   mode="bf16", **kw)
    m = tb.node_mask.numpy()
    _scaled_close(out.numpy()[m], want.numpy()[m], ORDER_TOL, (conv, "bf16"))

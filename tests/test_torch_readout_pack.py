"""The readout's packed head (ops/cuda/readout.py ``pack_head``, the
buffer csrc/readout.cu stages with bulk copies) and ``GNNModel``'s cache
of it.

* Every Linear's weight (nn.Linear's [out, in] layout, rows padded with
  zeros to a multiple of 4), bias and int8 column scales read back
  exactly from the buffer in each mode, at 16-byte aligned offsets.
* Packing the live weights of a train step (``lin.weight.t()``) is one
  concatenation of views: no other op runs.
* The model packs its head once per weights and mode for inference, and
  packs anew after ``Program.set_params`` and after an optimizer step; in
  grad mode the readout takes the live weights on every call.
* ``fused_readout`` on a packed head gives the bits of the pairs it was
  packed from (the plain version on the CPU), in each mode.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gnnbuilder_tpu_torch import Program
from gnnbuilder_tpu_torch.core.graph import build_graph_batch
from gnnbuilder_tpu_torch.data.datasets import FakeDataset
from gnnbuilder_tpu_torch.nn.model import GNNModel
from gnnbuilder_tpu_torch.ops import dispatch, segment
from gnnbuilder_tpu_torch.ops.cuda import readout


def _pairs(rng, dims):
    return [(torch.from_numpy((rng.standard_normal((i, o)) * .3)
                              .astype(np.float32)),
             torch.from_numpy(rng.standard_normal(o).astype(np.float32)))
            for i, o in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("padded", [True, False])
@pytest.mark.parametrize("mode", list(readout.MODES))
@pytest.mark.parametrize("dims", [(33, 64, 64, 3), (192, 64, 64, 64, 64, 1),
                                  (8, 5)])
def test_packed_head_reads_back_exactly(mode, dims, padded):
    weights, scales = readout.prepare_head(
        _pairs(np.random.default_rng(len(dims)), dims), mode)
    head = readout.pack_head(weights, scales, mode, padded=padded)
    p = head.params
    assert p.dtype == torch.float32 and p.is_contiguous()
    assert p.numel() % 4 == 0 and head.dims == list(dims)
    offs = head.w_off + head.b_off + head.s_off
    assert all(o % 4 == 0 for o in offs)       # 16-byte aligned
    # the weights' rows, one Linear after another, before every bias
    assert head.w_off == sorted(head.w_off) and max(head.w_off) < min(
        head.b_off)
    for i, (w, b) in enumerate(weights):
        din, dout = w.shape
        d4 = readout.row_stride(din, padded)
        # the kernel's shared-memory stride: (stride / 4) odd when padded
        assert d4 % 4 == 0 and d4 >= din and (not padded or d4 // 4 % 2)
        rows = p[head.w_off[i]:head.w_off[i] + dout * d4].view(dout, d4)
        assert torch.equal(rows[:, :din].t(), w.float())
        assert not rows[:, din:].any()          # zero padding
        assert torch.equal(p[head.b_off[i]:head.b_off[i] + dout], b)
        if mode == "int8":
            assert torch.equal(p[head.s_off[i]:head.s_off[i] + dout],
                               scales[i])
    assert (head.s_off != []) == (mode == "int8")
    desc = list(head.desc(("add", "mean", "max")))
    L, M = len(dims) - 1, readout.MAX_LINEARS
    assert desc[:2] == [L, 3] and desc[2:2 + L + 1] == list(dims)
    assert desc[2 + M + 1:2 + M + 1 + L] == head.w_off
    assert desc[-1] == int(padded)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_live_weights_pack_in_one_concatenation():
    lins = [torch.nn.Linear(i, o) for i, o in ((24, 16), (16, 16), (16, 3))]
    live = [(lin.weight.t(), lin.bias) for lin in lins]
    with _Ops() as rec:
        head = readout.pack_head(live, padded=False)
    work = [f for f in rec.ops if not f.is_view]
    assert [f.overloadpacket for f in work] == [torch.ops.aten.cat]
    assert head.params.requires_grad       # from the live parameters


def _graphs_and_batch():
    gs = FakeDataset(num_graphs=12, avg_num_nodes=9, node_dim=6, seed=3)
    return gs, build_graph_batch(gs, block_size=128, node_multiple=128,
                                 device="cpu")


def _model():
    return GNNModel(graph_input_feature_dim=6, gnn_hidden_dim=16,
                    gnn_num_layers=2, gnn_output_dim=8, gnn_conv="gcn",
                    pooling_aggrs=("add", "mean", "max"), mlp_hidden_dim=16,
                    mlp_hidden_layers=2, mlp_out_dim=3)


def _first_weight(head):
    """The first Linear's [out, in] weight read from a packed head."""
    din, dout = head.dims[:2]
    ld = readout.row_stride(din, head.padded)
    return head.params[:dout * ld].view(dout, ld)[:, :din]


def test_model_head_cache_is_rebuilt_after_new_weights():
    model = _model()
    prog = Program(model, max_nodes=256, max_edges=512, max_graphs=13,
                   block_size=128, device="cpu", seed=2)
    prog.init_params()
    with torch.no_grad():
        first = model._readout_head("f32")
        assert model._readout_head("f32") is first
        lins = model.mlp_head.linear_layers
        assert first.padded
        assert torch.equal(_first_weight(first), lins[0].weight)
        state = {k: v + 1.0 for k, v in model.state_dict().items()}
        prog.set_params(state)
        second = model._readout_head("f32")
        assert second is not first
        assert torch.equal(_first_weight(second), lins[0].weight)
        bf = model._readout_head("bf16")
        assert bf.mode == "bf16" and model._readout_head("bf16") is bf
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    with torch.no_grad():
        third = model._readout_head("f32")
        assert third is not second
        assert torch.equal(_first_weight(third), lins[0].weight)


def test_grad_mode_readout_takes_the_live_weights():
    gs, b = _graphs_and_batch()
    model = _model()
    Program(model, device="cpu", seed=5).init_params()
    seen = []
    orig = readout.fused_readout_vjp

    def spy(x, n_node, weights, **kw):
        seen.append(weights)
        return orig(x, n_node, weights, **kw)

    readout.fused_readout_vjp = spy
    try:
        out = model(b)
    finally:
        readout.fused_readout_vjp = orig
    (weights,) = seen
    for (w, bias), lin in zip(weights, model.mlp_head.linear_layers):
        assert w.t().data_ptr() == lin.weight.data_ptr()
        assert bias is lin.bias and w.requires_grad
    out[b.graph_mask].sum().backward()
    lin0 = model.mlp_head.linear_layers[0]
    assert lin0.weight.grad is not None and lin0.weight.grad.abs().sum() > 0
    # no head is packed or cached in grad mode
    assert not any("readout" in k for k in model._kernel_cache)


@pytest.mark.parametrize("mode", list(readout.MODES))
def test_packed_head_gives_the_bits_of_its_pairs(mode):
    gs, b = _graphs_and_batch()
    rng = np.random.default_rng(8)
    F = 8
    x = torch.from_numpy(rng.standard_normal((b.num_nodes, F))
                         .astype(np.float32))
    mx = segment.contiguous_segment_max(x, b.graph_starts, b.n_node,
                                        b.max_graph_nodes_static)
    weights, scales = readout.prepare_head(_pairs(rng, (3 * F, 16, 4)), mode)
    kw = dict(aggrs=("add", "mean", "max"), mx=mx, starts=b.graph_starts,
              mode=mode, out_act="softmax")
    want = readout.fused_readout(x, b.n_node, weights, scales=scales, **kw)
    head = readout.pack_head(weights, scales, mode)
    got = readout.fused_readout(x, b.n_node, head, **kw)
    assert torch.equal(got, want)
    other = "bf16" if mode != "bf16" else "f32"
    with pytest.raises(ValueError, match="packed in mode"):
        readout.fused_readout(x, b.n_node, head, **dict(kw, mode=other))
    with pytest.raises(ValueError, match="pooled"):
        readout.fused_readout(x, b.n_node, head, **dict(kw, aggrs=("add",),
                                                       mx=None))


def test_model_inference_forward_uses_the_packed_head():
    gs, b = _graphs_and_batch()
    model = _model()
    Program(model, device="cpu", seed=7).init_params()
    with torch.no_grad():
        got = model(b)
        assert "f32 readout" in model._kernel_cache
        dispatch.set_fused_mode("never")
        try:
            want = model(b)
        finally:
            dispatch.set_fused_mode("auto")
    m = b.graph_mask
    torch.testing.assert_close(got[m], want[m], atol=1e-5, rtol=1e-5)

"""The port's CUDA kernels on the card, each against its plain version.

Needs an NVIDIA card and nvcc; skips without them.  Imports no JAX, so it
also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gnnbuilder_tpu_torch import Program
from gnnbuilder_tpu_torch.bench.canonical import (
    canonical_batches,
    canonical_model,
)
from gnnbuilder_tpu_torch.ops import dispatch, segment
from gnnbuilder_tpu_torch import train
from gnnbuilder_tpu_torch.ops.cuda import (
    _build,
    ell_bwd,
    mp_block,
    pna_block,
    pna_layer,
    readout,
    scatter_bwd,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        _build.nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(n_graphs=128):
    gs, (b,) = canonical_batches("qm9", n_graphs=n_graphs,
                                 batch_size=n_graphs, block_size=128,
                                 node_multiple=128, device="cpu")
    return gs, b


def test_pna_block_kernel_matches_plain(cuda_device):
    """3 layers at F = 128; atol 5e-4 / rtol 1e-3 (sums in another
    order)."""
    _, b = _batch()
    rng = np.random.default_rng(4)
    F = 128

    def layer():
        s = 0.3 / np.sqrt(F + 1)
        a = (rng.standard_normal((2 * F, F)) * s, rng.standard_normal(F) * .1,
             rng.standard_normal((13 * F, F)) * s, rng.standard_normal(F) * .1,
             rng.standard_normal((F, F)) * s, rng.standard_normal(F) * .1)
        return tuple(torch.from_numpy(t.astype(np.float32)) for t in a)

    stacked = pna_block.stack_params([layer() for _ in range(3)], F)
    x = torch.from_numpy(
        rng.standard_normal((b.num_nodes, F)).astype(np.float32))
    kw = dict(deltas=(2.0, 1.5, 2.5), skips=(False, True, False),
              act="relu")
    plain = pna_block.pna_block_stack_plain(
        x, b.nbr_nodes, b.in_degree, *stacked, **kw)
    bc = b.to(cuda_device)
    before = pna_block.fused_pna_block_stack.launches
    got = pna_block.fused_pna_block_stack(
        x.to(cuda_device), bc.nbr_nodes, bc.in_degree,
        *[t.to(cuda_device) for t in stacked], **kw)
    torch.cuda.synchronize()
    assert pna_block.fused_pna_block_stack.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(),
                               atol=5e-4, rtol=1e-3)


def _readout_case(cuda_device, out_act, F):
    _, b = _batch()
    bc = b.to(cuda_device)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(
        rng.standard_normal((b.num_nodes, F)).astype(np.float32))
    dims = (3 * F, 64, 64, 64, 64, 3)
    ws = [(torch.from_numpy((rng.standard_normal((i, o)) * .1)
                            .astype(np.float32)),
           torch.from_numpy(rng.standard_normal(o).astype(np.float32)))
          for i, o in zip(dims[:-1], dims[1:])]
    aggrs = ("add", "mean", "max")
    mx = segment.contiguous_segment_max(x, b.graph_starts, b.n_node,
                                        b.max_graph_nodes_static)
    plain = readout.readout_plain(x, b.n_node, b.graph_starts, ws, aggrs,
                                  mx, "relu", out_act)
    before = readout.fused_readout.launches
    got = readout.fused_readout(
        x.to(cuda_device), bc.n_node,
        [(w.to(cuda_device), c.to(cuda_device)) for w, c in ws],
        aggrs=aggrs, mx=mx.to(cuda_device), act="relu", out_act=out_act,
        starts=bc.graph_starts)
    torch.cuda.synchronize()
    assert readout.fused_readout.launches == before + 1
    m = b.graph_mask.numpy()
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[m], plain.numpy()[m], atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("out_act", [None, "softmax", "log_softmax"])
def test_readout_kernel_matches_plain(cuda_device, out_act):
    """atol 1e-4 / rtol 1e-4 on graph_mask rows (pooling sums in another
    order; the ghost row is garbage on both)."""
    _readout_case(cuda_device, out_act, 64)


def test_readout_kernel_wide_head_matches_plain(cuda_device):
    """Pooling 384 features: a 1152-wide head whose ~340 KB of weights
    exceed shared memory, so the kernel reads them from device memory;
    atol 1e-4 / rtol 1e-4 as above."""
    _readout_case(cuda_device, None, 384)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    """On the card a wrapper launches its kernel or raises: F = 256, a
    256-row block and a head whose activation buffers exceed shared
    memory are refused, with no launch and no plain fallback."""
    z = torch.zeros
    for F, N, bs in ((256, 256, 128), (128, 256, 256)):
        args = [z(1, F, F), z(1, F, F), z(1, F), z(1, F, F),
                z(1, 4 * F, 3 * F), z(1, F), z(1, F, F), z(1, F)]
        before = pna_block.fused_pna_block_stack.launches
        with pytest.raises(ValueError, match="CUDA PNA stack takes"):
            pna_block.fused_pna_block_stack(
                z(N, F, device=cuda_device),
                z(N, 4, dtype=torch.int32, device=cuda_device),
                z(N, dtype=torch.int32, device=cuda_device),
                *[t.to(cuda_device) for t in args], deltas=(1.0,),
                skips=(False,), block_size=bs)
        assert pna_block.fused_pna_block_stack.launches == before
    n_node = torch.tensor([3, 5], dtype=torch.int32, device=cuda_device)
    ws = [(z(64, 4096, device=cuda_device), z(4096, device=cuda_device)),
          (z(4096, 1, device=cuda_device), z(1, device=cuda_device))]
    before = readout.fused_readout.launches
    with pytest.raises(ValueError, match="shared memory"):
        readout.fused_readout(z(8, 64, device=cuda_device), n_node, ws)
    assert readout.fused_readout.launches == before


def test_program_forward_through_kernels(cuda_device):
    """Canonical 6-layer model on the card against the per-layer plain
    path on the card; both kernels launch once per forward."""
    gs, b = _batch(256)
    model = canonical_model("pna", "qm9", graphs=gs)
    p = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, block_size=128)
    p.init_params()
    bc = b.to(cuda_device)
    s0 = pna_block.fused_pna_block_stack.launches
    r0 = readout.fused_readout.launches
    out = p.forward(bc)
    torch.cuda.synchronize()
    assert pna_block.fused_pna_block_stack.launches == s0 + 1
    assert readout.fused_readout.launches == r0 + 1
    dispatch.set_fused_mode("never")
    try:
        ref = p.forward(bc)
    finally:
        dispatch.set_fused_mode("auto")
    m = bc.graph_mask
    assert torch.isfinite(out[m]).all()
    np.testing.assert_allclose(out[m].cpu().numpy(), ref[m].cpu().numpy(),
                               atol=5e-4, rtol=1e-3)


def _std_batch(n_graphs=128, device="cpu"):
    gs, (b,) = canonical_batches("qm9", n_graphs=n_graphs,
                                 batch_size=n_graphs, node_multiple=256,
                                 device=device)
    return gs, b


def _scaled_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("Fin,Fout,act,skip", [
    (128, 128, "relu", True), (256, 128, "tanh", False),
    (128, 256, "gelu", True), (128, 128, None, False),
    (384, 384, "relu", True)])
def test_pna_layer_kernel_matches_plain(cuda_device, Fin, Fout, act, skip):
    """Every output and residual on a standard-packed QM9 batch, tie
    counts and empty-row extrema exactly; the rest to 1e-4 of max |value|
    (products summed in another order).  Hidden 384 needs more shared
    memory than 32 rows per CTA allow and runs 16."""
    _, b = _std_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(1)
    F = Fin

    def r(fan_in, *s):
        return (torch.randn(*s, generator=g) / fan_in ** 0.5).to(cuda_device)

    p = (r(2 * Fin, 2 * Fin, F), r(2 * Fin, F), r(13 * F, Fin + 12 * F, Fout),
         r(13 * F, Fout), r(Fout, Fout, Fout), r(Fout, Fout))
    x = torch.randn(b.num_nodes, Fin, generator=g).to(cuda_device)
    x[1::3] = x[0::3][: x[1::3].shape[0]]      # tied neighbour values
    sk = torch.randn(b.num_nodes, Fout, generator=g).to(cuda_device)
    args = (x, b.nbr_nodes, b.in_degree, *p, 1.8)
    kw = dict(skip=sk if skip else None, act=act)
    before = pna_layer.fused_pna_layer.launches
    got = pna_layer.fused_pna_layer(*args, **kw, save_res=True)
    out_only = pna_layer.fused_pna_layer(*args, **kw)
    torch.cuda.synchronize()
    assert pna_layer.fused_pna_layer.launches == before + 2
    want = pna_layer.pna_layer_plain(*args, **kw, save_res=True)
    torch.testing.assert_close(out_only, got[0], rtol=0, atol=0)
    for name, a, w in zip(("out", "v", "agg_cat", "aux", "mid"), got, want):
        assert torch.isfinite(a).all(), name
        if name == "aux":
            torch.testing.assert_close(a[:, 3 * F:], w[:, 3 * F:], rtol=0,
                                       atol=0)
            a, w = a[:, :3 * F], w[:, :3 * F]
            ok = b.in_degree > 0
            torch.testing.assert_close(a[~ok], w[~ok], rtol=0, atol=0)
            a, w = a[ok], w[ok]
        assert _scaled_err(a, w) <= 1e-4, name
    assert (got[3][:, 3 * F:] > 1).any()


def _scatter_case(cuda_device, F):
    _, b = _std_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(2)

    def r(fan_in, *s):
        return (torch.randn(*s, generator=g) / fan_in ** 0.5).to(cuda_device)

    p = (r(2 * F, 2 * F, F), r(2 * F, F), r(13 * F, 13 * F, F), r(13 * F, F),
         r(F, F, F), r(F, F))
    x = torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
    x[1::3] = x[0::3][: x[1::3].shape[0]]
    _, v, agg_cat, aux, _ = pna_layer.fused_pna_layer(
        x, b.nbr_nodes, b.in_degree, *p, 1.8, act="relu", save_res=True)
    ks_t = pna_layer.scaler_blocks(p[2], F, F).t().contiguous()
    d_mid = torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
    args = (d_mid, aux, agg_cat, b.in_degree, b.nbr_nodes, v, ks_t, 1.8)
    before = scatter_bwd.fused_pna_scatter_backward.launches
    got = scatter_bwd.fused_pna_scatter_backward(*args)
    torch.cuda.synchronize()
    assert scatter_bwd.fused_pna_scatter_backward.launches == before + 1
    want = scatter_bwd.pna_scatter_backward_plain(*args)
    assert torch.isfinite(got).all()
    assert _scaled_err(got, want) <= 1e-4


def test_scatter_bwd_kernel_matches_plain(cuda_device):
    """dv on the residuals of a real forward, to 1e-4 of max |value|
    (atomic adds in another order)."""
    _scatter_case(cuda_device, 128)


def test_scatter_bwd_kernel_wide_matches_plain(cuda_device):
    """As above at hidden 384."""
    _scatter_case(cuda_device, 384)


def test_train_step_through_kernels(cuda_device):
    """One Adam step of the canonical model on a 128-graph standard-packed
    batch: the kernel path launches the layer and scatter kernels once per
    layer and the readout once, and its loss (1e-5 relative) and every
    parameter's gradient (1e-4 of its max |value|) match the plain path
    run in float64.  The float32 plain path is no reference here: its std
    over u + v cancels on near-constant rows and lands ~3.6e-4 of max
    |value| off the float64 gradient, where the kernels land ~2.4e-5."""
    gs, b = _std_batch(device=cuda_device)
    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    torch.manual_seed(0)
    model = canonical_model("pna", "qm9", graphs=gs).to(cuda_device)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    step = train.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3))
    counts = _counts()
    loss = float(step(b, target).detach())
    torch.cuda.synchronize()
    assert _delta(counts) == (6, 6, 6, 1)
    ref = canonical_model("pna", "qm9", graphs=gs).to(cuda_device).double()
    ref.load_state_dict({k: v.double() for k, v in state.items()})
    dispatch.set_fused_mode("never")
    try:
        ref_loss = train.masked_mse_loss(
            ref(b.replace(node_feat=b.node_feat.double())), target.double(),
            b.graph_mask)
        ref_loss.backward()
    finally:
        dispatch.set_fused_mode("auto")
    ref_loss = float(ref_loss.detach())
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    want = dict(ref.named_parameters())
    for k, p in model.named_parameters():
        assert torch.isfinite(p.grad).all(), k
        err = _scaled_err(p.grad.double(), want[k].grad)
        assert err <= 1e-4, (k, err)


def _counts():
    """Launches of the layer kernel, the scatter kernel (either mode), the
    reverse-table gather and the readout."""
    return (pna_layer.fused_pna_layer.launches,
            scatter_bwd.fused_pna_scatter_backward.launches
            + scatter_bwd.fused_pna_scatter_cstk.launches,
            ell_bwd.fused_gather_backward.launches,
            readout.fused_readout.launches)


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def test_wide_model_trains_through_kernels(cuda_device):
    """Hidden and output width 384 on a 64-graph standard-packed batch:
    the layer kernel then runs 16 rows per CTA and the readout reads its
    head from device memory.  Five Adam steps launch 6 + 6 + 1 kernels
    each, keep every gradient finite, and give a loss curve within 1e-3
    relative of the plain path run in float64 (the criterion of the
    canonical train path); standard-packed inference then runs the layer
    kernel in every layer, to 1e-4 of max |value| of the per-layer plain
    path.  Gradients are held per kernel at this width above, not per
    parameter against float64: on this batch a max/min decision whose
    candidates lie within float32 rounding of each other goes the other
    way in float64 and sends that gradient to another neighbour, which
    moves layer 4's pre_nn gradient ~4e-4 of its max: the kernel path on
    the card, its plain version on the CPU and the float32 per-layer
    plain path on the CPU all show it (``python -m
    gnnbuilder_tpu_torch.bench.grad_precision --graphs 64 --hidden 384
    --output 384`` names the rows)."""
    widths = dict(gnn_hidden_dim=384, gnn_output_dim=384)
    gs, b = _std_batch(64, device=cuda_device)
    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    torch.manual_seed(0)
    model = canonical_model("pna", "qm9", graphs=gs, **widths)
    ref = canonical_model("pna", "qm9", graphs=gs, **widths)
    ref.load_state_dict(model.state_dict())
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.to(cuda_device)
    ref.to(cuda_device).double()
    curves = {}
    for name, mdl, bb, t in (
            ("auto", model, b, target),
            ("f64", ref, b.replace(node_feat=b.node_feat.double()),
             target.double())):
        step = train.make_train_step(
            mdl, torch.optim.Adam(mdl.parameters(), lr=1e-3))
        dispatch.set_fused_mode("auto" if name == "auto" else "never")
        try:
            curves[name] = []
            for _ in range(5):
                counts = _counts()
                curves[name].append(float(step(bb, t)))
                torch.cuda.synchronize()
                if name == "auto":
                    assert _delta(counts) == (6, 6, 6, 1)
                    assert all(torch.isfinite(p.grad).all()
                               for p in mdl.parameters())
        finally:
            dispatch.set_fused_mode("auto")
    for a, w in zip(curves["auto"], curves["f64"]):
        assert abs(a - w) <= 1e-3 * abs(w), curves
    p = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, device="cuda")
    p.set_params(state)
    before = pna_layer.fused_pna_layer.launches
    out = p.forward(b)
    torch.cuda.synchronize()
    assert pna_layer.fused_pna_layer.launches == before + 6
    dispatch.set_fused_mode("never")
    try:
        ref_out = p.forward(b)
    finally:
        dispatch.set_fused_mode("auto")
    m = b.graph_mask
    assert torch.isfinite(out[m]).all()
    assert _scaled_err(out[m], ref_out[m]) <= 1e-4


def _hub_block_batch(device, n_graphs=120):
    """QM9 graphs and a 71-node star whose hub has in-degree 70, packed
    at 128 rows: the batch ships no ELL table."""
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.data.datasets import Graph, load_dataset

    gs = load_dataset("qm9", n=n_graphs)
    rng = np.random.default_rng(0)
    leaves = np.arange(1, 71)
    ei = np.concatenate([np.stack([leaves, 0 * leaves]),
                         np.stack([0 * leaves, leaves])], axis=1)
    star = Graph(x=rng.standard_normal((71, 11)).astype(np.float32),
                 edge_index=ei.astype(np.int64),
                 edge_attr=np.zeros((ei.shape[1], 4), np.float32))
    gs = gs[:7] + [star] + gs[7:]
    b = build_graph_batch(gs, block_size=128, node_multiple=128,
                          device=device)
    assert b.nbr_nodes is None
    return gs, b


@pytest.mark.parametrize("conv", ["gcn", "gin", "sage"])
@pytest.mark.parametrize("F", [128, 384])
def test_mp_block_kernel_matches_plain(cuda_device, conv, F):
    """6 layers at width F with skips on the 128-graph block batch, and at
    128 on a batch with a 70-in-degree hub and no ELL table (the kernel
    aggregates from block_adj); 1e-4 of max |value| on real rows (sums in
    another order).  F = 384 keeps H and T in device memory."""
    batches = [_batch()[1].to(cuda_device)]
    if F == 128:
        batches.append(_hub_block_batch(cuda_device)[1])
    g = torch.Generator(device="cpu").manual_seed(3)
    L = 6
    w0, w1 = [(torch.randn(L, F, F, generator=g) / F ** 0.5).to(cuda_device)
              for _ in range(2)]
    b0, b1 = [(torch.randn(L, F, generator=g) * .1).to(cuda_device)
              for _ in range(2)]
    kw = dict(conv=conv, epss=[0.1 * i for i in range(L)],
              skips=[0 < i < L - 1 for i in range(L)], act="relu")
    for b in batches:
        x = torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
        before = mp_block.fused_mp_block_stack.launches
        got = mp_block.fused_mp_block_stack(x, b.block_adj, b.in_degree, w0,
                                            b0, w1, b1, **kw)
        torch.cuda.synchronize()
        assert mp_block.fused_mp_block_stack.launches == before + 1
        want = mp_block.mp_stack_plain(x, b.block_adj, b.in_degree, w0, b0,
                                       w1, b1, **kw)
        m = b.node_mask
        assert torch.isfinite(got[m]).all()
        assert _scaled_err(got[m], want[m]) <= 1e-4


@pytest.mark.parametrize("conv", ["gcn", "gin", "sage"])
def test_program_forward_mp_convs_through_kernels(cuda_device, conv):
    """Canonical GCN, GIN and SAGE on a 256-graph block batch: gcn and
    sage launch the stack and the readout once per forward, gin the
    readout only; outputs within 1e-4 of max |value| of the per-layer
    plain path on the card."""
    gs, b = _batch(256)
    model = canonical_model(conv, "qm9", graphs=gs)
    p = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, block_size=128)
    p.init_params()
    bc = b.to(cuda_device)
    s0 = mp_block.fused_mp_block_stack.launches
    r0 = readout.fused_readout.launches
    out = p.forward(bc)
    torch.cuda.synchronize()
    stacked = 1 if conv in dispatch.MP_STACK_CONVS else 0
    assert mp_block.fused_mp_block_stack.launches == s0 + stacked
    assert readout.fused_readout.launches == r0 + 1
    dispatch.set_fused_mode("never")
    try:
        ref = p.forward(bc)
    finally:
        dispatch.set_fused_mode("auto")
    m = bc.graph_mask
    assert torch.isfinite(out[m]).all()
    assert _scaled_err(out[m], ref[m]) <= 1e-4


def test_pna_without_ell_table_on_the_card(cuda_device):
    """PNA on a block batch with a 70-in-degree hub (no ELL table) runs
    the edge-list path on the card and matches the CPU to 1e-4 of max
    |value|."""
    gs, b = _hub_block_batch("cpu")
    model = canonical_model("pna", "qm9", graphs=gs, gnn_num_layers=3)
    size = dict(max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, block_size=128)
    p = Program(model, **size)
    state = p.init_params()
    cpu = Program(canonical_model("pna", "qm9", graphs=gs,
                                  gnn_num_layers=3), **size, device="cpu")
    cpu.set_params({k: v.cpu() for k, v in state.items()})
    out = p.forward(b.to(cuda_device)).cpu()
    ref = cpu.forward(b)
    m = b.graph_mask
    assert torch.isfinite(out[m]).all()
    assert _scaled_err(out[m], ref[m]) <= 1e-4


def test_ell_gather_kernel_matches_plain_bitwise_stable(cuda_device):
    """The reverse-table gather on the 128-graph train batch with PNA's
    seven coefficient blocks (half the extremum refs hit): within 1e-6 of
    max |value| of the plain version (another sum order), and the same
    bits on two launches."""
    _, b = _std_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(4)
    N, F = b.num_nodes, 128
    v = torch.randn(N, F, generator=g).to(cuda_device)
    cstk = torch.randn(N, 7 * F, generator=g).to(cuda_device)
    hit = torch.rand(N, F, generator=g).to(cuda_device) < 0.5
    first = v[b.rev_nbr_nodes[:, 0].long()]
    cstk[:, 3 * F:4 * F] = torch.where(hit, first, cstk[:, 3 * F:4 * F])
    args = (cstk, b.rev_nbr_nodes, b.out_degree, v, True, True, 2)
    before = ell_bwd.fused_gather_backward.launches
    one = ell_bwd.fused_gather_backward(*args)
    two = ell_bwd.fused_gather_backward(*args)
    torch.cuda.synchronize()
    assert ell_bwd.fused_gather_backward.launches == before + 2
    assert torch.equal(one, two)
    want = ell_bwd.ell_gather_backward_plain(*args)
    assert _scaled_err(one, want) <= 1e-6


def test_pna_dv_and_train_step_are_bitwise_reproducible(cuda_device):
    """On a batch with a reverse table the PNA dv (scatter kernel in cstk
    mode, then the gather) is the same bits on two launches, and two
    train steps from one saved state give the same bits in every
    gradient; the cstk rows match the plain version to 1e-5 of max
    |value|."""
    gs, b = _std_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(6)
    F = 128

    def r(fan_in, *s):
        return (torch.randn(*s, generator=g) / fan_in ** 0.5).to(cuda_device)

    p = (r(2 * F, 2 * F, F), r(2 * F, F), r(13 * F, 13 * F, F), r(13 * F, F),
         r(F, F, F), r(F, F))
    x = torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
    _, v, agg_cat, aux, _ = pna_layer.fused_pna_layer(
        x, b.nbr_nodes, b.in_degree, *p, 1.8, act="relu", save_res=True)
    ks_t = pna_layer.scaler_blocks(p[2], F, F).t().contiguous()
    d_mid = torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
    cargs = (d_mid, aux, agg_cat, b.in_degree, ks_t, 1.8)
    dvs = []
    for _ in range(2):
        cstk = scatter_bwd.fused_pna_scatter_cstk(*cargs)
        dvs.append(ell_bwd.fused_gather_backward(
            cstk, b.rev_nbr_nodes, b.out_degree, v, True, True, 2))
    torch.cuda.synchronize()
    assert torch.equal(dvs[0], dvs[1])
    assert _scaled_err(cstk, scatter_bwd.pna_scatter_cstk_plain(
        *cargs)) <= 1e-5

    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    torch.manual_seed(0)
    model = canonical_model("pna", "qm9", graphs=gs).to(cuda_device)
    state = {k: t.clone() for k, t in model.state_dict().items()}
    grads = []
    for _ in range(2):
        model.load_state_dict(state)
        step = train.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-3))
        counts = _counts()
        step(b, target)
        torch.cuda.synchronize()
        assert _delta(counts) == (6, 6, 6, 1)
        grads.append({k: q.grad.clone() for k, q in
                      model.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k

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
from gnnbuilder_tpu_torch.ops import ell
from gnnbuilder_tpu_torch.ops.cuda import (
    _build,
    edge_block,
    ell_agg,
    ell_bwd,
    gat_block,
    gat_bwd,
    gat_layer,
    gine_layer,
    mp_block,
    mp_layer,
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


# --------------------------------- the tensor-core PNA stack (row 1, 1b, 1i)
# f32 within 1e-4 of max |value| (chip_smoke.py's TOL: split TF32 keeps
# f32 accuracy); the modes layer by layer within MODE_TOL, and through a
# whole 16-layer launch within CHAIN_TOL (each moved bf16 rounding or
# int8 level moves the next layer's input).
STACK_TC_TOL = 1e-4


def _stack_case(dev, blocks, W, L, seed):
    """A synthetic block-packed case: ``blocks`` 128-row blocks, every
    neighbour inside its row's block, in-degrees in [0, W] with empty rows
    and at least one row at the full width W in every block, L layers of
    random weights (stack_params layout, F = 128)."""
    rng = np.random.default_rng(seed)
    N, F = 128 * blocks, 128
    deg = rng.integers(0, W + 1, size=N)
    deg[::128] = W            # a full row in every block
    deg[5::128] = 0           # and an empty one
    base = (np.arange(N) // 128 * 128)[:, None]
    nbr = base + rng.integers(0, 128, size=(N, W))
    s = 0.3 / np.sqrt(F + 1)

    def layer():
        a = (rng.standard_normal((2 * F, F)) * s, rng.standard_normal(F) * .1,
             rng.standard_normal((13 * F, F)) * s, rng.standard_normal(F) * .1,
             rng.standard_normal((F, F)) * s, rng.standard_normal(F) * .1)
        return tuple(torch.from_numpy(t.astype(np.float32)) for t in a)

    stacked = [t.to(dev) for t in pna_block.stack_params(
        [layer() for _ in range(L)], F)]
    x = torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32))
    kw = dict(deltas=list(rng.uniform(1.0, 3.0, size=L)),
              skips=[bool(v) for v in rng.integers(0, 2, size=L)],
              act="relu")
    return (x.to(dev), torch.from_numpy(nbr.astype(np.int32)).to(dev),
            torch.from_numpy(deg.astype(np.int32)).to(dev), stacked, kw)


# 1 block; 132 = one wave on the H100's 132 SMs; 133 = one CTA over;
# 160 = the b1024 batch's blocks.  W = 72 exceeds the 64 neighbour slots
# the kernel stages in shared memory (the rest come from device memory).
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("blocks,W,L", [(1, 72, 1), (132, 8, 1),
                                        (133, 8, 16), (160, 8, 1)])
def test_pna_block_tc_matches_plain(cuda_device, mode, blocks, W, L):
    x, nbr, deg, stacked, kw = _stack_case(cuda_device, blocks, W, L,
                                           seed=blocks + L)
    st, sc = pna_block.prepare_stack(stacked, mode)
    kw = dict(kw, mode=mode, scales=sc)
    before = pna_block.fused_pna_block_stack.mode_launches[mode]
    got = pna_block.fused_pna_block_stack(x, nbr, deg, *st, **kw)
    again = pna_block.fused_pna_block_stack(x, nbr, deg, *st, **kw)
    torch.cuda.synchronize()
    assert pna_block.fused_pna_block_stack.mode_launches[mode] == before + 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)                      # bitwise twice
    want = pna_block.pna_block_stack_plain(x, nbr, deg, *st, **kw)
    tol = (STACK_TC_TOL if mode == "f32"
           else MODE_TOL[mode] if L == 1 else CHAIN_TOL[mode])
    assert _scaled_err(got, want) <= tol
    if mode != "f32" and L > 1:     # and layer by layer at MODE_TOL
        h = x
        for l in range(L):
            one = [t[l:l + 1] for t in st]
            lkw = dict(kw, deltas=kw["deltas"][l:l + 1],
                       skips=kw["skips"][l:l + 1],
                       scales=None if sc is None else [t[l:l + 1]
                                                       for t in sc])
            g1 = pna_block.fused_pna_block_stack(h, nbr, deg, *one, **lkw)
            w1 = pna_block.pna_block_stack_plain(h, nbr, deg, *one, **lkw)
            assert _scaled_err(g1, w1) <= MODE_TOL[mode], l
            h = w1.contiguous()


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_pna_block_cached_layout_matches_layout_on_the_call(cuda_device,
                                                             mode):
    """The model's cached stage_stack layout gives the same output, bit for
    bit, as a direct call that lays the weights out on the call; the f32
    model path (inference scope) reuses the cache without a new layout."""
    gs, b = _batch(256)
    b = b.to(cuda_device)
    model = canonical_model("pna", "qm9", graphs=gs).to(cuda_device)
    if mode == "f32":
        stacked, scales = model._kernel_params(128)[0], None
    else:
        stacked, scales = model._mode_params(128, mode)[0]
    staged = model._staged_stack(128, mode)
    assert model._staged_stack(128, mode) is staged
    L = model.gnn_num_layers
    x = torch.nn.functional.pad(b.node_feat,
                                (0, 128 - b.feature_dim)).contiguous()
    kw = dict(deltas=[c.delta for c in model.gnn_convs],
              skips=[0 < i < L - 1 for i in range(L)], act="relu",
              mode=mode, scales=scales)
    cached = pna_block.fused_pna_block_stack(
        x, b.nbr_nodes, b.in_degree, *stacked, staged=staged, **kw)
    fresh = pna_block.fused_pna_block_stack(
        x, b.nbr_nodes, b.in_degree, *stacked, **kw)
    torch.cuda.synchronize()
    assert torch.equal(cached, fresh)
    if mode == "f32":
        layouts = []
        orig = pna_block.stage_stack

        def counting(*a, **k):
            layouts.append(1)
            return orig(*a, **k)

        pna_block.stage_stack = counting
        try:
            with torch.no_grad(), dispatch.inference_mode():
                before = pna_block.fused_pna_block_stack.launches
                out = model._fused_gnn_stack(b, b.node_feat)
                torch.cuda.synchronize()
        finally:
            pna_block.stage_stack = orig
        assert pna_block.fused_pna_block_stack.launches == before + 1
        assert not layouts
        assert torch.equal(out, fresh[:, :model.gnn_output_dim])


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


READOUT_HEADS = {1: (4,), 5: (64, 64, 64, 64, 3), 8: (32,) * 7 + (5,)}
# graph sizes of the raw readout batch: empty graphs, single rows, and
# QM9's largest (29 rows); the ghost takes the pad rows after them
READOUT_SIZES = [0, 1, 29, 7, 0, 13, 29, 1, 18, 3] * 13


def _readout_raw(dev, F, seed):
    """x [N, F] and the batch's n_node, starts, mx and graph mask for
    READOUT_SIZES plus the ghost (N a multiple of 128)."""
    sizes = list(READOUT_SIZES)
    n = sum(sizes)
    N = (n + 127) // 128 * 128 + 128
    n_node = torch.tensor(sizes + [N - n], dtype=torch.int32)
    starts = (torch.cumsum(n_node, 0) - n_node).to(torch.int32)
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(N, F, generator=g)
    mx = segment.contiguous_segment_max(x, starts, n_node, N - n)
    mask = torch.ones(len(sizes) + 1, dtype=torch.bool)
    mask[-1] = False
    return [t.to(dev) for t in (x, n_node, starts, mx)], mask.to(dev)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("F", [8, 11, 64, 128])
@pytest.mark.parametrize("n_lin", sorted(READOUT_HEADS))
def test_readout_kernel_every_mode_width_and_head(cuda_device, mode, F,
                                                  n_lin):
    """Graphs of 0, 1 and 29 rows and the ghost, heads of 1, 5 and 8
    Linears, each mode: 1e-4 of max (f32; pooling sums in another order)
    or the mode's hold on the real graphs, a finite ghost row, one launch
    of the mode; a packed head gives the bits of its pairs."""
    (x, n_node, starts, mx), m = _readout_raw(cuda_device, F, F + n_lin)
    g = torch.Generator(device="cpu").manual_seed(n_lin)
    dims = (3 * F,) + READOUT_HEADS[n_lin]
    pairs = [((torch.randn(i, o, generator=g) / i ** 0.5).to(cuda_device),
              (torch.randn(o, generator=g) * .1).to(cuda_device))
             for i, o in zip(dims[:-1], dims[1:])]
    head, scales = readout.prepare_head(pairs, mode)
    kw = dict(aggrs=("add", "mean", "max"), mx=mx, act="relu",
              out_act="softmax" if n_lin == 5 else None, starts=starts,
              mode=mode)
    before = readout.fused_readout.mode_launches[mode]
    got = readout.fused_readout(x, n_node, head, scales=scales, **kw)
    torch.cuda.synchronize()
    assert readout.fused_readout.mode_launches[mode] == before + 1
    want = readout.readout_plain(x, n_node, starts, head, kw["aggrs"], mx,
                                 "relu", kw["out_act"], mode, scales)
    assert torch.isfinite(got).all()
    tol = MODE_TOL.get(mode, 1e-4)
    assert _scaled_err(got[m], want[m]) <= tol, (mode, F, n_lin)
    packed = readout.pack_head(head, scales, mode)
    again = readout.fused_readout(x, n_node, packed, **kw)
    assert torch.equal(again, got)


def test_readout_kernel_head_from_device_memory(cuda_device):
    """A head of ~1.3 MB (pooled 3 x 384 -> 256 -> 256 -> 3 padded wide)
    exceeds shared memory: the kernel reads it from device memory; f32
    and int8 against the plain version on the raw batch's real graphs."""
    (x, n_node, starts, mx), m = _readout_raw(cuda_device, 384, 3)
    g = torch.Generator(device="cpu").manual_seed(11)
    dims = (3 * 384, 256, 256, 3)
    pairs = [((torch.randn(i, o, generator=g) / i ** 0.5).to(cuda_device),
              (torch.randn(o, generator=g) * .1).to(cuda_device))
             for i, o in zip(dims[:-1], dims[1:])]
    for mode in ("f32", "int8"):
        head, scales = readout.prepare_head(pairs, mode)
        kw = dict(aggrs=("add", "mean", "max"), mx=mx, starts=starts,
                  mode=mode)
        got = readout.fused_readout(x, n_node, head, scales=scales, **kw)
        want = readout.readout_plain(x, n_node, starts, head, kw["aggrs"],
                                     mx, "relu", None, mode, scales)
        assert _scaled_err(got[m], want[m]) <= MODE_TOL.get(mode, 1e-4)


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


def _std_batch(n_graphs=128, device="cpu", node_multiple=256):
    gs, (b,) = canonical_batches("qm9", n_graphs=n_graphs,
                                 batch_size=n_graphs,
                                 node_multiple=node_multiple, device=device)
    return gs, b


def _scaled_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("Fin,Fout,act,skip,mult", [
    (128, 128, "relu", True, 256), (256, 128, "tanh", False, 256),
    (128, 256, "gelu", True, 256), (128, 128, None, False, 256),
    (384, 384, "relu", True, 256), (1024, 1024, "relu", True, 256),
    (128, 128, "relu", True, 1), (384, 128, "tanh", True, 1)])
def test_pna_layer_kernel_matches_plain(cuda_device, Fin, Fout, act, skip,
                                        mult):
    """Every output and residual on a standard-packed QM9 batch, tie
    counts and empty-row extrema exactly; the rest to 1e-4 of max |value|
    (products summed in another order).  Widths up to 1024 (the widest
    the kernel took before it ran on the tensor cores); ``mult`` 1 packs a
    row count that is no multiple of the aggregate launch's rows per CTA
    (checked)."""
    _, b = _std_batch(device=cuda_device, node_multiple=mult)
    if mult == 1:
        am = pna_layer.agg_rows(b.num_nodes, "f32", cuda_device)
        assert b.num_nodes % am, (b.num_nodes, am)
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


@pytest.mark.parametrize("Fin", [128, 1024])
def test_pna_layer_v_is_the_correctly_rounded_product(cuda_device, Fin):
    """The v the f32 layer stores, whose values its tie counts and the
    backward's max / min routing compare, is x Wj summed in float64 and
    rounded once: bit for bit the float64 product rounded to float32 (two
    float64 sums differ by ~1e-16, which moves a float32 rounding almost
    never)."""
    _, b = _std_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(4)
    F = Fout = 128

    def r(fan_in, *s):
        return (torch.randn(*s, generator=g) / fan_in ** 0.5).to(cuda_device)

    p = (r(2 * Fin, 2 * Fin, F), r(2 * Fin, F), r(13 * F, Fin + 12 * F, Fout),
         r(13 * F, Fout), r(Fout, Fout, Fout), r(Fout, Fout))
    x = torch.randn(b.num_nodes, Fin, generator=g).to(cuda_device)
    v = pna_layer.fused_pna_layer(x, b.nbr_nodes, b.in_degree, *p, 1.8,
                                  act="relu", save_res=True)[1]
    want = (x.double() @ p[0][Fin:].double()).float()
    assert torch.equal(v, want), int((v != want).sum())


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
    before = (scatter_bwd.fused_pna_scatter_cstk.launches,
              ell_bwd.fused_gather_backward_csr.launches)
    got = scatter_bwd.fused_pna_scatter_backward(*args)
    again = scatter_bwd.fused_pna_scatter_backward(*args)
    torch.cuda.synchronize()
    assert (scatter_bwd.fused_pna_scatter_cstk.launches,
            ell_bwd.fused_gather_backward_csr.launches) == (
                before[0] + 2, before[1] + 2)
    want = scatter_bwd.pna_scatter_backward_plain(*args)
    assert torch.isfinite(got).all()
    assert _scaled_err(got, want) <= 1e-4
    assert torch.equal(got, again)


def test_scatter_bwd_kernel_matches_plain(cuda_device):
    """dv on the residuals of a real forward through the route of a batch
    without a reverse table (the coefficient stack, then the gather over
    the reverse CSR), to 1e-4 of max |value| (sums in another order), the
    same bits on two calls."""
    _scatter_case(cuda_device, 128)


def test_scatter_bwd_kernel_wide_matches_plain(cuda_device):
    """As above at hidden 384."""
    _scatter_case(cuda_device, 384)


@pytest.mark.parametrize("rev", [True, False])
def test_train_step_through_kernels(cuda_device, rev):
    """One Adam step of the canonical model on a 128-graph standard-packed
    batch, with and without its reverse table: the kernel path launches
    the layer and scatter kernels once per layer (and the reverse-table
    gather, where the table is there) and the readout once, and its loss
    (1e-5 relative) and every parameter's gradient (1e-4 of its max
    |value|) match the plain path run in float64.  The float32 plain path
    is no reference here: its std over u + v cancels on near-constant rows
    and lands ~3.6e-4 of max |value| off the float64 gradient, where the
    kernels land ~2.4e-5."""
    gs, b = _std_batch(device=cuda_device)
    if not rev:
        b = b.replace(rev_nbr_nodes=None, out_degree=None)
    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    torch.manual_seed(0)
    model = canonical_model("pna", "qm9", graphs=gs).to(cuda_device)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    step = train.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3))
    counts = _counts()
    loss = float(step(b, target).detach())
    torch.cuda.synchronize()
    assert _delta(counts) == (6, 6, 6 if rev else 0, 1)
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
    """Launches of the layer kernel, the scatter kernel, the reverse-table
    gather and the readout."""
    return (pna_layer.fused_pna_layer.launches,
            scatter_bwd.fused_pna_scatter_cstk.launches,
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
    moves layer 4's pre_nn gradient ~4e-4 of its max: the float32 plain
    path and the kernels' plain versions on the CPU show it; the kernel
    path on the card, whose v is summed in float64 and rounded once,
    decides every one as float64 does on this batch (``python -m
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


def _hub_ell_batch(device):
    """``_hub_block_batch``'s graphs with an ELL table 72 slots wide, so
    the hub's 70 in-neighbours sit in one row of it."""
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch

    gs, _ = _hub_block_batch("cpu")
    b = build_graph_batch(gs, block_size=128, node_multiple=128,
                          ell_width=72, device=device)
    assert int(b.in_degree.max()) == 70
    return b


def _dense_block_batch(device):
    """The 128-graph block batch with its first block's adjacency dense
    (an edge between every ordered pair, in-degree 128): the most list
    entries a block holds."""
    _, b = _batch()
    adj = b.block_adj.clone()
    adj[0] = 1.0
    deg = b.in_degree.clone()
    deg[:128] = 128
    return b.replace(block_adj=adj, in_degree=deg).to(device)


@pytest.mark.parametrize("conv", ["gcn", "gin", "sage"])
@pytest.mark.parametrize("F", [128, 384])
def test_mp_block_kernel_matches_plain(cuda_device, conv, F):
    """6 layers at width F with skips on the 128-graph block batch, and at
    128 on a batch with a 70-in-degree hub and no ELL table (the kernel
    aggregates from block_adj), on a batch whose first block is dense and
    on the 1024-graph batch (160 blocks, more than the card's SMs); 1e-4
    of max |value| on real rows (sums in another order).  F = 384 keeps
    H and T in device memory."""
    batches = [_batch()[1].to(cuda_device)]
    if F == 128:
        batches += [_hub_block_batch(cuda_device)[1],
                    _dense_block_batch(cuda_device),
                    _batch(1024)[1].to(cuda_device)]
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


# row 7's term sets: each one the kernel instantiates (lin-only, PNA's,
# cmp-only) and one it takes at run time
GATHER_TERMS = [(True, False, 0), (True, True, 2), (False, False, 1),
                (True, True, 1)]


def _gather_case(b, F, terms, seed, device):
    """(cstk, v) with K blocks of width F on batch b, half the extremum
    refs hitting v (exact ties), v None for lin-only."""
    has_lin, has_dev, n_cmp = terms
    g = torch.Generator(device="cpu").manual_seed(seed)
    N = b.num_nodes
    K = ell_bwd.n_blocks(*terms)
    v = torch.randn(N, F, generator=g).to(device)
    cstk = torch.randn(N, K * F, generator=g).to(device)
    o = int(has_lin) + 2 * int(has_dev)
    first = v[b.nbr_nodes[:, 0].long()]
    for k in range(n_cmp):
        hit = torch.rand(N, F, generator=g).to(device) < 0.5
        blk = cstk[:, (o + 2 * k) * F:(o + 2 * k + 1) * F]
        blk.copy_(torch.where(hit, first, blk))
    return cstk, (v if has_dev or n_cmp else None)


def _reverse_table(b):
    """The batch's reverse table, or one laid out from ``reverse_csr``
    where it carries none."""
    if b.rev_nbr_nodes is not None:
        return b.rev_nbr_nodes, b.out_degree
    ptr, idx = ell.reverse_csr(b.nbr_nodes, b.in_degree)
    odeg = (ptr[1:] - ptr[:-1]).to(torch.int32)
    r = torch.arange(int(odeg.max()), device=odeg.device)
    rev = torch.zeros((odeg.shape[0], r.shape[0]), dtype=torch.int32,
                      device=odeg.device)
    rev[r < odeg[:, None]] = idx
    return rev, odeg


def _gather_batches(device):
    """The 128-graph train batch, and a batch whose 70-out-degree hub
    sits in an ELL table 72 slots wide."""
    return {"train": _std_batch(device=device)[1],
            "hub": _hub_ell_batch(device)}


def test_ell_gather_kernel_matches_plain_bitwise_stable(cuda_device):
    """The reverse-table gather on the 128-graph train batch and on the
    hub batch (a sender of out-degree 70), at F = 11, 128 and 384, for each
    term set (half the extremum refs hit): the same bits as the
    slot-ordered loop (``ell_gather_backward_ordered``: the kernel's own
    sum order), within 1e-6 of max |value| of the plain version (another
    sum order), and the same bits on two launches."""
    for name, b in _gather_batches(cuda_device).items():
        rev, odeg = _reverse_table(b)
        if name == "hub":
            assert int(odeg.max()) == 70
        for F in (11, 128, 384):
            for i, terms in enumerate(GATHER_TERMS):
                cstk, v = _gather_case(b, F, terms, 4 + i, cuda_device)
                args = (cstk, rev, odeg, v, *terms)
                before = ell_bwd.fused_gather_backward.launches
                one = ell_bwd.fused_gather_backward(*args)
                two = ell_bwd.fused_gather_backward(*args)
                torch.cuda.synchronize()
                what = (name, F, terms)
                assert ell_bwd.fused_gather_backward.launches == before + 2
                assert torch.equal(one, two), what
                assert torch.equal(
                    one, ell_bwd.ell_gather_backward_ordered(*args)), what
                want = ell_bwd.ell_gather_backward_plain(*args)
                assert _scaled_err(one, want) <= 1e-6, what


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


MP_LAYER_CONVS = ("gin", "sage", "gcn", "lg", "simple_sum", "simple_mean")


def _mp_operands(conv, F, g, device, H=128):
    """(v, operands) of one layer at input width F (H hidden and out for
    gin and sage, F for the rest)."""
    def r(*s, sc=None):
        sc = 1.0 / s[0] ** 0.5 if sc is None else sc
        return (torch.randn(*s, generator=g) * sc).to(device)

    if conv == "gin":
        return dict(w0=r(F, H), b0=r(H, sc=.1), w1=r(H, H),
                    b1=r(H, sc=.1), eps=0.2)
    if conv == "sage":
        return dict(w0=r(F, H), b0=r(H, sc=.1), w1=r(F, H))
    if conv == "gcn":
        return dict(b0=r(F, sc=.1))
    return {}


@pytest.mark.parametrize("conv", MP_LAYER_CONVS)
@pytest.mark.parametrize("mode", ["ell", "block"])
def test_mp_layer_kernel_matches_plain(cuda_device, conv, mode):
    """Row 4 in both modes at input widths 11 and 128, with a skip and
    relu and without them (tanh), and its saved s: 1e-4 of max |value| on
    real rows (sums in another order); the block mode also on a batch
    with a 70-in-degree hub (no ELL table).  gin and sage (the tensor-core
    kernel, 64 rows a CTA) also at hidden 384 throughout (gelu) and on
    the 1024-graph batch (292 CTAs in ELL mode, over the card's 132
    SMs)."""
    batches = ([_std_batch(device=cuda_device)[1]] if mode == "ell" else
               [_batch()[1].to(cuda_device), _hub_block_batch(cuda_device)[1]])
    cases = [(b, F, 128, act, sk) for b in batches
             for F, act, sk in ((11, "relu", True), (128, "tanh", False))]
    if conv in ("gin", "sage"):
        big = (_std_batch(1024, device=cuda_device)[1] if mode == "ell" else
               _batch(1024)[1].to(cuda_device))
        cases += [(batches[0], 384, 384, "gelu", True),
                  (big, 128, 128, "relu", True), (big, 11, 128, None, False)]
    g = torch.Generator(device="cpu").manual_seed(9)
    for b, F, H, act, with_skip in cases:
        ops = _mp_operands(conv, F, g, cuda_device, H)
        x = torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
        Fout = H if conv in ("gin", "sage") else F
        skip = (torch.randn(b.num_nodes, Fout, generator=g)
                .to(cuda_device) if with_skip else None)
        kw = dict(ops, skip=skip, act=act, save_s=True,
                  block_adj=b.block_adj if mode == "block" else None)
        before = mp_layer.fused_mp_layer.launches
        out, s = mp_layer.fused_mp_layer(x, b.nbr_nodes, b.in_degree,
                                         conv, **kw)
        torch.cuda.synchronize()
        assert mp_layer.fused_mp_layer.launches == before + 1
        want, want_s = mp_layer.mp_layer_plain(
            x, b.nbr_nodes, b.in_degree, conv, **kw)
        m = b.node_mask
        assert torch.isfinite(out[m]).all()
        assert _scaled_err(out[m], want[m]) <= 1e-4, (F, act)
        assert _scaled_err(s[m], want_s[m]) <= 1e-4, (F, act)


@pytest.mark.parametrize("conv", mp_layer.EW_CONVS)
@pytest.mark.parametrize("packing", ["ell", "block"])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_mp_layer_ew_kernel_bits(cuda_device, conv, packing, mode):
    """Row 4's elementwise instances at F = 1, 2, 4, 8, 11, 64 and 128
    (lane groups of four lanes and more; scalar and float4 columns): s
    and, under relu or no activation, out the bits of
    ``mp_layer_ew_ordered`` (tanh 1e-6 of max: torch's tanh is not
    CUDA's), and within 1e-4 of max (bf16 2e-3) of the plain version."""
    b = (_std_batch(device=cuda_device)[1] if packing == "ell"
         else _batch()[1].to(cuda_device))
    badj = b.block_adj if packing == "block" else None
    g = torch.Generator(device="cpu").manual_seed(13)
    for F in (1, 2, 4, 8, 11, 64, 128):
        for act, with_skip in (("relu", True), (None, False),
                               ("tanh", True)):
            ops = _mp_operands(conv, F, g, cuda_device)
            x = torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
            skip = (torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
                    if with_skip else None)
            kw = dict(skip=skip, act=act, block_adj=badj, mode=mode)
            f32 = mode == "f32"
            got = mp_layer.fused_mp_layer(x, b.nbr_nodes, b.in_degree, conv,
                                          save_s=f32, **ops, **kw)
            out, s = got if f32 else (got, None)
            torch.cuda.synchronize()
            want_o, want_s = mp_layer.mp_layer_ew_ordered(
                x, b.nbr_nodes, b.in_degree, conv, ops.get("b0"), **kw)
            if f32:
                assert torch.equal(s, want_s), (F, act)
            if act == "tanh":
                assert _scaled_err(out, want_o) <= 1e-6, (F, act)
            else:
                assert torch.equal(out, want_o), (F, act)
            plain = mp_layer.mp_layer_plain(x, b.nbr_nodes, b.in_degree,
                                            conv, **ops, **kw)
            m = b.node_mask
            tol = 1e-4 if f32 else MODE_TOL[mode]
            assert _scaled_err(out[m], plain[m]) <= tol, (F, act)


def test_csr_gather_is_bitwise_stable(cuda_device):
    """The gather's CSR mode over ``reverse_csr`` of the forward table, on
    the train batch and the hub batch, at F = 11, 128 and 384, for each
    term set: the same bits as the slot-ordered loop over the CSR, within
    1e-6 of max |value| of the plain version and of the table mode, and
    the same bits on two launches."""
    for name, b in _gather_batches(cuda_device).items():
        ptr, idx = ell.reverse_csr(b.nbr_nodes, b.in_degree)
        rev, odeg = _reverse_table(b)
        for F in (11, 128, 384):
            for i, terms in enumerate(GATHER_TERMS):
                cstk, v = _gather_case(b, F, terms, 5 + i, cuda_device)
                args = (cstk, ptr, idx, v, *terms)
                before = ell_bwd.fused_gather_backward_csr.launches
                one = ell_bwd.fused_gather_backward_csr(*args)
                two = ell_bwd.fused_gather_backward_csr(*args)
                torch.cuda.synchronize()
                what = (name, F, terms)
                assert (ell_bwd.fused_gather_backward_csr.launches
                        == before + 2)
                assert torch.equal(one, two), what
                assert torch.equal(
                    one, ell_bwd.ell_gather_backward_csr_ordered(*args)), what
                assert _scaled_err(one, ell_bwd.ell_gather_backward_csr_plain(
                    *args)) <= 1e-6, what
                table = ell_bwd.fused_gather_backward(cstk, rev, odeg, v,
                                                      *terms)
                assert _scaled_err(one, table) <= 1e-6, what


@pytest.mark.parametrize("conv", ["gcn", "gin", "sage"])
@pytest.mark.parametrize("rev", [True, False])
def test_mp_train_step_through_kernels(cuda_device, conv, rev):
    """One Adam step of canonical GCN, GIN or SAGE on the 128-graph
    standard-packed batch, with its reverse table or without one: six mp
    layer launches, six lin-only gathers (table or CSR mode) and one
    readout; every gradient within 1e-4 of max |value| of the plain path
    run in float64 (GIN: in float32, since relu decisions within float32
    rounding of 0 go the other way in float64 and move a gradient ~1e-3
    of its max in every float32 path), and the same bits on a second
    step from the same state."""
    gs, b = _std_batch(device=cuda_device)
    if not rev:
        b = b.replace(rev_nbr_nodes=None, out_degree=None)
    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    torch.manual_seed(0)
    model = canonical_model(conv, "qm9", graphs=gs).to(cuda_device)
    state = {k: t.clone() for k, t in model.state_dict().items()}
    counters = (mp_layer.fused_mp_layer, ell_bwd.fused_gather_backward,
                ell_bwd.fused_gather_backward_csr, readout.fused_readout)
    grads = []
    for _ in range(2):
        model.load_state_dict(state)
        step = train.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-3))
        before = [f.launches for f in counters]
        step(b, target)
        torch.cuda.synchronize()
        assert [f.launches - n for f, n in zip(counters, before)] == [
            6, 6 if rev else 0, 0 if rev else 6, 1]
        grads.append({k: q.grad.clone() for k, q in
                      model.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
    dt = torch.float32 if conv == "gin" else torch.float64
    ref = canonical_model(conv, "qm9", graphs=gs).to(cuda_device).to(dt)
    ref.load_state_dict({k: v.to(dt) for k, v in state.items()})
    dispatch.set_fused_mode("never")
    try:
        train.masked_mse_loss(
            ref(b.replace(node_feat=b.node_feat.to(dt))), target.to(dt),
            b.graph_mask).backward()
    finally:
        dispatch.set_fused_mode("auto")
    want = dict(ref.named_parameters())
    for k, q in grads[0].items():
        assert torch.isfinite(q).all(), k
        assert _scaled_err(q.to(dt), want[k].grad) <= 1e-4, k


def test_pna_train_step_without_reverse_table_is_bitwise_reproducible(
        cuda_device):
    """The canonical PNA train step on the 128-graph batch without its
    reverse table: dv through the coefficient stack and the CSR gather in
    every layer, and every gradient the same bits on two steps from one
    state."""
    gs, b = _std_batch(device=cuda_device)
    b = b.replace(rev_nbr_nodes=None, out_degree=None)
    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    torch.manual_seed(0)
    model = canonical_model("pna", "qm9", graphs=gs).to(cuda_device)
    state = {k: t.clone() for k, t in model.state_dict().items()}
    grads = []
    for _ in range(2):
        model.load_state_dict(state)
        step = train.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-3))
        before = ell_bwd.fused_gather_backward_csr.launches
        counts = _counts()
        step(b, target)
        torch.cuda.synchronize()
        assert _delta(counts) == (6, 6, 0, 1)
        assert ell_bwd.fused_gather_backward_csr.launches == before + 6
        grads.append({k: q.grad.clone() for k, q in
                      model.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def _gat_operands(Fin, H, C, g, device, concat=True):
    def r(*s, sc):
        return (torch.randn(*s, generator=g) * sc).to(device)

    return dict(w=r(Fin, H * C, sc=Fin ** -0.5), att_src=r(1, H, C, sc=.3),
                att_dst=r(1, H, C, sc=.3),
                bias=r(H * C if concat else C, sc=.1))


@pytest.mark.parametrize("Fin,H,C,act,skip", [
    (11, 4, 128, "relu", False), (512, 4, 128, "relu", True),
    (512, 4, 64, None, False), (24, 3, 20, "tanh", True)])
@pytest.mark.parametrize("self_loops", [True, False])
def test_gat_layer_kernel_matches_plain(cuda_device, Fin, H, C, act, skip,
                                        self_loops):
    """Row 10 on the standard-packed batch at the canonical widths and an
    odd one: 1e-4 of max |value| on real rows (sums in another order)."""
    _, b = _std_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(21)
    ops = _gat_operands(Fin, H, C, g, cuda_device)
    x = torch.randn(b.num_nodes, Fin, generator=g).to(cuda_device)
    sk = (torch.randn(b.num_nodes, H * C, generator=g).to(cuda_device)
          if skip else None)
    args = (x, b.nbr_nodes, b.in_degree, *ops.values(), H)
    kw = dict(self_loops=self_loops, skip=sk, act=act)
    before = gat_layer.fused_gat_layer.launches
    out = gat_layer.fused_gat_layer(*args, **kw)
    torch.cuda.synchronize()
    assert gat_layer.fused_gat_layer.launches == before + 1
    want = gat_layer.gat_layer_plain(*args, **kw)
    m = b.node_mask
    assert torch.isfinite(out[m]).all()
    assert _scaled_err(out[m], want[m]) <= 1e-4


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("Fin,self_loops,act,skip", [
    (11, True, "relu", False), (512, True, "relu", True),
    (40, False, None, True)])
def test_gat_block_kernel_matches_plain(cuda_device, concat, Fin,
                                        self_loops, act, skip):
    """Row 9 on the block-packed batch (parallel edges: counts above 1)
    and on a block batch with a 70-in-degree hub, heads 4: 1e-4 of max
    |value| on real rows."""
    H, C = 4, 128 if concat else 64
    g = torch.Generator(device="cpu").manual_seed(22)
    for b in (_batch()[1].to(cuda_device), _hub_block_batch(cuda_device)[1]):
        ops = _gat_operands(Fin, H, C, g, cuda_device, concat)
        out_w = H * C if concat else C
        x = torch.randn(b.num_nodes, Fin, generator=g).to(cuda_device)
        sk = (torch.randn(b.num_nodes, out_w, generator=g).to(cuda_device)
              if skip else None)
        args = (x, b.block_adj, *ops.values(), H)
        kw = dict(self_loops=self_loops, skip=sk, act=act, concat=concat)
        before = gat_block.fused_gat_block_layer.launches
        out = gat_block.fused_gat_block_layer(*args, **kw)
        torch.cuda.synchronize()
        assert gat_block.fused_gat_block_layer.launches == before + 1
        want = gat_block.gat_block_layer_plain(*args, **kw)
        m = b.node_mask
        assert torch.isfinite(out[m]).all()
        assert _scaled_err(out[m], want[m]) <= 1e-4


@pytest.mark.parametrize("rev", [True, False])
@pytest.mark.parametrize("H,C", [(4, 128), (4, 64), (3, 20), (2, 4)])
def test_gat_bwd_kernel_matches_plain(cuda_device, rev, H, C):
    """Row 11's six outputs on the standard-packed batch and on the hub
    batch (a receiver of in-degree 70 in a 72-wide table, and a sender of
    out-degree 70), over the reverse table or the reverse CSR: 1e-4 of
    max |value|, and the same bits on two launches.  (4, 128) and (4, 64)
    are the main path's row instances, (3, 20) and (2, 4) the general
    one."""
    g = torch.Generator(device="cpu").manual_seed(23)
    for name, b in (("train", _std_batch(device=cuda_device)[1]),
                    ("hub", _hub_ell_batch(cuda_device))):
        N = b.num_nodes
        dz, h = [torch.randn(N, H * C, generator=g).to(cuda_device)
                 for _ in range(2)]
        a_src, a_dst = [torch.randn(N, H, generator=g).to(cuda_device)
                        for _ in range(2)]
        args = (dz, h, a_src, a_dst, b.nbr_nodes, b.in_degree, H)
        rt, od = _reverse_table(b) if rev else (None, None)
        if name == "hub":
            assert int(b.in_degree.max()) == 70
            assert not rev or int(od.max()) == 70
        kw = dict(rev_nbr_nodes=rt, out_degree=od)
        before = gat_bwd.fused_gat_scatter_backward.launches
        one = gat_bwd.fused_gat_scatter_backward(*args, **kw)
        two = gat_bwd.fused_gat_scatter_backward(*args, **kw)
        torch.cuda.synchronize()
        assert gat_bwd.fused_gat_scatter_backward.launches == before + 2
        want = gat_bwd.gat_scatter_backward_plain(*args)
        for what, a, c, w in zip(("dh_val", "da_src", "dsum", "s", "m",
                                  "den"), one, two, want):
            assert torch.equal(a, c), (name, what)
            assert _scaled_err(a, w) <= 1e-4, (name, what)


@pytest.mark.parametrize("rev", [True, False])
def test_gat_train_step_through_kernels(cuda_device, rev):
    """One Adam step of the canonical heads-4 GAT model on the 128-graph
    standard-packed batch, with its reverse table or without one: six
    row-10 and six row-11 launches and one readout; every gradient within
    1e-4 of max |value| of the plain path in float64 taken on the kernel
    path's ReLU decisions (``bench.grad_precision.grads_on_relu_pattern``:
    one layer output within float32 rounding of 0 on this batch takes its
    ReLU the other way in the kernel forward than in the plain paths,
    which moves att_dst's small gradient ~3e-3 of its max), and the same
    bits on a second step from the same state."""
    from gnnbuilder_tpu_torch.bench.grad_precision import (
        conv_output_masks,
        grads_on_relu_pattern,
    )

    gs, b = _std_batch(device=cuda_device)
    if not rev:
        b = b.replace(rev_nbr_nodes=None, out_degree=None)
    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    model = canonical_model("gat", "qm9", graphs=gs,
                            conv_kwargs=dict(heads=4))
    Program(model, device="cuda", seed=3).init_params()
    state = {k: t.clone() for k, t in model.state_dict().items()}
    counters = (gat_layer.fused_gat_layer,
                gat_bwd.fused_gat_scatter_backward, readout.fused_readout)
    grads = []
    for _ in range(2):
        model.load_state_dict(state)
        step = train.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-3))
        before = [f.launches for f in counters]
        step(b, target)
        torch.cuda.synchronize()
        assert [f.launches - n for f, n in zip(counters, before)] == [
            6, 6, 1]
        grads.append({k: q.grad.clone() for k, q in
                      model.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
    model.load_state_dict(state)
    masks = conv_output_masks(model, b)
    ref = canonical_model("gat", "qm9", graphs=gs, conv_kwargs=dict(
        heads=4)).to(cuda_device).double()
    ref.load_state_dict({k: v.double() for k, v in state.items()})
    want = grads_on_relu_pattern(
        ref, b.replace(node_feat=b.node_feat.double()), target.double(),
        masks)
    for k, q in grads[0].items():
        assert torch.isfinite(q).all(), k
        assert _scaled_err(q.double(), want[k]) <= 1e-4, k


def test_program_forward_gat_through_kernels(cuda_device):
    """Canonical heads-4 GAT through ``Program.forward``: on the block
    batch every layer takes row 9, on the standard-packed batch row 10;
    outputs within 1e-4 of max |value| of the plain path on real
    graphs."""
    for gs, b, bs in ((*_batch(), 128), (*_std_batch(), 0)):
        model = canonical_model("gat", "qm9", graphs=gs,
                                conv_kwargs=dict(heads=4))
        prog = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                       max_graphs=b.num_graphs, block_size=bs,
                       device="cuda", seed=4)
        prog.init_params()
        bc = b.to(cuda_device)
        counters = (gat_block.fused_gat_block_layer,
                    gat_layer.fused_gat_layer)
        before = [f.launches for f in counters]
        out = prog.forward(bc)
        torch.cuda.synchronize()
        assert [f.launches - n for f, n in zip(counters, before)] == (
            [6, 0] if bs else [0, 6])
        dispatch.set_fused_mode("never")
        try:
            ref = prog.forward(bc)
        finally:
            dispatch.set_fused_mode("auto")
        m = bc.graph_mask
        assert torch.isfinite(out[m]).all()
        assert _scaled_err(out[m], ref[m]) <= 1e-4


AGG_SETS = [("sum",), ("mean",), ("max",), ("min",), ("std",),
            ("max", "min", "mean", "std"),
            ("sum", "mean", "min", "max", "std")]


@pytest.mark.parametrize("with_u", [False, True])
def test_ell_agg_kernel_matches_plain(cuda_device, with_u):
    """Row 8 for each aggregator alone, PNA's four and all five, and PNA's
    block min / max, with and without u, at F = 11, 128 and 384 and at
    the widths a row needs fewer than four lanes for (F = 1, 2 scalar, 4,
    8 float4), on the 128-graph standard batch with values rounded to
    halves (ties): within 1e-5 of max |value| per aggregator (std's
    E[t^2] - E[t]^2 formed as the plain version forms it), empty rows
    exactly; in f32 and bf16 the same bits as the slot-ordered loop
    (``ell_aggregate_ordered``), also on the hub batch (an in-degree of
    70 in a 72-wide table)."""
    _, b = _std_batch(device=cuda_device)
    hub = _hub_ell_batch(cuda_device)
    assert int(b.in_degree.max()) >= 3
    g = torch.Generator(device="cpu").manual_seed(3)
    for F in (11, 128, 384, 1, 2, 4, 8):
        v = (torch.randn(b.num_nodes, F, generator=g) * 2).round().div(2)
        v = v.to(cuda_device)
        u = (torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
             if with_u else None)
        hv = (torch.randn(hub.num_nodes, F, generator=g) * 2).round().div(2)
        hv = hv.to(cuda_device)
        hu = (torch.randn(hub.num_nodes, F, generator=g).to(cuda_device)
              if with_u else None)
        for aggs in AGG_SETS + [("min", "max")]:
            before = ell_agg.fused_ell_aggregate.launches
            got = ell_agg.fused_ell_aggregate(v, b.nbr_nodes, b.in_degree,
                                              aggs, u=u)
            torch.cuda.synchronize()
            assert ell_agg.fused_ell_aggregate.launches == before + 1
            want = ell_agg.ell_aggregate_plain(v, b.nbr_nodes, b.in_degree,
                                               aggs, u)
            m = b.node_mask
            empty = b.in_degree == 0
            assert torch.equal(got[empty], want[empty])
            for i, a in enumerate(aggs):
                sl = slice(i * F, (i + 1) * F)
                assert _scaled_err(got[m, sl], want[m, sl]) <= 1e-5, (F, a)
            for mode in ("f32", "bf16"):
                for bb, vv, uu in ((b, v, u), (hub, hv, hu)):
                    args = (vv, bb.nbr_nodes, bb.in_degree, aggs, uu)
                    got = ell_agg.fused_ell_aggregate(*args, mode=mode)
                    assert torch.equal(got, ell_agg.ell_aggregate_ordered(
                        *args, mode=mode)), (F, aggs, mode)


@pytest.mark.parametrize("rev", [True, False])
def test_ell_agg_backward_is_bitwise_stable(cuda_device, rev):
    """Row 8's u-free backward (tie counts and the coefficient gather of
    row 7, over the reverse table or the reverse CSR) for all five
    aggregators with ties: within 2e-5 of max |value| of the same
    backward on the CPU (plain versions) and of float64 autograd of the
    plain forward, and the same bits on two launches."""
    _, b = _std_batch(device=cuda_device)
    if not rev:
        b = b.replace(rev_nbr_nodes=None, out_degree=None)
    aggs = ("sum", "mean", "min", "max", "std")
    g = torch.Generator(device="cpu").manual_seed(7)
    F = 128
    v = (torch.randn(b.num_nodes, F, generator=g) * 2).round().div(2)
    ct = torch.randn(b.num_nodes, len(aggs) * F, generator=g)
    ct[~b.node_mask.cpu()] = 0.0

    def grad(dev, dt=torch.float32):
        bb = b.to(dev)
        vv = v.to(dev, dt).clone().requires_grad_()
        if dt == torch.float64:
            out = ell_agg.ell_aggregate_plain(vv, bb.nbr_nodes,
                                              bb.in_degree, aggs)
        else:
            out = ell_agg.fused_ell_aggregate_vjp(
                vv, bb.nbr_nodes, bb.in_degree, aggs,
                rev_nbr_nodes=bb.rev_nbr_nodes, out_degree=bb.out_degree)
        out.backward(ct.to(dev, dt))
        return vv.grad

    counter = (ell_bwd.fused_gather_backward if rev
               else ell_bwd.fused_gather_backward_csr)
    before = counter.launches
    one, two = grad(cuda_device), grad(cuda_device)
    torch.cuda.synchronize()
    assert counter.launches >= before + 2
    assert torch.equal(one, two)
    assert _scaled_err(one.cpu(), grad("cpu")) <= 2e-5
    assert _scaled_err(one.double().cpu(),
                       grad("cpu", torch.float64)) <= 2e-5


def _gine_operands(F, g, device, H=128, Fout=128):
    def r(*s, sc=None):
        sc = 1.0 / s[0] ** 0.5 if sc is None else sc
        return (torch.randn(*s, generator=g) * sc).to(device)

    return dict(w0=r(F, H), b0=r(H, sc=.1), w1=r(H, Fout),
                b1=r(Fout, sc=.1))


@pytest.mark.parametrize("block", [False, True])
def test_gine_layer_kernel_matches_plain(cuda_device, block):
    """Row 12 at F = 11, 128 and 384 (hidden 384: the caller's weights at
    64 rows a CTA, where the Ring's stages do not fit), pe nonzero on pad
    edges, as lin_edge's bias puts it there, with skip and relu, without
    them (tanh), and gelu, on a standard and a block batch, and at F =
    128 on the b1024 train batch (292 CTAs of 64 rows: more than the card
    has SMs), each on the caller's weights and on their Ring layout
    (``layer_operands``): within 1e-5 of max |value| on real rows."""
    b = (_batch()[1] if block else _std_batch()[1]).to(cuda_device)
    big = _std_batch(n_graphs=1024)[1].to(cuda_device)
    g = torch.Generator(device="cpu").manual_seed(12)
    for bb, F, H, act, with_skip in ((b, 11, 128, "relu", True),
                                     (b, 128, 128, "tanh", False),
                                     (b, 384, 384, "gelu", True),
                                     (big, 128, 128, "relu", True)):
        x = torch.randn(bb.num_nodes, F, generator=g).to(cuda_device)
        pe = torch.randn(bb.num_edges, F, generator=g).to(cuda_device)
        ops = _gine_operands(F, g, cuda_device, H=H, Fout=H)
        skip = (torch.randn(bb.num_nodes, H, generator=g).to(cuda_device)
                if with_skip else None)
        args = (x, pe, bb.nbr_nodes, bb.nbr_edges, bb.in_degree)
        kw = dict(ops, eps=0.1, skip=skip, act=act)
        (staged,) = [o[4] for o in gine_layer.layer_operands(
            [(ops["w0"], ops["w1"])])]
        assert (staged is None) == (F == 384), F
        want = gine_layer.gine_layer_plain(*args, **kw)
        m = bb.node_mask
        for st in (None, staged):
            before = gine_layer.fused_gine_layer.launches
            got = gine_layer.fused_gine_layer(*args, **kw, staged=st)
            torch.cuda.synchronize()
            assert gine_layer.fused_gine_layer.launches == before + 1
            assert _scaled_err(got[m], want[m]) <= 1e-5, (F, act, st is None)


def test_gine_cached_layout_follows_an_optimizer_step(cuda_device):
    """Under inference the model caches its GINE layers' Ring layout; after
    an Adam step the next forward lays the new weights out and matches the
    plain path on them (1e-4 of max on real graphs), where the forward
    before the step does not."""
    gs, b = _std_batch(device=cuda_device)
    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    torch.manual_seed(0)
    model = canonical_model("gine", "qm9", graphs=gs).to(cuda_device)
    m = b.graph_mask

    def forward(fused=True):
        dispatch.set_fused_mode("auto" if fused else "never")
        try:
            with torch.no_grad():
                return model(b)
        finally:
            dispatch.set_fused_mode("auto")

    before = forward()
    assert model._kernel_cache.get("f32 gine layers") is not None
    step = train.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-2))
    step(b, target)
    launches = gine_layer.fused_gine_layer.launches
    after = forward()
    torch.cuda.synchronize()
    assert gine_layer.fused_gine_layer.launches == launches + 6
    want = forward(fused=False)
    assert _scaled_err(after[m], want[m]) <= 1e-4
    assert _scaled_err(before[m], want[m]) > 1e-3


@pytest.mark.parametrize("rev", [True, False])
def test_gine_train_step_is_bitwise_reproducible(cuda_device, rev):
    """One Adam step of canonical GINE on the 128-graph standard batch,
    with its reverse table or without: six row-12 launches and one
    readout, every gradient the same bits on a second step from the same
    state, and within 1e-4 of max |value| of the float32 plain path."""
    gs, b = _std_batch(device=cuda_device)
    if not rev:
        b = b.replace(rev_nbr_nodes=None, out_degree=None)
    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    torch.manual_seed(0)
    model = canonical_model("gine", "qm9", graphs=gs).to(cuda_device)
    state = {k: t.clone() for k, t in model.state_dict().items()}
    grads = []
    for _ in range(2):
        model.load_state_dict(state)
        step = train.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-3))
        before = (gine_layer.fused_gine_layer.launches,
                  readout.fused_readout.launches)
        step(b, target)
        torch.cuda.synchronize()
        assert (gine_layer.fused_gine_layer.launches - before[0],
                readout.fused_readout.launches - before[1]) == (6, 1)
        grads.append({k: q.grad.clone() for k, q in
                      model.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
    model.load_state_dict(state)
    model.zero_grad()
    dispatch.set_fused_mode("never")
    try:
        train.masked_mse_loss(model(b), target, b.graph_mask).backward()
    finally:
        dispatch.set_fused_mode("auto")
    for k, q in model.named_parameters():
        assert torch.isfinite(grads[0][k]).all(), k
        assert _scaled_err(grads[0][k], q.grad) <= 1e-4, k


@pytest.mark.parametrize("aggr", ["max", "sum", "mean"])
def test_edge_block_kernel_matches_plain(cuda_device, aggr):
    """Row 13 at Fin = 11 and 128 (F = Fout = 128) and at 384 throughout,
    with skip and relu, without them (tanh), and gelu, on the 128-graph
    block batch, and (max) at 128 on a batch whose 70-in-degree hub sits
    in an ELL table 72 wide (a CTA with 70 slots of one row): within
    1e-5 of max |value| on real rows."""
    b0 = _batch()[1].to(cuda_device)
    cases = [(b0, 11, 128, "relu", True), (b0, 128, 128, "tanh", False),
             (b0, 384, 384, "gelu", True)]
    if aggr == "max":
        cases.append((_hub_ell_batch(cuda_device), 128, 128, "relu", True))
    g = torch.Generator(device="cpu").manual_seed(13)
    for b, Fin, F, act, with_skip in cases:
        x = torch.randn(b.num_nodes, Fin, generator=g).to(cuda_device)
        sc = 1.0 / (2 * Fin) ** 0.5
        ops = dict(w_pair=(torch.randn(2 * Fin, F, generator=g) * sc),
                   b0=torch.randn(F, generator=g) * .1,
                   w1=torch.randn(F, F, generator=g) / F ** 0.5,
                   b1=torch.randn(F, generator=g) * .1)
        ops = {k: t.to(cuda_device) for k, t in ops.items()}
        skip = (torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
                if with_skip else None)
        kw = dict(ops, aggregation=aggr, skip=skip, act=act)
        before = edge_block.fused_edge_block_layer.launches
        got = edge_block.fused_edge_block_layer(x, b.nbr_nodes, b.in_degree,
                                                **kw)
        torch.cuda.synchronize()
        assert edge_block.fused_edge_block_layer.launches == before + 1
        want = edge_block.edge_block_layer_plain(x, b.nbr_nodes,
                                                 b.in_degree, **kw)
        m = b.node_mask
        assert _scaled_err(got[m], want[m]) <= 1e-5, (Fin, act)


@pytest.mark.parametrize("conv,kw,block", [
    ("gine", {}, True), ("gine", {}, False), ("edge", {}, True),
    ("simple", {"aggregation": "max"}, False),
    ("simple", {"aggregation": "min"}, False),
    ("pna", {"aggregators": ("sum", "mean", "min", "max", "std")}, True),
    ("pna", {"aggregators": ("sum", "mean", "min", "max", "std")}, False)])
def test_program_forward_edge_and_agg_paths(cuda_device, conv, kw, block):
    """``Program.forward`` of canonical GINE (block and standard), EdgeConv
    (block), Simple max and min (standard, 128 wide) and five-aggregator
    PNA (block and standard): each layer through its kernel (rows 12, 13
    or 8), within 1e-4 of max |value| of the per-layer plain path on
    graph_mask rows."""
    same = conv == "simple"
    nd = 128 if same else None
    if block:
        gs, (b,) = canonical_batches("qm9", n_graphs=128, batch_size=128,
                                     block_size=128, node_multiple=128,
                                     node_dim=nd, device=cuda_device)
    else:
        gs, (b,) = canonical_batches("qm9", n_graphs=128, batch_size=128,
                                     node_multiple=256, node_dim=nd,
                                     device=cuda_device)
    model = canonical_model(conv, "qm9", graphs=gs, conv_kwargs=dict(kw))
    prog = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                   max_graphs=b.num_graphs, block_size=128 if block else 0,
                   device=cuda_device, seed=5)
    prog.init_params()
    fn = {"gine": gine_layer.fused_gine_layer,
          "edge": edge_block.fused_edge_block_layer}.get(
              conv, ell_agg.fused_ell_aggregate)
    before = fn.launches
    out = prog.forward(b)
    torch.cuda.synchronize()
    assert fn.launches == before + 6
    dispatch.set_fused_mode("never")
    try:
        ref = prog.forward(b)
    finally:
        dispatch.set_fused_mode("auto")
    m = b.graph_mask
    assert torch.isfinite(out[m]).all()
    assert _scaled_err(out[m], ref[m]) <= 1e-4


# ------------------------------------------------ bf16 and int8 modes
# Each mode against its plain version in the same mode, layer by layer on
# the same input: bf16 within 2e-3 and int8 within 5e-3 of max |value|
# (the sums run in another order, which can move a bf16 rounding or an
# int8 level at its boundary); chained through a whole model, int8 within
# 5e-2 (each moved level moves the next layer's output).
MODE_TOL = {"bf16": 2e-3, "int8": 5e-3}
CHAIN_TOL = {"bf16": 5e-3, "int8": 5e-2}


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_pna_block_modes_match_plain_per_layer(cuda_device, mode):
    gs, b = _batch(256)
    b = b.to(cuda_device)
    model = canonical_model("pna", "qm9", graphs=gs).to(cuda_device)
    stacked, _ = model._kernel_params(128)
    L = model.gnn_num_layers
    kw = dict(act="relu")
    h = torch.nn.functional.pad(b.node_feat, (0, 128 - b.feature_dim))
    before = pna_block.fused_pna_block_stack.mode_launches[mode]
    for l, c in enumerate(model.gnn_convs):
        st, sc = pna_block.prepare_stack([t[l:l + 1] for t in stacked], mode)
        args = (h.contiguous(), b.nbr_nodes, b.in_degree, *st)
        lkw = dict(kw, deltas=[c.delta], skips=[0 < l < L - 1], mode=mode,
                   scales=sc)
        got = pna_block.fused_pna_block_stack(*args, **lkw)
        torch.cuda.synchronize()
        want = pna_block.pna_block_stack_plain(*args, **lkw)
        assert torch.isfinite(got).all()
        assert _scaled_err(got, want) <= MODE_TOL[mode], l
        h = want
    assert pna_block.fused_pna_block_stack.mode_launches[mode] == before + L


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_readout_modes_match_plain(cuda_device, mode):
    gs, b = _batch(256)
    b = b.to(cuda_device)
    model = canonical_model("pna", "qm9", graphs=gs).to(cuda_device)
    head, scales = readout.prepare_head(model._kernel_params(128)[1], mode)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    h = torch.randn((b.num_nodes, 64), generator=g, device=cuda_device)
    mx = segment.contiguous_segment_max(h, b.graph_starts, b.n_node,
                                        b.max_graph_nodes_static)
    aggrs = ("add", "mean", "max")
    got = readout.fused_readout(h, b.n_node, head, aggrs=aggrs, mx=mx,
                                starts=b.graph_starts, mode=mode,
                                scales=scales)
    torch.cuda.synchronize()
    want = readout.readout_plain(h, b.n_node, b.graph_starts, head, aggrs,
                                 mx, "relu", None, mode, scales)
    m = b.graph_mask
    assert _scaled_err(got[m], want[m]) <= MODE_TOL[mode]


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_pna_layer_modes_match_plain_per_layer(cuda_device, mode):
    """The canonical model's 6 layers (11 -> 128 ... 128 -> 64, zero-padded
    to 128) on a standard-packed batch."""
    gs, b = _std_batch(256, device=cuda_device)
    model = canonical_model("pna", "qm9", graphs=gs).to(cuda_device)
    L = model.gnn_num_layers
    h = b.node_feat
    before = pna_layer.fused_pna_layer.mode_launches[mode]
    for i, c in enumerate(model.gnn_convs):
        skip = h if 0 < i < L - 1 else None
        ops = pna_layer.pad_operands(
            h, c.pre_nn.weight.t(), c.pre_nn.bias, c.post_nn.weight.t(),
            c.post_nn.bias, c.lin.weight.t(), c.lin.bias, skip)
        ops = [None if t is None else t.detach().contiguous() for t in ops]
        w_pre, k_post, w_lin, s_lin = pna_layer.prepare_layer(
            ops[1], ops[3], ops[5], mode)
        args = (ops[0], b.nbr_nodes, b.in_degree, w_pre, ops[2], k_post,
                ops[4], w_lin, ops[6], c.delta)
        lkw = dict(skip=ops[7], act="relu", mode=mode, s_lin=s_lin)
        got = pna_layer.fused_pna_layer(*args, **lkw)
        torch.cuda.synchronize()
        want = pna_layer.pna_layer_plain(*args, **lkw)
        assert torch.isfinite(got).all()
        assert _scaled_err(got, want) <= MODE_TOL[mode], i
        h = want[:, :c.out_channels]
    assert pna_layer.fused_pna_layer.mode_launches[mode] == before + L


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("block", [True, False])
def test_program_forward_policies_through_kernels(cuda_device, precision,
                                                  block):
    """``Program(precision=...)`` of canonical PNA on the card: the stack
    (block-packed) or the layer kernel (standard-packed, every layer) and
    the readout launch in the policy's mode, and the output agrees with
    the same Program on the CPU (the modes' plain versions)."""
    gs, b = _batch(256) if block else _std_batch(256)
    size = dict(max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, block_size=128 if block else 0)
    progs = [Program(canonical_model("pna", "qm9", graphs=gs),
                     precision=precision, device=d, seed=7, **size)
             for d in (cuda_device, "cpu")]
    progs[0].init_params()
    progs[1].set_params({k: v.cpu() for k, v in progs[0].params.items()})
    stack = pna_block.fused_pna_block_stack.mode_launches
    layer = pna_layer.fused_pna_layer.mode_launches
    head = readout.fused_readout.mode_launches
    before = (stack[precision], layer[precision], head[precision])
    out = progs[0].forward(b.to(cuda_device))
    torch.cuda.synchronize()
    n_stack, n_layer = (1, 0) if block else (0, 6)
    assert (stack[precision], layer[precision], head[precision]) == (
        before[0] + n_stack, before[1] + n_layer, before[2] + 1)
    ref = progs[1].forward(b)
    m = b.graph_mask
    assert out.dtype == torch.float32
    assert _scaled_err(out.cpu()[m], ref[m]) <= CHAIN_TOL[precision]


def test_calibrated_int8_forward_on_the_card(cuda_device):
    """calibrate_int8 on two batches, then a forward with static scales:
    the rows 1, 2 and 5 gates decline (the plain path owns the per-site
    state), and the output matches the CPU's static forward."""
    gs, (b1, b2) = canonical_batches("qm9", n_graphs=256, batch_size=128,
                                     block_size=128, node_multiple=128,
                                     device="cpu")
    size = dict(max_nodes=b1.num_nodes, max_edges=b1.num_edges,
                max_graphs=b1.num_graphs, block_size=128)
    progs = [Program(canonical_model("pna", "qm9", graphs=gs),
                     precision="int8", device=d, seed=9, **size)
             for d in (cuda_device, "cpu")]
    progs[0].init_params()
    progs[1].set_params({k: v.cpu() for k, v in progs[0].params.items()})
    sc = progs[0].calibrate_int8([b1.to(cuda_device), b2.to(cuda_device)])
    sc_cpu = progs[1].calibrate_int8([b1, b2])
    assert set(sc) == set(sc_cpu)
    for k in sc:
        assert abs(sc[k] - sc_cpu[k]) <= 1e-5 * sc_cpu[k]
    before = [f.mode_launches["int8"] for f in (
        pna_block.fused_pna_block_stack, readout.fused_readout,
        pna_layer.fused_pna_layer)]
    out = progs[0].forward(b1.to(cuda_device))
    torch.cuda.synchronize()
    assert [f.mode_launches["int8"] for f in (
        pna_block.fused_pna_block_stack, readout.fused_readout,
        pna_layer.fused_pna_layer)] == before
    ref = progs[1].forward(b1)
    m = b1.graph_mask
    assert _scaled_err(out.cpu()[m], ref[m]) <= CHAIN_TOL["int8"]


# ------------------------------------------ modes of rows 3, 4, 8, 12, 13

MP_MODE_CASES = ([(c, "bf16") for c in MP_LAYER_CONVS]
                 + [(c, "int8") for c in mp_layer.QUANT_CONVS])


@pytest.mark.parametrize("conv,mode", MP_MODE_CASES)
@pytest.mark.parametrize("packing", ["ell", "block"])
def test_mp_layer_modes_match_plain(cuda_device, conv, mode, packing):
    """Row 4 in each mode at input widths 11 and 128 (gin and sage 128
    out): 2e-3 / 5e-3 of max on real rows, one launch of the mode."""
    b = (_std_batch(device=cuda_device)[1] if packing == "ell"
         else _batch()[1].to(cuda_device))
    g = torch.Generator(device="cpu").manual_seed(9)
    for F, act, with_skip in ((11, "relu", True), (128, "tanh", False)):
        ops = _mp_operands(conv, F, g, cuda_device)
        w0, w1, s0, s1 = mp_layer.prepare_layer(ops.get("w0"), ops.get("w1"),
                                                mode)
        if "w0" in ops:
            ops.update(w0=w0, w1=w1)
        x = torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
        Fout = 128 if conv in ("gin", "sage") else F
        skip = (torch.randn(b.num_nodes, Fout, generator=g).to(cuda_device)
                if with_skip else None)
        kw = dict(ops, skip=skip, act=act, mode=mode, s0=s0, s1=s1,
                  block_adj=b.block_adj if packing == "block" else None)
        before = mp_layer.fused_mp_layer.mode_launches[mode]
        out = mp_layer.fused_mp_layer(x, b.nbr_nodes, b.in_degree, conv, **kw)
        torch.cuda.synchronize()
        assert mp_layer.fused_mp_layer.mode_launches[mode] == before + 1
        want = mp_layer.mp_layer_plain(x, b.nbr_nodes, b.in_degree, conv,
                                       **kw)
        m = b.node_mask
        assert torch.isfinite(out[m]).all()
        assert _scaled_err(out[m], want[m]) <= MODE_TOL[mode], (F, act)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("conv", ["gcn", "gin", "sage"])
def test_mp_block_modes_match_plain_per_layer(cuda_device, conv, mode):
    """Row 3 in each mode, the canonical model's 6 layers one at a time
    on the plain version's input to each."""
    gs, b = _batch(256)
    b = b.to(cuda_device)
    model = canonical_model(conv, "qm9", graphs=gs).to(cuda_device)
    stacked, _ = model._kernel_params(128)
    L = model.gnn_num_layers
    h = torch.nn.functional.pad(b.node_feat, (0, 128 - b.feature_dim))
    before = mp_block.fused_mp_block_stack.mode_launches[mode]
    for l, c in enumerate(model.gnn_convs):
        st, sc = mp_block.prepare_mp_stack([t[l:l + 1] for t in stacked],
                                           mode)
        args = (h.contiguous(), b.block_adj, b.in_degree, *st)
        lkw = dict(conv=conv, epss=[getattr(c, "eps", 0.0)],
                   skips=[0 < l < L - 1], act="relu", mode=mode, scales=sc)
        got = mp_block.fused_mp_block_stack(*args, **lkw)
        torch.cuda.synchronize()
        want = mp_block.mp_stack_plain(*args[:7], conv, lkw["epss"],
                                       lkw["skips"], "relu", mode, sc)
        assert torch.isfinite(got).all()
        assert _scaled_err(got, want) <= MODE_TOL[mode], l
        h = want
    assert mp_block.fused_mp_block_stack.mode_launches[mode] == before + L


@pytest.mark.parametrize("with_u", [False, True])
def test_ell_agg_bf16_matches_plain(cuda_device, with_u):
    _, b = _std_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(4)
    v = torch.randn(b.num_nodes, 128, generator=g).to(cuda_device)
    u = (torch.randn(b.num_nodes, 128, generator=g).to(cuda_device)
         if with_u else None)
    aggs = ("sum", "mean", "min", "max", "std")
    got = ell_agg.fused_ell_aggregate(v, b.nbr_nodes, b.in_degree, aggs, u=u,
                                      mode="bf16")
    torch.cuda.synchronize()
    want = ell_agg.ell_aggregate_plain(v, b.nbr_nodes, b.in_degree, aggs, u,
                                       mode="bf16")
    m = b.node_mask
    assert _scaled_err(got[m], want[m]) <= MODE_TOL["bf16"]


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_gine_layer_modes_match_plain(cuda_device, mode):
    _, b = _std_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(5)
    for F in (11, 128):
        def r(*s, sc=1.0):
            return (torch.randn(*s, generator=g) * sc).to(cuda_device)

        x, pe = r(b.num_nodes, F), r(b.num_edges, F)
        w0, w1, s0, s1 = mp_layer.prepare_layer(r(F, 128, sc=F ** -0.5),
                                                r(128, 128, sc=128 ** -0.5),
                                                mode)
        args = (x, pe, b.nbr_nodes, b.nbr_edges, b.in_degree, w0,
                r(128, sc=.1), w1, r(128, sc=.1))
        kw = dict(eps=0.1, skip=r(b.num_nodes, 128), act="relu", mode=mode,
                  s0=s0, s1=s1)
        got = gine_layer.fused_gine_layer(*args, **kw)
        torch.cuda.synchronize()
        want = gine_layer.gine_layer_plain(*args, **kw)
        m = b.node_mask
        assert _scaled_err(got[m], want[m]) <= MODE_TOL[mode], F


@pytest.mark.parametrize("aggr", ["max", "sum", "mean"])
def test_edge_block_bf16_matches_plain(cuda_device, aggr):
    _, b = _batch()
    b = b.to(cuda_device)
    g = torch.Generator(device="cpu").manual_seed(6)
    for Fin in (11, 128):
        def r(*s, sc=1.0):
            return (torch.randn(*s, generator=g) * sc).to(cuda_device)

        args = (r(b.num_nodes, Fin), b.nbr_nodes, b.in_degree,
                r(2 * Fin, 128, sc=Fin ** -0.5).to(torch.bfloat16),
                r(128, sc=.1), r(128, 128, sc=128 ** -0.5).to(torch.bfloat16),
                r(128, sc=.1))
        kw = dict(aggregation=aggr, act="relu", mode="bf16")
        got = edge_block.fused_edge_block_layer(*args, **kw)
        torch.cuda.synchronize()
        want = edge_block.edge_block_layer_plain(*args, **kw)
        m = b.node_mask
        assert _scaled_err(got[m], want[m]) <= MODE_TOL["bf16"], Fin


# the slice's forwards on the card against the CPU: the two sides' matrix
# products round in other orders, and an ulp before a mode's rounding
# moves a bf16 value by 2^-8 or an int8 level, compounding over six
# layers (chip_smoke.py SLICE_CPU_TOL)
SLICE_CPU_TOL = {"bf16": 1e-2, "int8": 5e-2}
_ALL5 = {"aggregators": ("sum", "mean", "min", "max", "std")}
# (conv, conv_kwargs, block): the packings the gates send to the slice's
# kernels
SLICE_PROGRAMS = [("gcn", None, True), ("gcn", None, False),
                  ("gin", None, False), ("sage", None, True),
                  ("sage", None, False), ("lg", None, True),
                  ("lg", None, False), ("simple", None, True),
                  ("simple", None, False), ("gine", None, True),
                  ("gine", None, False), ("edge", None, True),
                  ("simple", {"aggregation": "max"}, False),
                  ("pna", _ALL5, True), ("pna", _ALL5, False)]


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("conv,kw,block", SLICE_PROGRAMS)
def test_program_forward_slice_policies_through_kernels(
        cuda_device, conv, kw, block, precision):
    """``Program(precision=...)`` of the slice's convs on the card: a
    kernel of the slice launches wherever the gates give one (none for
    EdgeConv under int8, whose gate declines), and the output agrees with
    the same Program on the CPU."""
    nd = 128 if conv in ("lg", "simple") else None
    gs, (b,) = canonical_batches(
        "qm9", n_graphs=256, batch_size=256, node_dim=nd,
        block_size=128 if block else 0,
        node_multiple=128 if block else 256, device="cpu")
    size = dict(max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, block_size=128 if block else 0)
    progs = [Program(canonical_model(conv, "qm9", graphs=gs,
                                     conv_kwargs=dict(kw or {})),
                     precision=precision, device=d, seed=7, **size)
             for d in (cuda_device, "cpu")]
    progs[0].init_params()
    progs[1].set_params({k: v.cpu() for k, v in progs[0].params.items()})
    fns = (mp_block.fused_mp_block_stack, mp_layer.fused_mp_layer,
           ell_agg.fused_ell_aggregate, gine_layer.fused_gine_layer,
           edge_block.fused_edge_block_layer)
    before = [dict(f.mode_launches) for f in fns]
    out = progs[0].forward(b.to(cuda_device))
    torch.cuda.synchronize()
    moved = {f.__name__: {k: v - before[i][k] for k, v in
                          f.mode_launches.items() if v != before[i][k]}
             for i, f in enumerate(fns)}
    moved = {k: v for k, v in moved.items() if v}
    if conv == "edge" and precision == "int8":
        assert not moved, moved
    else:
        assert moved, "no kernel of the slice ran"
    ref = progs[1].forward(b)
    m = b.graph_mask
    assert torch.isfinite(out[m]).all()
    assert _scaled_err(out.cpu()[m], ref[m]) <= SLICE_CPU_TOL[precision], \
        moved


# ------------------------------------ modes of rows 9 and 10, and serving

# a served prediction against Program.forward of the same graphs: a
# graph's rows go through the same operations in any batch, but for the
# float32 rounding of sums whose padding differs
SERVE_TOL = 1e-5

@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("Fin,skip", [(11, False), (512, True)])
def test_gat_layer_modes_match_plain(cuda_device, mode, Fin, skip):
    """Row 10 in bf16 and int8 at the canonical heads-4 widths on the
    standard-packed batch: 2e-3 / 5e-3 of max on real rows, one launch of
    the mode."""
    _, b = _std_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(31)
    ops = _gat_operands(Fin, 4, 128, g, cuda_device)
    x = torch.randn(b.num_nodes, Fin, generator=g).to(cuda_device)
    w, sw = gat_layer.prepare_layer(ops["w"], mode)
    args = (x, b.nbr_nodes, b.in_degree, w, ops["att_src"], ops["att_dst"],
            ops["bias"], 4)
    kw = dict(act="relu", mode=mode, sw=sw,
              skip=(torch.randn(b.num_nodes, 512, generator=g)
                    .to(cuda_device) if skip else None))
    before = gat_layer.fused_gat_layer.mode_launches[mode]
    out = gat_layer.fused_gat_layer(*args, **kw)
    torch.cuda.synchronize()
    assert gat_layer.fused_gat_layer.mode_launches[mode] == before + 1
    want = gat_layer.gat_layer_plain(*args, **kw)
    m = b.node_mask
    assert torch.isfinite(out[m]).all()
    assert _scaled_err(out[m], want[m]) <= MODE_TOL[mode]


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("Fin,skip", [(11, False), (512, True)])
def test_gat_block_bf16_matches_plain(cuda_device, concat, Fin, skip):
    """Row 9 in bf16, heads 4, on the block-packed batch and on one with a
    70-in-degree hub: 2e-3 of max on real rows."""
    H, C = 4, 128 if concat else 64
    g = torch.Generator(device="cpu").manual_seed(32)
    for b in (_batch()[1].to(cuda_device), _hub_block_batch(cuda_device)[1]):
        ops = _gat_operands(Fin, H, C, g, cuda_device, concat)
        w, wa_src, wa_dst = gat_block.prepare_block(
            ops["w"], ops["att_src"], ops["att_dst"], "bf16")
        out_w = H * C if concat else C
        x = torch.randn(b.num_nodes, Fin, generator=g).to(cuda_device)
        args = (x, b.block_adj, w, ops["att_src"], ops["att_dst"],
                ops["bias"], H)
        kw = dict(act="relu", concat=concat, mode="bf16", wa_src=wa_src,
                  wa_dst=wa_dst,
                  skip=(torch.randn(b.num_nodes, out_w, generator=g)
                        .to(cuda_device) if skip else None))
        before = gat_block.fused_gat_block_layer.mode_launches["bf16"]
        out = gat_block.fused_gat_block_layer(*args, **kw)
        torch.cuda.synchronize()
        assert gat_block.fused_gat_block_layer.mode_launches["bf16"] == \
            before + 1
        want = gat_block.gat_block_layer_plain(*args, **kw)
        m = b.node_mask
        assert torch.isfinite(out[m]).all()
        assert _scaled_err(out[m], want[m]) <= MODE_TOL["bf16"]


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("block", [True, False])
def test_program_forward_gat_policies_through_kernels(cuda_device,
                                                      precision, block):
    """Canonical heads-4 GAT under bf16 and int8 on the card: every layer
    launches row 9 in bf16 (block-packed under bf16) or row 10 in the
    policy's mode (standard-packed, and block-packed under int8), and
    the output agrees with the same Program on the CPU."""
    gs, b = _batch(256) if block else _std_batch(256)
    size = dict(max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, block_size=128 if block else 0)
    progs = [Program(canonical_model("gat", "qm9", graphs=gs,
                                     conv_kwargs=dict(heads=4)),
                     precision=precision, device=d, seed=7, **size)
             for d in (cuda_device, "cpu")]
    progs[0].init_params()
    progs[1].set_params({k: v.cpu() for k, v in progs[0].params.items()})
    fns = (gat_block.fused_gat_block_layer, gat_layer.fused_gat_layer)
    before = [dict(f.mode_launches) for f in fns]
    out = progs[0].forward(b.to(cuda_device))
    torch.cuda.synchronize()
    moved = [{k: v - before[i][k] for k, v in f.mode_launches.items()
              if v != before[i][k]} for i, f in enumerate(fns)]
    want = ([{"bf16": 6}, {}] if block and precision == "bf16"
            else [{}, {precision: 6}])
    assert moved == want
    ref = progs[1].forward(b)
    m = b.graph_mask
    assert torch.isfinite(out[m]).all()
    assert _scaled_err(out.cpu()[m], ref[m]) <= SLICE_CPU_TOL[precision]


def test_served_int8_gat_through_row_10(cuda_device, tmp_path):
    """A block-packed canonical GAT under int8 behind ``GNNServer``: the
    server's forwards launch row 10 in int8 in every layer, each
    prediction agrees with ``Program.forward`` of the same graphs, and a
    server from ``export_bundle`` gives the same predictions."""
    from gnnbuilder_tpu_torch.data.datasets import load_dataset
    from gnnbuilder_tpu_torch.serve import GNNServer

    graphs = load_dataset("qm9", n=160)
    prog = Program.from_dataset(
        canonical_model("gat", "qm9", graphs=graphs,
                        conv_kwargs=dict(heads=4)),
        graphs, batch_size=32, block_size=128, precision="int8",
        device=cuda_device, seed=5)
    # the bucket's example: the largest graphs, so that the widths the
    # bundle pins cover every request
    example = prog.batch(sorted(graphs, key=lambda g: g.num_nodes)[-32:])
    prog.init_params()
    want = np.concatenate([prog.forward(prog.batch(graphs[i:i + 32]))
                           .cpu().numpy()[:32] for i in range(0, 160, 32)])
    counter = gat_layer.fused_gat_layer.mode_launches
    with GNNServer.from_program(prog, example, max_batch=32) as srv:
        before = counter["int8"]
        got = srv.predict(graphs, timeout=300)
        st = srv.stats()
        launched = counter["int8"] - before
    assert launched == 6 * st["batches"] and st["served"] == 160
    assert _scaled_err(torch.from_numpy(got), torch.from_numpy(want)) <= \
        SERVE_TOL
    prog.export_bundle(str(tmp_path / "b"), example)
    with GNNServer.from_bundle(str(tmp_path / "b"), max_batch=32,
                               device=cuda_device) as srv:
        again = srv.predict(graphs, timeout=300)
    assert _scaled_err(torch.from_numpy(again), torch.from_numpy(got)) <= \
        SERVE_TOL


# --------------------------------------- GAT with edge features (edge_dim)
EDGE_GAT = dict(conv_kwargs=dict(heads=4, edge_dim=4))


def _simple_block_batch(n_graphs=128, device="cpu"):
    """QM9 graphs with each repeated (sender, receiver) pair kept once,
    block-packed: the batches the block kernel's edge mode takes."""
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.data.datasets import (
        drop_repeated_edges,
        load_dataset,
    )

    gs = drop_repeated_edges(load_dataset("qm9", n=n_graphs))
    b = build_graph_batch(gs, block_size=128, node_multiple=128,
                          device=device)
    assert not b.multigraph_static
    return gs, b


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("concat", [True, False])
def test_gat_block_edge_mode_matches_plain(cuda_device, mode, concat):
    """Row 9's edge-logit mode, heads 4, on a block-packed batch of simple
    QM9 graphs: 1e-4 of max on real rows in f32, 2e-3 in bf16; one launch
    counted in the mode's edge launches."""
    H, C = 4, 128 if concat else 64
    _, b = _simple_block_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(41)
    ops = _gat_operands(11, H, C, g, cuda_device, concat)
    w, wa_src, wa_dst = gat_block.prepare_block(
        ops["w"], ops["att_src"], ops["att_dst"], mode)
    a_edge = torch.randn(b.num_edges, H, generator=g).to(cuda_device)
    table = gat_block.build_block_edge_logits(
        b.senders, b.receivers, b.edge_mask, a_edge, b.num_nodes, 128)
    x = torch.randn(b.num_nodes, 11, generator=g).to(cuda_device)
    args = (x, b.block_adj, w, ops["att_src"], ops["att_dst"], ops["bias"],
            H)
    kw = dict(act="relu", concat=concat, mode=mode, wa_src=wa_src,
              wa_dst=wa_dst, edge_table=table,
              self_extra=torch.randn(b.num_nodes, H, generator=g).to(
                  cuda_device))
    before = gat_block.fused_gat_block_layer.edge_launches[mode]
    out = gat_block.fused_gat_block_layer(*args, **kw)
    torch.cuda.synchronize()
    assert gat_block.fused_gat_block_layer.edge_launches[mode] == before + 1
    want = gat_block.gat_block_layer_plain(*args, **kw)
    m = b.node_mask
    assert torch.isfinite(out[m]).all()
    assert _scaled_err(out[m], want[m]) <= (1e-4 if mode == "f32"
                                            else MODE_TOL[mode])


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_gat_layer_edge_mode_matches_plain(cuda_device, mode):
    """Row 10's edge-logit mode at the canonical heads-4 widths on the
    standard-packed batch, in each mode (int8 is on no path: the gate
    declines an edge conv under int8): 1e-4 / 2e-3 / 5e-3 of max."""
    _, b = _std_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(42)
    ops = _gat_operands(512, 4, 128, g, cuda_device)
    w, sw = gat_layer.prepare_layer(ops["w"], mode)
    x = torch.randn(b.num_nodes, 512, generator=g).to(cuda_device)
    le = torch.randn(b.num_nodes, b.nbr_nodes.shape[1], 4,
                     generator=g).to(cuda_device)
    args = (x, b.nbr_nodes, b.in_degree, w, ops["att_src"], ops["att_dst"],
            ops["bias"], 4)
    kw = dict(act="relu", mode=mode, sw=sw, edge_logits=le,
              self_edge_logit=torch.randn(b.num_nodes, 4, generator=g).to(
                  cuda_device),
              skip=torch.randn(b.num_nodes, 512, generator=g).to(
                  cuda_device))
    before = gat_layer.fused_gat_layer.edge_launches[mode]
    out = gat_layer.fused_gat_layer(*args, **kw)
    torch.cuda.synchronize()
    assert gat_layer.fused_gat_layer.edge_launches[mode] == before + 1
    want = gat_layer.gat_layer_plain(*args, **kw)
    m = b.node_mask
    assert torch.isfinite(out[m]).all()
    assert _scaled_err(out[m], want[m]) <= (1e-4 if mode == "f32"
                                            else MODE_TOL[mode])


def test_edge_gat_train_step_is_bitwise_reproducible(cuda_device):
    """One Adam step of canonical edge GAT (heads 4, edge_dim 4) on the
    128-graph standard-packed batch: six launches of row 10's edge mode
    (its backward is torch autograd of the plain layer, no row 11), the
    same bits on a second step from the same state, and every gradient,
    ``lin_edge`` and ``att_edge`` included, within 1e-4 of max of the
    float64 plain path on the kernel path's ReLU decisions."""
    from gnnbuilder_tpu_torch.bench.grad_precision import (
        conv_output_masks,
        grads_on_relu_pattern,
    )

    gs, b = _std_batch(device=cuda_device)
    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    model = canonical_model("gat", "qm9", graphs=gs, **EDGE_GAT)
    Program(model, device="cuda", seed=5).init_params()
    state = {k: t.clone() for k, t in model.state_dict().items()}
    grads = []
    for _ in range(2):
        model.load_state_dict(state)
        step = train.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-3))
        before = (dict(gat_layer.fused_gat_layer.edge_launches),
                  gat_bwd.fused_gat_scatter_backward.launches)
        step(b, target)
        torch.cuda.synchronize()
        assert gat_layer.fused_gat_layer.edge_launches["f32"] == \
            before[0]["f32"] + 6
        assert gat_bwd.fused_gat_scatter_backward.launches == before[1]
        grads.append({k: q.grad.clone() for k, q in
                      model.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
    model.load_state_dict(state)
    masks = conv_output_masks(model, b)
    ref = canonical_model("gat", "qm9", graphs=gs, **EDGE_GAT).to(
        cuda_device).double()
    ref.load_state_dict({k: v.double() for k, v in state.items()})
    want = grads_on_relu_pattern(
        ref, b.replace(node_feat=b.node_feat.double(),
                       edge_feat=b.edge_feat.double()), target.double(),
        masks)
    assert grads[0]["gnn_convs.0.att_edge"].abs().max() > 0
    for k, q in grads[0].items():
        assert torch.isfinite(q).all(), k
        assert _scaled_err(q.double(), want[k]) <= 1e-4, k


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_program_forward_edge_gat_through_kernels(cuda_device, precision):
    """Canonical edge GAT through ``Program.forward`` on three batches:
    simple block-packed graphs take row 9's edge mode in every layer (f32,
    bf16), block-packed graphs with repeated pairs and standard-packed
    ones row 10's (int8: neither, the plain path); outputs within 1e-4 of
    max of the plain path in f32, and of the CPU in the same policy
    within 1e-2 / 5e-2 under bf16 / int8."""
    sgs, simple = _simple_block_batch(device="cpu")
    mgs, multi = _batch()
    assert multi.multigraph_static
    tgs, std = _std_batch()
    for gs, b, key in ((sgs, simple, "gat_block"), (mgs, multi, "gat_layer"),
                       (tgs, std, "gat_layer")):
        size = dict(max_nodes=b.num_nodes, max_edges=b.num_edges,
                    max_graphs=b.num_graphs,
                    block_size=128 if b.block_adj is not None else 0)
        progs = [Program(canonical_model("gat", "qm9", graphs=gs,
                                         **EDGE_GAT),
                         precision=precision, device=d, seed=7, **size)
                 for d in (cuda_device, "cpu")]
        progs[0].init_params()
        progs[1].set_params({k: v.cpu() for k, v in progs[0].params.items()})
        fns = {"gat_block": gat_block.fused_gat_block_layer,
               "gat_layer": gat_layer.fused_gat_layer}
        before = {k: dict(f.edge_launches) for k, f in fns.items()}
        bc = b.to(cuda_device)
        out = progs[0].forward(bc)
        torch.cuda.synchronize()
        moved = {k: {md: n - before[k][md] for md, n in
                     f.edge_launches.items() if n != before[k][md]}
                 for k, f in fns.items()}
        want = {"gat_block": {}, "gat_layer": {}}
        if precision != "int8":
            want[key] = {precision: 6}
        assert moved == want, (key, moved)
        m = bc.graph_mask
        assert torch.isfinite(out[m]).all()
        if precision == "f32":
            dispatch.set_fused_mode("never")
            try:
                ref = progs[0].forward(bc)
            finally:
                dispatch.set_fused_mode("auto")
            assert _scaled_err(out[m], ref[m]) <= 1e-4
        else:
            ref = progs[1].forward(b)
            assert _scaled_err(out.cpu()[b.graph_mask],
                               ref[b.graph_mask]) <= SLICE_CPU_TOL[precision]


# ------------------------------- the tensor-core GAT kernels (rows 9, 10)
# (Fin, H, C): the first layer's 11 and odd widths, chunk widths 64 and
# 128, and a head of two chunks (200)
GAT_TC_SHAPES = [(11, 4, 128), (24, 3, 20), (40, 8, 64), (512, 1, 128),
                 (512, 4, 64), (40, 3, 200)]
GAT_TOL = {"f32": 1e-4, **MODE_TOL}


def _gat_tc_args(b, Fin, H, C, mode, edge, block, concat, seed):
    """(args, kw) of row 9 (``block``) or 10 in ``mode`` on batch ``b``,
    with random edge terms when ``edge``."""
    dev = b.node_feat.device
    g = torch.Generator(device="cpu").manual_seed(seed)
    ops = _gat_operands(Fin, H, C, g, dev, concat)
    x = torch.randn(b.num_nodes, Fin, generator=g).to(dev)
    out_w = H * C if concat else C
    kw = dict(act="relu", mode=mode, skip=torch.randn(
        b.num_nodes, out_w, generator=g).to(dev))
    if block:
        w, wa_src, wa_dst = gat_block.prepare_block(
            ops["w"], ops["att_src"], ops["att_dst"], mode)
        kw.update(concat=concat, wa_src=wa_src, wa_dst=wa_dst)
        table = (b.block_adj,)
        if edge:
            a_edge = torch.randn(b.num_edges, H, generator=g).to(dev)
            kw.update(edge_table=gat_block.build_block_edge_logits(
                b.senders, b.receivers, b.edge_mask, a_edge, b.num_nodes,
                128), self_extra=torch.randn(b.num_nodes, H,
                                             generator=g).to(dev))
    else:
        w, kw["sw"] = gat_layer.prepare_layer(ops["w"], mode)
        table = (b.nbr_nodes, b.in_degree)
        if edge:
            kw.update(edge_logits=torch.randn(
                b.num_nodes, b.nbr_nodes.shape[1], H, generator=g).to(dev),
                self_edge_logit=torch.randn(b.num_nodes, H,
                                            generator=g).to(dev))
    args = (x, *table, w, ops["att_src"], ops["att_dst"], ops["bias"], H)
    return args, kw


def _hold_gat(fn, plain, b, args, kw, mode):
    """Two launches the same bits, both within the mode's tolerance of the
    plain version on real rows; returns the output."""
    before = fn.launches
    one = fn(*args, **kw)
    two = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(one, two)
    want = plain(*args, **{k: v for k, v in kw.items() if k != "staged"})
    m = b.node_mask
    assert torch.isfinite(one[m]).all()
    assert _scaled_err(one[m], want[m]) <= GAT_TOL[mode]
    return one


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("Fin,H,C", GAT_TC_SHAPES)
def test_gat_layer_tc_matches_plain_every_shape(cuda_device, Fin, H, C,
                                                mode, edge):
    """Row 10 in each mode, with and without edge terms, at the widths
    above on a standard-packed batch of 1,856 rows (not a multiple of the
    projection's 128-row tile): within 1e-4 / 2e-3 / 5e-3 of max |value|
    of the plain version, the same bits on two launches."""
    _, (b,) = canonical_batches("qm9", n_graphs=100, batch_size=100,
                                node_multiple=8, device=cuda_device)
    assert b.num_nodes % 128
    args, kw = _gat_tc_args(b, Fin, H, C, mode, edge, False, True, Fin + C)
    _hold_gat(gat_layer.fused_gat_layer, gat_layer.gat_layer_plain, b, args,
              kw, mode)


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("Fin,H,C", GAT_TC_SHAPES)
def test_gat_block_tc_matches_plain_every_shape(cuda_device, Fin, H, C,
                                                mode, edge, concat):
    """Row 9 in each mode, with and without edge terms, concatenated and
    averaged heads, at the widths above on a block batch of simple QM9
    graphs: within 1e-4 / 2e-3 of max |value| of the plain version, the
    same bits on two launches."""
    _, b = _simple_block_batch(device=cuda_device)
    args, kw = _gat_tc_args(b, Fin, H, C, mode, edge, True, concat, Fin + H)
    _hold_gat(gat_block.fused_gat_block_layer,
              gat_block.gat_block_layer_plain, b, args, kw, mode)


@pytest.mark.parametrize("blocks", [1, 132, 133, 160])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_gat_block_tc_at_block_counts(cuda_device, blocks, mode):
    """Row 9 at the canonical widths on batches of 1, 132, 133 and 160
    blocks (one wave of the card's 132 SMs, one over, b1024), concat with
    edge terms and the head mean without: within tolerance, bitwise
    twice."""
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.data.datasets import (
        drop_repeated_edges,
        load_dataset,
    )

    gs = load_dataset("qm9", n=5 * blocks if blocks < 160 else 1024)
    b = build_graph_batch(drop_repeated_edges(gs), block_size=128,
                          node_multiple=128 * blocks, device=cuda_device)
    assert b.num_nodes == 128 * blocks
    for Fin, C, concat, edge in ((512, 128, True, True),
                                 (512, 64, False, False)):
        args, kw = _gat_tc_args(b, Fin, 4, C, mode, edge, True, concat,
                                blocks)
        _hold_gat(gat_block.fused_gat_block_layer,
                  gat_block.gat_block_layer_plain, b, args, kw, mode)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("concat", [True, False])
def test_gat_block_tc_hub_and_repeated_pairs(cuda_device, mode, concat):
    """Row 9 on a block batch that repeats pairs (counts above 1) and on
    one with a 70-in-degree hub, Fin 11 and 512, heads 3 and 4: within
    tolerance, bitwise twice."""
    for b in (_batch()[1].to(cuda_device), _hub_block_batch(cuda_device)[1]):
        assert b.block_adj.max() > 1 or b.nbr_nodes is None
        for Fin, H in ((11, 3), (512, 4)):
            args, kw = _gat_tc_args(b, Fin, H, 128 if concat else 64, mode,
                                    False, True, concat, Fin + H)
            _hold_gat(gat_block.fused_gat_block_layer,
                      gat_block.gat_block_layer_plain, b, args, kw, mode)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_gat_cached_layout_matches_the_layout_on_the_call(cuda_device,
                                                          mode):
    """Each kernel on weights staged beforehand (``stage_projection``,
    the block kernel's with its logit weights: what
    ``GATConv.mode_operands`` caches) gives the same bits as on weights
    it lays out itself on the call."""
    _, b = _std_batch(device=cuda_device)
    args, kw = _gat_tc_args(b, 512, 4, 128, mode, False, False, True, 3)
    staged = gat_layer.stage_projection(args[3], 4, mode)
    assert torch.equal(gat_layer.fused_gat_layer(*args, **kw),
                       gat_layer.fused_gat_layer(*args, **kw, staged=staged))
    if mode == "int8":
        return
    _, bb = _simple_block_batch(device=cuda_device)
    args, kw = _gat_tc_args(bb, 512, 4, 128, mode, True, True, True, 4)
    staged = gat_layer.stage_projection(args[2], 4, mode, kw["wa_src"],
                                        kw["wa_dst"])
    assert torch.equal(
        gat_block.fused_gat_block_layer(*args, **kw),
        gat_block.fused_gat_block_layer(*args, **kw, staged=staged))


def test_gat_train_step_after_adam_uses_the_updated_weights(cuda_device):
    """A GAT model whose f32 inference cache was filled, then one Adam
    step (lr 5e-3): the next ``Program.forward`` matches the plain path
    on the updated weights within 1e-4 of max (the cache rebuilt, not
    served stale; the pre-update output is more than 1e-3 off), and the
    next train step's loss, on a forward that lays out its live weights,
    matches the plain path's loss on them within 1e-4 relative (the
    split-TF32 products sit ~1e-6 of max off the plain float32 ones)."""
    gs, b = _std_batch(device=cuda_device)
    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    model = canonical_model("gat", "qm9", graphs=gs,
                            conv_kwargs=dict(heads=4))
    prog = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                   max_graphs=b.num_graphs, device="cuda", seed=9)
    prog.init_params()
    m = b.graph_mask
    stale = prog.forward(b)
    step = train.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=5e-3))
    before = gat_layer.fused_gat_layer.launches
    step(b, target)
    fresh = prog.forward(b)
    assert gat_layer.fused_gat_layer.launches == before + 12
    dispatch.set_fused_mode("never")
    try:
        ref = prog.forward(b)
        with torch.no_grad():
            plain_loss = float(train.masked_mse_loss(model(b), target, m))
    finally:
        dispatch.set_fused_mode("auto")
    assert _scaled_err(fresh[m], ref[m]) <= 1e-4
    assert _scaled_err(stale[m], ref[m]) > 1e-3
    loss = float(step(b, target))
    assert abs(loss - plain_loss) <= 1e-4 * abs(plain_loss)


@pytest.mark.parametrize("conv", ["gcn", "sage"])
def test_mp_stack_after_adam_uses_the_updated_weights(cuda_device, conv):
    """A block-packed GCN or SAGE model whose f32 stack layout was cached
    by an inference forward, then one Adam step (lr 5e-3) on the standard
    batch: the next block forward launches the stack kernel again and
    matches the per-layer plain path on the updated weights within 1e-4
    of max (the cached layout rebuilt, not served stale; the pre-update
    output is more than 1e-3 off)."""
    gs, b = _batch(256)
    b = b.to(cuda_device)
    gs_std, sb = _std_batch(device=cuda_device)
    target = train.stack_targets(gs_std, sb.num_graphs, device=cuda_device)
    model = canonical_model(conv, "qm9", graphs=gs)
    prog = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                   max_graphs=b.num_graphs, block_size=128, device="cuda",
                   seed=9)
    prog.init_params()
    m = b.graph_mask
    stale = prog.forward(b)
    step = train.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=5e-3))
    step(sb, target)
    before = mp_block.fused_mp_block_stack.launches
    fresh = prog.forward(b)
    torch.cuda.synchronize()
    assert mp_block.fused_mp_block_stack.launches == before + 1
    dispatch.set_fused_mode("never")
    try:
        ref = prog.forward(b)
    finally:
        dispatch.set_fused_mode("auto")
    assert _scaled_err(fresh[m], ref[m]) <= 1e-4
    assert _scaled_err(stale[m], ref[m]) > 1e-3


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_pna_layer_cached_layout_matches_layout_on_the_call(cuda_device,
                                                             mode):
    """The layer on weights staged beforehand (``layer_operands``: what
    ``GNNModel`` caches for inference) gives the same bits as on weights
    it lays out itself on the call, and two calls give the same bits."""
    _, b = _std_batch(device=cuda_device)
    g = torch.Generator(device="cpu").manual_seed(8)

    def r(fan_in, *s):
        return (torch.randn(*s, generator=g) / fan_in ** 0.5).to(cuda_device)

    F = 128
    p = (r(2 * F, 2 * F, F), r(2 * F, F), r(13 * F, 13 * F, F), r(13 * F, F),
         r(F, F, F), r(F, F))
    x = torch.randn(b.num_nodes, F, generator=g).to(cuda_device)
    ops = pna_layer.layer_operands([p], mode)[0]
    args = (x, b.nbr_nodes, b.in_degree, *ops["weights"], 1.8)
    kw = dict(act="relu", mode=mode, s_lin=ops["s_lin"])
    on_call = pna_layer.fused_pna_layer(*args, **kw)
    cached = pna_layer.fused_pna_layer(*args, **kw, staged=ops["staged"])
    again = pna_layer.fused_pna_layer(*args, **kw, staged=ops["staged"])
    assert torch.equal(on_call, cached) and torch.equal(cached, again)


@pytest.mark.parametrize("n_rows", [1, 47, 1000, 18688, 18701])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_pna_layer_at_row_counts(cuda_device, n_rows, mode):
    """A random ELL table (width 6, degrees 0..6, repeated neighbours) at
    row counts that fill the aggregate launch's tiles or leave a part
    tile: the kernel against the plain version (f32 1e-4 of max with the
    residuals, tie counts and empty-row extrema exact; the modes 2e-3 /
    5e-3)."""
    g = torch.Generator(device="cpu").manual_seed(n_rows)
    W, F = 6, 128
    nbr = torch.randint(0, n_rows, (n_rows, W), generator=g,
                        dtype=torch.int32)
    deg = torch.randint(0, W + 1, (n_rows,), generator=g, dtype=torch.int32)
    nbr[:, 1] = nbr[:, 0]

    def r(fan_in, *s):
        return (torch.randn(*s, generator=g) / fan_in ** 0.5).to(cuda_device)

    p = (r(2 * F, 2 * F, F), r(2 * F, F), r(13 * F, 13 * F, F), r(13 * F, F),
         r(F, F, F), r(F, F))
    x = torch.randn(n_rows, F, generator=g).to(cuda_device)
    w_pre, k_post, w_lin, s_lin = pna_layer.prepare_layer(p[0], p[2], p[4],
                                                          mode)
    args = (x, nbr.to(cuda_device), deg.to(cuda_device), w_pre, p[1],
            k_post, p[3], w_lin, p[5], 1.8)
    kw = dict(act="relu", mode=mode, s_lin=s_lin,
              save_res=mode == "f32")
    got = pna_layer.fused_pna_layer(*args, **kw)
    torch.cuda.synchronize()
    want = pna_layer.pna_layer_plain(*args, **kw)
    if mode != "f32":
        assert _scaled_err(got, want) <= MODE_TOL[mode]
        return
    for name, a, w in zip(("out", "v", "agg_cat", "aux", "mid"), got, want):
        if name == "aux":
            torch.testing.assert_close(a[:, 3 * F:], w[:, 3 * F:], rtol=0,
                                       atol=0)
            a, w = a[:, :3 * F], w[:, :3 * F]
            ok = deg.to(cuda_device) > 0
            torch.testing.assert_close(a[~ok], w[~ok], rtol=0, atol=0)
            a, w = a[ok], w[ok]
            if not ok.any():   # one empty row: nothing left to compare
                continue
        assert _scaled_err(a, w) <= 1e-4, name


def test_pna_step_after_adam_uses_the_updated_weights(cuda_device):
    """A PNA model whose f32 inference cache was filled on a
    standard-packed batch, then one Adam step (lr 5e-3): the next
    ``Program.forward`` matches the plain path on the updated weights
    within 1e-4 of max (the cached layer layouts rebuilt, not served
    stale; the pre-update output is more than 1e-3 off)."""
    gs, b = _std_batch(device=cuda_device)
    target = train.stack_targets(gs, b.num_graphs, device=cuda_device)
    model = canonical_model("pna", "qm9", graphs=gs)
    prog = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                   max_graphs=b.num_graphs, device="cuda", seed=9)
    prog.init_params()
    m = b.graph_mask
    stale = prog.forward(b)
    step = train.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=5e-3))
    before = pna_layer.fused_pna_layer.launches
    step(b, target)
    fresh = prog.forward(b)
    assert pna_layer.fused_pna_layer.launches == before + 12
    dispatch.set_fused_mode("never")
    try:
        ref = prog.forward(b)
    finally:
        dispatch.set_fused_mode("auto")
    assert _scaled_err(fresh[m], ref[m]) <= 1e-4
    assert _scaled_err(stale[m], ref[m]) > 1e-3


def _captured_matches_eager(prog, b, k, dynamic=False):
    """Replays of ``k`` chained forwards captured in a CUDA graph (one
    graph of k, or with ``dynamic`` one of 1 replayed k times): the last
    forward's output against an eager forward, error / max |value| on
    graph_mask rows."""
    carry = torch.zeros((), device=b.device)
    with prog._captured_chain(b, 1 if dynamic else k, carry) as (run, out):
        run(k if dynamic else 1)
        run(k if dynamic else 1)
        torch.cuda.synchronize()
        got = out.clone()
    want = prog.forward(b)
    m = b.graph_mask
    assert torch.isfinite(got[m]).all()
    return _scaled_err(got[m], want[m])


def test_benchmark_inner_on_a_small_pna_program(cuda_device):
    """``benchmark_inner`` on canonical PNA, one 256-graph block batch:
    static and dynamic fits resolved, k = 1 and 5 timed, and the last
    forward of a replayed chain within 1e-4 of max of an eager one."""
    gs, b = _batch(256)
    model = canonical_model("pna", "qm9", graphs=gs)
    p = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                max_graphs=b.num_graphs, block_size=128)
    p.init_params()
    bc = b.to(cuda_device)
    for dynamic in (False, True):
        r = p.benchmark_inner(bc, iters=10, repeats=3, dynamic=dynamic)
        assert r["resolved"] is True, r
        assert set(r["times_s"]) == {1, 5}
        assert 0 < r["latency_s"] < r["times_s"][5]
        assert r["overhead_s"] >= 0 and r["graphs_per_s"] > 0
        assert _captured_matches_eager(p, bc, 3, dynamic) <= 1e-4


# every conv's canonical model (name: conv, conv_kwargs, node width or
# None for QM9's), as the smoke's slice phases run them
CAPTURE_MODELS = {
    "pna": ("pna", {}, None), "gcn": ("gcn", {}, None),
    "gin": ("gin", {}, None), "sage": ("sage", {}, None),
    "lg": ("lg", {}, 128), "simple": ("simple", {}, 128),
    "simple_max": ("simple", {"aggregation": "max"}, 128),
    "gine": ("gine", {}, None), "edge": ("edge", {}, None),
    "gat": ("gat", {"heads": 4}, None),
    "gat_edge": ("gat", {"heads": 4, "edge_dim": 4}, None),
    "pna5": ("pna", {"aggregators": ("sum", "mean", "min", "max", "std")},
             None)}


@pytest.mark.parametrize("packing", ["block", "standard"])
@pytest.mark.parametrize("name", sorted(CAPTURE_MODELS))
def test_forward_captures_without_host_sync(cuda_device, name, packing):
    """Every conv's forward, on both packings and under every policy,
    captures in a CUDA graph: its warm forward raises nothing under
    ``set_sync_debug_mode("error")``, no cache changes while capturing,
    and a replay's output is within 1e-4 of max of an eager forward
    (256 QM9 graphs; the readout kernel launched once per forward)."""
    conv, ckw, width = CAPTURE_MODELS[name]
    kw = (dict(block_size=128, node_multiple=128) if packing == "block"
          else dict(node_multiple=256))
    gs, (b,) = canonical_batches("qm9", n_graphs=256, batch_size=256,
                                 node_dim=width, device=cuda_device, **kw)
    for policy in ("f32", "bf16", "int8"):
        model = canonical_model(conv, "qm9", graphs=gs, conv_kwargs=ckw)
        p = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                    max_graphs=b.num_graphs,
                    block_size=kw.get("block_size", 0), precision=policy)
        p.init_params()
        r0 = readout.fused_readout.launches
        assert _captured_matches_eager(p, b, 2) <= 1e-4, policy
        # cold, warm, 2 captured (a replay calls no wrapper), eager
        assert readout.fused_readout.launches == r0 + 5, policy


# ------------------------------------------- trainer pieces, verification

def _train_batch(n_graphs=256):
    gs, (b,) = canonical_batches("qm9", n_graphs=n_graphs,
                                 batch_size=n_graphs, node_multiple=256,
                                 device="cuda")
    return gs, b, train.stack_targets(gs, b.num_graphs, device="cuda")


@pytest.mark.parametrize("conv,ck", [("pna", {}), ("gat", {"heads": 4})])
def test_remat_step_gives_the_plain_step_gradient_bits(cuda_device, conv,
                                                       ck):
    """``GNNModel(remat=True)``: the loss and every gradient of a step
    bit-equal to the plain model's, and the layer kernel replayed in the
    backward."""
    gs, b, y = _train_batch()
    torch.manual_seed(0)
    ms = [canonical_model(conv, "qm9", graphs=gs, gnn_num_layers=3,
                          conv_kwargs=dict(ck), remat=r).to(cuda_device)
          for r in (False, True)]
    ms[1].load_state_dict(ms[0].state_dict())
    kern = pna_layer.fused_pna_layer if conv == "pna" else \
        gat_layer.fused_gat_layer
    res = []
    with torch.enable_grad():
        for m in ms:
            kern.launches = 0
            loss = train.masked_mse_loss(m(b), y, b.graph_mask)
            loss.backward()
            torch.cuda.synchronize()
            res.append((loss.detach(), kern.launches,
                        {k: p.grad for k, p in m.named_parameters()}))
    (l0, n0, g0), (l1, n1, g1) = res
    assert torch.equal(l0, l1)
    assert n0 == 3 and n1 == 6, (n0, n1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_loader_fed_step_matches_a_direct_one(cuda_device):
    """A PNA step on ``GraphLoader``'s batch (packed on the host, copied
    without waiting) and one on the same chunk packed directly: the same
    batch, the same loss and weights, bit for bit."""
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.data.loader import GraphLoader

    gs = canonical_batches("qm9", n_graphs=512, batch_size=256,
                           device="cpu")[0]
    loader = GraphLoader(gs, batch_size=256, shuffle=True, seed=3,
                         node_multiple=256)
    chunk = loader._chunks()[0]
    epoch = loader.epoch()
    lb, ly = next(epoch)
    epoch.close()
    db = build_graph_batch(chunk, node_budget=loader.node_budget,
                           edge_budget=loader.edge_budget,
                           graph_budget=loader.graph_budget,
                           node_multiple=256, device="cuda")
    dy = train.stack_targets(chunk, loader.graph_budget, device="cuda")
    assert torch.equal(ly, dy)
    for name in ("node_feat", "nbr_nodes", "in_degree", "rev_nbr_nodes",
                 "graph_starts", "edge_feat"):
        assert torch.equal(getattr(lb, name), getattr(db, name)), name
    torch.manual_seed(0)
    ms = [canonical_model("pna", "qm9", graphs=gs, gnn_num_layers=3).to(
        cuda_device) for _ in range(2)]
    ms[1].load_state_dict(ms[0].state_dict())
    losses = []
    with torch.enable_grad():
        for m, (b, y) in zip(ms, ((lb, ly), (db, dy))):
            step = train.make_train_step(m, torch.optim.Adam(
                m.parameters(), lr=1e-3))
            losses.append(step(b, y))
    assert torch.equal(*losses)
    for p, q in zip(ms[0].parameters(), ms[1].parameters()):
        assert torch.equal(p, q)


def test_run_parity_check_on_the_card_against_cpu_goldens(cuda_device,
                                                          tmp_path):
    """Canonical PNA (block-packed, rows 1 and 2): goldens of 32 QM9
    graphs from a CPU Program, ``run_parity_check`` on the card: MAE <=
    1e-5 of max |golden|."""
    from gnnbuilder_tpu_torch.verify import golden

    gs = canonical_batches("qm9", n_graphs=32, batch_size=32,
                           device="cpu")[0]
    bucket = dict(max_nodes=256, max_edges=512, max_graphs=2,
                  block_size=128)
    cpu = Program(canonical_model("pna", "qm9", graphs=gs), device="cpu",
                  **bucket)
    cpu.init_params()
    card = Program(canonical_model("pna", "qm9", graphs=gs), **bucket)
    card.set_params({k: v.to("cuda") for k, v in cpu.params.items()})
    cpu.gen_testbench_data(gs, str(tmp_path))
    gmax = max(float(np.abs(o).max())
               for o in golden.load_golden_outputs(str(tmp_path)))
    pna_block.fused_pna_block_stack.launches = 0
    rep = card.run_parity_check(gs, str(tmp_path))
    assert rep["num_graphs"] == len(gs)
    assert pna_block.fused_pna_block_stack.launches == len(gs)
    assert rep["model_output_mae"] <= 1e-5 * gmax, rep


DSE_ROW_KEYS = ("dataset", "num_nodes", "num_edges", "latency_us",
                "latency_per_graph_us", "graphs_per_s", "edges_per_s",
                "protocol", "overhead_us", "flops", "bytes_accessed",
                "peak_hbm_bytes", "compile_s", "measure_s")


@pytest.mark.parametrize("point,kernel", [
    (dict(conv="pna", gnn_hidden_dim=256, batch_size=256, block_size=128),
     "pna_layer"),
    (dict(conv="gcn", batch_size=64, ell_width=0, block_size=128),
     "mp_block_stack"),
    (dict(conv="edge", batch_size=256, block_size=128), "edge_block")],
    ids=["pna_h256_block", "gcn_b64_ell0_block", "edge_block"])
def test_measure_config_on_the_card(cuda_device, point, kernel):
    """A DSE design point timed on the card: the row's fields, a positive
    latency by the inner chain, the route's kernel launched (PNA at
    hidden 256 runs per layer: the stack kernel holds 128 features), the
    knobs restored, and the design point's forward within 1e-4 of max of
    the plain path."""
    from gnnbuilder_tpu_torch.core import graph as graph_mod
    from gnnbuilder_tpu_torch.dse import DSEConfig, measure_config
    from gnnbuilder_tpu_torch.dse.measure import _design_point
    from gnnbuilder_tpu_torch.ops.cuda import edge_block, mp_block

    wrappers = dict(pna_layer=pna_layer.fused_pna_layer,
                    mp_block_stack=mp_block.fused_mp_block_stack,
                    edge_block=edge_block.fused_edge_block_layer)
    cfg = DSEConfig(**point)
    before = wrappers[kernel].launches
    stack_before = pna_block.fused_pna_block_stack.launches
    row = measure_config(cfg, dataset="qm9", iters=6)
    assert all(k in row for k in DSE_ROW_KEYS + tuple(cfg.to_dict()))
    assert row["latency_us"] > 0 and row["peak_hbm_bytes"] > 0
    assert row["protocol"].startswith("inner")
    assert wrappers[kernel].launches > before
    assert pna_block.fused_pna_block_stack.launches == stack_before
    assert graph_mod._DEFAULT_ELL_WIDTH is None
    _, prog, b = _design_point(cfg, "qm9", 0, cuda_device)
    with torch.no_grad():
        got = prog.forward(b)
        dispatch.set_fused_mode("never")
        try:
            want = prog.forward(b)
        finally:
            dispatch.set_fused_mode("auto")
    m = b.graph_mask
    assert _scaled_err(got[m], want[m]) <= 1e-4

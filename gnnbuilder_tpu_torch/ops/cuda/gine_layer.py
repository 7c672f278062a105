"""One GINE layer: per-slot messages ``relu(x_j + pe_e)`` summed over each
receiver's valid ELL slots, then GIN's MLP (``fused_gine_layer``), its
backward (``GINELayerFunction``) and the entry GINEConv calls
(``fused_gine_layer_auto``).

``fused_gine_layer`` launches ``csrc/gine_layer.cu`` for CUDA tensors and
runs ``gine_layer_plain``, the same function in plain torch, for CPU
tensors.  It replaces the TPU kernel ``gnnbuilder_tpu/ops/pallas/
gine_layer.py`` ``fused_gine_layer``; the plain version is that file's
``gine_layer_reference``:

    s   = sum_{w < deg} relu(x[nbr_nodes[:, w]] + pe[nbr_edges[:, w]])
    out = act(relu(((1 + eps) x + s) w0 + b0) w1 + b1 [+ skip])

``pe = lin_edge(edge_feat)`` [E, F] is formed by the caller, in the
batch's packed (receiver-sorted) edge order that ``nbr_edges`` indexes.
Pad slots are masked by in-degree: they point at pad edges, whose pe is
lin_edge's bias, not 0.  The backward recomputes the plain version, as
the JAX package's ``_make_vjp_fn`` recomputes its reference: the MLP's
gradients by torch autograd from the recomputed sum s, and the messages'
over the valid slots alone, dpe by assignment (each valid slot owns one
edge) and dx by ``index_put_(accumulate=True)`` over the senders, whose
order is fixed, so every step gives the same bits.  (Autograd of the
[N, W] gathers would accumulate every pad slot into the ghost row, one
hot spot that costs hundreds of ms on the card at b1024.)

What bounds the kernel on the H100: bytes at width 128; see the source.
Operands are in the JAX package's [in, out] layout: w0 [F, H], b0 [H],
w1 [H, Fout], b1 [Fout].  The kernel runs both products on the tensor
cores; ``staged`` (``layer_operands`` / ``stage_weights``: W0 and W1 laid
out on the card in the order its CTAs stream them, made in one gather
for all of a model's layers) lets it stream them by bulk copies, else it
reads the caller's weights.  The plain version's f32 products go through
``_f32_dot`` (the CPU tests' seam for the kernel's order); in the bf16
mode its T w0 is the float64 product rounded once, as the kernel forms it
(Z is rounded to bf16 next).

Modes (``mode``; the JAX kernel's ``gather_mode="bf16"`` with
``mm="bf16"``, and ``quant``): "bf16" rounds both gathered
rows, x_j and pe_e, to bf16 before ``relu(x_j + pe_e)`` (the sum stays
float32) and the MLP's operands, with bfloat16 ``w0`` / ``w1``; "int8"
quantizes both MLP products (``ops.quant.qdot``, int8 weights with
per-column scales ``s0`` / ``s1``) and keeps the aggregation exact.
``mp_layer.prepare_layer`` brings float32 weights to a mode.
``GINELayerFunction`` takes a mode: the kernel forward in it, the
backward the same float32 recompute (the JAX VJP's under every mode; for
"int8" its straight-through estimator).  Its plain twin (``plain=True``)
runs ``gine_layer_plain`` forward.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.cuda.mp_layer import (
    LAYER_ACTS,
    MODES,
    prepare_layer,
    weight_dtype,
)
from gnnbuilder_tpu_torch.ops.cuda.pna_block import split_tf32
from gnnbuilder_tpu_torch.ops.ell import ell_gather, ell_mask
from gnnbuilder_tpu_torch.ops.quant import qdot, to_bf16

__all__ = ["fused_gine_layer", "gine_layer_plain", "GINELayerFunction",
           "fused_gine_layer_vjp", "fused_gine_layer_auto", "stage_weights",
           "unstage_weight", "layer_operands", "ring_chunks"]

# the Ring's layout (csrc/tc_rows.cuh): a chunk is 2 k-steps x 16 n-tiles
# x 32 lanes, a unit per lane: its two registers of the mode's values
# (_UNIT of them; f32 then splits each into TF32 halves, four words);
# per mode the k of a k-step and a chunk's bytes
_KSTEP = {"f32": 8, "bf16": 16, "int8": 32}
_UNIT = {"f32": 2, "bf16": 4, "int8": 8}
RING_CHUNK = {"f32": 1024 * 16, "bf16": 1024 * 8, "int8": 1024 * 8}
_index_cache: dict = {}


def _messages(x, pe, nbr_nodes, nbr_edges, in_degree, mode="f32"):
    """(x_j + pe_e per slot [N, W, F], the valid-slot mask [N, W, 1]);
    both rows rounded to bf16 in the bf16 mode."""
    if mode == "bf16":
        x, pe = to_bf16(x), to_bf16(pe)
    pre = ell_gather(x, nbr_nodes) + ell_gather(pe, nbr_edges)
    return pre, ell_mask(nbr_nodes, in_degree)[..., None]


def _f32_dot(a, w):
    """The f32 mode's product in the plain version."""
    return a @ w


def _mlp(h, w0, b0, w1, b1, skip, act, mode="f32", s0=None, s1=None):
    def dot(a, w, sw):
        if mode == "int8":
            return qdot(a, w, sw)
        if mode == "bf16":
            return to_bf16(a) @ w.float()
        return _f32_dot(a, w)

    # bf16: Z is rounded to bf16 next, so h w0 is the float64 product
    # rounded once, as the kernel forms it (any float32 order flips a
    # bf16 rounding now and then)
    z = ((to_bf16(h).double() @ w0.double()).float() if mode == "bf16"
         else dot(h, w0, s0))
    o = dot(torch.relu(z + b0), w1, s1) + b1
    if skip is not None:
        o = o + skip
    return o if act is None else ACTIVATIONS[act](o)


def gine_layer_plain(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1,
                     b1, eps: float = 0.0, skip=None,
                     act: Optional[str] = None, mode: str = "f32", s0=None,
                     s1=None, staged=None):
    """The layer in plain torch (``gine_layer_reference``), in ``mode``;
    it takes ``fused_gine_layer``'s arguments and has no use for the
    weights' layout ``staged``."""
    pre, m = _messages(x, pe, nbr_nodes, nbr_edges, in_degree, mode)
    s = torch.where(m, torch.relu(pre), x.new_zeros(())).sum(1)
    return _mlp((1.0 + eps) * x + s, w0, b0, w1, b1, skip, act, mode, s0,
                s1)


def _ring_index(K: int, N: int, mode: str,
                transposed: bool = False) -> torch.Tensor:
    """[chunks, 1024, E] positions in a [K, N] weight's flat values (K N:
    a zero; ``transposed``: the values of its contiguous transpose, [N,
    K]) of its chunks in the Ring's order: its 128-column tiles in turn,
    each tile's k-chunks in turn, unit u of a chunk (lane u % 32, n-tile
    u / 32 % 16, k-step u / 512) lane's E values: column 8 nt + lane / 4
    of the tile, k = chunk 2 KS + k-step KS + E (lane % 4) + 0 .. E - 1
    (KS: the mode's k-step), mma_step's fragment order."""
    E, KS = _UNIT[mode], _KSTEP[mode]
    u = torch.arange(1024)
    lane, nt, ks = u & 31, (u >> 5) & 15, u >> 9
    n = (torch.arange(-(-N // 128)) * 128)[:, None, None, None] \
        + (8 * nt + (lane >> 2))[None, None, :, None]
    kchunks = -(-K // (2 * KS))
    k = (torch.arange(kchunks) * 2 * KS)[None, :, None, None] \
        + (ks * KS + E * (lane & 3))[None, None, :, None] \
        + torch.arange(E)[None, None, None, :]
    at = n * K + k if transposed else k * N + n
    idx = torch.where((k >= K) | (n >= N), K * N, at)
    return idx.reshape(-1, 1024, E)


def ring_chunks(F: int, H: int, Fout: int, mode: str) -> int:
    """Chunks of a layer's Ring layout (W0 [F, H] then W1 [H, Fout])."""
    kc = 2 * _KSTEP[mode]
    return (-(-H // 128) * -(-F // kc) + -(-Fout // 128) * -(-H // kc))


def stage_weights(layers, mode: str = "f32"):
    """Each layer's (w0, w1) in ``mode``'s type (float32, bfloat16, int8:
    ``mp_layer.prepare_layer``) laid out as the kernel's Ring streams them
    (``_ring_index``; f32 split into TF32 halves, as Chunk::store splits
    them), made on the weights' device in one gather for all layers: a
    list of uint8 tensors, one a layer, views of one buffer,
    ``ring_chunks`` x ``RING_CHUNK[mode]`` bytes each."""
    ws = [w.detach() for pair in layers for w in pair]
    # a weight's values in place: a Linear's [in, out] view of its [out,
    # in] parameter is read through that parameter, with no copy
    srcs = [(w, False) if w.is_contiguous() else
            (w.t(), True) if w.t().is_contiguous() else (w.contiguous(), False)
            for w in ws]
    dev = ws[0].device
    key = (tuple((tuple(w.shape), tr) for w, (_, tr) in zip(ws, srcs)), mode,
           dev)
    idx = _index_cache.get(key)
    if idx is None:
        parts, off = [], 0
        for w, (_, tr) in zip(ws, srcs):
            K, N = w.shape
            i = _ring_index(K, N, mode, tr)
            parts.append(torch.where(i == K * N, -1, i + off))
            off += K * N
        idx = torch.cat(parts).to(dev)
        idx = torch.where(idx < 0, off, idx)
        _index_cache[key] = idx
    flat = torch.cat([src.reshape(-1) for src, _ in srcs]
                     + [ws[0].new_zeros(1)])
    units = flat[idx]
    if mode == "f32":   # each unit: tf32(f0), tf32(f1), then the lows
        units = torch.cat(split_tf32(units), dim=-1)
    staged = units.reshape(-1).view(torch.uint8)
    out, at, cb = [], 0, RING_CHUNK[mode]
    for w0, w1 in layers:
        n = ring_chunks(w0.shape[0], w0.shape[1], w1.shape[1], mode)
        out.append(staged[at:at + n * cb])
        at += n * cb
    return out


def unstage_weight(staged, K: int, N: int, mode: str, first: int = 0):
    """The [K, N] weight whose chunks start at chunk ``first`` of a
    layer's layout (0: w0; ``ring_chunks`` of w0 alone: w1), back from
    ``stage_weights``' bytes; in f32 its TF32 halves, [2, K, N]."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16,
          "int8": torch.int8}[mode]
    idx = _ring_index(K, N, mode).to(staged.device).reshape(-1)
    vals = staged[first * RING_CHUNK[mode]:].view(dt)
    if mode == "f32":   # each unit: hi0, hi1, lo0, lo1
        vals = vals[:idx.numel() * 2].reshape(-1, 2, 2).transpose(0, 1)
    else:
        vals = vals[:idx.numel()][None]
    flat = torch.zeros((vals.shape[0], K * N + 1), dtype=dt,
                       device=staged.device)
    flat[:, idx] = vals.reshape(vals.shape[0], -1)
    out = flat[:, :K * N].reshape(-1, K, N)
    return out if mode == "f32" else out[0]


def layer_operands(weights, mode: str = "f32"):
    """Each layer's kernel operands in ``mode`` from its float32 (w0, w1)
    [in, out]: (w0, w1, s0, s1) of the mode (``mp_layer.prepare_layer``;
    in f32 the weights as given, which the caller makes contiguous) and
    the Ring layout of all layers at once (``stage_weights``), or None
    for a layer whose Ring does not fit the card (``ring_chunks`` of the
    library: 0)."""
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    prepared = [prepare_layer(w0.detach(), w1.detach(), mode) if mode == "f32"
                else prepare_layer(w0.detach().contiguous(),
                                   w1.detach().contiguous(), mode)
                for w0, w1 in weights]
    staged = stage_weights([(p[0], p[1]) for p in prepared], mode)
    return [p + (st if lib.gnnb_gine_layer_ring_chunks(
        p[0].shape[0], p[0].shape[1], p[1].shape[1], MODES[mode]) else None,)
            for p, st in zip(prepared, staged)]


def _check(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1, b1, skip,
           act, mode, s0, s1):
    if act not in LAYER_ACTS:
        raise ValueError(f"unsupported GINE layer activation {act!r}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options: {tuple(MODES)}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, F] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    N, F = x.shape
    if pe.dim() != 2 or pe.shape[1] != F or pe.dtype != torch.float32:
        raise ValueError(f"pe must be [E, {F}] float32, got "
                         f"{tuple(pe.shape)} {pe.dtype}")
    H, Fout = w0.shape[-1], w1.shape[-1]
    wdt = weight_dtype(mode)
    for name, t, shape in (("w0", w0, (F, H)), ("b0", b0, (H,)),
                           ("w1", w1, (H, Fout)), ("b1", b1, (Fout,)),
                           ("skip", skip, (N, Fout))):
        dt = wdt if name[0] == "w" else torch.float32
        if t is not None and (tuple(t.shape) != shape or t.dtype != dt):
            raise ValueError(f"{name} must be {shape} {dt} in mode "
                             f"{mode!r}, got {tuple(t.shape)} {t.dtype}")
    for name, t, n in (("s0", s0, H), ("s1", s1, Fout)):
        if mode != "int8":
            if t is not None:
                raise ValueError(f"mode {mode!r} takes no {name}")
        elif t is None or tuple(t.shape) != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({n},) float32 in mode 'int8'")
    for name, t in (("nbr_nodes", nbr_nodes), ("nbr_edges", nbr_edges)):
        if t is None or t.dim() != 2 or t.shape[0] != N:
            raise ValueError(f"{name} must be [{N}, W]")
    if nbr_edges.shape != nbr_nodes.shape:
        raise ValueError("nbr_edges must match nbr_nodes' shape")
    if tuple(in_degree.shape) != (N,):
        raise ValueError(f"in_degree must be [{N}]")
    devs = {t.device for t in (x, pe, nbr_nodes, nbr_edges, in_degree, w0,
                               b0, w1, b1, skip, s0, s1) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1, b1, eps,
            skip, act, mode, s0, s1, staged=None):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, F = x.shape
    H, Fout = w0.shape[1], w1.shape[1]
    dev = x.device
    smem = lib.gnnb_gine_layer_smem_bytes(F, H, MODES[mode])
    smem_max = lib.gnnb_smem_per_block_optin(dev.index or 0)
    if smem > smem_max:
        raise ValueError(f"the CUDA GINE layer takes widths within "
                         f"{smem_max} bytes of shared memory; got F={F} "
                         f"H={H} ({smem} bytes)")
    if any(t.dtype != torch.int32 for t in (nbr_nodes, nbr_edges,
                                            in_degree)):
        raise ValueError("nbr_nodes, nbr_edges and in_degree must be int32")
    ops = [t for t in (x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1,
                       b1, skip, s0, s1) if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("all inputs must be contiguous")
    fn = lib.gnnb_gine_layer
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 5 + [I] * 5 + [P] * 5 + [ctypes.c_float, I, I]
                   + [P] * 4 + [I, P, ctypes.c_longlong])
    if staged is not None:
        want = ring_chunks(F, H, Fout, mode) * RING_CHUNK[mode]
        if (staged.dtype != torch.uint8 or staged.dim() != 1
                or staged.numel() != want or staged.device != dev):
            raise ValueError(f"staged must be ({want},) uint8 on {dev} "
                             "(stage_weights)")
    out = torch.empty((N, Fout), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), pe.data_ptr(), nbr_nodes.data_ptr(),
             nbr_edges.data_ptr(), in_degree.data_ptr(), N,
             nbr_nodes.shape[1], F, H, Fout, w0.data_ptr(), b0.data_ptr(),
             w1.data_ptr(), b1.data_ptr(),
             None if skip is None else skip.data_ptr(), float(eps),
             LAYER_ACTS[act], MODES[mode],
             None if s0 is None else s0.data_ptr(),
             None if s1 is None else s1.data_ptr(), out.data_ptr(), stream,
             dev.index or 0, None if staged is None else staged.data_ptr(),
             0 if staged is None else staged.numel())
    if err != 0:
        raise RuntimeError(f"gine_layer launch failed: cudaError {err}")
    fused_gine_layer.launches += 1
    fused_gine_layer.mode_launches[mode] += 1
    return out


def fused_gine_layer(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1,
                     b1, eps: float = 0.0, skip=None,
                     act: Optional[str] = None, mode: str = "f32", s0=None,
                     s1=None, staged=None):
    """One GINE layer (module docstring) on x [N, F] and pe [E, F] float32
    over the ELL table ``nbr_nodes`` / ``nbr_edges`` [N, W] and
    ``in_degree`` [N] (int32), weights typed by ``mode``
    (``mp_layer.prepare_layer``), with their Ring layout ``staged``
    (``stage_weights``) or None.  A CUDA ``x`` launches the kernel, which
    takes any width within shared memory and raises on what it does not
    take; a CPU ``x`` runs the plain version."""
    _check(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1, b1, skip,
           act, mode, s0, s1)
    if x.device.type == "cuda":
        return _launch(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1,
                       b1, eps, skip, act, mode, s0, s1, staged)
    if x.device.type != "cpu":
        raise ValueError(f"no GINE layer for device {x.device}")
    return gine_layer_plain(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0,
                            w1, b1, eps, skip, act, mode, s0, s1)


fused_gine_layer.launches = 0
fused_gine_layer.mode_launches = dict.fromkeys(MODES, 0)


class GINELayerFunction(torch.autograd.Function):
    """``fused_gine_layer`` with the JAX package's backward, a recompute
    of the float32 ``gine_layer_plain`` on the saved inputs (module
    docstring).  ``mode``: the forward in it on ``mode_weights`` = (w0,
    w1, s0, s1) of the mode with their layout ``staged``; ``plain``: the
    plain twin."""

    @staticmethod
    def forward(ctx, x, pe, nbr_nodes, nbr_edges, in_degree, skip, w0, b0,
                w1, b1, eps, act, staged=None, mode="f32", mode_weights=None,
                plain=False):
        ctx.save_for_backward(x, pe, nbr_nodes, nbr_edges, in_degree, skip,
                              w0, b0, w1, b1)
        ctx.eps, ctx.act = eps, act
        wm = (w0, w1, None, None) if mode_weights is None else mode_weights
        if plain:
            return gine_layer_plain(x, pe, nbr_nodes, nbr_edges, in_degree,
                                    wm[0], b0, wm[1], b1, eps, skip, act,
                                    mode, wm[2], wm[3])
        return fused_gine_layer(x, pe, nbr_nodes, nbr_edges, in_degree,
                                wm[0], b0, wm[1], b1, eps, skip, act,
                                mode=mode, s0=wm[2], s1=wm[3], staged=staged)

    @staticmethod
    def backward(ctx, ct):
        x, pe, nbr, nbre, deg, skip, w0, b0, w1, b1 = ctx.saved_tensors
        pre, m = _messages(x, pe, nbr, nbre, deg)
        zero = x.new_zeros(())
        s = torch.where(m, torch.relu(pre), zero).sum(1)
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_()
                      for t in ((1.0 + ctx.eps) * x + s, skip, w0, b0, w1,
                                b1)]
            h, sk, *ws = leaves
            o = _mlp(h, *ws, sk, ctx.act)
            got = iter(torch.autograd.grad(
                o, [t for t in leaves if t is not None], ct))
        dh, dskip, dw0, db0, dw1, db1 = [
            None if t is None else next(got) for t in leaves]
        # d(x_j + pe_e) per valid slot: dh of the receiver where the relu
        # passed (relu'(0) = 0, as in torch and JAX)
        valid = m[..., 0]
        dmsg = torch.where(pre > 0, dh[:, None, :], zero)[valid]
        dx = ((1.0 + ctx.eps) * dh).index_put_((nbr[valid].long(),), dmsg,
                                               accumulate=True)
        dpe = torch.zeros_like(pe).index_put_((nbre[valid].long(),), dmsg)
        return (dx, dpe, None, None, None, dskip, dw0, db0, dw1, db1, None,
                None, None, None, None, None)


def fused_gine_layer_vjp(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0, w1,
                         b1, eps: float = 0.0, skip=None,
                         act: Optional[str] = None, mode: str = "f32",
                         staged=None, mode_weights=None,
                         plain: bool = False):
    """Differentiable ``fused_gine_layer`` on float32 weights: the kernel
    forward in ``mode`` (on the Ring layout ``staged`` of its weights, if
    given, and ``mode_weights`` = (w0, w1, s0, s1) of the mode, made here
    when None) and the float32 plain-recompute backward; ``plain``: the
    plain twin."""
    if mode != "f32" and mode_weights is None:
        mode_weights = prepare_layer(w0.detach().contiguous(),
                                     w1.detach().contiguous(), mode)
    return GINELayerFunction.apply(x, pe, nbr_nodes, nbr_edges, in_degree,
                                   skip, w0, b0, w1, b1, float(eps), act,
                                   staged, mode, mode_weights, bool(plain))


def fused_gine_layer_auto(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0,
                          w1, b1, eps: float = 0.0, skip=None,
                          act: Optional[str] = None, mode: str = "f32",
                          operands=None):
    """The layer as GINEConv calls it: the differentiable path
    (``GINELayerFunction`` in ``mode``; its plain twin under
    ``dispatch.plain_twins``) when grad mode is on and an input needs a
    gradient, else the kernel alone.  ``operands``: this layer's
    ``layer_operands`` in ``mode`` (the weights of the mode and their
    Ring layout), else float32 weights are brought to ``mode`` here and
    the kernel reads them as they are.  The kernel takes any width, so
    nothing is padded."""
    from gnnbuilder_tpu_torch.ops import dispatch

    ops = [None if t is None else t.contiguous()
           for t in (x, pe, skip, w0, b0, w1, b1)]
    x, pe, skip, w0, b0, w1, b1 = ops
    staged = None if operands is None else operands[4]
    mode_weights = (operands[:4] if operands is not None and mode != "f32"
                    else None)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ops):
        return fused_gine_layer_vjp(x, pe, nbr_nodes, nbr_edges, in_degree,
                                    w0, b0, w1, b1, eps, skip, act, mode,
                                    staged, mode_weights,
                                    plain=dispatch.twins_on())
    if mode_weights is not None:
        w0, w1, s0, s1 = mode_weights
    else:
        w0, w1, s0, s1 = prepare_layer(w0, w1, mode)
    return fused_gine_layer(x, pe, nbr_nodes, nbr_edges, in_degree, w0, b0,
                            w1, b1, eps, skip, act, mode=mode, s0=s0, s1=s1,
                            staged=staged)

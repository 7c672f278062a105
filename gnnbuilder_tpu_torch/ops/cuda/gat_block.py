"""One GAT layer on a block-packed batch, inference only:
``fused_gat_block_layer`` launches ``csrc/gat_block.cu`` for CUDA tensors
and runs ``gat_block_layer_plain``, the same function in plain torch, for
CPU tensors.

It replaces the TPU kernel ``gnnbuilder_tpu/ops/pallas/gat_block.py``
``fused_gat_block_layer`` (it has no int8 mode, as the JAX gate never
gives it one); the plain version is that file's ``_reference``: h = x W,
per head a_src = h . att_src and a_dst = h . att_dst, then
``ops.block.block_gat_attention``
over the block adjacency's edge counts (k parallel edges give k equal
softmax terms), heads concatenated ([N, H*C]) or averaged ([N, C]), then
bias, skip (before the activation) and the activation.  Like the TPU
kernel it serves inference: GATConv takes it under inference scope only,
and training keeps the windowed layer kernel (``ops.cuda.gat_layer``).

The edge-logit mode (GATConv ``edge_dim``, in both modes): ``edge_table``
[N / 128, H, 128, 128] float32 adds a per-pair term to each logit before
the leaky ReLU, ``self_extra`` [N, H] one to the self loop's
(``build_block_edge_logits`` scatters the per-edge terms into the
table).  One term per pair is exact on simple graphs only: GATConv takes
this mode only on a batch without repeated pairs.

The bf16 mode (``mode="bf16"``, the JAX kernel's ``mm="bf16"``):
bfloat16 ``w``; h = bf16(x) w; the logit terms formed as the JAX kernel
forms them, a_src = bf16(x) wa_src with wa_src = bf16(bf16(w) A_src)
per head (``prepare_block``), not as h . att_src (in bf16 the two orders
differ, and the difference goes through exp); the weighted sum of h over
the neighbours with both the softmax weights and h rounded to bf16,
while the denominator, the self term and the bias stay float32.

What bounds it on the H100: operations (the projection, on the tensor
cores: split TF32 in three passes under f32, bf16 MMAs under bf16, the
logit terms as two more MMA columns); see the source.  The kernel is one
launch: each CTA projects its 128-row block's h for one head into shared
memory and attends from there.  It reads the weights in
``gat_layer.stage_projection``'s layout (under bf16 with the logit
weights' tile), made on the call or passed as ``staged`` (the model's
inference cache).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.block import block_gat_attention
from gnnbuilder_tpu_torch.ops.cuda.gat_layer import (
    GAT_ACTS,
    _staged_ok,
    stage_projection,
)
from gnnbuilder_tpu_torch.ops.quant import to_bf16

__all__ = ["fused_gat_block_layer", "gat_block_layer_plain",
           "prepare_block", "build_block_edge_logits", "MODES"]

# kernel modes, with their codes in the source
MODES = {"f32": 0, "bf16": 1}


def prepare_block(w, att_src, att_dst, mode: str):
    """(w, wa_src, wa_dst) as ``mode`` takes them: "bf16" gives bfloat16
    w and the bfloat16 logit weights wa [Fin, H] = bf16(bf16(w) A) per
    head (the JAX wrapper's ``w @ blockdiag(att)`` with bf16 operands and
    a float32 sum); "f32" gives w and None, None."""
    if mode not in MODES:
        raise ValueError(f"the GAT block kernel has modes {tuple(MODES)}; "
                         f"got {mode!r}")
    if mode == "f32":
        return w, None, None
    Fin, H = w.shape[0], att_src.shape[1]
    wb = to_bf16(w).reshape(Fin, H, -1)

    def logit_weights(att):
        wa = torch.einsum("khc,hc->kh", wb, to_bf16(att).reshape(H, -1))
        return wa.to(torch.bfloat16).contiguous()

    return (w.contiguous().to(torch.bfloat16), logit_weights(att_src),
            logit_weights(att_dst))


def build_block_edge_logits(senders, receivers, edge_mask, a_edge,
                            num_nodes: int, block_size: int):
    """The per-pair edge-logit table [T, H, B, B] (T = num_nodes / B) of
    per-edge terms ``a_edge`` [E, H]: entry [t, hd, i, j] holds the term
    of edge (t*B + j) -> (t*B + i), the layout of ``block_adj``.  Pad
    edges add 0 at the ghost position.  Parallel edges would add up, so
    the table is exact for simple graphs only (the JAX package's
    ``build_block_edge_logits``, built here in the kernel's layout)."""
    B = block_size
    H = a_edge.shape[1]
    r, s = receivers.long(), senders.long()
    vals = torch.where(edge_mask[:, None], a_edge, a_edge.new_zeros(()))
    heads = torch.arange(H, device=a_edge.device)[None, :]
    table = a_edge.new_zeros((num_nodes // B, H, B, B))
    return table.index_put(((r // B)[:, None], heads, (r % B)[:, None],
                            (s % B)[:, None]), vals, accumulate=True)


def gat_block_layer_plain(x, block_adj, w, att_src, att_dst, bias,
                          heads: int, neg_slope: float = 0.2,
                          self_loops: bool = True, skip=None,
                          act: Optional[str] = None, concat: bool = True,
                          mode: str = "f32", wa_src=None, wa_dst=None,
                          edge_table=None, self_extra=None):
    """The layer in plain torch (``_reference``), in ``mode``."""
    N = x.shape[0]
    bf16 = mode == "bf16"
    xm = to_bf16(x) if bf16 else x
    h = (xm @ w.float()).reshape(N, heads, -1)
    if bf16:
        a_src = xm @ wa_src.float()
        a_dst = xm @ wa_dst.float()
    else:
        a_src = (h * att_src).sum(-1)
        a_dst = (h * att_dst).sum(-1)
    out = block_gat_attention(block_adj, h, a_src, a_dst,
                              neg_slope=neg_slope, self_loops=self_loops,
                              bf16_sum=bf16, edge_table=edge_table,
                              self_extra=self_extra)
    out = out.reshape(N, -1) if concat else out.mean(dim=1)
    out = out + bias
    if skip is not None:
        out = out + skip
    return out if act is None else ACTIVATIONS[act](out)


def _check(x, block_adj, w, att_src, att_dst, bias, heads, skip, act,
           concat, mode, wa_src, wa_dst, edge_table, self_extra):
    if act not in GAT_ACTS:
        raise ValueError(f"unsupported GAT block activation {act!r}")
    if mode not in MODES:
        raise ValueError(f"the GAT block kernel has modes {tuple(MODES)}; "
                         f"got {mode!r}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, Fin] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    N, Fin = x.shape
    if w.dim() != 2 or w.shape[0] != Fin or heads < 1 \
            or w.shape[1] % heads:
        raise ValueError(f"w must be [{Fin}, heads * C] with heads={heads}, "
                         f"got {tuple(w.shape)}")
    HC = w.shape[1]
    C = HC // heads
    out_w = HC if concat else C
    bf = torch.bfloat16
    wdt = bf if mode == "bf16" else torch.float32
    for name, t, shape, dt in (("w", w, (Fin, HC), wdt),
                               ("att_src", att_src, (1, heads, C), None),
                               ("att_dst", att_dst, (1, heads, C), None),
                               ("bias", bias, (out_w,), None),
                               ("skip", skip, (N, out_w), None),
                               ("wa_src", wa_src, (Fin, heads), bf),
                               ("wa_dst", wa_dst, (Fin, heads), bf),
                               ("self_extra", self_extra, (N, heads), None)):
        dt = dt or torch.float32
        if t is not None and (tuple(t.shape) != shape or t.dtype != dt):
            raise ValueError(f"{name} must be {shape} {dt} in mode "
                             f"{mode!r}, got {tuple(t.shape)} {t.dtype}")
    if (wa_src is None or wa_dst is None) != (mode == "f32"):
        raise ValueError(f"wa_src and wa_dst go with mode 'bf16' "
                         f"(prepare_block); got mode {mode!r}")
    if (block_adj.dim() != 3 or block_adj.shape[1] != block_adj.shape[2]
            or block_adj.shape[0] * block_adj.shape[1] != N):
        raise ValueError(f"block_adj must be [N / B, B, B] with N={N}")
    T, B = block_adj.shape[:2]
    if edge_table is not None and (
            tuple(edge_table.shape) != (T, heads, B, B)
            or edge_table.dtype != torch.float32):
        raise ValueError(f"edge_table must be {(T, heads, B, B)} float32, "
                         f"got {tuple(edge_table.shape)} {edge_table.dtype}")
    if self_extra is not None and edge_table is None:
        raise ValueError("self_extra goes with edge_table")
    devs = {t.device for t in (x, block_adj, w, att_src, att_dst, bias,
                               skip, wa_src, wa_dst, edge_table, self_extra)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, block_adj, w, att_src, att_dst, bias, heads, neg_slope,
            self_loops, skip, act, concat, mode, wa_src, wa_dst, edge_table,
            self_extra, staged):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    N, Fin = x.shape
    HC = w.shape[1]
    C = HC // heads
    dev = x.device
    rows = lib.gnnb_gat_block_rows()
    if block_adj.shape[1] != rows or block_adj.dtype != torch.float32:
        raise ValueError(f"the CUDA GAT block layer takes float32 blocks of "
                         f"{rows} rows; got {tuple(block_adj.shape)} "
                         f"{block_adj.dtype}")
    if staged is None:
        staged = stage_projection(w, heads, mode, wa_src, wa_dst)
    _staged_ok(staged, Fin, heads, C, mode, mode == "bf16", dev)
    if edge_table is not None and self_extra is None:
        self_extra = x.new_zeros((N, heads))
    ops = [t for t in (x, block_adj, att_src, att_dst, bias, skip,
                       edge_table, self_extra)
           if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("all inputs must be contiguous")
    if block_adj.data_ptr() % 16 or staged.data_ptr() % 16:
        raise ValueError("block_adj and staged must be 16-byte aligned")
    fn = lib.gnnb_gat_block
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 2 + [I] * 4 + [P, ctypes.c_longlong] + [P] * 4 + \
        [ctypes.c_float, I, I, I, I] + [P] * 4 + [I]
    out = torch.empty((N, HC if concat else C), dtype=torch.float32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), block_adj.data_ptr(), N, Fin, heads, C,
             staged.data_ptr(), staged.numel() * staged.element_size(),
             att_src.data_ptr(), att_dst.data_ptr(),
             bias.data_ptr(), None if skip is None else skip.data_ptr(),
             float(neg_slope), int(bool(self_loops)), int(bool(concat)),
             GAT_ACTS[act], MODES[mode],
             None if edge_table is None else edge_table.data_ptr(),
             None if self_extra is None else self_extra.data_ptr(),
             out.data_ptr(), stream, dev.index or 0)
    if err != 0:
        raise RuntimeError(f"gat_block launch failed: cudaError {err}")
    fused_gat_block_layer.launches += 1
    fused_gat_block_layer.mode_launches[mode] += 1
    if edge_table is not None:
        fused_gat_block_layer.edge_launches[mode] += 1
    return out


def fused_gat_block_layer(x, block_adj, w, att_src, att_dst, bias,
                          heads: int, neg_slope: float = 0.2,
                          self_loops: bool = True, skip=None,
                          act: Optional[str] = None, concat: bool = True,
                          mode: str = "f32", wa_src=None, wa_dst=None,
                          edge_table=None, self_extra=None, staged=None):
    """One GAT layer (module docstring) on x [N, Fin] float32 over
    ``block_adj`` [N / 128, 128, 128] float32 edge counts, with w [Fin,
    H*C], att_src and att_dst [1, H, C], bias and skip of the output
    width (H*C with ``concat``, else C); in mode "bf16" ``w``, ``wa_src``
    and ``wa_dst`` as ``prepare_block`` gives them; with edge features
    ``edge_table`` [N / 128, H, 128, 128] and ``self_extra`` [N, H] (0
    when None).  A CUDA ``x`` launches the kernel, which takes any width
    and raises on what it does not take (and on inputs that need a
    gradient: it has no backward), on ``staged`` =
    ``gat_layer.stage_projection(w, heads, mode, wa_src, wa_dst)`` (made
    here when None; under "bf16" with the logit tile); a CPU ``x`` runs
    the plain version."""
    ops = [None if t is None else t.contiguous()
           for t in (x, w, att_src, att_dst, bias, skip, edge_table,
                     self_extra)]
    x, w, att_src, att_dst, bias, skip, edge_table, self_extra = ops
    _check(x, block_adj, w, att_src, att_dst, bias, heads, skip, act, concat,
           mode, wa_src, wa_dst, edge_table, self_extra)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ops)
    if grad and mode != "f32":
        raise ValueError(f"mode {mode!r} is an inference mode: no backward")
    if x.device.type == "cuda":
        if grad:
            raise ValueError("the CUDA GAT block layer has no backward: "
                             "run it under torch.no_grad()")
        return _launch(x, block_adj, w, att_src, att_dst, bias, heads,
                       neg_slope, self_loops, skip, act, concat, mode,
                       wa_src, wa_dst, edge_table, self_extra, staged)
    if x.device.type != "cpu":
        raise ValueError(f"no GAT block layer for device {x.device}")
    return gat_block_layer_plain(x, block_adj, w, att_src, att_dst, bias,
                                 heads, neg_slope, self_loops, skip, act,
                                 concat, mode, wa_src, wa_dst, edge_table,
                                 self_extra)


fused_gat_block_layer.launches = 0
fused_gat_block_layer.mode_launches = dict.fromkeys(MODES, 0)
# the launches in the edge-logit mode, per mode (also in the counts above)
fused_gat_block_layer.edge_launches = dict.fromkeys(MODES, 0)

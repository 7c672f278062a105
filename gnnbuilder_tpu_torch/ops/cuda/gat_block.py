"""One GAT layer on a block-packed batch, inference only:
``fused_gat_block_layer`` launches ``csrc/gat_block.cu`` for CUDA tensors
and runs ``gat_block_layer_plain``, the same function in plain torch, for
CPU tensors.

It replaces the TPU kernel ``gnnbuilder_tpu/ops/pallas/gat_block.py``
``fused_gat_block_layer`` (without its edge-logit mode; it has no int8
mode); the plain version is that file's ``_reference``: h = x W, per
head a_src = h . att_src and a_dst = h . att_dst, then
``ops.block.block_gat_attention``
over the block adjacency's edge counts (k parallel edges give k equal
softmax terms), heads concatenated ([N, H*C]) or averaged ([N, C]), then
bias, skip (before the activation) and the activation.  Like the TPU
kernel it serves inference: GATConv takes it under inference scope only,
and training keeps the windowed layer kernel (``ops.cuda.gat_layer``).

The bf16 mode (``mode="bf16"``, the JAX kernel's ``mm="bf16"``):
bfloat16 ``w``; h = bf16(x) w; the logit terms formed as the JAX kernel
forms them, a_src = bf16(x) wa_src with wa_src = bf16(bf16(w) A_src)
per head (``prepare_block``), not as h . att_src (in bf16 the two orders
differ, and the difference goes through exp); the weighted sum of h over
the neighbours with both the softmax weights and h rounded to bf16,
while the denominator, the self term and the bias stay float32.

What bounds it on the H100: operations (the projection); see the source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.block import block_gat_attention
from gnnbuilder_tpu_torch.ops.cuda.gat_layer import GAT_ACTS
from gnnbuilder_tpu_torch.ops.quant import to_bf16

__all__ = ["fused_gat_block_layer", "gat_block_layer_plain",
           "prepare_block", "MODES"]

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


def gat_block_layer_plain(x, block_adj, w, att_src, att_dst, bias,
                          heads: int, neg_slope: float = 0.2,
                          self_loops: bool = True, skip=None,
                          act: Optional[str] = None, concat: bool = True,
                          mode: str = "f32", wa_src=None, wa_dst=None):
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
                              bf16_sum=bf16)
    out = out.reshape(N, -1) if concat else out.mean(dim=1)
    out = out + bias
    if skip is not None:
        out = out + skip
    return out if act is None else ACTIVATIONS[act](out)


def _check(x, block_adj, w, att_src, att_dst, bias, heads, skip, act,
           concat, mode, wa_src, wa_dst):
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
                               ("wa_dst", wa_dst, (Fin, heads), bf)):
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
    devs = {t.device for t in (x, block_adj, w, att_src, att_dst, bias,
                               skip, wa_src, wa_dst) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, block_adj, w, att_src, att_dst, bias, heads, neg_slope,
            self_loops, skip, act, concat, mode, wa_src, wa_dst):
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
    smem = lib.gnnb_gat_block_smem_bytes(heads)
    smem_max = lib.gnnb_smem_per_block_optin(dev.index or 0)
    if smem > smem_max:
        raise ValueError(f"the CUDA GAT block layer takes heads within "
                         f"{smem_max} bytes of shared memory; got heads="
                         f"{heads} ({smem} bytes)")
    ops = [t for t in (x, block_adj, w, att_src, att_dst, bias, skip,
                       wa_src, wa_dst) if t is not None]
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("all inputs must be contiguous")
    if block_adj.data_ptr() % 16:
        raise ValueError("block_adj must be 16-byte aligned")
    fn = lib.gnnb_gat_block
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 2 + [I] * 4 + [P] * 5 + \
        [ctypes.c_float, I, I, I, I] + [P] * 7 + [I]
    f = torch.float32
    h = torch.empty((N, HC), dtype=f, device=dev)
    a_src = torch.empty((N, heads), dtype=f, device=dev)
    a_dst = torch.empty((N, heads), dtype=f, device=dev)
    out = torch.empty((N, HC if concat else C), dtype=f, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), block_adj.data_ptr(), N, Fin, heads, C,
             w.data_ptr(), att_src.data_ptr(), att_dst.data_ptr(),
             bias.data_ptr(), None if skip is None else skip.data_ptr(),
             float(neg_slope), int(bool(self_loops)), int(bool(concat)),
             GAT_ACTS[act], MODES[mode],
             None if wa_src is None else wa_src.data_ptr(),
             None if wa_dst is None else wa_dst.data_ptr(), h.data_ptr(),
             a_src.data_ptr(), a_dst.data_ptr(), out.data_ptr(), stream,
             dev.index or 0)
    if err != 0:
        raise RuntimeError(f"gat_block launch failed: cudaError {err}")
    fused_gat_block_layer.launches += 1
    fused_gat_block_layer.mode_launches[mode] += 1
    return out


def fused_gat_block_layer(x, block_adj, w, att_src, att_dst, bias,
                          heads: int, neg_slope: float = 0.2,
                          self_loops: bool = True, skip=None,
                          act: Optional[str] = None, concat: bool = True,
                          mode: str = "f32", wa_src=None, wa_dst=None):
    """One GAT layer (module docstring) on x [N, Fin] float32 over
    ``block_adj`` [N / 128, 128, 128] float32 edge counts, with w [Fin,
    H*C], att_src and att_dst [1, H, C], bias and skip of the output
    width (H*C with ``concat``, else C); in mode "bf16" ``w``, ``wa_src``
    and ``wa_dst`` as ``prepare_block`` gives them.  A CUDA ``x``
    launches the kernel, which takes any width and raises on what it does
    not take (and on inputs that need a gradient: it has no backward); a
    CPU ``x`` runs the plain version."""
    ops = [None if t is None else t.contiguous()
           for t in (x, w, att_src, att_dst, bias, skip)]
    x, w, att_src, att_dst, bias, skip = ops
    _check(x, block_adj, w, att_src, att_dst, bias, heads, skip, act, concat,
           mode, wa_src, wa_dst)
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
                       wa_src, wa_dst)
    if x.device.type != "cpu":
        raise ValueError(f"no GAT block layer for device {x.device}")
    return gat_block_layer_plain(x, block_adj, w, att_src, att_dst, bias,
                                 heads, neg_slope, self_loops, skip, act,
                                 concat, mode, wa_src, wa_dst)


fused_gat_block_layer.launches = 0
fused_gat_block_layer.mode_launches = dict.fromkeys(MODES, 0)

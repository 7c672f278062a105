"""One GAT layer on a block-packed batch, inference only:
``fused_gat_block_layer`` launches ``csrc/gat_block.cu`` for CUDA tensors
and runs ``gat_block_layer_plain``, the same function in plain torch, for
CPU tensors.

It replaces the TPU kernel ``gnnbuilder_tpu/ops/pallas/gat_block.py``
``fused_gat_block_layer`` (without its edge-logit and int8 modes); the
plain version is that file's ``_reference``: h = x W, per head a_src =
h . att_src and a_dst = h . att_dst, then ``ops.block.block_gat_attention``
over the block adjacency's edge counts (k parallel edges give k equal
softmax terms), heads concatenated ([N, H*C]) or averaged ([N, C]), then
bias, skip (before the activation) and the activation.  Like the TPU
kernel it serves inference: GATConv takes it under inference scope only,
and training keeps the windowed layer kernel (``ops.cuda.gat_layer``).

What bounds it on the H100: operations (the projection); see the source.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.block import block_gat_attention
from gnnbuilder_tpu_torch.ops.cuda.gat_layer import GAT_ACTS

__all__ = ["fused_gat_block_layer", "gat_block_layer_plain"]


def gat_block_layer_plain(x, block_adj, w, att_src, att_dst, bias,
                          heads: int, neg_slope: float = 0.2,
                          self_loops: bool = True, skip=None,
                          act: Optional[str] = None, concat: bool = True):
    """The layer in plain torch (``_reference``)."""
    N = x.shape[0]
    h = (x @ w).reshape(N, heads, -1)
    a_src = (h * att_src).sum(-1)
    a_dst = (h * att_dst).sum(-1)
    out = block_gat_attention(block_adj, h, a_src, a_dst,
                              neg_slope=neg_slope, self_loops=self_loops)
    out = out.reshape(N, -1) if concat else out.mean(dim=1)
    out = out + bias
    if skip is not None:
        out = out + skip
    return out if act is None else ACTIVATIONS[act](out)


def _check(x, block_adj, w, att_src, att_dst, bias, heads, skip, act,
           concat):
    if act not in GAT_ACTS:
        raise ValueError(f"unsupported GAT block activation {act!r}")
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
    for name, t, shape in (("att_src", att_src, (1, heads, C)),
                           ("att_dst", att_dst, (1, heads, C)),
                           ("bias", bias, (out_w,)),
                           ("skip", skip, (N, out_w))):
        if t is not None and (tuple(t.shape) != shape
                              or t.dtype != torch.float32):
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if (block_adj.dim() != 3 or block_adj.shape[1] != block_adj.shape[2]
            or block_adj.shape[0] * block_adj.shape[1] != N):
        raise ValueError(f"block_adj must be [N / B, B, B] with N={N}")
    devs = {t.device for t in (x, block_adj, w, att_src, att_dst, bias,
                               skip) if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, block_adj, w, att_src, att_dst, bias, heads, neg_slope,
            self_loops, skip, act, concat):
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
    ops = [x, block_adj, w, att_src, att_dst, bias] + (
        [] if skip is None else [skip])
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("all inputs must be contiguous")
    if block_adj.data_ptr() % 16:
        raise ValueError("block_adj must be 16-byte aligned")
    fn = lib.gnnb_gat_block
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 2 + [I] * 4 + [P] * 5 + [ctypes.c_float, I, I, I] + \
        [P] * 5 + [I]
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
             GAT_ACTS[act], h.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(),
             out.data_ptr(), stream, dev.index or 0)
    if err != 0:
        raise RuntimeError(f"gat_block launch failed: cudaError {err}")
    fused_gat_block_layer.launches += 1
    return out


def fused_gat_block_layer(x, block_adj, w, att_src, att_dst, bias,
                          heads: int, neg_slope: float = 0.2,
                          self_loops: bool = True, skip=None,
                          act: Optional[str] = None, concat: bool = True):
    """One GAT layer (module docstring) on x [N, Fin] float32 over
    ``block_adj`` [N / 128, 128, 128] float32 edge counts, with w [Fin,
    H*C], att_src and att_dst [1, H, C], bias and skip of the output
    width (H*C with ``concat``, else C).  A CUDA ``x`` launches the
    kernel, which takes any width and raises on what it does not take
    (and on inputs that need a gradient: it has no backward); a CPU ``x``
    runs the plain version."""
    ops = [None if t is None else t.contiguous()
           for t in (x, w, att_src, att_dst, bias, skip)]
    x, w, att_src, att_dst, bias, skip = ops
    _check(x, block_adj, w, att_src, att_dst, bias, heads, skip, act, concat)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in ops):
            raise ValueError("the CUDA GAT block layer has no backward: "
                             "run it under torch.no_grad()")
        return _launch(x, block_adj, w, att_src, att_dst, bias, heads,
                       neg_slope, self_loops, skip, act, concat)
    if x.device.type != "cpu":
        raise ValueError(f"no GAT block layer for device {x.device}")
    return gat_block_layer_plain(x, block_adj, w, att_src, att_dst, bias,
                                 heads, neg_slope, self_loops, skip, act,
                                 concat)


fused_gat_block_layer.launches = 0

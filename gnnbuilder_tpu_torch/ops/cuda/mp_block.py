"""Whole GCN, GIN or SAGE conv stack in one kernel, on block-packed
batches.

``fused_mp_block_stack`` launches ``csrc/mp_block.cu`` for CUDA tensors
and runs ``mp_stack_plain``, the same function in plain torch, for CPU
tensors.  It replaces the TPU kernel
``gnnbuilder_tpu/ops/pallas/mp_block.py`` ``mp_block_stack``; the plain
version is that file's ``mp_stack_reference``.  The kernel aggregates
from the block adjacency ``block_adj``, not the ELL table, so it takes
every block-packed batch, a hub over the ELL width included.

What bounds it on the H100: operations (1 or 2 F x F products per row and
layer, run as f32 FMAs); see the source for the layout.

Weights use the JAX package's [in, out] layout, stacked over layers and
zero-padded to one width F (``stack_mp_params``): per conv ``(w0, b0, w1,
b1)`` = gcn ``(lin, bias, 0, 0)``, gin ``(lin0, lin0.b, lin1, lin1.b)``,
sage ``(lin_l, lin_l.b, lin_r, 0)``.  Biases are [L, F].
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from gnnbuilder_tpu_torch.ops.activations import ACTIVATIONS
from gnnbuilder_tpu_torch.ops.block import block_spmm
from gnnbuilder_tpu_torch.ops.cuda.pna_block import _pad2

__all__ = ["fused_mp_block_stack", "mp_stack_plain", "mp_block_stack_auto",
           "stack_mp_params", "CONV_CODES", "STACK_ACTS"]

# the convs the kernel takes, with their codes in the source
CONV_CODES = {"gcn": 0, "gin": 1, "sage": 2}
# epilogue activations the kernel takes, with their codes in the source
STACK_ACTS = {None: 0, "relu": 1, "gelu": 2, "sigmoid": 3, "tanh": 4}


def _act(name):
    return (lambda t: t) if name is None else ACTIVATIONS[name]


def mp_stack_plain(x, block_adj, in_degree, w0, b0, w1, b1, conv, epss,
                   skips, act=None):
    """The stack in plain torch: the per-layer math of the convs'
    block-aggregation paths, iterated (the JAX ``mp_stack_reference``)."""
    degf = in_degree.to(x.dtype)[:, None]
    f = _act(act)
    h = x
    for l in range(w0.shape[0]):
        if conv == "gcn":
            dis = torch.rsqrt(degf + 1.0)
            p = (h @ w0[l]) * dis
            o = dis * (block_spmm(block_adj, p) + p) + b0[l]
        elif conv == "gin":
            hh = (1.0 + epss[l]) * h + block_spmm(block_adj, h)
            o = torch.relu(hh @ w0[l] + b0[l]) @ w1[l] + b1[l]
        else:
            mean = block_spmm(block_adj, h) / degf.clamp(min=1.0)
            o = mean @ w0[l] + b0[l] + h @ w1[l]
        if skips[l]:
            o = o + h
        h = f(o)
    return h


def _check(x, block_adj, in_degree, w0, b0, w1, b1, conv, epss, skips, act,
           block_size):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [N, F] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    N, F = x.shape
    L = w0.shape[0]
    for name, t, shape in (("w0", w0, (L, F, F)), ("b0", b0, (L, F)),
                           ("w1", w1, (L, F, F)), ("b1", b1, (L, F))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if block_size < 1 or N % block_size:
        raise ValueError(f"N={N} is not a multiple of block_size="
                         f"{block_size}")
    if tuple(block_adj.shape) != (N // block_size, block_size, block_size):
        raise ValueError(f"block_adj must be [{N // block_size}, "
                         f"{block_size}, {block_size}]")
    if tuple(in_degree.shape) != (N,):
        raise ValueError("in_degree must be [N]")
    if conv not in CONV_CODES:
        raise ValueError(f"unsupported stack conv {conv!r}; options: "
                         f"{sorted(CONV_CODES)}")
    if len(epss) != L or len(skips) != L:
        raise ValueError("need one eps and one skip flag per layer")
    if act not in STACK_ACTS:
        raise ValueError(f"unsupported stack activation {act!r}")
    devs = {t.device for t in (x, block_adj, in_degree, w0, b0, w1, b1)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _launch(x, block_adj, in_degree, w0, b0, w1, b1, conv, epss, skips, act,
            block_size):
    from gnnbuilder_tpu_torch.ops.cuda._build import load

    lib = load()
    rows = lib.gnnb_mp_block_rows()
    mult = lib.gnnb_mp_block_width_multiple()
    max_layers = lib.gnnb_mp_block_max_layers()
    N, F = x.shape
    L = w0.shape[0]
    dev = x.device.index or 0
    smem = lib.gnnb_mp_block_smem_bytes(F)
    smem_max = lib.gnnb_smem_per_block_optin(dev)
    if (block_size != rows or F % mult or L > max_layers
            or smem > smem_max):
        raise ValueError(
            f"the CUDA mp stack takes block_size={rows}, widths that are "
            f"multiples of {mult} within {smem_max} bytes of shared memory "
            f"and at most {max_layers} layers; got block_size={block_size} "
            f"F={F} ({smem} bytes) L={L}")
    if in_degree.dtype != torch.int32 or block_adj.dtype != torch.float32:
        raise ValueError("in_degree must be int32 and block_adj float32")
    tensors = (x, block_adj, in_degree, w0, b0, w1, b1)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("all inputs must be 16-byte aligned")
    fn = lib.gnnb_mp_block_stack
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([P] * 3 + [I] * 2 + [P] * 4 + [I] * 2
                   + [ctypes.POINTER(ctypes.c_float),
                      ctypes.POINTER(ctypes.c_int), I, P, P, P, I])
    out = torch.empty_like(x)
    # T of the wider widths lives in device memory, one row per node
    scratch = (None if lib.gnnb_mp_block_ht_in_smem(F, dev) == 1
               else torch.empty_like(x))
    c_eps = (ctypes.c_float * L)(*[float(e) for e in epss])
    c_skips = (ctypes.c_int * L)(*[int(bool(s)) for s in skips])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), block_adj.data_ptr(), in_degree.data_ptr(), N, F,
             w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), L,
             CONV_CODES[conv], c_eps, c_skips, STACK_ACTS[act],
             out.data_ptr(), None if scratch is None else scratch.data_ptr(),
             stream, dev)
    if err != 0:
        raise RuntimeError(f"mp_block_stack launch failed: cudaError {err}")
    fused_mp_block_stack.launches += 1
    return out


def fused_mp_block_stack(x, block_adj, in_degree, w0, b0, w1, b1, conv: str,
                         epss: Sequence[float], skips: Sequence[bool],
                         act: Optional[str] = None, block_size: int = 128):
    """Run the whole L-layer GCN, GIN or SAGE stack.

    x [N, F] float32; block_adj [N / block_size, block_size, block_size]
    float32 edge counts; in_degree [N] int32; w0, w1 [L, F, F]; b0, b1
    [L, F]; one eps (GIN) and one skip flag per layer.  A CUDA ``x``
    launches the kernel, which takes 128-row blocks and F a multiple of
    128 and raises on anything else; a CPU ``x`` runs the plain version.
    Returns h [N, F]."""
    _check(x, block_adj, in_degree, w0, b0, w1, b1, conv, epss, skips, act,
           block_size)
    if x.device.type == "cuda":
        return _launch(x, block_adj, in_degree, w0, b0, w1, b1, conv, epss,
                       skips, act, block_size)
    if x.device.type != "cpu":
        raise ValueError(f"no mp stack for device {x.device}")
    return mp_stack_plain(x, block_adj, in_degree, w0, b0, w1, b1, conv,
                          epss, skips, act)


fused_mp_block_stack.launches = 0


def stack_mp_params(layers, F_p: int):
    """Per-layer ``(w0, b0, w1, b1)`` in [in, out] layout, any widths, None
    for an operand the conv lacks, into uniform zero-padded stacked
    operands (w0 [L, F_p, F_p], b0 [L, F_p], w1, b1).  Pad lanes are inert:
    padded weight ROWS are zero, so whatever pad lanes of h carry adds
    nothing to real lanes, and pad output columns are sliced off by the
    caller."""
    out = [[] for _ in range(4)]
    for layer in layers:
        for k, t in enumerate(layer):
            if t is None:
                shape = (F_p, F_p) if k % 2 == 0 else (F_p,)
                ref = next(u for u in layer if u is not None)
                out[k].append(ref.new_zeros(shape))
            elif t.dim() == 2:
                out[k].append(_pad2(t, F_p, F_p))
            else:
                out[k].append(torch.nn.functional.pad(t, (0, F_p - len(t))))
    return tuple(torch.stack(xs).contiguous() for xs in out)


def mp_block_stack_auto(x, block_adj, in_degree, conv, stacked, epss, skips,
                        act=None, out_dim: Optional[int] = None,
                        block_size: int = 128):
    """``fused_mp_block_stack`` on ``x`` of any width <= F: zero-pads x to
    the stacked width F and returns the first ``out_dim`` columns."""
    F_p = stacked[0].shape[2]
    xp = torch.nn.functional.pad(x, (0, F_p - x.shape[1])).contiguous()
    out = fused_mp_block_stack(xp, block_adj, in_degree, *stacked, conv=conv,
                               epss=epss, skips=skips, act=act,
                               block_size=block_size)
    return out if out_dim is None else out[:, :out_dim]

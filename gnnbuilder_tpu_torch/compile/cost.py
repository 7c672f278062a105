"""The work of one forward, counted from shapes (``Program.cost_analysis``).

The JAX package reads FLOPs and bytes from XLA's analysis of the
compiled program.  Here the kernels are ctypes launches that no tracer
sees, so the count is made from the model's widths and the batch's
shapes, and it is the same whichever route computes the forward (the
kernels or the plain path, the card or the CPU).

Notation: N the batch's node rows, Ep its edge rows, E its real edges
(``edge_mask``), G its graphs; Fi and Fo a layer's input and output
widths (the model's own, no lane padding); GAT: H heads of C channels.

``flops``:
  * every product of an [m, k] operand with a [k, n] weight is 2 m k n,
    over the batch's N node rows (Ep edge rows for an edge Linear; E real
    edges for EdgeConv's per-message lin1);
  * every aggregation counts one operation per real edge, feature and
    aggregator, and a message formed per edge its own operations per
    edge and feature (PNA's u_i + v_j: 1; GINE's x_j + e_ij and ReLU: 2;
    EdgeConv's w_i + v_j and ReLU: 2; GAT per head its logit and its
    softmax sum, 2, and its weighted sum, C, over the real edges and,
    with self loops, one slot per node);
  * pooling one operation per node row, feature and aggregator; the MLP
    head 2 G in out per Linear;
  * row-wise elementwise work (biases, norms, scalers, skips,
    activations) is not counted.
  gcn 2 N Fi Fo + E Fo; gin 2 N (Fi Fo + Fo Fo) + E Fi; sage 4 N Fi Fo
  + E Fi; lg, simple E F; pna 4 N Fi Fi + 2 N (Fi + A S Fi) Fo + 2 N Fo Fo
  + E Fi (1 + A) (A aggregators, S scalers); gine 2 Ep De Fi + 2 N (Fi
  Fo + Fo Fo) + 3 E Fi; edge 4 N Fi Fo + 2 E Fo Fo + 3 E Fo; gat 2 N Fi
  H C + 4 N H C + (E [+ N]) H (C + 2), with edge features also 2 Ep De H
  C + 2 Ep H C + E De + 2 N De H C + 2 N H C + (E [+ N]) H.

``bytes accessed`` (the analog of XLA's unfused traffic): each layer reads
its inputs once and writes its output once.  A layer is a conv, the
pooling, or one MLP Linear.  A conv reads x [N, Fi], the real edges'
sender ids and the in-degrees (4 (E + N)), the edge features where it
uses them, the skip [N, Fo] where it adds one, and its parameters; it
writes [N, out width].  The pooling reads [N, F] and the graphs' row
counts and starts (8 G) and writes [G, A F].  A Linear reads [G, in] and
its parameters and writes [G, out].  Activations take 2 bytes a value
under bf16, else 4; the output and the edge features 4.  Parameters take
4 bytes a value under f32, 2 under bf16; under int8 a Linear's weight 1
byte a value and a float32 scale per output column, other parameters 4.
Under bf16 and int8 ``flops`` stays the same.

These rules differ from the per-kernel bounds of ``chip_smoke.py``,
which count a kernel's 128-lane padding and its own operands.
"""

from __future__ import annotations

import torch

__all__ = ["forward_cost"]

_ACT_BYTES = {"f32": 4, "bf16": 2, "int8": 4}


def _param_bytes(module: torch.nn.Module, policy: str) -> int:
    n = 0
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if policy == "bf16":
                n += 2 * p.numel()
            elif (policy == "int8" and name == "weight"
                  and isinstance(mod, torch.nn.Linear)):
                n += p.numel() + 4 * p.shape[0]
            else:
                n += 4 * p.numel()
    return n


def _conv_flops(conv, kind: str, N: int, Ep: int, E: int) -> int:
    Fi, Fo = conv.in_channels, conv.out_channels
    if kind == "gcn":
        return 2 * N * Fi * Fo + E * Fo
    if kind == "gin":
        return 2 * N * (Fi * Fo + Fo * Fo) + E * Fi
    if kind == "sage":
        return 4 * N * Fi * Fo + E * Fi
    if kind in ("lg", "simple"):
        return E * Fi
    if kind == "pna":
        A, S = len(conv.aggregators), len(conv.scalers)
        return (4 * N * Fi * Fi + 2 * N * (Fi + A * S * Fi) * Fo
                + 2 * N * Fo * Fo + E * Fi * (1 + A))
    if kind == "gine":
        De = conv.edge_dim
        return (2 * Ep * De * Fi + 2 * N * (Fi * Fo + Fo * Fo)
                + 3 * E * Fi)
    if kind == "edge":
        return 4 * N * Fi * Fo + 2 * E * Fo * Fo + 3 * E * Fo
    if kind == "gat":
        H, C = conv.heads, conv.out_channels
        slots = E + (N if conv.add_self_loops else 0)
        n = 2 * N * Fi * H * C + 4 * N * H * C + slots * H * (C + 2)
        if conv.edge_dim is not None:
            De = conv.edge_dim
            n += (2 * Ep * De * H * C + 2 * Ep * H * C + E * De
                  + 2 * N * De * H * C + 2 * N * H * C + slots * H)
        return n
    raise ValueError(f"no cost rule for conv {kind!r}")


def forward_cost(model, batch, policy: str = "f32") -> dict:
    """{"flops", "bytes accessed"} of one forward of ``model`` on
    ``batch`` under the precision ``policy`` ("f32", "bf16" or "int8"),
    by the rules of the module docstring."""
    N, Ep, G = batch.num_nodes, batch.num_edges, batch.num_graphs
    E = int(batch.edge_mask.sum())
    a = _ACT_BYTES[policy]
    edge_w = (0 if batch.edge_feat is None
              else 4 * batch.edge_feat.numel())
    L = model.gnn_num_layers
    flops = nbytes = 0
    for i, conv in enumerate(model.gnn_convs):
        flops += _conv_flops(conv, model.gnn_conv, N, Ep, E)
        width = model._width(conv.out_channels)
        reads_edges = getattr(conv, "edge_dim", None) is not None
        skip = model.gnn_skip_connection and 0 < i < L - 1
        nbytes += (a * N * conv.in_channels + 4 * (E + N)
                   + (edge_w if reads_edges else 0)
                   + (a * N * width if skip else 0)
                   + _param_bytes(conv, policy) + a * N * width)
    F = model._width(model.gnn_output_dim)
    A = len(model.pooling_aggrs)
    flops += A * N * F
    nbytes += a * N * F + 8 * G + a * G * A * F
    lins = list(model.mlp_head.linear_layers)
    for j, lin in enumerate(lins):
        flops += 2 * G * lin.in_features * lin.out_features
        out_b = 4 if j == len(lins) - 1 else a
        nbytes += (a * G * lin.in_features + _param_bytes(lin, policy)
                   + out_b * G * lin.out_features)
    return {"flops": float(flops), "bytes accessed": float(nbytes)}

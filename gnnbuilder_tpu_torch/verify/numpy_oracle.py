"""Independent from-the-equations oracles for GAT and EdgeConv.

The seven reference convs are pinned to the reference repo's real PyG
golden binaries (tests/test_reference_fixtures.py); GAT and EdgeConv have
no such fixture because the reference never implemented them
(gnn_builder_lib.h:2343 "// TODO: GAT layer"; :2636-2703 commented-out
EdgeConv skeleton).  Their parity chain previously bottomed out in this
repo's own ``verify.torch_ref`` derivation of PyG semantics — a
self-referential loop.  This module is the third, independently written
implementation that breaks it:

* written directly from the papers' equations —
  GAT: Velickovic et al., "Graph Attention Networks", ICLR 2018, eqs.
  (1)-(6) (the two-slice form a^T [W x_i || W x_j] = a_dst.Wx_i +
  a_src.Wx_j), plus the two conventions PyG documents on top of the
  paper (torch_geometric.nn.GATConv docs): a self loop is added per node
  (existing self loops replaced), and with edge features the self-loop
  attribute is the mean of the receiver's incoming real-edge attributes
  (fill_value="mean");
  EdgeConv: Wang et al., "Dynamic Graph CNN for Learning on Point
  Clouds", TOG 2019, eq. (7) with the asymmetric edge function
  h(x_i, x_j - x_i) and max aggregation.
* deliberately NAIVE: plain Python loops over edges and per-receiver
  dicts — no scatter, no segment trick, no broadcasting cleverness — so
  it cannot share a vectorization bug with either torch_ref (scatter
  ops) or the JAX layers (segment/Pallas ops).

Weights come in as plain numpy arrays in the paper's orientation
(W: [in, out] so x @ W).  The JAX package's tests hold this oracle,
verify.torch_ref and the layers to each other at 1e-3 on seeded ER
graphs, the reference's networkx cross-check pattern
(gen_test_data.py:129-173).  This is the port's own copy of the JAX
package's ``verify/numpy_oracle.py``, line for line below this
docstring, so the two give the same outputs bit for bit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gat_conv_oracle", "edge_conv_oracle"]


def _leaky_relu(x: np.ndarray, slope: float) -> np.ndarray:
    return np.where(x > 0, x, slope * x)


def gat_conv_oracle(
    x: np.ndarray,              # [N, Fin]
    edge_index: np.ndarray,     # [2, E] int, row 0 = source j, row 1 = target i
    W: np.ndarray,              # [Fin, H*C] shared linear (paper's W, per head)
    att_src: np.ndarray,        # [H, C] a_src (applied to W x_j)
    att_dst: np.ndarray,        # [H, C] a_dst (applied to W x_i)
    bias: np.ndarray,           # [H*C] (concat) or [C] (mean)
    heads: int,
    out_channels: int,
    concat: bool = True,
    negative_slope: float = 0.2,
    edge_attr: np.ndarray | None = None,   # [E, Fe]
    W_edge: np.ndarray | None = None,      # [Fe, H*C]
    att_edge: np.ndarray | None = None,    # [H, C]
) -> np.ndarray:
    """GAT forward per the paper, one edge at a time.

    Paper eq. (3)/(6): alpha_ij = softmax_j LeakyReLU(
    a^T [W x_i || W x_j]); x_i' = sum_j alpha_ij W x_j, heads
    concatenated (eq. 5) or averaged (eq. 6).
    """
    n = x.shape[0]
    H, C = heads, out_channels
    h = (x.astype(np.float64) @ W.astype(np.float64)).reshape(n, H, C)

    # edge list with PyG's documented self-loop convention: drop existing
    # self loops, append one per node
    edges: list[tuple[int, int, int]] = []  # (j, i, original edge id or -1)
    for e in range(edge_index.shape[1]):
        j, i = int(edge_index[0, e]), int(edge_index[1, e])
        if j != i:
            edges.append((j, i, e))
    for v in range(n):
        edges.append((v, v, -1))

    # per-edge attribute (self loop -> mean of receiver's incoming attrs)
    attrs: dict[int, np.ndarray] = {}
    if edge_attr is not None:
        fe = edge_attr.shape[1]
        acc = [np.zeros(fe, np.float64) for _ in range(n)]
        cnt = [0] * n
        for j, i, e in edges:
            if e >= 0:
                acc[i] += edge_attr[e].astype(np.float64)
                cnt[i] += 1
        for k, (j, i, e) in enumerate(edges):
            if e >= 0:
                attrs[k] = edge_attr[e].astype(np.float64)
            else:
                attrs[k] = acc[i] / max(cnt[i], 1)

    # raw attention logits, one edge at a time (paper eq. 1/3 + PyG's
    # edge-feature extension: + a_edge . (W_edge e_ij))
    logits = np.zeros((len(edges), H), np.float64)
    for k, (j, i, e) in enumerate(edges):
        for hh in range(H):
            val = float(np.dot(att_src[hh], h[j, hh])) + float(
                np.dot(att_dst[hh], h[i, hh])
            )
            if edge_attr is not None:
                ep = (attrs[k] @ W_edge.astype(np.float64)).reshape(H, C)
                val += float(np.dot(att_edge[hh], ep[hh]))
            logits[k, hh] = val
    logits = _leaky_relu(logits, negative_slope)

    # softmax over each receiver's incoming edges (paper eq. 2), then the
    # attention-weighted sum (paper eq. 4)
    out = np.zeros((n, H, C), np.float64)
    for i in range(n):
        ks = [k for k, (j, ii, e) in enumerate(edges) if ii == i]
        if not ks:
            continue
        for hh in range(H):
            ls = np.array([logits[k, hh] for k in ks])
            ls = np.exp(ls - ls.max())
            alpha = ls / ls.sum()
            for a, k in zip(alpha, ks):
                out[i, hh] += a * h[edges[k][0], hh]

    if concat:
        res = out.reshape(n, H * C)
    else:
        res = out.mean(axis=1)
    return (res + bias.astype(np.float64)).astype(np.float32)


def edge_conv_oracle(
    x: np.ndarray,              # [N, F]
    edge_index: np.ndarray,     # [2, E]
    W0: np.ndarray,             # [2F, Fout]
    b0: np.ndarray,             # [Fout]
    W1: np.ndarray,             # [Fout, Fout]
    b1: np.ndarray,             # [Fout]
    aggregation: str = "max",
) -> np.ndarray:
    """EdgeConv per DGCNN eq. (7): x_i' = aggr_j h_Theta(x_i, x_j - x_i)
    with h = Linear -> ReLU -> Linear on [x_i || x_j - x_i].

    Empty neighborhoods produce 0 (the PyG scatter fill the whole
    framework standardizes on)."""
    n = x.shape[0]
    xd = x.astype(np.float64)
    per_recv: dict[int, list[np.ndarray]] = {i: [] for i in range(n)}
    for e in range(edge_index.shape[1]):
        j, i = int(edge_index[0, e]), int(edge_index[1, e])
        feat = np.concatenate([xd[i], xd[j] - xd[i]])
        y = feat @ W0.astype(np.float64) + b0.astype(np.float64)
        y = np.maximum(y, 0.0)
        y = y @ W1.astype(np.float64) + b1.astype(np.float64)
        per_recv[i].append(y)

    fout = W1.shape[1]
    out = np.zeros((n, fout), np.float64)
    for i in range(n):
        ys = per_recv[i]
        if not ys:
            continue
        stack = np.stack(ys)
        if aggregation in ("sum", "add"):
            out[i] = stack.sum(axis=0)
        elif aggregation == "mean":
            out[i] = stack.mean(axis=0)
        elif aggregation == "max":
            out[i] = stack.max(axis=0)
        else:
            raise ValueError(aggregation)
    return out.astype(np.float32)

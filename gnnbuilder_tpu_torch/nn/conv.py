"""Message-passing convs: GCN, GIN, GINE, SAGE, LG, Simple, PNA, GAT and
EdgeConv (the JAX package's ``nn/conv.py``, PyG semantics).  Each takes
``(g, x, act, skip)`` and returns ``[N, out_channels]``; the skip is
added before the activation.  Each takes the reference's parallelism
factors ``p_in`` / ``p_out`` (default 1) as metadata; they change no
computation.

GCN, GIN, SAGE, LG and Simple (sum, mean) run their layer through
``ops.cuda.mp_layer.fused_mp_layer_auto`` (the CUDA kernel on the card,
differentiable through its hand-written backward) where
``dispatch.mp_layer_cfg`` allows: over the ELL table on a standard-packed
batch, over the block adjacency for GCN, LG and Simple on a block-packed
one.  Otherwise they aggregate in plain torch with the block-diagonal
product on a block-packed batch (``dispatch.block_cfg``), else over the
ELL table, else over the edge list.  On a block-packed batch under
inference scope the model runs GCN and SAGE stacks through the mp stack
kernel instead (``nn/model.py``).

GCN: self loops added analytically, ``dis = rsqrt(in_degree + 1)``, the
normalised sum ``dis_i sum_j dis_j h_j + dis_i^2 h_i``; ``lin`` has no
bias, ``bias`` is added after aggregation; the plain path transforms
first only when ``out_channels <= in_channels``, the kernel path always.
GIN: ``lin1(relu(lin0((1 + eps) x + sum_j x_j)))``.  SAGE:
``lin_l(mean_j x_j) + lin_r(x)``, the mean over max(deg, 1); ``lin_l``
has a bias, ``lin_r`` none.  LG (LightGCN): ``sum_j x_j / sqrt(d_i d_j)``,
no self loops, 0 on an empty row.  Simple: the sum, mean, max or min of
the neighbour rows.  LG and Simple have no parameters and need
in_channels == out_channels.

Under a precision policy each kernel route above runs in the mode its
gate gives (``cfg["mode"]``, ``ops/dispatch.py``), with the conv's
float32 weights brought to that mode per call.

Simple's max and min and PNA's aggregation outside its layer kernel take
the multi-aggregate kernel (``ops.cuda.ell_agg``, differentiable through
its hand-written backward) through ``_fused_multi`` where
``dispatch.agg_cfg`` allows and the batch takes no block product; on a
block-packed batch PNA takes the block product for sum, mean and std
(``ops.block.block_multi``) and the kernel for max and min, with the
receiver term u added after the reduction (it commutes with each).

GINE (edge features): ``lin1(relu(lin0((1 + eps) x + sum_j relu(x_j +
lin_edge(e_ij)))))``, through ``ops.cuda.gine_layer`` where
``dispatch.gine_layer_cfg`` allows, else over the ELL table (its edge
slots ``nbr_edges``) or the edge list.  EdgeConv: ``aggr_j lin1(relu(
lin0([x_i || x_j - x_i])))`` for aggr max, sum or mean, lin0 a PairLinear
(u - v at the receiver, v at the sender), through ``ops.cuda.edge_block``
under inference scope on a block-packed batch
(``dispatch.edge_block_cfg``), else over the ELL table or the edge list.

PNA with towers=1, divide_input=False, one pre and one post layer (PyG
semantics, the JAX package's ``nn/conv.py`` PNAConv): message
``pre_nn([x_i || x_j])``; aggregate with max/min/mean/std (or any of
sum, mean, max, min, std) over the ELL table; scale the concat by
identity, log(d+1)/delta and delta/log(d+1) with d clamped to >= 1;
``post_nn([x_i || scaled])``; then ``lin``.

With the default aggregators and scalers, and when ``dispatch.pna_layer_cfg``
allows, the layer runs through ``ops.cuda.pna_layer.fused_pna_layer_auto``
(the CUDA kernel on the card, differentiable through its hand-written
backward); otherwise through the plain torch ops below: over the ELL table, or over the edge list on
a batch that ships none (an in-degree over 64, or ``ell_width=0``).

GAT (PyG GATConv): per-edge logits ``leaky_relu(a_src_j + a_dst_i)``
with ``a = (x W) . att`` per head, a softmax over each receiver's incoming
edges and the analytic self loop, the attention-weighted sum of ``x W``,
heads concatenated or averaged, then ``bias``.  Its routes, in the JAX
package's order: the block attention kernel (``ops.cuda.gat_block``)
under inference scope on a block-packed batch (``dispatch.gat_block_cfg``);
the windowed layer kernel (``ops.cuda.gat_layer``, differentiable through
its hand-written backward) in concat mode on a batch with an ELL table
(``dispatch.gat_layer_cfg``); else plain: the block attention
(``ops.block.block_gat_attention``), the ELL table
(``ops.ell.ell_softmax_sum``) or the edge list.  With ``edge_dim`` (PyG
``GATConv(edge_dim=...)``) each logit gains ``att_edge . lin_edge(e_ij)``
before the leaky ReLU, and the self loop the same term of the mean of
the receiver's incoming edge features (PyG's ``fill_value="mean"``);
the block kernel takes it on batches without repeated pairs only, the
plain block attention never (the per-edge terms are not rank 1).
"""

from __future__ import annotations

from typing import Sequence

import torch

from gnnbuilder_tpu_torch.core.graph import GraphBatch
from gnnbuilder_tpu_torch.nn.linear import (
    BlockScaledLinear,
    Linear,
    PairLinear,
)
from gnnbuilder_tpu_torch.ops import block, dispatch, ell, segment
from gnnbuilder_tpu_torch.ops.activations import get_activation, leaky_relu
from gnnbuilder_tpu_torch.ops.quant import true_div

__all__ = ["GCNConv", "GINConv", "GINEConv", "SAGEConv", "LGConv",
           "SimpleConv", "PNAConv", "GATConv", "EdgeConv",
           "PNA_AGGREGATORS", "PNA_SCALERS", "SUPPORTED_GNN_CONVS"]

PNA_AGGREGATORS = ("max", "min", "mean", "std")
PNA_SCALERS = ("identity", "amplification", "attenuation")


def _finish(out, act, skip):
    """Skip add (before the activation), then the activation."""
    if skip is not None:
        out = out + skip
    if act is not None:
        out = get_activation(act)(out)
    return out


def _halo_on() -> bool:
    from gnnbuilder_tpu_torch.parallel.halo import active_halo

    return active_halo() is not None


def _mp_layer(g: GraphBatch, conv: str, v, act, skip, **operands):
    """The layer through the mp layer kernel when ``dispatch.mp_layer_cfg``
    gives a route for ``conv``, else None (the caller's plain path)."""
    cfg = dispatch.mp_layer_cfg(g, conv.split("_")[0])
    if cfg is None:
        return None
    from gnnbuilder_tpu_torch.ops.cuda.mp_layer import fused_mp_layer_auto

    return fused_mp_layer_auto(
        v, g.nbr_nodes, g.in_degree, conv, skip=skip, act=act,
        rev_nbr_nodes=g.rev_nbr_nodes, out_degree=g.out_degree,
        block_adj=g.block_adj if cfg.get("block") else None,
        mode=cfg.get("mode", "f32"), **operands)


def _fused_multi(g: GraphBatch, aggregators, v, u=None):
    """The multi-aggregate kernel's [N, A*F] concat of ``aggregators`` of
    ``(u_i +) v_j`` (differentiable) when ``dispatch.agg_cfg`` allows and
    the batch takes no block product, else None (the caller's plain
    path), as the JAX package's ``_fused_multi``."""
    cfg = dispatch.agg_cfg(g)
    if dispatch.block_cfg(g) is not None or cfg is None:
        return None
    from gnnbuilder_tpu_torch.ops.cuda.ell_agg import fused_ell_aggregate_vjp

    return fused_ell_aggregate_vjp(
        v, g.nbr_nodes, g.in_degree, aggregators, u=u,
        rev_nbr_nodes=g.rev_nbr_nodes, out_degree=g.out_degree,
        mode=cfg.get("mode", "f32"))


def _sum(g: GraphBatch, x):
    """Sum of each node's incoming neighbour rows: block product, ELL
    table or edge list, in that order of preference."""
    cfg = dispatch.block_cfg(g)
    if cfg is not None:
        return block.block_sum(x, g.block_adj, mm=cfg.get("mm"))
    if g.nbr_nodes is not None:
        return ell.ell_sum(x, g.nbr_nodes, g.in_degree)
    return segment.segment_sum(x[g.senders.long()], g.receivers,
                               g.num_nodes)


class GCNConv(torch.nn.Module):
    def __init__(self, in_channels: int, out_channels: int, p_in: int = 1,
                 p_out: int = 1):
        super().__init__()
        self.p_in, self.p_out = p_in, p_out
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.lin = Linear(in_channels, out_channels, bias=False)
        self.bias = torch.nn.Parameter(torch.zeros(out_channels))

    def forward(self, g: GraphBatch, x, act=None, skip=None):
        dis = torch.rsqrt(g.in_degree.to(x.dtype) + 1.0)[:, None]
        if dispatch.mp_layer_cfg(g, "gcn") is not None:
            # as PyG: transform first, then propagate p_j = h_j dis_j
            return _mp_layer(g, "gcn", self.lin(x) * dis, act, skip,
                             b0=self.bias)
        transform_first = self.out_channels <= self.in_channels
        h = self.lin(x) if transform_first else x
        # separable norm 1/sqrt((1+d_i)(1+d_j)) = dis_i dis_j: scale once
        # per sender, sum, scale once per receiver
        agg = dis * _sum(g, h * dis)
        agg = agg + h * (dis * dis)        # self loop: norm_ii = 1/deg_i
        out = agg if transform_first else self.lin(agg)
        return _finish(out + self.bias, act, skip)


class GINConv(torch.nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 eps: float = 0.0, p_in: int = 1, p_out: int = 1):
        super().__init__()
        self.p_in, self.p_out = p_in, p_out
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.eps = float(eps)
        self.lin0 = Linear(in_channels, out_channels)
        self.lin1 = Linear(out_channels, out_channels)

    def forward(self, g: GraphBatch, x, act=None, skip=None):
        out = _mp_layer(g, "gin", x, act, skip, w0=self.lin0.weight.t(),
                        b0=self.lin0.bias, w1=self.lin1.weight.t(),
                        b1=self.lin1.bias, eps=self.eps)
        if out is not None:
            return out
        h = (1.0 + self.eps) * x + _sum(g, x)
        return _finish(self.lin1(torch.relu(self.lin0(h))), act, skip)


class SAGEConv(torch.nn.Module):
    def __init__(self, in_channels: int, out_channels: int, p_in: int = 1,
                 p_out: int = 1):
        super().__init__()
        self.p_in, self.p_out = p_in, p_out
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.lin_l = Linear(in_channels, out_channels)
        self.lin_r = Linear(in_channels, out_channels, bias=False)

    def forward(self, g: GraphBatch, x, act=None, skip=None):
        out = _mp_layer(g, "sage", x, act, skip, w0=self.lin_l.weight.t(),
                        b0=self.lin_l.bias, w1=self.lin_r.weight.t())
        if out is not None:
            return out
        deg = g.in_degree.to(x.dtype)[:, None]
        agg = _sum(g, x) / deg.clamp(min=1.0)
        return _finish(self.lin_l(agg) + self.lin_r(x), act, skip)


class _SameWidth(torch.nn.Module):
    """A parameter-free conv whose output width is its input width."""

    def __init__(self, in_channels: int, out_channels: int, p_in: int = 1,
                 p_out: int = 1):
        super().__init__()
        self.p_in, self.p_out = p_in, p_out
        if in_channels != out_channels:
            raise ValueError(f"{type(self).__name__} requires in_channels "
                             f"== out_channels")
        self.in_channels = in_channels
        self.out_channels = out_channels


class LGConv(_SameWidth):
    def forward(self, g: GraphBatch, x, act=None, skip=None):
        deg = g.in_degree.to(x.dtype)[:, None]
        dis = torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1.0)),
                          x.new_zeros(()))
        out = _mp_layer(g, "lg", x * dis, act, skip)
        if out is not None:
            return out
        return _finish(dis * _sum(g, x * dis), act, skip)


class SimpleConv(_SameWidth):
    def __init__(self, in_channels: int, out_channels: int,
                 aggregation: str = "sum", p_in: int = 1, p_out: int = 1):
        super().__init__(in_channels, out_channels, p_in, p_out)
        if aggregation not in ("sum", "add", "mean", "max", "min"):
            raise ValueError(f"unknown aggregation {aggregation}")
        self.aggregation = aggregation

    def forward(self, g: GraphBatch, x, act=None, skip=None):
        name = "sum" if self.aggregation == "add" else self.aggregation
        if name in ("sum", "mean"):
            out = _mp_layer(g, f"simple_{name}", x, act, skip)
            if out is not None:
                return out
            bcfg = dispatch.block_cfg(g)
            if bcfg is not None:
                s = block.block_sum(x, g.block_adj, mm=bcfg.get("mm"))
                if name == "mean":
                    s = s / g.in_degree.to(x.dtype).clamp(min=1.0)[:, None]
                return _finish(s, act, skip)
        else:
            out = _fused_multi(g, (name,), x)
            if out is not None:
                return _finish(out, act, skip)
        if g.nbr_nodes is not None:
            fn = {"sum": ell.ell_sum, "mean": ell.ell_mean,
                  "max": ell.ell_max, "min": ell.ell_min}[name]
            return _finish(fn(x, g.nbr_nodes, g.in_degree), act, skip)
        msg = x[g.senders.long()]
        count = g.in_degree.to(x.dtype)[:, None]
        if name == "sum":
            out = segment.segment_sum(msg, g.receivers, g.num_nodes)
        else:
            fn = {"mean": segment.segment_mean, "max": segment.segment_max,
                  "min": segment.segment_min}[name]
            out = fn(msg, g.receivers, g.num_nodes, count=count)
        return _finish(out, act, skip)


class PNAConv(torch.nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 delta: float = 1.0,
                 aggregators: Sequence[str] = PNA_AGGREGATORS,
                 scalers: Sequence[str] = PNA_SCALERS, p_in: int = 1,
                 p_out: int = 1):
        super().__init__()
        self.p_in, self.p_out = p_in, p_out
        for a in aggregators:
            if a not in ("sum", "mean", "std", "max", "min"):
                raise ValueError(f"unknown aggregator {a}")
        for s in scalers:
            if s not in PNA_SCALERS:
                raise ValueError(f"unknown scaler {s}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.delta = float(delta)
        self.aggregators = tuple(aggregators)
        self.scalers = tuple(scalers)
        F = in_channels
        self.pre_nn = PairLinear(2 * F, F)
        self.post_nn = BlockScaledLinear(
            F + len(self.aggregators) * len(self.scalers) * F, out_channels)
        self.lin = Linear(out_channels, out_channels)

    def _weights(self):
        """(w_pre, b_pre, k_post, b_post, w_lin, b_lin) in [in, out]
        layout, as the layer kernel takes them."""
        return (self.pre_nn.weight.t(), self.pre_nn.bias,
                self.post_nn.weight.t(), self.post_nn.bias,
                self.lin.weight.t(), self.lin.bias)

    def forward(self, g: GraphBatch, x, act=None, skip=None, operands=None):
        """``operands``: ``pna_layer.layer_operands`` of this layer's
        ``_weights()`` in the active policy's mode, made by the caller
        (``GNNModel``: for all layers at once, from the live weights in a
        train step, cached under inference); without them the kernel path
        lays its weights out on the call."""
        if (self.aggregators == PNA_AGGREGATORS
                and self.scalers == PNA_SCALERS):
            cfg = dispatch.pna_layer_cfg(g, act)
            if cfg is not None:
                from gnnbuilder_tpu_torch.ops.cuda.pna_layer import (
                    fused_pna_layer_auto,
                )

                mode = cfg.get("mode", "f32")
                if operands is not None and operands["mode"] != mode:
                    operands = None
                return fused_pna_layer_auto(
                    x, g.nbr_nodes, g.in_degree, *self._weights(),
                    self.delta, skip=skip, act=act,
                    rev_nbr_nodes=g.rev_nbr_nodes, out_degree=g.out_degree,
                    mode=mode, operands=operands)
        u, v = self.pre_nn(x, x)
        if dispatch.block_cfg(g) is not None \
                and dispatch.agg_cfg(g) is not None:
            agg_cat = self._block_aggregate(g, u, v)
        else:
            agg_cat = _fused_multi(g, self.aggregators, v, u=u)
        if agg_cat is None:
            if g.nbr_nodes is not None:
                table = u[:, None, :] + ell.ell_gather(v, g.nbr_nodes)
                mask = ell.ell_mask(g.nbr_nodes, g.in_degree)
                aggs = ell.ell_multi_table(table, g.in_degree,
                                           self.aggregators, mask)
            else:
                h_edge = u[g.receivers.long()] + v[g.senders.long()]
                aggs = segment.segment_multi(
                    h_edge, g.receivers, g.num_nodes, self.aggregators,
                    count=g.in_degree.to(x.dtype)[:, None])
            agg_cat = torch.cat([aggs[a] for a in self.aggregators], dim=-1)
        deg = g.in_degree.to(x.dtype).clamp(min=1.0)[:, None]
        log_deg = torch.log(deg + 1.0)
        scales = []
        for s in self.scalers:
            if s == "identity":
                scales.append(None)
            elif s == "amplification":
                scales.append(true_div(log_deg, self.delta))
            else:
                scales.append(true_div(self.delta, log_deg))
        out = self.post_nn(x, agg_cat, scales)
        return _finish(self.lin(out), act, skip)

    def _block_aggregate(self, g: GraphBatch, u, v):
        """The aggregation on a block-packed batch: the message u_i + v_j's
        shift u commutes with every aggregator (mean = u + mean v, std =
        std v, sum = deg u + sum v, max = u + max v), so sum, mean and std
        ride one block product over [v | v^2] and only max and min take
        the multi-aggregate kernel, without u."""
        from gnnbuilder_tpu_torch.ops.cuda.ell_agg import (
            fused_ell_aggregate_vjp,
        )

        aggs = self.aggregators
        linear = tuple(a for a in aggs if a in ("sum", "mean", "std"))
        mm = dispatch.block_cfg(g).get("mm")
        out = block.block_multi(v, g.block_adj, g.in_degree, linear,
                                mm=mm) if linear else {}
        cmp = tuple(a for a in aggs if a in ("max", "min"))
        if cmp:
            cat = fused_ell_aggregate_vjp(
                v, g.nbr_nodes, g.in_degree, cmp,
                rev_nbr_nodes=g.rev_nbr_nodes, out_degree=g.out_degree,
                mode=dispatch.agg_cfg(g).get("mode", "f32"))
            F = v.shape[1]
            out.update({a: cat[:, i * F:(i + 1) * F]
                        for i, a in enumerate(cmp)})
        count = g.in_degree.to(v.dtype)[:, None]
        zero = v.new_zeros(())
        parts = []
        for a in aggs:
            if a == "std":
                parts.append(out[a])
            elif a == "sum":
                parts.append(count * u + out[a])
            else:
                parts.append(torch.where(count > 0, u + out[a], zero))
        return torch.cat(parts, dim=-1)


class GATConv(torch.nn.Module):
    """GAT with ``heads`` heads of ``out_channels`` each: the output is
    [N, heads * out_channels] with ``concat``, else the head mean [N,
    out_channels].  ``lin`` has no bias; ``att_src`` and ``att_dst`` are
    [1, heads, out_channels] as in the JAX package.  ``edge_dim``, the
    width of the batch's edge features, adds ``lin_edge`` (no bias) and
    ``att_edge`` [1, heads, out_channels] for the edge terms of the
    logits."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 1,
                 concat: bool = True, negative_slope: float = 0.2,
                 add_self_loops: bool = True, edge_dim=None, p_in: int = 1,
                 p_out: int = 1):
        super().__init__()
        self.p_in, self.p_out = p_in, p_out
        self.edge_dim = None if edge_dim is None else int(edge_dim)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.heads = int(heads)
        self.concat = bool(concat)
        self.negative_slope = float(negative_slope)
        self.add_self_loops = bool(add_self_loops)
        H, C = self.heads, out_channels
        self.lin = Linear(in_channels, H * C, bias=False)
        self.att_src = torch.nn.Parameter(torch.empty(1, H, C))
        self.att_dst = torch.nn.Parameter(torch.empty(1, H, C))
        torch.nn.init.xavier_uniform_(self.att_src.view(H, C))
        torch.nn.init.xavier_uniform_(self.att_dst.view(H, C))
        if self.edge_dim is not None:
            self.lin_edge = Linear(self.edge_dim, H * C, bias=False)
            self.att_edge = torch.nn.Parameter(torch.empty(1, H, C))
            torch.nn.init.xavier_uniform_(self.att_edge.view(H, C))
        self.bias = torch.nn.Parameter(
            torch.zeros(H * C if self.concat else C))

    @property
    def out_width(self) -> int:
        return self.heads * self.out_channels if self.concat \
            else self.out_channels

    def mode_operands(self, mode: str):
        """The weights the GAT kernels take in ``mode`` ("f32", "bf16" or
        "int8"), from the float32 parameters: {"layer": (w, sw, staged)}
        (``gat_layer.prepare_layer``, then ``stage_projection``) and,
        except under int8 (the block kernel has no int8 mode), {"block":
        (w, wa_src, wa_dst, staged)} (``gat_block.prepare_block``, then
        ``stage_projection`` with the logit weights under bf16); under
        f32 both share one staged layout."""
        from gnnbuilder_tpu_torch.ops.cuda import gat_block, gat_layer

        w, H = self.lin.weight.t(), self.heads
        wl, sw = gat_layer.prepare_layer(w, mode)
        staged = gat_layer.stage_projection(wl, H, mode)
        out = {"layer": (wl, sw, staged)}
        if mode != "int8":
            wb, wa_src, wa_dst = gat_block.prepare_block(
                w, self.att_src, self.att_dst, mode)
            out["block"] = (wb, wa_src, wa_dst, staged if mode == "f32" else
                            gat_layer.stage_projection(wb, H, mode, wa_src,
                                                       wa_dst))
        return out

    def _edge_logits(self, g: GraphBatch):
        """The edge terms of the logits: per edge att_edge . lin_edge(e)
        [E, H], and per node that of the mean of its incoming edge
        features [N, H] (PyG's ``fill_value="mean"``: the projection
        commutes with the mean, so the raw features are averaged; an
        empty row's mean is 0).

        Under the all-gather strategy of a sharded forward the batch's
        edge rows are this rank's: a_edge is formed on them (the ELL
        gather all-gathers it), and the mean on all the edges for this
        rank's node rows (``parallel.halo.scoped_edge_mean``).  There is
        no halo forward: the JAX package's halo forward of this conv
        averages over the global receivers into the rank's rows, which is
        right on the first rank only, so it has no reference to be held
        to."""
        if g.edge_feat is None:
            raise ValueError("GATConv with edge_dim needs the batch's edge "
                             "features")
        from gnnbuilder_tpu_torch.parallel.halo import (
            active_halo,
            active_scope,
            scoped_edge_mean,
        )

        if active_halo() is not None:
            raise NotImplementedError(
                "GATConv with edge_dim has no halo forward: its self-loop "
                "term averages edge features per receiver over the whole "
                "edge list; use the all-gather strategy (halo=False)")
        H, C, n = self.heads, self.out_channels, g.num_nodes
        e = g.edge_feat
        a_edge = (self.lin_edge(e).reshape(-1, H, C)
                  * self.att_edge).sum(-1)                     # [E, H]
        scope = active_scope()
        if scope is None:
            mean_attr = segment.segment_mean(
                e, g.receivers, n, count=g.in_degree.to(e.dtype)[:, None])
        else:
            mean_attr = scoped_edge_mean(scope, e, g.receivers, g.in_degree)
        a_self = (self.lin_edge(mean_attr).reshape(n, H, C)
                  * self.att_edge).sum(-1)                     # [N, H]
        return a_edge, a_self

    def forward(self, g: GraphBatch, x, act=None, skip=None, operands=None):
        """``operands``: ``mode_operands(mode)`` of the active policy's
        mode, made once by the caller (``GNNModel`` caches them); made
        here when None."""
        H, C, n = self.heads, self.out_channels, g.num_nodes
        ns, loops = self.negative_slope, self.add_self_loops
        edge = self.edge_dim is not None
        w = self.lin.weight.t()
        cfg = dispatch.gat_block_cfg(g, act, edge)
        if cfg is not None:
            from gnnbuilder_tpu_torch.ops.cuda.gat_block import (
                build_block_edge_logits,
                fused_gat_block_layer,
            )

            mode = cfg.get("mode", "f32")
            # the cached kernel operands; under f32 without them the
            # wrapper lays the live weights out on the call
            wm, wa_src, wa_dst, staged = (
                operands["block"] if operands is not None
                else (w, None, None, None) if mode == "f32"
                else self.mode_operands(mode)["block"])
            ekw = {}
            if edge:
                a_edge, a_self = self._edge_logits(g)
                ekw = dict(edge_table=build_block_edge_logits(
                    g.senders, g.receivers, g.edge_mask, a_edge, n,
                    g.block_size_static), self_extra=a_self)
            return fused_gat_block_layer(
                x, g.block_adj, wm, self.att_src, self.att_dst, self.bias, H,
                neg_slope=ns, self_loops=loops, skip=skip, act=act,
                concat=self.concat, mode=mode, wa_src=wa_src, wa_dst=wa_dst,
                staged=staged, **ekw)
        cfg = dispatch.gat_layer_cfg(g, act, edge) if self.concat else None
        if cfg is not None:
            from gnnbuilder_tpu_torch.ops.cuda.gat_layer import (
                fused_gat_layer_auto,
            )

            mode = cfg.get("mode", "f32")
            prepared = staged = None
            if operands is not None:
                wl, sw, staged = operands["layer"]
                prepared = None if mode == "f32" else (wl, sw)
            ekw = {}
            if edge:
                a_edge, a_self = self._edge_logits(g)
                ekw = dict(edge_logits=ell.ell_gather_valid(
                    a_edge, g.nbr_edges, g.in_degree), self_edge_logit=a_self)
            return fused_gat_layer_auto(
                x, g.nbr_nodes, g.in_degree, w, self.att_src, self.att_dst,
                self.bias, H, neg_slope=ns, self_loops=loops, skip=skip,
                act=act, rev_nbr_nodes=g.rev_nbr_nodes,
                out_degree=g.out_degree, mode=mode, prepared=prepared,
                staged=staged, rev_csr=lambda: g.rev_csr, **ekw)
        h = self.lin(x).reshape(n, H, C)
        a_src = (h * self.att_src).sum(-1)                     # [N, H]
        a_dst = (h * self.att_dst).sum(-1)
        z_self = a_src + a_dst
        if edge:
            a_edge, a_self = self._edge_logits(g)
            z_self = z_self + a_self
        if dispatch.block_cfg(g) is not None and not edge:
            out = block.block_gat_attention(g.block_adj, h, a_src, a_dst,
                                            neg_slope=ns, self_loops=loops)
        elif g.nbr_nodes is not None and g.nbr_edges is not None:
            # separable logits per ELL slot (plus the edge term); the self
            # loop is an analytic extra slot
            z = ell.ell_gather(a_src, g.nbr_nodes) + a_dst[:, None, :]
            if edge:
                z = z + ell.ell_gather_valid(a_edge, g.nbr_edges, g.in_degree)
            lt = leaky_relu(z, ns)                              # [N, W, H]
            vt = ell.ell_gather(h, g.nbr_nodes)                 # [N, W, H, C]
            mask = ell.ell_mask(g.nbr_nodes, g.in_degree)
            if loops:
                out = ell.ell_softmax_sum(lt, vt, mask,
                                          leaky_relu(z_self, ns), h)
            else:
                out = ell.ell_softmax_sum(lt, vt, mask)
        else:
            send, recv = g.senders.long(), g.receivers.long()
            z = a_src[send] + a_dst[recv]
            if edge:
                z = z + a_edge
            logits = leaky_relu(z, ns)                          # [E, H]
            if loops:
                self_logit = leaky_relu(z_self, ns)
                m = logits.new_full((n, H), float("-inf")).scatter_reduce(
                    0, recv[:, None].expand_as(logits), logits,
                    reduce="amax", include_self=True)
                m = torch.maximum(m, self_logit)
                exp_e = torch.exp(logits - m[recv])
                exp_self = torch.exp(self_logit - m)
                denom = segment.segment_sum(exp_e, recv, n) + exp_self
                num = (segment.segment_sum(exp_e[:, :, None] * h[send], recv,
                                           n)
                       + exp_self[:, :, None] * h)
                out = num / denom[:, :, None]
            else:
                alpha = segment.segment_softmax(logits, recv, n)
                out = segment.segment_sum(alpha[:, :, None] * h[send], recv,
                                          n)
        out = out.reshape(n, H * C) if self.concat else out.mean(dim=1)
        return _finish(out + self.bias, act, skip)


class GINEConv(torch.nn.Module):
    """GINE: GIN with edge features in the message, ``relu(x_j +
    lin_edge(e_ij))``.  ``edge_dim`` is the width of the batch's edge
    features; ``lin_edge`` maps them to ``in_channels``."""

    def __init__(self, in_channels: int, out_channels: int,
                 edge_dim=None, eps: float = 0.0, p_in: int = 1,
                 p_out: int = 1):
        super().__init__()
        self.p_in, self.p_out = p_in, p_out
        if edge_dim is None:
            raise ValueError("GINEConv needs edge_dim, the width of the "
                             "edge features")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.edge_dim = int(edge_dim)
        self.eps = float(eps)
        self.lin_edge = Linear(self.edge_dim, in_channels)
        self.lin0 = Linear(in_channels, out_channels)
        self.lin1 = Linear(out_channels, out_channels)

    def forward(self, g: GraphBatch, x, act=None, skip=None, operands=None):
        """``operands``: this layer's ``gine_layer.layer_operands`` (the
        weights of the mode and their Ring layout) from the model, or
        None."""
        if g.edge_feat is None:
            raise ValueError("GINEConv requires edge features")
        e = self.lin_edge(g.edge_feat)
        # under halo the kernel is skipped (the JAX conv's rule): the
        # edge-slot gathers below take global ids into the replicated
        # edge arrays
        cfg = None if _halo_on() else dispatch.gine_layer_cfg(g, act)
        if cfg is not None:
            from gnnbuilder_tpu_torch.ops.cuda.gine_layer import (
                fused_gine_layer_auto,
            )

            return fused_gine_layer_auto(
                x, e, g.nbr_nodes, g.nbr_edges, g.in_degree,
                self.lin0.weight.t(), self.lin0.bias, self.lin1.weight.t(),
                self.lin1.bias, eps=self.eps, skip=skip, act=act,
                mode=cfg.get("mode", "f32"), operands=operands)
        if g.nbr_nodes is not None:
            table = torch.relu(ell.ell_gather(x, g.nbr_nodes)
                               + ell.ell_gather(e, g.nbr_edges,
                                                node_rows=False))
            mask = ell.ell_mask(g.nbr_nodes, g.in_degree)[..., None]
            agg = torch.where(mask, table, x.new_zeros(())).sum(1)
        else:
            msg = torch.relu(x[g.senders.long()] + e)
            agg = segment.segment_sum(msg, g.receivers, g.num_nodes)
        h = (1.0 + self.eps) * x + agg
        return _finish(self.lin1(torch.relu(self.lin0(h))), act, skip)


class EdgeConv(torch.nn.Module):
    """EdgeConv (Dynamic Graph CNN): ``aggr_j lin1(relu(lin0([x_i || x_j -
    x_i])))`` for ``aggregation`` max (the default), sum ("add") or mean;
    an empty row gives 0.  ``lin0`` is a PairLinear over the virtual
    concat, so the message is ``(u - v)_i + v_j``."""

    def __init__(self, in_channels: int, out_channels: int,
                 aggregation: str = "max", p_in: int = 1, p_out: int = 1):
        super().__init__()
        self.p_in, self.p_out = p_in, p_out
        if aggregation not in ("sum", "add", "mean", "max"):
            raise ValueError(f"unknown aggregation {aggregation}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.aggregation = aggregation
        self.lin0 = PairLinear(2 * in_channels, out_channels)
        self.lin1 = Linear(out_channels, out_channels)

    def forward(self, g: GraphBatch, x, act=None, skip=None):
        name = "sum" if self.aggregation == "add" else self.aggregation
        cfg = dispatch.edge_block_cfg(g, act)
        if cfg is not None:
            from gnnbuilder_tpu_torch.ops.cuda.edge_block import (
                fused_edge_block_layer_auto,
            )

            return fused_edge_block_layer_auto(
                x, g.nbr_nodes, g.in_degree, self.lin0.weight.t(),
                self.lin0.bias, self.lin1.weight.t(), self.lin1.bias,
                aggregation=name, skip=skip, act=act,
                mode=cfg.get("mode", "f32"))
        u, v = self.lin0(x, x)
        w = u - v
        if g.nbr_nodes is not None:
            table = torch.relu(w[:, None, :]
                               + ell.ell_gather(v, g.nbr_nodes))
            mask = ell.ell_mask(g.nbr_nodes, g.in_degree)
            out = ell.ell_multi_table(self.lin1(table), g.in_degree, (name,),
                                      mask)[name]
        else:
            recv = g.receivers.long()
            y = self.lin1(torch.relu(w[recv] + v[g.senders.long()]))
            if name == "sum":
                out = segment.segment_sum(y, recv, g.num_nodes)
            else:
                fn = {"mean": segment.segment_mean,
                      "max": segment.segment_max}[name]
                out = fn(y, recv, g.num_nodes,
                         count=g.in_degree.to(x.dtype)[:, None])
        return _finish(out, act, skip)


SUPPORTED_GNN_CONVS = {"gcn": GCNConv, "gin": GINConv, "gine": GINEConv,
                       "sage": SAGEConv, "lg": LGConv, "simple": SimpleConv,
                       "pna": PNAConv, "gat": GATConv, "edge": EdgeConv}

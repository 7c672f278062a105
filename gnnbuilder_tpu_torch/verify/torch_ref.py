"""Pure-torch golden reference implementing PyTorch-Geometric layer semantics.

The reference framework verifies its kernels against golden outputs from the
actual PyG layers (gen_test_data.py:216-317, code_gen.py:279-305).  PyG is
not a dependency, so this module re-implements the exact math of each PyG
conv in plain torch (scatter/index_add ops): the golden model of the port's
parity checks (``verify.port``, ``verify.golden``), playing the role of the
reference's serialized PyTorch outputs.  It is this package's own copy of
the JAX package's ``verify/torch_ref.py``, line for line below this
docstring, so the two give the same outputs bit for bit.

Semantics verified against the PyG documentation/source conventions:
  * edge_index[0]=source j, edge_index[1]=target i, aggregation at target
  * empty segments fill 0 (PyG scatter convention)
  * GCNConv: add self loops, symmetric norm from in-degrees, transform->agg
  * SAGEConv: lin_l(mean) + lin_r(x), bias on lin_l only
  * GINConv: nn((1+eps) x + sum), nn = Linear-ReLU-Linear (hidden=out)
  * GINEConv: message relu(x_j + lin_edge(e)), edge_dim projection
  * PNAConv: towers=1, pre([x_i||x_j]), aggr [max,min,mean,std], scalers
    [identity, amplification, attenuation] with deg clamp >=1 and given delta,
    std eps 1e-5, post([x||12F]), final lin
  * GATConv: add self loops (after removing existing), leaky-relu logits,
    per-target softmax, bias
  * LGConv: 1/sqrt(d_i d_j) sum, no self loops; SimpleConv: plain sum
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

__all__ = [
    "TorchGCNConv",
    "TorchGINConv",
    "TorchGINEConv",
    "TorchSAGEConv",
    "TorchPNAConv",
    "TorchGATConv",
    "TorchLGConv",
    "TorchSimpleConv",
    "TorchEdgeConv",
    "TorchGlobalPooling",
    "TorchMLP",
    "TorchGNNModel",
    "TORCH_CONVS",
]


def _scatter_sum(src, index, n):
    out = torch.zeros((n,) + src.shape[1:], dtype=src.dtype)
    return out.index_add_(0, index, src)


def _scatter_mean(src, index, n):
    s = _scatter_sum(src, index, n)
    cnt = _scatter_sum(torch.ones(src.shape[0], 1, dtype=src.dtype), index, n)
    return s / cnt.clamp(min=1.0)


def _scatter_max(src, index, n):
    out = torch.zeros((n,) + src.shape[1:], dtype=src.dtype)
    idx = index.view(-1, *([1] * (src.dim() - 1))).expand_as(src)
    return out.scatter_reduce_(0, idx, src, reduce="amax", include_self=False)


def _scatter_min(src, index, n):
    out = torch.zeros((n,) + src.shape[1:], dtype=src.dtype)
    idx = index.view(-1, *([1] * (src.dim() - 1))).expand_as(src)
    return out.scatter_reduce_(0, idx, src, reduce="amin", include_self=False)


def _scatter_std(src, index, n, eps=1e-5):
    mean = _scatter_mean(src, index, n)
    mean_sq = _scatter_mean(src * src, index, n)
    var = (mean_sq - mean * mean).relu()
    return (var + eps).sqrt()


def _in_degree(edge_index, n, dtype=torch.float32):
    return torch.bincount(edge_index[1], minlength=n).to(dtype)


class TorchGCNConv(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, edge_index, edge_attr=None):
        n = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        deg = _in_degree(edge_index, n) + 1.0
        dis = deg.pow(-0.5)
        h = self.lin(x)
        norm = dis[src] * dis[dst]
        agg = _scatter_sum(h[src] * norm.unsqueeze(-1), dst, n)
        agg = agg + h * (dis * dis).unsqueeze(-1)
        return agg + self.bias


class TorchGINConv(nn.Module):
    def __init__(self, in_channels, out_channels, eps=0.0):
        super().__init__()
        self.eps = eps
        self.lin0 = nn.Linear(in_channels, out_channels)
        self.lin1 = nn.Linear(out_channels, out_channels)

    def forward(self, x, edge_index, edge_attr=None):
        n = x.shape[0]
        agg = _scatter_sum(x[edge_index[0]], edge_index[1], n)
        h = (1.0 + self.eps) * x + agg
        return self.lin1(torch.relu(self.lin0(h)))


class TorchGINEConv(nn.Module):
    def __init__(self, in_channels, out_channels, edge_dim, eps=0.0):
        super().__init__()
        self.eps = eps
        self.lin_edge = nn.Linear(edge_dim, in_channels)
        self.lin0 = nn.Linear(in_channels, out_channels)
        self.lin1 = nn.Linear(out_channels, out_channels)

    def forward(self, x, edge_index, edge_attr):
        n = x.shape[0]
        msg = torch.relu(x[edge_index[0]] + self.lin_edge(edge_attr))
        agg = _scatter_sum(msg, edge_index[1], n)
        h = (1.0 + self.eps) * x + agg
        return self.lin1(torch.relu(self.lin0(h)))


class TorchSAGEConv(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.lin_l = nn.Linear(in_channels, out_channels, bias=True)
        self.lin_r = nn.Linear(in_channels, out_channels, bias=False)

    def forward(self, x, edge_index, edge_attr=None):
        n = x.shape[0]
        agg = _scatter_mean(x[edge_index[0]], edge_index[1], n)
        return self.lin_l(agg) + self.lin_r(x)


class TorchPNAConv(nn.Module):
    AGGREGATORS = ("max", "min", "mean", "std")
    SCALERS = ("identity", "amplification", "attenuation")

    def __init__(self, in_channels, out_channels, delta=1.0):
        super().__init__()
        self.delta = delta
        self.pre_nn = nn.Linear(2 * in_channels, in_channels)
        self.post_nn = nn.Linear(
            (len(self.AGGREGATORS) * len(self.SCALERS) + 1) * in_channels,
            out_channels,
        )
        self.lin = nn.Linear(out_channels, out_channels)

    def forward(self, x, edge_index, edge_attr=None):
        n = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        h = self.pre_nn(torch.cat([x[dst], x[src]], dim=-1))
        aggs = {
            "max": _scatter_max(h, dst, n),
            "min": _scatter_min(h, dst, n),
            "mean": _scatter_mean(h, dst, n),
            "std": _scatter_std(h, dst, n),
        }
        agg_cat = torch.cat([aggs[a] for a in self.AGGREGATORS], dim=-1)
        deg = _in_degree(edge_index, n).clamp(min=1.0).unsqueeze(-1)
        log_deg = (deg + 1.0).log()
        scaled = [
            agg_cat,
            agg_cat * (log_deg / self.delta),
            agg_cat * (self.delta / log_deg),
        ]
        out = torch.cat([x] + scaled, dim=-1)
        return self.lin(self.post_nn(out))


class TorchGATConv(nn.Module):
    def __init__(
        self, in_channels, out_channels, heads=1, concat=True,
        negative_slope=0.2, edge_dim=None,
    ):
        super().__init__()
        self.heads = heads
        self.out_channels = out_channels
        self.concat = concat
        self.negative_slope = negative_slope
        self.edge_dim = edge_dim
        self.lin = nn.Linear(in_channels, heads * out_channels, bias=False)
        self.att_src = nn.Parameter(torch.empty(1, heads, out_channels))
        self.att_dst = nn.Parameter(torch.empty(1, heads, out_channels))
        nn.init.xavier_uniform_(self.att_src)
        nn.init.xavier_uniform_(self.att_dst)
        if edge_dim is not None:
            self.lin_edge = nn.Linear(
                edge_dim, heads * out_channels, bias=False
            )
            self.att_edge = nn.Parameter(
                torch.empty(1, heads, out_channels)
            )
            nn.init.xavier_uniform_(self.att_edge)
        out_dim = heads * out_channels if concat else out_channels
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x, edge_index, edge_attr=None):
        n = x.shape[0]
        H, C = self.heads, self.out_channels
        # PyG add_self_loops path: remove existing self loops, add one per
        # node; self-loop edge_attr = fill_value="mean" (scatter-mean of
        # the receiver's incoming edge attrs, PyG GATConv default)
        keep = edge_index[0] != edge_index[1]
        ei = edge_index[:, keep]
        loops = torch.arange(n, dtype=ei.dtype).unsqueeze(0).repeat(2, 1)
        ei = torch.cat([ei, loops], dim=1)
        src, dst = ei[0], ei[1]
        if self.edge_dim is not None:
            ea = edge_attr[keep]
            cnt = _scatter_sum(
                torch.ones(ea.shape[0], 1), edge_index[1][keep], n
            ).clamp(min=1.0)
            self_attr = _scatter_sum(ea, edge_index[1][keep], n) / cnt
            ea_full = torch.cat([ea, self_attr], dim=0)

        h = self.lin(x).view(n, H, C)
        a_src = (h * self.att_src).sum(-1)  # [N, H]
        a_dst = (h * self.att_dst).sum(-1)
        raw = a_src[src] + a_dst[dst]
        if self.edge_dim is not None:
            e_proj = self.lin_edge(ea_full).view(-1, H, C)
            raw = raw + (e_proj * self.att_edge).sum(-1)
        logits = torch.nn.functional.leaky_relu(
            raw, self.negative_slope
        )  # [E', H]
        m = torch.full((n, H), float("-inf"))
        idx = dst.unsqueeze(-1).expand_as(logits)
        m = m.scatter_reduce_(0, idx, logits, reduce="amax", include_self=True)
        e = (logits - m[dst]).exp()
        denom = _scatter_sum(e, dst, n)
        alpha = e / denom[dst].clamp(min=1e-16)
        out = _scatter_sum(alpha.unsqueeze(-1) * h[src], dst, n)
        out = out.reshape(n, H * C) if self.concat else out.mean(dim=1)
        return out + self.bias


class TorchLGConv(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()

    def forward(self, x, edge_index, edge_attr=None):
        n = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        deg = _in_degree(edge_index, n)
        dis = deg.clamp(min=1.0).pow(-0.5) * (deg > 0)
        norm = dis[src] * dis[dst]
        return _scatter_sum(x[src] * norm.unsqueeze(-1), dst, n)


class TorchSimpleConv(nn.Module):
    def __init__(self, in_channels, out_channels, aggregation="sum"):
        super().__init__()
        self.aggregation = aggregation

    def forward(self, x, edge_index, edge_attr=None):
        n = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        if self.aggregation in ("sum", "add"):
            return _scatter_sum(x[src], dst, n)
        if self.aggregation == "mean":
            return _scatter_mean(x[src], dst, n)
        if self.aggregation == "max":
            return _scatter_max(x[src], dst, n)
        if self.aggregation == "min":
            return _scatter_min(x[src], dst, n)
        raise ValueError(self.aggregation)


class TorchGlobalPooling(nn.Module):
    def __init__(self, aggrs=("add",)):
        super().__init__()
        self.aggrs = aggrs

    def forward(self, x, batch, num_graphs):
        outs = []
        for a in self.aggrs:
            if a == "add":
                outs.append(_scatter_sum(x, batch, num_graphs))
            elif a == "mean":
                outs.append(_scatter_mean(x, batch, num_graphs))
            elif a == "max":
                outs.append(_scatter_max(x, batch, num_graphs))
            else:
                raise ValueError(a)
        return torch.cat(outs, dim=-1)


_TORCH_ACTS = {
    "relu": torch.relu,
    "gelu": lambda x: torch.nn.functional.gelu(x),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}


class TorchMLP(nn.Module):
    def __init__(self, in_dim, out_dim, hidden_dim=64, hidden_layers=2,
                 activation="relu"):
        super().__init__()
        self.activation = activation
        dims = []
        if hidden_layers == 0:
            dims.append((in_dim, out_dim))
        else:
            for i in range(hidden_layers):
                dims.append((in_dim if i == 0 else hidden_dim, hidden_dim))
            dims.append((hidden_dim, out_dim))
        self.linear_layers = nn.ModuleList(
            [nn.Linear(a, b) for a, b in dims]
        )

    def forward(self, x):
        act = _TORCH_ACTS[self.activation]
        for i, lin in enumerate(self.linear_layers):
            x = lin(x)
            if i < len(self.linear_layers) - 1:
                x = act(x)
        return x


class TorchEdgeConv(nn.Module):
    """PyG EdgeConv semantics: aggr_j MLP([x_i || x_j - x_i]), default
    "max"; MLP = Linear(2F -> F_out) -> ReLU -> Linear(F_out -> F_out) per
    the reference skeleton's docstring (gnn_builder_lib.h:2663-2669)."""

    def __init__(self, in_channels, out_channels, aggregation="max"):
        super().__init__()
        self.lin0 = nn.Linear(2 * in_channels, out_channels)
        self.lin1 = nn.Linear(out_channels, out_channels)
        self.aggregation = aggregation

    def forward(self, x, edge_index, edge_attr=None):
        n = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        h = torch.cat([x[dst], x[src] - x[dst]], dim=-1)
        y = self.lin1(torch.relu(self.lin0(h)))
        if self.aggregation in ("sum", "add"):
            return _scatter_sum(y, dst, n)
        if self.aggregation == "mean":
            return _scatter_mean(y, dst, n)
        if self.aggregation == "max":
            return _scatter_max(y, dst, n)
        raise ValueError(self.aggregation)


TORCH_CONVS = {
    "gcn": TorchGCNConv,
    "gin": TorchGINConv,
    "gine": TorchGINEConv,
    "gat": TorchGATConv,
    "pna": TorchPNAConv,
    "sage": TorchSAGEConv,
    "lg": TorchLGConv,
    "simple": TorchSimpleConv,
    "edge": TorchEdgeConv,
}


class TorchGNNModel(nn.Module):
    """Golden whole-model forward — semantics of reference models.py:551-575."""

    def __init__(
        self,
        graph_input_feature_dim,
        gnn_hidden_dim,
        gnn_num_layers,
        gnn_output_dim,
        gnn_conv,
        gnn_activation="relu",
        gnn_skip_connection=False,
        graph_input_edge_dim=None,
        pooling_aggrs=("add",),
        mlp_hidden_dim=64,
        mlp_hidden_layers=2,
        mlp_out_dim=1,
        mlp_activation="relu",
        output_activation=None,
        conv_kwargs=None,
    ):
        super().__init__()
        self.gnn_num_layers = gnn_num_layers
        self.gnn_activation = gnn_activation
        self.gnn_skip_connection = gnn_skip_connection
        self.output_activation = output_activation
        conv_cls = TORCH_CONVS[gnn_conv]
        kw = dict(conv_kwargs or {})
        if gnn_conv == "gine":
            kw["edge_dim"] = graph_input_edge_dim
        convs = []
        L = gnn_num_layers
        for i in range(L):
            in_dim = graph_input_feature_dim if i == 0 else gnn_hidden_dim
            out_dim = gnn_output_dim if i == L - 1 else gnn_hidden_dim
            if L == 1:
                in_dim, out_dim = graph_input_feature_dim, gnn_output_dim
            convs.append(conv_cls(in_dim, out_dim, **kw))
        self.gnn_convs = nn.ModuleList(convs)
        self.global_pooling = TorchGlobalPooling(pooling_aggrs)
        self.mlp_head = TorchMLP(
            gnn_output_dim * len(pooling_aggrs),
            mlp_out_dim,
            mlp_hidden_dim,
            mlp_hidden_layers,
            mlp_activation,
        )

    def forward(self, x, edge_index, batch=None, num_graphs=1, edge_attr=None):
        if batch is None:
            batch = torch.zeros(x.shape[0], dtype=torch.long)
        act = _TORCH_ACTS[self.gnn_activation]
        h = x
        L = self.gnn_num_layers
        for i, conv in enumerate(self.gnn_convs):
            h_in = h
            h = conv(h, edge_index, edge_attr)
            if self.gnn_skip_connection and 0 < i < L - 1:
                h = h + h_in
            h = act(h)
        pooled = self.global_pooling(h, batch, num_graphs)
        out = self.mlp_head(pooled)
        if self.output_activation == "softmax":
            out = torch.softmax(out, dim=-1)
        elif self.output_activation == "log_softmax":
            out = torch.log_softmax(out, dim=-1)
        return out

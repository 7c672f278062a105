"""GNNModel — the whole-model container (the reference's GNNModel,
models.py:462-575, and the JAX package's ``nn/model.py``).

A uniform conv stack (first layer F_in -> hidden, interior hidden ->
hidden, last hidden -> F_out), skip connections on interior layers added
before the activation, multi-aggregation global pooling, an MLP head, and
an optional output activation over the last axis.

Under inference scope (``ops.dispatch.inference_mode``) a block-packed
batch runs the whole conv stack in one kernel: PNA through
``ops.cuda.pna_block``, GCN and SAGE through ``ops.cuda.mp_block`` (GIN
keeps its per-layer path, as in the JAX package).  Any other PNA batch
with an ELL table runs each layer through ``ops.cuda.pna_layer``, in
inference and in training; GCN, GIN and SAGE layers otherwise run their
plain per-layer paths.  The readout runs through
``ops.cuda.readout``.  With ``set_fused_mode("never")`` the model runs the
per-layer plain path.  The paths compute the same function.  In training
(grad mode on) the kernels get the live parameters, so gradients reach
them; in inference the readout weights come from a cache.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from gnnbuilder_tpu_torch.core.graph import GraphBatch
from gnnbuilder_tpu_torch.nn.conv import (
    PNA_AGGREGATORS,
    PNA_SCALERS,
    SUPPORTED_GNN_CONVS,
)
from gnnbuilder_tpu_torch.nn.mlp import MLP
from gnnbuilder_tpu_torch.nn.pool import (
    SUPPORTED_GLOBAL_POOLING_AGGRS,
    GlobalPooling,
)
from gnnbuilder_tpu_torch.ops.activations import (
    OUTPUT_ACTIVATIONS,
    SUPPORTED_MODEL_ACTIVATIONS,
)

__all__ = ["GNNModel"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class GNNModel(torch.nn.Module):
    def __init__(
        self,
        graph_input_feature_dim: int,
        gnn_hidden_dim: int,
        gnn_num_layers: int,
        gnn_output_dim: int,
        gnn_conv: str,
        gnn_activation: str = "relu",
        gnn_skip_connection: bool = False,
        graph_input_edge_dim: Optional[int] = None,
        pooling_aggrs: Sequence[str] = ("add",),
        mlp_hidden_dim: int = 64,
        mlp_hidden_layers: int = 2,
        mlp_out_dim: int = 1,
        mlp_activation: str = "relu",
        output_activation: Optional[str] = None,
        conv_kwargs: Optional[dict] = None,
    ):
        super().__init__()
        if gnn_conv not in SUPPORTED_GNN_CONVS:
            raise ValueError(
                f"gnn_conv must be one of {sorted(SUPPORTED_GNN_CONVS)}"
            )
        if gnn_activation not in SUPPORTED_MODEL_ACTIVATIONS:
            raise ValueError(
                f"gnn_activation must be one of {SUPPORTED_MODEL_ACTIVATIONS}"
            )
        if (output_activation is not None
                and output_activation not in OUTPUT_ACTIVATIONS):
            raise ValueError(
                f"output_activation must be one of {sorted(OUTPUT_ACTIVATIONS)}"
            )
        if gnn_num_layers == 0 and graph_input_feature_dim != gnn_output_dim:
            raise ValueError(
                "gnn_num_layers=0 requires graph_input_feature_dim =="
                " gnn_output_dim"
            )
        for a in pooling_aggrs:
            if a not in SUPPORTED_GLOBAL_POOLING_AGGRS:
                raise ValueError(
                    f"pooling aggregation {a!r} not supported; options: "
                    f"{SUPPORTED_GLOBAL_POOLING_AGGRS}"
                )
        self.graph_input_feature_dim = graph_input_feature_dim
        self.gnn_hidden_dim = gnn_hidden_dim
        self.gnn_num_layers = gnn_num_layers
        self.gnn_output_dim = gnn_output_dim
        self.gnn_conv = gnn_conv
        self.gnn_activation = gnn_activation
        self.gnn_skip_connection = gnn_skip_connection
        self.graph_input_edge_dim = graph_input_edge_dim
        self.pooling_aggrs = tuple(pooling_aggrs)
        self.mlp_hidden_dim = mlp_hidden_dim
        self.mlp_hidden_layers = mlp_hidden_layers
        self.mlp_out_dim = mlp_out_dim
        self.mlp_activation = mlp_activation
        self.output_activation = output_activation
        self.conv_kwargs = dict(conv_kwargs or {})

        conv_cls = SUPPORTED_GNN_CONVS[gnn_conv]
        self.gnn_convs = torch.nn.ModuleList(
            conv_cls(in_dim, out_dim, **self.conv_kwargs)
            for in_dim, out_dim in self._layer_dims()
        )
        self.global_pooling = GlobalPooling(self.pooling_aggrs)
        self.mlp_head = MLP(
            in_dim=gnn_output_dim * len(self.pooling_aggrs),
            out_dim=mlp_out_dim,
            hidden_dim=mlp_hidden_dim,
            hidden_layers=mlp_hidden_layers,
            activation=mlp_activation,
        )
        self._kernel_cache = None   # (key, _kernel_params result)

    def _layer_dims(self):
        """(in_dim, out_dim) per conv layer — models.py:509-549."""
        L = self.gnn_num_layers
        if L == 1:
            return [(self.graph_input_feature_dim, self.gnn_output_dim)]
        dims = []
        for i in range(L):
            in_dim = (self.graph_input_feature_dim if i == 0
                      else self.gnn_hidden_dim)
            out_dim = self.gnn_output_dim if i == L - 1 else self.gnn_hidden_dim
            dims.append((in_dim, out_dim))
        return dims

    @property
    def gnn_layer_sizes(self):
        return self._layer_dims()

    def forward(self, g: GraphBatch, x=None):
        """Returns [G, mlp_out_dim] per-graph predictions (ghost graph row
        included — mask it with g.graph_mask downstream)."""
        h = g.node_feat if x is None else x
        L = self.gnn_num_layers
        stacked = self._fused_gnn_stack(g, h)
        if stacked is not None:
            h = stacked
        else:
            for i, conv in enumerate(self.gnn_convs):
                skip = (h if self.gnn_skip_connection and 0 < i < L - 1
                        else None)
                h = conv(g, h, self.gnn_activation, skip)
        fused = self._fused_readout(g, h)
        if fused is not None:
            return fused
        out = self.mlp_head(self.global_pooling(g, h))
        if self.output_activation is not None:
            out = OUTPUT_ACTIVATIONS[self.output_activation](out)
        return out

    # ------------------------------------------------------------- kernels
    def _stack_width(self) -> int:
        dims = [self.graph_input_feature_dim]
        for conv in self.gnn_convs:
            dims += [conv.in_channels, conv.out_channels]
        return _round_up(max(dims), 128)

    def _conv_operands(self):
        """Per-layer conv weights in [in, out] layout, as the stack kernel
        of the model's conv takes them (None for what a conv lacks)."""
        t = lambda lin: lin.weight.t()
        if self.gnn_conv == "pna":
            return [(t(c.pre_nn), c.pre_nn.bias, t(c.post_nn),
                     c.post_nn.bias, t(c.lin), c.lin.bias)
                    for c in self.gnn_convs]
        if self.gnn_conv == "gcn":
            return [(t(c.lin), c.bias, None, None) for c in self.gnn_convs]
        if self.gnn_conv == "gin":
            return [(t(c.lin0), c.lin0.bias, t(c.lin1), c.lin1.bias)
                    for c in self.gnn_convs]
        return [(t(c.lin_l), c.lin_l.bias, t(c.lin_r), None)
                for c in self.gnn_convs]

    def _kernel_params(self, width: int):
        """(stacked conv operands, readout weights): the conv weights
        padded and stacked for the stack kernel and the MLP weights in
        [in, out] layout, kept until a parameter is replaced or changed in
        place."""
        key = (width,) + tuple((id(p), p._version, p.device)
                               for p in self.parameters())
        if self._kernel_cache is None or self._kernel_cache[0] != key:
            from gnnbuilder_tpu_torch.ops.cuda.mp_block import stack_mp_params
            from gnnbuilder_tpu_torch.ops.cuda.pna_block import stack_params

            with torch.no_grad():
                stacked = None
                if self.gnn_num_layers > 0:
                    stack = (stack_params if self.gnn_conv == "pna"
                             else stack_mp_params)
                    stacked = stack(self._conv_operands(), width)
                readout = [(lin.weight.t().contiguous(), lin.bias.detach())
                           for lin in self.mlp_head.linear_layers]
            self._kernel_cache = (key, (stacked, readout))
        return self._kernel_cache[1]

    def _fused_gnn_stack(self, g: GraphBatch, h):
        """The whole conv stack in one kernel call when the gate allows:
        PNA with the default aggregators and scalers, an activation the
        kernel has, a block-packed batch, inference scope.  None = run the
        per-layer loop."""
        if self.gnn_num_layers < 1:
            return None
        if self.gnn_conv != "pna":
            return self._fused_mp_stack(g, h)
        if any(tuple(c.aggregators) != PNA_AGGREGATORS
               or tuple(c.scalers) != PNA_SCALERS for c in self.gnn_convs):
            return None
        from gnnbuilder_tpu_torch.ops import dispatch
        from gnnbuilder_tpu_torch.ops.cuda.pna_block import (
            STACK_ACTS,
            pna_block_stack_auto,
        )

        if self.gnn_activation not in STACK_ACTS:
            return None
        cfg = dispatch.pna_stack_cfg(g)
        if cfg is None:
            return None
        width = self._stack_width()
        L = self.gnn_num_layers
        return pna_block_stack_auto(
            h, g.nbr_nodes, g.in_degree, self._kernel_params(width)[0],
            deltas=[c.delta for c in self.gnn_convs],
            skips=[self.gnn_skip_connection and 0 < i < L - 1
                   for i in range(L)],
            act=self.gnn_activation, out_dim=self.gnn_output_dim,
            block_size=cfg["block_size"],
        )

    def _fused_mp_stack(self, g: GraphBatch, h):
        """The whole GCN or SAGE stack in one ``ops.cuda.mp_block`` call
        when ``dispatch.mp_stack_cfg`` allows (GIN only when called with
        the kernel directly); None = run the per-layer loop."""
        from gnnbuilder_tpu_torch.ops import dispatch
        from gnnbuilder_tpu_torch.ops.cuda.mp_block import (
            STACK_ACTS,
            mp_block_stack_auto,
        )

        if self.gnn_activation not in STACK_ACTS:
            return None
        cfg = dispatch.mp_stack_cfg(g, self.gnn_conv)
        if cfg is None:
            return None
        L = self.gnn_num_layers
        return mp_block_stack_auto(
            h, g.block_adj, g.in_degree, self.gnn_conv,
            self._kernel_params(self._stack_width())[0],
            epss=[getattr(c, "eps", 0.0) for c in self.gnn_convs],
            skips=[self.gnn_skip_connection and 0 < i < L - 1
                   for i in range(L)],
            act=self.gnn_activation, out_dim=self.gnn_output_dim,
            block_size=cfg["block_size"],
        )

    def _fused_readout(self, g: GraphBatch, h):
        """Pooling + MLP head + output activation in one kernel call when
        the gate allows; max pooling stays plain and streams in, and the
        backward recomputes the plain readout.  None = run GlobalPooling +
        MLP."""
        from gnnbuilder_tpu_torch.ops import dispatch, segment
        from gnnbuilder_tpu_torch.ops.cuda.readout import fused_readout_vjp

        cfg = dispatch.readout_config(
            g, self.pooling_aggrs, self.mlp_activation,
            self.output_activation)
        if cfg is None:
            return None
        if torch.is_grad_enabled():
            weights = [(lin.weight.t(), lin.bias)
                       for lin in self.mlp_head.linear_layers]
        else:
            weights = self._kernel_params(self._stack_width())[1]
        h = h.contiguous()
        mx = None
        if "max" in self.pooling_aggrs:
            mx = segment.contiguous_segment_max(
                h, g.graph_starts, g.n_node, g.max_graph_nodes_static)
        return fused_readout_vjp(
            h, g.n_node, weights, aggrs=self.pooling_aggrs, mx=mx,
            act=self.mlp_activation, out_act=self.output_activation,
            starts=cfg["starts"],
        )

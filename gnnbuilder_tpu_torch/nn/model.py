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
inference and in training; GCN, GIN, SAGE, LG and Simple layers run
through ``ops.cuda.mp_layer`` where ``dispatch.mp_layer_cfg`` allows
(every standard-packed batch with an ELL table; block-packed GCN, LG and
Simple), else their plain per-layer paths.  LG and Simple have no
parameters and no stack kernel.  GAT layers run through
``ops.cuda.gat_block`` under inference scope on a block-packed batch and
through ``ops.cuda.gat_layer`` elsewhere on a batch with an ELL table
(concat heads), else their plain paths; with concat heads a GAT layer's
output is heads * channels wide, and the next layer and the MLP head take
that width, as the JAX package's layers infer it.  A GAT with edge
features (``conv_kwargs={"heads": H, "edge_dim": E}``, as in the JAX
package) runs the block kernel only on a batch that repeats no (sender,
receiver) pair.  GINE layers (which
read the batch's edge features, ``edge_dim=graph_input_edge_dim``) run
through ``ops.cuda.gine_layer`` on any batch with an ELL table, in
inference and in training; EdgeConv layers through ``ops.cuda.edge_block``
under inference scope on a block-packed batch; Simple's max and min and
PNA with other aggregators than the default take the multi-aggregate
kernel ``ops.cuda.ell_agg`` (``nn/conv.py``).  The readout runs through
``ops.cuda.readout``.  With ``set_fused_mode("never")`` the model runs the
per-layer plain path.  The paths compute the same function.  In training
(grad mode on) the kernels get the live parameters, so gradients reach
them; in inference the readout weights come from a cache.

Under a precision policy (``compile.precision``, entered by
``Program.forward``) every kernel whose gate gives a mode runs in it
(``dispatch``'s ``cfg["mode"]``): the PNA and mp stacks, the per-layer
kernels and the readout; the cache then also holds, per mode, the
stacked weights as bfloat16 or as int8 with their scales, rebuilt when a
parameter changes (the per-layer kernels bring their weights to the mode
per call, but for PNA's and GAT's, whose weights and staged layouts the
cache holds per mode under inference).  Every ``Linear`` learns its
``site``, its name in the model, the key of its int8 calibration.
"""

from __future__ import annotations

import contextvars
from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from gnnbuilder_tpu_torch.core.graph import GraphBatch
from gnnbuilder_tpu_torch.nn.conv import (
    PNA_AGGREGATORS,
    PNA_SCALERS,
    SUPPORTED_GNN_CONVS,
)
from gnnbuilder_tpu_torch.nn.linear import Linear
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


# convs with a whole-stack kernel (LG and Simple have none)
_STACK_CONVS = ("pna", "gcn", "gin", "sage")

# convs that read the batch's edge features: they take
# ``edge_dim=graph_input_edge_dim``
_EDGE_CONVS = ("gine",)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _remat(conv, g, h, act, skip, kw):
    """``conv(g, h, act, skip, **kw)`` under ``torch.utils.checkpoint``:
    the tensors the layer's autograd saves are dropped after the forward
    and rebuilt by running the layer again in the backward.  The replay
    takes the same batch (its ``rev_csr`` cache included) and the same
    operands the forward took (``kw``: the weights' layout made once per
    step), and runs in a copy of the forward's context, so the dispatch
    and precision contextvars it reads are the forward's even where the
    backward runs on another thread (the card's autograd thread): the
    replay takes the forward's path and saves the same bits."""
    ctx = contextvars.copy_context()

    def layer(h, skip):
        return ctx.run(conv, g, h, act, skip, **kw)

    return checkpoint(layer, h, skip, use_reentrant=False)


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
        gnn_p_in: int = 1,
        gnn_p_hidden: int = 1,
        gnn_p_out: int = 1,
        mlp_p_in: int = 1,
        mlp_p_hidden: int = 1,
        mlp_p_out: int = 1,
        conv_kwargs: Optional[dict] = None,
        remat: bool = False,
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
        if gnn_conv in _EDGE_CONVS and graph_input_edge_dim is None:
            raise ValueError(f"gnn_conv={gnn_conv!r} reads edge features: "
                             f"it needs graph_input_edge_dim")
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
        self.gnn_p_in = gnn_p_in
        self.gnn_p_hidden = gnn_p_hidden
        self.gnn_p_out = gnn_p_out
        self.mlp_p_in = mlp_p_in
        self.mlp_p_hidden = mlp_p_hidden
        self.mlp_p_out = mlp_p_out
        self.conv_kwargs = dict(conv_kwargs or {})
        # rematerialize each conv layer in the backward (the JAX package's
        # ``nn.remat`` per conv): a train step keeps no layer's residuals
        # and replays the layer's forward in the backward
        self.remat = bool(remat)

        conv_cls = SUPPORTED_GNN_CONVS[gnn_conv]
        conv_kw = dict(self.conv_kwargs)
        if gnn_conv in _EDGE_CONVS:
            conv_kw["edge_dim"] = graph_input_edge_dim
        self.gnn_convs = torch.nn.ModuleList(
            conv_cls(in_dim, out_dim, p_in=p_in, p_out=p_out, **conv_kw)
            for in_dim, out_dim, p_in, p_out in self._layer_dims()
        )
        self.global_pooling = GlobalPooling(self.pooling_aggrs)
        self.mlp_head = MLP(
            in_dim=self._width(gnn_output_dim) * len(self.pooling_aggrs),
            out_dim=mlp_out_dim,
            hidden_dim=mlp_hidden_dim,
            hidden_layers=mlp_hidden_layers,
            activation=mlp_activation,
            p_in=mlp_p_in,
            p_hidden=mlp_p_hidden,
            p_out=mlp_p_out,
        )
        # mode -> (key, cached kernel operands); see _kernel_params
        self._kernel_cache = {}
        for name, mod in self.named_modules():
            if isinstance(mod, Linear):
                mod.site = name

    def _width(self, channels: int) -> int:
        """The width of a conv output of ``channels`` channels: GAT with
        concatenated heads (the default) gives heads * channels, which the
        JAX package's layers infer as their input width."""
        kw = self.conv_kwargs
        if self.gnn_conv == "gat" and kw.get("concat", True):
            return int(kw.get("heads", 1)) * channels
        return channels

    def _layer_dims(self):
        """(in_dim, out_dim, p_in, p_out) per conv layer — models.py:509-549;
        in_dim is the width the layer takes (``_width`` of the layer
        before)."""
        L = self.gnn_num_layers
        if L == 1:
            return [(self.graph_input_feature_dim, self.gnn_output_dim,
                     self.gnn_p_in, self.gnn_p_out)]
        dims = []
        for i in range(L):
            first, last = i == 0, i == L - 1
            in_dim = (self.graph_input_feature_dim if first
                      else self._width(self.gnn_hidden_dim))
            out_dim = self.gnn_output_dim if last else self.gnn_hidden_dim
            dims.append((in_dim, out_dim,
                         self.gnn_p_in if first else self.gnn_p_hidden,
                         self.gnn_p_out if last else self.gnn_p_hidden))
        return dims

    @property
    def gnn_layer_sizes(self):
        return [d[:2] for d in self._layer_dims()]

    # --- introspection mirroring the reference (models.py:577-634) ---
    @property
    def input_node_features_dim(self):
        return self.graph_input_feature_dim

    @property
    def input_edge_features_dim(self):
        return self.graph_input_edge_dim

    @property
    def output_features_dim(self):
        return self.mlp_out_dim

    def forward(self, g: GraphBatch, x=None):
        """Returns [G, mlp_out_dim] per-graph predictions (ghost graph row
        included — mask it with g.graph_mask downstream)."""
        h = g.node_feat if x is None else x
        L = self.gnn_num_layers
        stacked = self._fused_gnn_stack(g, h)
        if stacked is not None:
            h = stacked
        else:
            ops = (self._gat_operands() or self._pna_operands(g)
                   or self._gine_operands(g))
            for i, conv in enumerate(self.gnn_convs):
                skip = (h if self.gnn_skip_connection and 0 < i < L - 1
                        else None)
                kw = {} if ops is None else {"operands": ops[i]}
                if self.remat and torch.is_grad_enabled():
                    h = _remat(conv, g, h, self.gnn_activation, skip, kw)
                else:
                    h = conv(g, h, self.gnn_activation, skip, **kw)
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

    def _cached(self, mode: str, width: int, build):
        """``build()``'s result for (mode, width), kept until a parameter
        is replaced or changed in place."""
        key = (width,) + tuple((id(p), p._version, p.device)
                               for p in self.parameters())
        hit = self._kernel_cache.get(mode)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, build())
            self._kernel_cache[mode] = hit
        return hit[1]

    def _kernel_params(self, width: int):
        """(stacked conv operands, readout weights): the conv weights
        padded and stacked for the stack kernel and the MLP weights in
        [in, out] layout, kept until a parameter is replaced or changed in
        place."""
        def build():
            from gnnbuilder_tpu_torch.ops.cuda.mp_block import stack_mp_params
            from gnnbuilder_tpu_torch.ops.cuda.pna_block import stack_params

            stacked = None
            if self.gnn_num_layers > 0 and self.gnn_conv in _STACK_CONVS:
                stack = (stack_params if self.gnn_conv == "pna"
                         else stack_mp_params)
                stacked = stack(self._conv_operands(), width)
            readout = [(lin.weight.t().contiguous(), lin.bias.detach())
                       for lin in self.mlp_head.linear_layers]
            return stacked, readout

        return self._cached("f32", width, build)

    def _mode_params(self, width: int, mode: str):
        """((stack operands, their scales), (readout weights, their
        scales), GAT operands) as the kernels take them in ``mode``
        ("bf16": bfloat16 weights; "int8": int8 weights with per-column
        scales; scales None otherwise), from ``_kernel_params`` and cached
        the same way; the GAT operands are each layer's
        ``GATConv.mode_operands`` (None for other convs)."""
        def build():
            from gnnbuilder_tpu_torch.ops.cuda.mp_block import (
                prepare_mp_stack,
            )
            from gnnbuilder_tpu_torch.ops.cuda.pna_block import prepare_stack
            from gnnbuilder_tpu_torch.ops.cuda.readout import prepare_head

            stacked, readout = self._kernel_params(width)
            prepare = (prepare_stack if self.gnn_conv == "pna"
                       else prepare_mp_stack)
            stack = ((None, None) if stacked is None
                     else prepare(stacked, mode))
            gat = ([c.mode_operands(mode) for c in self.gnn_convs]
                   if self.gnn_conv == "gat" else None)
            return stack, prepare_head(readout, mode), gat

        return self._cached(mode, width, build)

    def _readout_head(self, mode: str):
        """The MLP head packed for the readout kernel in ``mode``
        (``readout.pack_head``: one buffer, each Linear's weight in its
        [out, in] layout), cached like ``_kernel_params`` (rebuilt after
        ``set_params`` or an optimizer step)."""
        width = self._stack_width()

        def build():
            from gnnbuilder_tpu_torch.ops.cuda.readout import pack_head

            if mode == "f32":
                weights = [(lin.weight.t(), lin.bias)
                           for lin in self.mlp_head.linear_layers]
                return pack_head(weights)
            return pack_head(*self._mode_params(width, mode)[1], mode)

        return self._cached(f"{mode} readout", width, build)

    def _staged_stack(self, width: int, mode: str):
        """The stack kernel's weights in ``mode`` laid out as it streams
        them (PNA: ``pna_block.stage_stack``; GCN, GIN, SAGE:
        ``mp_block.stage_mp_stack``), cached like ``_kernel_params``
        (rebuilt after ``set_params`` or an optimizer step)."""
        def build():
            from gnnbuilder_tpu_torch.ops.cuda.mp_block import stage_mp_stack
            from gnnbuilder_tpu_torch.ops.cuda.pna_block import stage_stack

            stacked = (self._kernel_params(width)[0] if mode == "f32"
                       else self._mode_params(width, mode)[0][0])
            stage = stage_stack if self.gnn_conv == "pna" else stage_mp_stack
            return stage(stacked, mode)

        return self._cached(f"{mode} staged", width, build)

    def _pna_operands(self, g: GraphBatch):
        """Each PNA layer's kernel operands (None: the layers make their
        own): ``pna_layer.layer_operands`` of all layers at once, the
        padded weights of the mode and their staged layout, for layers
        with the default aggregators and scalers (the kernel's), where the
        layer's gate lets the kernel run.  Under
        inference in the active policy's mode, cached like
        ``_kernel_params`` (rebuilt after ``set_params`` or an optimizer
        step).  With a gradient, where the layer kernel runs (a card and
        its gate), from the live weights on every call."""
        from gnnbuilder_tpu_torch.ops import dispatch
        from gnnbuilder_tpu_torch.ops.cuda.pna_layer import layer_operands

        if (self.gnn_conv != "pna" or not self.gnn_convs
                or any(tuple(c.aggregators) != PNA_AGGREGATORS
                       or tuple(c.scalers) != PNA_SCALERS
                       for c in self.gnn_convs)):
            return None
        mode = dispatch.policy()

        def layers():
            return layer_operands([c._weights() for c in self.gnn_convs],
                                  mode)

        if dispatch.pna_layer_cfg(g, self.gnn_activation) is None:
            return None
        if not torch.is_grad_enabled():
            return self._cached(f"{mode} pna layers", self._stack_width(),
                                layers)
        if (mode != "f32"
                or self.gnn_convs[0].lin.weight.device.type != "cuda"):
            return None
        return layers()

    def _gine_operands(self, g: GraphBatch):
        """Each GINE layer's kernel operands in the mode its gate gives
        (``gine_layer.layer_operands`` of all layers at once: the weights
        of the mode and their Ring layout, laid out on the card in one
        gather), where the layer kernel runs (a card and its gate); None
        otherwise.  Under inference cached like ``_kernel_params``
        (rebuilt after ``set_params`` or an optimizer step); with a
        gradient, from the live weights on every call."""
        from gnnbuilder_tpu_torch.ops import dispatch
        from gnnbuilder_tpu_torch.ops.cuda.gine_layer import layer_operands
        from gnnbuilder_tpu_torch.parallel.halo import active_halo

        if (self.gnn_conv != "gine" or not self.gnn_convs
                or self.gnn_convs[0].lin0.weight.device.type != "cuda"
                or active_halo() is not None):
            return None
        cfg = dispatch.gine_layer_cfg(g, self.gnn_activation)
        if cfg is None:
            return None
        mode = cfg.get("mode", "f32")

        def layers():
            return layer_operands([(c.lin0.weight.t(), c.lin1.weight.t())
                                   for c in self.gnn_convs], mode)

        if not torch.is_grad_enabled():
            return self._cached(f"{mode} gine layers", self._stack_width(),
                                layers)
        return layers() if mode == "f32" else None

    def _gat_operands(self):
        """Each GAT layer's kernel operands in the active policy's mode
        (``GATConv.mode_operands``: the weights of the mode and their
        staged layouts) under inference, cached like ``_kernel_params``
        (under bf16 / int8 with ``_mode_params``); None otherwise (a
        gradient, or another conv): a train step lays its live weights
        out on every call."""
        from gnnbuilder_tpu_torch.ops import dispatch

        mode = dispatch.policy()
        if (self.gnn_conv != "gat" or torch.is_grad_enabled()
                or dispatch._off()):
            return None
        width = self._stack_width()
        if mode == "f32":
            return self._cached(
                "f32 gat", width,
                lambda: [c.mode_operands("f32") for c in self.gnn_convs])
        return self._mode_params(width, mode)[2]

    def spec(self) -> dict:
        """The constructor's arguments, as plain JSON values: the model
        ``GNNModel(**spec())`` has the same parameter names and shapes."""
        return dict(
            graph_input_feature_dim=self.graph_input_feature_dim,
            gnn_hidden_dim=self.gnn_hidden_dim,
            gnn_num_layers=self.gnn_num_layers,
            gnn_output_dim=self.gnn_output_dim,
            gnn_conv=self.gnn_conv,
            gnn_activation=self.gnn_activation,
            gnn_skip_connection=self.gnn_skip_connection,
            graph_input_edge_dim=self.graph_input_edge_dim,
            pooling_aggrs=list(self.pooling_aggrs),
            mlp_hidden_dim=self.mlp_hidden_dim,
            mlp_hidden_layers=self.mlp_hidden_layers,
            mlp_out_dim=self.mlp_out_dim,
            mlp_activation=self.mlp_activation,
            output_activation=self.output_activation,
            gnn_p_in=self.gnn_p_in,
            gnn_p_hidden=self.gnn_p_hidden,
            gnn_p_out=self.gnn_p_out,
            mlp_p_in=self.mlp_p_in,
            mlp_p_hidden=self.mlp_p_hidden,
            mlp_p_out=self.mlp_p_out,
            conv_kwargs={k: list(v) if isinstance(v, tuple) else v
                         for k, v in self.conv_kwargs.items()},
            remat=self.remat,
        )

    def _fused_gnn_stack(self, g: GraphBatch, h):
        """The whole conv stack in one kernel call when the gate allows:
        PNA with the default aggregators and scalers, an activation the
        kernel has, a block-packed batch, inference scope.  None = run the
        per-layer loop."""
        if self.gnn_num_layers < 1 or self.gnn_conv not in _STACK_CONVS:
            return None
        if self.gnn_conv != "pna":
            return self._fused_mp_stack(g, h)
        if any(tuple(c.aggregators) != PNA_AGGREGATORS
               or tuple(c.scalers) != PNA_SCALERS for c in self.gnn_convs):
            return None
        from gnnbuilder_tpu_torch.ops import dispatch
        from gnnbuilder_tpu_torch.ops.cuda.pna_block import (
            STACK_ACTS,
            STACK_WIDTH,
            pna_block_stack_auto,
        )

        if self.gnn_activation not in STACK_ACTS:
            return None
        cfg = dispatch.pna_stack_cfg(g)
        if cfg is None:
            return None
        width = self._stack_width()
        if width > STACK_WIDTH:
            # the kernel holds one 128-wide row block; a wider stack takes
            # the per-layer path (row 5 on the ELL table)
            return None
        L = self.gnn_num_layers
        mode = cfg.get("mode", "f32")
        if mode == "f32":
            stacked, scales = self._kernel_params(width)[0], None
        else:
            stacked, scales = self._mode_params(width, mode)[0]
        staged = (self._staged_stack(width, mode) if h.device.type == "cuda"
                  else None)
        return pna_block_stack_auto(
            h, g.nbr_nodes, g.in_degree, stacked,
            deltas=[c.delta for c in self.gnn_convs],
            skips=[self.gnn_skip_connection and 0 < i < L - 1
                   for i in range(L)],
            act=self.gnn_activation, out_dim=self.gnn_output_dim,
            block_size=cfg["block_size"], mode=mode, scales=scales,
            staged=staged,
        )

    def _fused_mp_stack(self, g: GraphBatch, h):
        """The whole GCN or SAGE stack in one ``ops.cuda.mp_block`` call,
        in the gate's mode, when ``dispatch.mp_stack_cfg`` allows (GIN only
        when called with the kernel directly); None = run the per-layer
        loop."""
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
        width = self._stack_width()
        mode = cfg.get("mode", "f32")
        if mode == "f32":
            stacked, scales = self._kernel_params(width)[0], None
        else:
            stacked, scales = self._mode_params(width, mode)[0]
        staged = (self._staged_stack(width, mode) if h.device.type == "cuda"
                  else None)
        return mp_block_stack_auto(
            h, g.block_adj, g.in_degree, self.gnn_conv, stacked,
            epss=[getattr(c, "eps", 0.0) for c in self.gnn_convs],
            skips=[self.gnn_skip_connection and 0 < i < L - 1
                   for i in range(L)],
            act=self.gnn_activation, out_dim=self.gnn_output_dim,
            block_size=cfg["block_size"], mode=mode, scales=scales,
            staged=staged,
        )

    def _fused_readout(self, g: GraphBatch, h):
        """Pooling + MLP head + output activation in one kernel call when
        the gate allows; max pooling stays plain and streams in, and the
        backward recomputes the plain readout.  None = run GlobalPooling +
        MLP."""
        from gnnbuilder_tpu_torch.ops import dispatch, segment
        from gnnbuilder_tpu_torch.ops.cuda.readout import (
            fused_readout,
            fused_readout_vjp,
        )

        cfg = dispatch.readout_config(
            g, self.pooling_aggrs, self.mlp_activation,
            self.output_activation)
        if cfg is None:
            return None
        h = h.contiguous()
        mx = None
        if "max" in self.pooling_aggrs:
            mx = segment.contiguous_segment_max(
                h, g.graph_starts, g.n_node, g.max_graph_nodes_static)
        kw = dict(aggrs=self.pooling_aggrs, mx=mx, act=self.mlp_activation,
                  out_act=self.output_activation, starts=cfg["starts"])
        mode = cfg.get("mode", "f32")
        if mode != "f32" or not torch.is_grad_enabled():
            # inference (the modes have no backward): the head packed once
            return fused_readout(h, g.n_node, self._readout_head(mode),
                                 mode=mode, **kw)
        # the live weights, packed by the wrapper on every call
        weights = [(lin.weight.t(), lin.bias)
                   for lin in self.mlp_head.linear_layers]
        return fused_readout_vjp(h, g.n_node, weights, **kw)

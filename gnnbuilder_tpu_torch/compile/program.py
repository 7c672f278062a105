"""Program — the run driver: owns the model's parameters, the padding
bucket and the device, packs batches and runs the forward.

The JAX package's ``Program`` compiles one XLA executable per bucket; here
PyTorch runs eagerly and the bucket only fixes the padded shapes.  The
device is explicit: ``device=None`` means the CUDA card and raises when
there is none; the CPU runs only when the caller asks for it.

``precision`` ("f32", "bf16" or "int8", ``compile.precision``) is the
forward's policy, as in the JAX package: ``params`` stays the float32
master; under bf16 the forward runs a copy of the model whose parameters
are the master rounded to bf16 (``Precision.cast_params``, held as
float32 values) on node features rounded to bf16; under int8 it runs the
master with every ``Linear`` quantized, with the static activation scales
of ``calibrate_int8`` when it has them.  The output is float32.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Optional, Sequence

import torch

from gnnbuilder_tpu_torch.compile.precision import Precision
from gnnbuilder_tpu_torch.core.graph import (
    GraphBatch,
    build_graph_batch,
    resolve_device,
)
from gnnbuilder_tpu_torch.nn.model import GNNModel

__all__ = ["Program", "BucketSpec", "resolve_device",
           "enable_persistent_cache"]


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Keep compiled kernels across processes (serving cold start).  The
    JAX package's persistent cache of compiled executables maps onto the
    hashed nvcc build directory (``ops/cuda/_build.py``): a process loads
    the library an earlier one built for the same sources, headers, flags
    and compiler, and builds only when there is none.  That directory
    persists already, under ``build/gnnbuilder_tpu_torch`` of the
    checkout; ``path`` moves it (a library this process has loaded stays
    loaded).  Returns the directory."""
    from gnnbuilder_tpu_torch.ops.cuda import _build

    if path is not None:
        _build.set_build_root(path)
    return str(_build.build_root())


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static padded sizes of every batch this Program runs."""

    max_nodes: int
    max_edges: int
    max_graphs: int


class Program:
    def __init__(
        self,
        model: GNNModel,
        max_nodes: int = 500,
        max_edges: int = 500,
        max_graphs: int = 2,
        precision: Precision | str = "f32",
        seed: int = 0,
        block_size: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if block_size:
            assert max_nodes % block_size == 0, (max_nodes, block_size)
        # block_size > 0 selects block-diagonal packing (core/graph.py),
        # which the whole-stack kernel needs
        self.block_size = int(block_size)
        self.bucket = BucketSpec(max_nodes, max_edges, max_graphs)
        self.precision = (
            precision if isinstance(precision, Precision)
            else Precision.from_name(precision)
        )
        self._seed = seed
        self._initialized = False
        self.int8_scales: Optional[dict] = None
        self._cast = None      # (master key, bf16-rounded model copy)

    # ------------------------------------------------------------ params
    def init_params(self, example_batch: Optional[GraphBatch] = None):
        """Seeded init, torch.nn.Linear's law U(+-1/sqrt(fan_in)) for weight
        and bias (where the Linear has one) and GAT's attention vectors
        [1, H, C] glorot-uniform U(+-sqrt(6 / (H + C))) (the JAX package's
        init), drawn from one ``torch.Generator`` in module order; GCN's
        and GAT's separate biases stay zero, as in the JAX package.
        Returns the state dict."""
        from gnnbuilder_tpu_torch.nn.conv import GATConv

        gen = torch.Generator().manual_seed(self._seed)
        with torch.no_grad():
            for mod in self.model.modules():
                if isinstance(mod, GATConv):
                    bound = math.sqrt(6.0 / (mod.heads + mod.out_channels))
                    for p in (mod.att_src, mod.att_dst):
                        r = torch.rand(p.shape, generator=gen)
                        p.copy_((2.0 * r - 1.0) * bound)
                if isinstance(mod, torch.nn.Linear):
                    bound = 1.0 / math.sqrt(mod.in_features)
                    for p in (mod.weight, mod.bias):
                        if p is None:
                            continue
                        r = torch.rand(p.shape, generator=gen)
                        p.copy_((2.0 * r - 1.0) * bound)
        self._initialized = True
        return self.model.state_dict()

    def set_params(self, params: dict):
        """Load a state dict (e.g. ``port.params_from_jax``'s result)."""
        self.model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in params.items()}
        )
        self._initialized = True

    @property
    def params(self) -> dict:
        return self.model.state_dict()

    # ----------------------------------------------------------- batching
    def batch(self, graphs: Sequence) -> GraphBatch:
        return build_graph_batch(
            graphs,
            node_budget=self.bucket.max_nodes,
            edge_budget=self.bucket.max_edges,
            graph_budget=self.bucket.max_graphs,
            block_size=self.block_size or None,
            device=self.device,
        )

    # ------------------------------------------------------------ forward
    def _policy_model(self) -> GNNModel:
        """The model the forward runs: under bf16 a copy whose parameters
        are the master's rounded to bf16, rebuilt when a master parameter
        is replaced or changed in place; else the model itself."""
        if self.precision.name != "bf16":
            return self.model
        key = tuple((id(p), p._version) for p in self.model.parameters())
        if self._cast is None or self._cast[0] != key:
            cast = self.precision.cast_params(self.model.state_dict())
            cache, self.model._kernel_cache = self.model._kernel_cache, {}
            try:    # the copy starts with an empty kernel cache
                model = copy.deepcopy(self.model)
            finally:
                self.model._kernel_cache = cache
            model.load_state_dict({k: v.float() for k, v in cast.items()})
            self._cast = (key, model)
        return self._cast[1]

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        """[G, out] float32 predictions, ghost row included (mask with
        ``batch.graph_mask``).  Runs under inference scope and the
        precision policy, so a block-packed batch goes through the stack
        and readout kernels in the policy's mode."""
        from gnnbuilder_tpu_torch.ops.dispatch import inference_mode
        from gnnbuilder_tpu_torch.ops.quant import calibration, to_bf16

        if not self._initialized:
            self.init_params(batch)
        if batch.device != self.device:
            raise ValueError(f"batch on {batch.device}, program on "
                             f"{self.device}")
        prec = self.precision
        if prec.name == "bf16":
            batch = batch.replace(node_feat=to_bf16(batch.node_feat))
        static = (calibration(scales=self.int8_scales) if self.int8_scales
                  else contextlib.nullcontext())
        with torch.no_grad(), inference_mode(), prec.activate(), static:
            return self._policy_model()(batch).float()

    def calibrate_int8(self, batches: Sequence[GraphBatch]) -> dict:
        """Record static int8 activation scales from representative
        batches (``ops.quant.calibration``): one eager pass per batch
        through the plain path, each quantized site's max |activation|,
        then ``scale = max / 127`` for every later forward.  Returns
        {site: scale}, sites named as the model's modules."""
        from gnnbuilder_tpu_torch.ops.quant import (
            calibration,
            scales_from_record,
        )

        if self.precision.name != "int8":
            raise ValueError("calibrate_int8 requires precision='int8'")
        if not self._initialized:
            self.init_params(batches[0])
        record: dict = {}
        with torch.no_grad(), self.precision.activate(), \
                calibration(record=record):
            for b in batches:
                self.model(b)
        self.int8_scales = scales_from_record(record)
        return self.int8_scales

    def benchmark(self, batch: GraphBatch, iters: int = 25,
                  warmup: int = 3) -> dict:
        """Device time per forward, from CUDA events around ``iters``
        back-to-back forwards after ``warmup`` untimed ones.  CUDA only."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark measures the card; this Program "
                               f"runs on {self.device}")
        for _ in range(warmup):
            self.forward(batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            self.forward(batch)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
        real_graphs = int(batch.graph_mask.sum())
        real_edges = int(batch.edge_mask.sum())
        return {
            "latency_s": dt,
            "graphs_per_s": real_graphs / dt,
            "edges_per_s": real_edges / dt,
            "device": torch.cuda.get_device_name(self.device),
        }

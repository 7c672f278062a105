"""Program — the run driver: owns the model's parameters, the padding
bucket and the device, packs batches and runs the forward.

The JAX package's ``Program`` compiles one XLA executable per bucket; here
PyTorch runs eagerly and the bucket only fixes the padded shapes.  The
device is explicit: ``device=None`` means the CUDA card and raises when
there is none; the CPU runs only when the caller asks for it.
"""

from __future__ import annotations

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

__all__ = ["Program", "BucketSpec", "resolve_device"]


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

    # ------------------------------------------------------------ params
    def init_params(self, example_batch: Optional[GraphBatch] = None):
        """Seeded init, torch.nn.Linear's law U(+-1/sqrt(fan_in)) for weight
        and bias (where the Linear has one), drawn from one
        ``torch.Generator`` in module order; GCN's separate bias stays
        zero, as in the JAX package.  Returns the state dict."""
        gen = torch.Generator().manual_seed(self._seed)
        with torch.no_grad():
            for mod in self.model.modules():
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
    def forward(self, batch: GraphBatch) -> torch.Tensor:
        """[G, out] float32 predictions, ghost row included (mask with
        ``batch.graph_mask``).  Runs under inference scope, so a
        block-packed batch goes through the stack and readout kernels."""
        from gnnbuilder_tpu_torch.ops.dispatch import inference_mode

        if not self._initialized:
            self.init_params(batch)
        if batch.device != self.device:
            raise ValueError(f"batch on {batch.device}, program on "
                             f"{self.device}")
        with torch.no_grad(), inference_mode():
            return self.model(batch).float()

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

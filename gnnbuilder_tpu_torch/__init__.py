"""gnnbuilder_tpu_torch — the PyTorch/CUDA port of gnnbuilder_tpu.

The JAX package ``gnnbuilder_tpu`` is the reference; this package imports
torch and numpy only, and offers the same public surface but for the
design-space exploration (``NOT_YET_PORTED``).  Its models (``GNNModel``
with the nine convs, global pooling and an MLP head) run inference
through ``Program.forward``, in float32 or under the bf16 and int8
precision policies, training through ``train.make_train_step`` (fed by
``data.loader.GraphLoader``, with ``GNNModel(remat=True)`` to trade
memory for a replay), golden verification through ``verify`` and
``Program.run_parity_check``, and serving through ``serve.GNNServer``
(micro-batching over a live ``Program`` or over its ``export_bundle``).
On the card their hot paths run hand-written CUDA kernels (``ops/cuda``,
built from ``csrc`` with nvcc at first use); on the CPU, which a caller
asks for, the kernels' plain versions.  Batches are packed on the host
by a C++ packer (``native``, built with g++ at first use).
"""

from gnnbuilder_tpu_torch.compile.precision import Precision
from gnnbuilder_tpu_torch.compile.program import (
    Program,
    enable_persistent_cache,
)
from gnnbuilder_tpu_torch.core.graph import GraphBatch, build_graph_batch
from gnnbuilder_tpu_torch.data.datasets import FakeDataset, load_dataset
from gnnbuilder_tpu_torch.nn.conv import (
    SUPPORTED_GNN_CONVS,
    EdgeConv,
    GATConv,
    GCNConv,
    GINConv,
    GINEConv,
    LGConv,
    PNAConv,
    SAGEConv,
    SimpleConv,
)
from gnnbuilder_tpu_torch.nn.mlp import MLP
from gnnbuilder_tpu_torch.nn.model import GNNModel
from gnnbuilder_tpu_torch.nn.pool import (
    SUPPORTED_GLOBAL_POOLING_AGGRS,
    GlobalPooling,
)
from gnnbuilder_tpu_torch.utils.stats import (
    compute_average_degree,
    compute_average_nodes_and_edges,
    compute_in_deg_histogram,
    compute_max_nodes_and_edges,
    compute_median_degree,
    compute_median_nodes_and_edges,
)

__version__ = "0.1.0"

# names of the JAX package's public surface this package does not have
# yet: the design-space exploration (ROADMAP)
NOT_YET_PORTED = ("DSEEngine", "DSEConfig", "CostModel")

__all__ = [
    "GraphBatch",
    "build_graph_batch",
    "GCNConv",
    "GINConv",
    "GINEConv",
    "GATConv",
    "PNAConv",
    "SAGEConv",
    "LGConv",
    "SimpleConv",
    "EdgeConv",
    "SUPPORTED_GNN_CONVS",
    "MLP",
    "GNNModel",
    "GlobalPooling",
    "SUPPORTED_GLOBAL_POOLING_AGGRS",
    "Program",
    "enable_persistent_cache",
    "Precision",
    "compute_max_nodes_and_edges",
    "compute_average_nodes_and_edges",
    "compute_median_nodes_and_edges",
    "compute_average_degree",
    "compute_median_degree",
    "compute_in_deg_histogram",
    "FakeDataset",
    "load_dataset",
]

"""gnnbuilder_tpu_torch — the PyTorch/CUDA port of gnnbuilder_tpu.

The JAX package ``gnnbuilder_tpu`` is the reference; this package imports
torch and numpy only.  It runs canonical PNA inference through
``Program.forward`` and training through ``train.make_train_step``, with
hand-written CUDA kernels for the whole PNA conv stack, one PNA layer
(forward with residuals), the PNA aggregation backward and the fused
readout.
"""

from gnnbuilder_tpu_torch.compile.program import Program
from gnnbuilder_tpu_torch.core.graph import GraphBatch, build_graph_batch
from gnnbuilder_tpu_torch.data.datasets import FakeDataset, load_dataset
from gnnbuilder_tpu_torch.nn.model import GNNModel

__all__ = ["Program", "GraphBatch", "build_graph_batch", "GNNModel",
           "FakeDataset", "load_dataset"]

"""DSE configuration space: the model axes (conv, widths, layers, skip)
and the execution axes (batch size, precision, ELL width, block packing)
of one design point, the JAX package's ``dse/space.py`` with its fields,
its defaults and its sampling, so that a corpus of either package parses
here and gives the same feature vectors.

The cost model predicts latency for models that were never measured,
which is the point of the DSE: predict in milliseconds what measuring
takes seconds.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

__all__ = ["DSEConfig", "full_space", "space_size", "sample_space",
           "DEFAULT_AXES"]


@dataclasses.dataclass(frozen=True)
class DSEConfig:
    """One point in the design space (the JAX package's fields and
    defaults)."""

    conv: str = "gcn"
    gnn_hidden_dim: int = 128
    gnn_output_dim: int = 64
    gnn_num_layers: int = 3
    gnn_skip_connection: bool = True
    mlp_hidden_dim: int = 64
    mlp_hidden_layers: int = 4
    # execution policy
    batch_size: int = 256
    precision: str = "f32"          # f32 | bf16
    ell_width: Optional[int] = None  # None = auto, 0 = edge-list path
    # the JAX package's Pallas schedule knobs (ops.dispatch.
    # set_kernel_overrides): kept so that its corpora parse and its
    # feature columns line up; the card's kernels take None only
    tile_rows: Optional[int] = None
    gather_mode: Optional[str] = None
    window_mode: Optional[str] = None
    sub_rows: Optional[int] = None
    # layout: 0 = standard packing, B = block-diagonal packing at B rows
    block_size: int = 0
    # dataset statistics the latency depends on
    avg_nodes: float = 16.0
    avg_edges: float = 34.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# The JAX package's axes, in its order, but for its four Pallas schedule
# knobs (tile_rows, gather_mode, window_mode, sub_rows): they pick a TPU
# kernel's tile height, one-hot gather precision and window DMA schedule,
# which the card's kernels do not have (an indexed load is exact there),
# so each axis holds None alone: 8,064 points.
DEFAULT_AXES = {
    # every conv a GNNModel takes with in != out (LG and Simple need in ==
    # out at every layer; their aggregation is covered by the gcn rows)
    "conv": ["gcn", "gin", "sage", "pna", "gat", "gine", "edge"],
    "gnn_hidden_dim": [64, 128, 256],
    "gnn_output_dim": [32, 64],
    "gnn_num_layers": [2, 3, 4, 6],
    "gnn_skip_connection": [False, True],
    "mlp_hidden_dim": [64],
    "mlp_hidden_layers": [4],
    "batch_size": [64, 256, 1024],
    "precision": ["f32", "bf16"],
    "ell_width": [None, 0],
    "tile_rows": [None],
    "gather_mode": [None],
    "window_mode": [None],
    "sub_rows": [None],
    "block_size": [0, 128],
}


def full_space(axes: Optional[dict] = None):
    """Iterator over the full cartesian space (lazily)."""
    axes = dict(DEFAULT_AXES if axes is None else axes)
    keys = list(axes)
    for combo in itertools.product(*(axes[k] for k in keys)):
        yield DSEConfig(**dict(zip(keys, combo)))


def space_size(axes: Optional[dict] = None) -> int:
    axes = DEFAULT_AXES if axes is None else axes
    n = 1
    for v in axes.values():
        n *= len(v)
    return n


def sample_space(
    n: int, seed: int = 0, axes: Optional[dict] = None
) -> list[DSEConfig]:
    """``n`` configs drawn without replacement: a seeded permutation of
    the materialised space, its first ``n``."""
    rng = np.random.default_rng(seed)
    all_cfgs = list(full_space(axes))
    idx = rng.permutation(len(all_cfgs))[:n]
    return [all_cfgs[i] for i in idx]

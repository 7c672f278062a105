"""Design-space exploration on the card: the config space, the
measurement of a design point (``Program.benchmark_inner`` and
``cost_analysis``), the learned cost models and the ``DSEEngine`` front
end, with the JAX package's API.  ``python -m gnnbuilder_tpu_torch.dse.build``
measures the card corpus shipped in ``gnnbuilder_tpu_torch/dse_models/``
and fits it.  scikit-learn is needed to fit or predict, not to import.
"""

from gnnbuilder_tpu_torch.dse.analysis import dse_speedup_report
from gnnbuilder_tpu_torch.dse.engine import DSEEngine
from gnnbuilder_tpu_torch.dse.measure import measure_config, measure_many
from gnnbuilder_tpu_torch.dse.model import (
    CostModel,
    cv_mape,
    fit_cost_model,
    transform_x,
)
from gnnbuilder_tpu_torch.dse.space import DSEConfig, full_space, sample_space

__all__ = [
    "DSEEngine",
    "DSEConfig",
    "full_space",
    "sample_space",
    "measure_config",
    "measure_many",
    "CostModel",
    "cv_mape",
    "fit_cost_model",
    "transform_x",
    "dse_speedup_report",
]

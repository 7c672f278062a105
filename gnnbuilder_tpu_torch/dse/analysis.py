"""DSE speed and accuracy: what a prediction costs against a
measurement, and how far off it is, from a measured corpus."""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np

from gnnbuilder_tpu_torch.dse.model import fit_cost_model, rows_to_configs

__all__ = ["dse_speedup_report"]


def dse_speedup_report(rows: Sequence[dict], n_timing_reps: int = 50) -> dict:
    """Fit the cost model on ``rows`` (``measure_many`` output) and report:

    * mean measurement cost per design (warm-up + timing), seconds
    * mean prediction cost per design, seconds
    * the speedup ratio
    * cross-validated MAPE of the predictions
    """
    model, mape = fit_cost_model(rows)
    cfgs = rows_to_configs(rows)

    t0 = time.perf_counter()
    for _ in range(n_timing_reps):
        model.predict(cfgs[:1])
    predict_s = (time.perf_counter() - t0) / n_timing_reps

    measure_s = float(
        np.mean(
            [
                float(r.get("measure_s", r.get("compile_s", 0.0)))
                for r in rows
            ]
        )
    )
    return {
        "num_designs": len(rows),
        "cv_mape": mape,
        "predict_s_per_design": predict_s,
        "measure_s_per_design": measure_s,
        "speedup": measure_s / max(predict_s, 1e-9),
    }

"""DSEEngine: the design-space exploration front end (the JAX package's
API).  Given a dataset, measure a corpus of design points, fit the cost
model, rank candidate configs by prediction and measure the winners;
or start from the card corpus shipped with the package
(``from_pretrained``) and tune the execution knobs of a fixed model.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Sequence

import numpy as np

from gnnbuilder_tpu_torch.dse.measure import measure_config, measure_many
from gnnbuilder_tpu_torch.dse.model import (
    CostModel,
    fit_cost_model,
    rows_to_configs,
)
from gnnbuilder_tpu_torch.dse.space import DSEConfig, full_space, sample_space

__all__ = ["DSEEngine", "CORPUS_CSV", "pretrained_model"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the card corpus shipped with the package (``dse.build`` measures it)
CORPUS_CSV = os.path.join(_PKG, "dse_models", "perf_data.csv")
# where fitted models of a corpus are kept, one directory per corpus hash
CACHE_DIR = os.path.join(os.path.dirname(_PKG), "build", "dse")
PRETRAINED_TARGET = "latency_per_graph_us"


def read_rows(csv_path: str) -> list[dict]:
    import csv

    with open(csv_path) as f:
        return list(csv.DictReader(f))


def kept_rows(rows: Sequence[dict], floor: float = 1.0) -> list[dict]:
    """The rows ``fit_cost_model`` fits: per-call latency above
    ``floor`` us."""
    return [r for r in rows if float(r["latency_us"]) > floor]


def corpus_dir(csv_path: str = CORPUS_CSV) -> str:
    """The cache directory of a corpus: ``CACHE_DIR`` / the first 16 hex
    digits of the CSV's SHA-256, so that a new corpus fits anew."""
    with open(csv_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(CACHE_DIR, digest)


def fit_pretrained(rows: Sequence[dict]) -> CostModel:
    """The latency model of a corpus, per graph (the engine's objective),
    on ``kept_rows``; deterministic (``random_state=0``)."""
    rows = kept_rows(rows)
    y = np.asarray([float(r[PRETRAINED_TARGET]) for r in rows])
    return CostModel(target=PRETRAINED_TARGET).fit(rows_to_configs(rows), y)


def _save_atomic(model: CostModel, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    model.save(tmp)
    os.replace(tmp, path)


def pretrained_model(csv_path: str = CORPUS_CSV) -> str:
    """Path of the fitted latency model of the corpus ``csv_path``,
    fitting and caching it (``corpus_dir`` / ``model_direct.pk``) on
    first use; needs scikit-learn then."""
    path = os.path.join(corpus_dir(csv_path), "model_direct.pk")
    if not os.path.exists(path):
        _save_atomic(fit_pretrained(read_rows(csv_path)), path)
    return path


class DSEEngine:
    """Explore execution configs for a model spec on a dataset.

    Typical flow::

        eng = DSEEngine(dataset="qm9")
        rows = eng.build_corpus(n=40)        # measure a seed corpus
        eng.fit()                            # learned latency model (+MAPE)
        best = eng.optimize(candidates)      # rank by prediction
        truth = eng.verify(best[:3])         # measure winners
    """

    def __init__(
        self,
        dataset: str = "qm9",
        corpus_csv: Optional[str] = None,
        objective: str = "latency_per_graph_us",
    ):
        self.dataset = dataset
        self.corpus_csv = corpus_csv
        self.objective = objective
        self.rows: list[dict] = []
        self.cost_model: Optional[CostModel] = None
        self.mape: Optional[float] = None
        if corpus_csv and os.path.exists(corpus_csv):
            self.rows = read_rows(corpus_csv)

    @classmethod
    def from_pretrained(
        cls, dataset: str = "qm9", model_path: Optional[str] = None
    ) -> "DSEEngine":
        """Engine backed by a fitted cost model, so that a user ranks and
        tunes without measuring a corpus first.  ``model_path`` None: the
        model of the card corpus shipped with the package
        (``CORPUS_CSV``), fitted once and cached under ``build/dse/``
        (``pretrained_model``); no pickle ships in the tree."""
        if model_path is None:
            model_path = pretrained_model()
        eng = cls(dataset=dataset)
        eng.cost_model = CostModel.load(model_path)
        return eng

    # ------------------------------------------------------------- corpus
    def build_corpus(
        self, n: int = 40, seed: int = 0, axes: Optional[dict] = None,
        iters: int = 10,
    ) -> list[dict]:
        cfgs = sample_space(n, seed=seed, axes=axes)
        self.rows = measure_many(
            cfgs, dataset=self.dataset, iters=iters, out_csv=self.corpus_csv
        )
        return self.rows

    # ---------------------------------------------------------------- fit
    def fit(self, target: Optional[str] = None) -> float:
        target = target or self.objective
        if not self.rows:
            raise RuntimeError("no corpus; call build_corpus() first")
        self.cost_model, self.mape = fit_cost_model(self.rows, target=target)
        return self.mape

    # ------------------------------------------------------------ predict
    def predict(self, cfgs: Sequence[DSEConfig]) -> np.ndarray:
        if self.cost_model is None:
            self.fit()
        return self.cost_model.predict(cfgs)

    def optimize(
        self,
        candidates: Optional[Sequence[DSEConfig]] = None,
        top_k: int = 5,
    ) -> list[tuple[DSEConfig, float]]:
        """Rank candidate configs by predicted objective (ascending)."""
        if candidates is None:
            candidates = list(full_space())
        preds = self.predict(candidates)
        order = np.argsort(preds)[:top_k]
        return [(candidates[i], float(preds[i])) for i in order]

    # ------------------------------------------------------------- verify
    def verify(self, cfgs: Sequence[DSEConfig], iters: int = 15) -> list[dict]:
        """Measure ground truth for the predicted winners (on the card)."""
        return [
            measure_config(c, dataset=self.dataset, iters=iters) for c in cfgs
        ]

    # --------------------------------------------------------------- tune
    def tune_kernels(
        self,
        conv: str,
        gnn_hidden_dim: int = 128,
        gnn_output_dim: int = 64,
        gnn_num_layers: int = 6,
        gnn_skip_connection: bool = True,
        batch_size: int = 256,
        precision: str = "f32",
        avg_nodes: float = 16.0,
        avg_edges: float = 34.0,
        apply: bool = True,
    ) -> dict:
        """Pick the execution knobs of a fixed model and batch spec by
        prediction: ``ell_width`` in {None, 0} x ``block_size`` in {0,
        128}, 4 candidates (the JAX package's TPU schedule knobs stay
        None: the card's kernels have none).  With ``apply``, set the
        winner's ``ell_width`` process-wide through
        ``ops.dispatch.set_kernel_overrides``, leaving every other
        override as it was; ``ell_width`` is a packing-time knob, so
        batches packed after the call see it.  ``block_size`` is the
        caller's to pack with (``build_graph_batch`` / ``Program`` /
        ``GraphLoader``); it is reported in ``applied``.  Only knobs that
        keep the numerics are tuned."""
        base = dict(
            conv=conv, gnn_hidden_dim=gnn_hidden_dim,
            gnn_output_dim=gnn_output_dim, gnn_num_layers=gnn_num_layers,
            gnn_skip_connection=gnn_skip_connection,
            batch_size=batch_size, precision=precision,
            avg_nodes=avg_nodes, avg_edges=avg_edges,
        )
        cands = [
            DSEConfig(**base, ell_width=ew, block_size=bs_)
            for ew in (None, 0)
            for bs_ in (0, 128)
        ]
        ranked = self.optimize(cands, top_k=len(cands))
        best, best_pred = ranked[0]
        applied = {}
        if apply:
            from gnnbuilder_tpu_torch.ops import dispatch

            dispatch.set_kernel_overrides(ell_width=best.ell_width)
            applied = {
                "tile_rows": best.tile_rows, "ell_width": best.ell_width,
                "window_mode": best.window_mode,
                "block_size": best.block_size,
            }
        return {
            "best": best,
            "predicted_us_per_graph": best_pred,
            "ranked": ranked,
            "applied": applied,
        }

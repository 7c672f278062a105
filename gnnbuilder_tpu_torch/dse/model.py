"""Learned DSE cost models: predict a design point's latency (or memory)
without running it.

The JAX package's ``dse/model.py`` with the same numerics: the same
feature vector column for column (``transform_x``), the same regressor (a
robust linear fit on standardized features plus extra trees on its
residual, in log space), the same fast-regime specialist and the same
cross-validation.  The labels are the card's: ``dse.measure`` times each
design point with ``Program.benchmark_inner`` and counts its cost with
``Program.cost_analysis``.

scikit-learn is imported inside the functions that fit, so the package
imports where it is not installed; a fitted model needs it to predict.
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy as np

from gnnbuilder_tpu_torch.dse.space import DSEConfig

__all__ = [
    "transform_x",
    "fit_cost_model",
    "rows_to_configs",
    "CostModel",
    "cv_mape",
    "cv_mape_banded",
    "label_noise_floor",
    "LABEL_NOISE_BANDS",
]

# frozen: a fitted model indexes its features by name, so the one-hot
# list never changes (EdgeConv rides the appended "conv_edge" flag)
CONV_ONE_HOT = ["gcn", "gin", "sage", "pna", "gat", "gine", "lg", "simple"]

# the JAX package's columns, in its order and under its names, so a model
# fit by either package reads the other's vectors
FEATURE_NAMES = (
    [f"conv_{c}" for c in CONV_ONE_HOT]
    + [
        "gnn_hidden_dim",
        "gnn_output_dim",
        "gnn_num_layers",
        "gnn_skip_connection",
        "mlp_hidden_dim",
        "mlp_hidden_layers",
        "batch_size",
        "is_bf16",
        "is_ell",
        "tile_rows",
        "gather_bf16",
        "window_tile",
        "sub_rows",
        "avg_nodes",
        "avg_edges",
        # analytic estimates in log space: a few hundred noisy samples
        # cannot rediscover N * h^2 scaling, so the roofline terms are
        # handed to the model
        "log_flops_est",
        "log_bytes_est",
        "log_gather_est",
        "log_batch_nodes",
        "log_batch_edges",
        "log_hidden",
        "block_packed",
        # widths that are multiples of 128, and log-batch interactions
        "hidden_mxu_aligned",
        "out_mxu_aligned",
        "log_bs",
        "log_bs_log_h",
        "conv_edge",
        # the padded batch geometry of the measurement's packing policy
        # (node_multiple 256 at batch >= 64, else 8; block packing's
        # waste), computable for configs never measured
        "log_padded_nodes",
        "pad_ratio",
        "log_padded_edges",
        "log_flops_padded",
        "fused_gate_open",
    ]
)

# per-conv matmul cost relative to one N * h * h product a layer (PNA:
# the pre_nn pair, the 13-block post_nn and lin; GIN: a 2-layer MLP;
# SAGE: two products; GAT: projections and attention; LG / Simple: none;
# EdgeConv: two node products and lin1 at edge cost)
_CONV_MM = {
    "gcn": 1.0, "gin": 2.0, "sage": 2.0, "pna": 15.0, "gat": 3.0,
    "gine": 3.0, "lg": 0.0, "simple": 0.0,
    "edge": 5.0,
}


def _analytic_features(c: DSEConfig) -> list[float]:
    h = float(c.gnn_hidden_dim)
    L = float(c.gnn_num_layers)
    bs = float(c.batch_size)
    n = bs * max(float(c.avg_nodes), 1.0)
    e = bs * max(float(c.avg_edges), 1.0)
    mm = _CONV_MM.get(c.conv, 1.0)
    flops = 2.0 * n * h * h * mm * L + 2.0 * bs * (
        float(c.mlp_hidden_dim) ** 2 * float(c.mlp_hidden_layers)
    )
    gather = e * h * L                     # message traffic term
    itemsize = 2.0 if c.precision == "bf16" else 4.0
    bytes_est = itemsize * (n * h * (L + 1.0) + gather)
    lg = np.log
    return [
        float(lg(max(flops, 1.0))),
        float(lg(max(bytes_est, 1.0))),
        float(lg(max(gather, 1.0))),
        float(lg(max(n, 1.0))),
        float(lg(max(e, 1.0))),
        float(lg(max(h, 1.0))),
    ]


def _rup(x: float, m: float) -> float:
    return float(-(-x // m) * m)


def _padded_geometry(c: DSEConfig) -> tuple[float, float, float]:
    """(padded_nodes, pad_ratio, padded_edges) mirroring ``dse.measure``'s
    packing policy: node_multiple 256 at batch >= 64, else 8; block
    packing wastes about half a mean graph per block."""
    bs = float(c.batch_size)
    real_n = bs * max(float(c.avg_nodes), 1.0)
    real_e = bs * max(float(c.avg_edges), 1.0)
    if getattr(c, "block_size", 0):
        B = float(c.block_size)
        waste = B / max(B - float(c.avg_nodes) / 2.0, 1.0)
        n = _rup(real_n * waste + 1, B)
    else:
        n = _rup(real_n + 1, 256.0 if bs >= 64 else 8.0)
    e = _rup(real_e, 8.0)
    return n, n / max(real_n, 1.0), e


def _padded_features(c: DSEConfig) -> list[float]:
    n, ratio, e = _padded_geometry(c)
    h = float(c.gnn_hidden_dim)
    L = float(c.gnn_num_layers)
    mm = _CONV_MM.get(c.conv, 1.0)
    flops_padded = 2.0 * n * h * h * max(mm, 0.25) * L
    # the JAX package's layer-kernel gate (a width that is a multiple of
    # 128, or a 512-row floor); kept as a column of the shared schema
    aligned = float(c.gnn_hidden_dim) % 128 == 0
    gate = aligned or n >= 512
    return [
        float(np.log(n)),
        float(ratio),
        float(np.log(max(e, 1.0))),
        float(np.log(max(flops_padded, 1.0))),
        1.0 if gate else 0.0,
    ]


def transform_x(cfgs: Sequence[DSEConfig]) -> np.ndarray:
    """Config -> feature vector (one-hot conv, the numeric knobs, the
    analytic roofline terms and the padded geometry), float64, one row a
    config, columns ``FEATURE_NAMES``."""
    rows = []
    for c in cfgs:
        onehot = [1.0 if c.conv == name else 0.0 for name in CONV_ONE_HOT]
        rows.append(
            onehot
            + [
                float(c.gnn_hidden_dim),
                float(c.gnn_output_dim),
                float(c.gnn_num_layers),
                float(bool(c.gnn_skip_connection)),
                float(c.mlp_hidden_dim),
                float(c.mlp_hidden_layers),
                float(c.batch_size),
                1.0 if c.precision == "bf16" else 0.0,
                0.0 if c.ell_width == 0 else 1.0,
                float(c.tile_rows or 0),
                1.0 if c.gather_mode == "bf16" else 0.0,
                1.0 if getattr(c, "window_mode", None) == "tile" else 0.0,
                float(getattr(c, "sub_rows", None) or 0),
                float(c.avg_nodes),
                float(c.avg_edges),
            ]
            + _analytic_features(c)
            + [
                1.0 if getattr(c, "block_size", 0) else 0.0,
                1.0 if int(c.gnn_hidden_dim) % 128 == 0 else 0.0,
                1.0 if int(c.gnn_output_dim) % 128 == 0 else 0.0,
                float(np.log(float(c.batch_size))),
                float(np.log(float(c.batch_size))
                      * np.log(max(float(c.gnn_hidden_dim), 1.0))),
                1.0 if c.conv == "edge" else 0.0,
            ]
            + _padded_features(c)
        )
    return np.asarray(rows, dtype=np.float64)


class _HuberTreesResidual:
    """Robust power-law backbone plus tree residuals (log-target space).

    A Huber linear fit on the standardized features, which include the
    analytic log-roofline terms (so the linear part is a robust power-law
    model), carries the scaling trend; extra trees then model only the
    residual (kernel-regime effects the analytic terms miss).  Both fits
    are deterministic (``random_state=0``)."""

    def __init__(self, n_estimators=1200, min_samples_leaf=1, epsilon=1.35):
        self.n_estimators = n_estimators
        self.min_samples_leaf = min_samples_leaf
        self.epsilon = epsilon

    def fit(self, X, t):
        from sklearn.ensemble import ExtraTreesRegressor
        from sklearn.linear_model import HuberRegressor
        from sklearn.pipeline import make_pipeline
        from sklearn.preprocessing import StandardScaler

        self.linear_ = make_pipeline(
            StandardScaler(),
            HuberRegressor(max_iter=10000, epsilon=self.epsilon, tol=1e-6),
        ).fit(X, t)
        resid = t - self.linear_.predict(X)
        self.trees_ = ExtraTreesRegressor(
            n_estimators=self.n_estimators,
            min_samples_leaf=self.min_samples_leaf,
            random_state=0,
        ).fit(X, resid)
        return self

    def predict(self, X):
        return self.linear_.predict(X) + self.trees_.predict(X)


def _make_regressor():
    return _HuberTreesResidual()


# routing threshold of the fast-regime specialist (us of total latency):
# a config the global model predicts below it is predicted again by a
# model fit on the rows below it.  A constant of the model, the JAX
# package's, so that both packages fit the same model on the same rows.
_FAST_ROUTE_US = 300.0

# the labels' retest spread by band of total latency (us): the median
# relative spread |new - old| / mean of 8 corpus points a band measured
# again in a fresh process on an NVIDIA H100 80GB HBM3 at its 700 W limit
# (``python -m gnnbuilder_tpu_torch.dse.build --retest 24``;
# gnnbuilder_tpu_torch/dse_models/label_retest.json, to 4 digits).  A
# prediction is no more accurate than its labels.
LABEL_NOISE_BANDS = ((500.0, 0.002400), (2000.0, 0.006620),
                     (float("inf"), 0.003607))


def label_noise_floor(latency_us: float) -> float:
    for hi, noise in LABEL_NOISE_BANDS:
        if latency_us < hi:
            return noise
    return LABEL_NOISE_BANDS[-1][1]


class CostModel:
    """Latency (and optionally bytes) predictor over DSEConfigs.

    Two stages: a global model over the whole corpus and a fast-regime
    specialist fit on the rows below ``_FAST_ROUTE_US`` (when there are
    at least 30); a config the global model predicts fast is predicted
    again by the specialist."""

    def __init__(self, target: str = "latency_us", log_target: bool = True,
                 fast_specialist: bool = True):
        self.target = target
        self.log_target = log_target
        self.pipeline = _make_regressor()
        self.fast_specialist = fast_specialist
        self.fast_pipeline_ = None
        # the feature schema at fit time: a model fit before a feature
        # was added predicts on its own columns
        self.feature_names = list(FEATURE_NAMES)

    def _features(self, cfgs: Sequence[DSEConfig]) -> np.ndarray:
        X = transform_x(cfgs)
        names = getattr(self, "feature_names", None)
        if names is None:
            # a model without a schema: features were only ever appended,
            # so its training columns are a prefix of the vector
            pipe = self.pipeline
            n_in = getattr(pipe, "n_features_in_", None)
            if n_in is None:
                trees = getattr(pipe, "trees_", None)
                n_in = getattr(trees, "n_features_in_", None)
            if n_in is None:
                n_in = X.shape[1]
            return X[:, : int(n_in)]
        if list(names) != list(FEATURE_NAMES):
            idx = [FEATURE_NAMES.index(n) for n in names
                   if n in FEATURE_NAMES]
            if len(idx) != len(names):
                raise ValueError(
                    "pickled cost model uses features no longer computed: "
                    f"{set(names) - set(FEATURE_NAMES)}"
                )
            X = X[:, idx]
        return X

    def _total_scale(self, cfgs) -> np.ndarray:
        """Multiplier turning the target into total latency per call (the
        axis the specialist routes on): batch_size for the per-graph
        target, 1 for the per-call one."""
        if self.target == "latency_per_graph_us":
            return np.asarray([float(c.batch_size) for c in cfgs])
        return np.ones(len(cfgs))

    def fit(self, cfgs: Sequence[DSEConfig], y: np.ndarray) -> "CostModel":
        self.feature_names = list(FEATURE_NAMES)
        X = transform_x(cfgs)
        t = np.log(np.maximum(y, 1e-9)) if self.log_target else y
        self.pipeline.fit(X, t)
        self.fast_pipeline_ = None
        if (self.fast_specialist and self.log_target
                and self.target in ("latency_us", "latency_per_graph_us")):
            total = np.asarray(y) * self._total_scale(cfgs)
            fast = total < _FAST_ROUTE_US
            if fast.sum() >= 30:
                self.fast_pipeline_ = _HuberTreesResidual(
                    n_estimators=800
                ).fit(X[fast], t[fast])
        return self

    def predict(self, cfgs: Sequence[DSEConfig]) -> np.ndarray:
        X = self._features(cfgs)
        t = self.pipeline.predict(X)
        if getattr(self, "fast_pipeline_", None) is not None:
            total = np.exp(t) * self._total_scale(cfgs)
            sel = total < _FAST_ROUTE_US
            if sel.any():
                t = np.asarray(t, dtype=np.float64).copy()
                t[sel] = self.fast_pipeline_.predict(X[sel])
        return np.exp(t) if self.log_target else t

    def predict_with_noise_floor(
        self, cfgs: Sequence[DSEConfig]
    ) -> tuple[np.ndarray, np.ndarray]:
        """(prediction, label noise floor) per config: the floor is the
        labels' retest spread in the prediction's band
        (``LABEL_NOISE_BANDS``), so a delta below it is ranked by
        measuring, not by trusting the prediction."""
        pred = self.predict(cfgs)
        floors = np.asarray([label_noise_floor(p) for p in pred])
        return pred, floors

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "CostModel":
        with open(path, "rb") as f:
            return pickle.load(f)


def cv_mape(
    cfgs: Sequence[DSEConfig],
    y: np.ndarray,
    folds: int = 5,
    seed: int = 0,
    log_target: bool = True,
    target: str = "latency_us",
) -> float:
    """K-fold cross-validated mean absolute percentage error."""
    n = len(cfgs)
    folds = min(folds, n)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    mapes = []
    for k in range(folds):
        test = idx[k::folds]
        train = np.setdiff1d(idx, test)
        if len(train) == 0 or len(test) == 0:
            continue
        m = CostModel(target=target, log_target=log_target)
        m.fit([cfgs[i] for i in train], y[train])
        pred = m.predict([cfgs[i] for i in test])
        mapes.append(
            float(np.mean(np.abs(pred - y[test]) / np.maximum(y[test], 1e-9)))
        )
    return float(np.mean(mapes))


def cv_mape_banded(
    cfgs: Sequence[DSEConfig],
    y: np.ndarray,
    bands: Sequence[float] = (50.0, 150.0, 500.0, 2000.0),
    folds: int = 5,
    seed: int = 0,
    log_target: bool = True,
    band_by: np.ndarray | None = None,
    target: str = "latency_us",
) -> dict:
    """Out-of-fold MAPE broken down by label magnitude (``band_by``, by
    default the labels): small designs' labels spread more between
    measurements than large ones', so one scalar mostly reports the
    small designs' label noise; the bands separate it from model error.
    Returns {band: {"n", "mape"}} for the populated bands."""
    n = len(cfgs)
    folds = min(folds, n)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    pred = np.full(n, np.nan)
    for k in range(folds):
        test = idx[k::folds]
        train = np.setdiff1d(idx, test)
        if len(train) == 0 or len(test) == 0:
            continue
        m = CostModel(target=target, log_target=log_target)
        m.fit([cfgs[i] for i in train], y[train])
        pred[test] = m.predict([cfgs[i] for i in test])
    by = y if band_by is None else np.asarray(band_by, dtype=float)
    edges = [0.0, *bands, float("inf")]
    out = {}
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (by >= lo) & (by < hi) & ~np.isnan(pred)
        if not sel.any():
            continue
        ape = np.abs(pred[sel] - y[sel]) / np.maximum(y[sel], 1e-9)
        label = f"{lo:g}-{hi:g}" if np.isfinite(hi) else f">={lo:g}"
        out[label] = {"n": int(sel.sum()), "mape": float(np.mean(ape))}
    return out


def rows_to_configs(rows: Sequence[dict]) -> list[DSEConfig]:
    """Rebuild DSEConfigs from result rows (CSV round trips stringify;
    a column a corpus lacks means the default policy ran)."""
    cfg_fields = set(DSEConfig.__dataclass_fields__)
    str_fields = ("conv", "precision", "gather_mode", "window_mode")
    cfgs = []
    for r in rows:
        kw = {}
        for k in cfg_fields:
            v = r.get(k, None)
            if isinstance(v, str):
                if v in ("", "None"):
                    v = None
                elif k not in str_fields:
                    if v in ("True", "False"):
                        v = v == "True"
                    else:
                        v = float(v) if "." in v else int(v)
            kw[k] = v
        if kw.get("block_size") is None:
            kw["block_size"] = 0  # a corpus without the column: standard
        cfgs.append(DSEConfig(**kw))
    return cfgs


def fit_cost_model(
    rows: Sequence[dict],
    target: str = "latency_us",
    out_path: Optional[str] = None,
    floor: float = 1.0,
) -> tuple[CostModel, float]:
    """Fit from ``measure_many`` rows; returns (model, cv_mape).

    Rows whose per-call latency (``latency_us``) is at or below ``floor``
    (1 us) are dropped with a warning: such a label is a clamped
    measurement, and one of them moves the MAPE by orders of magnitude.
    A per-graph target may go below 1 us at large batches; the filter
    reads the per-call column."""
    cfgs = rows_to_configs(rows)
    y = np.asarray([float(r[target]) for r in rows])
    percall = np.asarray([float(r.get("latency_us", r[target]))
                          for r in rows])
    keep = percall > floor
    if not keep.all():
        import warnings

        warnings.warn(
            f"dropping {int((~keep).sum())}/{len(y)} rows at the "
            f"measurement noise floor (<= {floor})"
        )
        cfgs = [c for c, k in zip(cfgs, keep) if k]
        y = y[keep]
    model = CostModel(target=target).fit(cfgs, y)
    mape = cv_mape(cfgs, y, target=target)
    if out_path:
        model.save(out_path)
    return model, mape

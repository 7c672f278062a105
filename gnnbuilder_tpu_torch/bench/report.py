"""Results processing: pivot tables, plots, LaTeX — the JAX package's
``bench/report.py``, the analog of the reference's
experiments/process_and_plot_data.py (1,002 LoC of pandas/seaborn
post-processing) and print_graph_stats.py.

Reads the flat results files the harness (``bench/harness.py``) writes
(one value per ``<metric>_<backend>_<conv>_<dataset>.txt``, the format
the reference's experiments parse back at process_and_plot_data.py:22-45)
and/or ``results.json``, and produces:

* a tidy DataFrame + latency/throughput pivot tables (conv x dataset)
* a grouped-bar runtime plot per dataset (matplotlib)
* a LaTeX dataset-statistics table (print_graph_stats.py analog)

pandas and matplotlib are imported inside the functions that use them,
so the module imports where they are absent (a machine that runs the
grid); run the tables where they are installed.  A file name is split
at its last three underscores, as the JAX module splits it: a backend
with an underscore in its name (``torch_cpu``) lands in the metric.

CLI:  python -m gnnbuilder_tpu_torch.bench.report results/ --plot out.png
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "load_results",
    "pivot",
    "plot_runtimes",
    "dataset_stats_table",
]


def load_results(results_dir: str) -> "pandas.DataFrame":  # noqa: F821
    """Parse flat files (metric_backend_conv_dataset.txt) into a tidy frame;
    read results.json when there are none."""
    import pandas as pd

    rows = []
    for path in glob.glob(os.path.join(results_dir, "*_*_*_*.txt")):
        stem = os.path.basename(path)[:-4]
        parts = stem.split("_")
        # metric may contain underscores: backend/conv/dataset are the last 3
        metric = "_".join(parts[:-3])
        backend, conv, dataset = parts[-3:]
        with open(path) as f:
            value = float(f.read().strip().splitlines()[0])
        rows.append(
            dict(metric=metric, backend=backend, conv=conv,
                 dataset=dataset, value=value)
        )
    df = pd.DataFrame(rows)
    jpath = os.path.join(results_dir, "results.json")
    if os.path.exists(jpath) and df.empty:
        with open(jpath) as f:
            data = json.load(f)
        flat = []
        for r in data:
            for k, v in r.items():
                if isinstance(v, (int, float)):
                    flat.append(
                        dict(metric=k, backend=r["backend"], conv=r["conv"],
                             dataset=r["dataset"], value=float(v))
                    )
        df = pd.DataFrame(flat)
    return df


def pivot(
    df, metric: str = "latency_s", backend: Optional[str] = None
):
    """conv x dataset pivot for one metric (the reference's runtime tables)."""
    sel = df[df.metric == metric]
    if backend is not None:
        sel = sel[sel.backend == backend]
    return sel.pivot_table(
        index="conv", columns="dataset", values="value", aggfunc="mean"
    )


def plot_runtimes(
    df,
    out_path: str,
    metric: str = "latency_s",
    scale: float = 1e3,
    ylabel: str = "latency (ms/graph)",
):
    """Grouped bar chart: one group per dataset, one bar per (backend, conv)
    — the runtime comparison figure of the reference's experiments."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sel = df[df.metric == metric].copy()
    if sel.empty:
        raise ValueError(f"no rows for metric {metric!r}")
    sel["series"] = sel.backend + "/" + sel.conv
    datasets = sorted(sel.dataset.unique())
    series = sorted(sel.series.unique())
    width = 0.8 / max(len(series), 1)
    fig, ax = plt.subplots(figsize=(1.8 * len(datasets) + 2, 4))
    xs = np.arange(len(datasets))
    for i, s in enumerate(series):
        vals = [
            sel[(sel.series == s) & (sel.dataset == d)].value.mean() * scale
            for d in datasets
        ]
        ax.bar(xs + i * width, vals, width, label=s)
    ax.set_xticks(xs + 0.4 - width / 2)
    ax.set_xticklabels(datasets)
    ax.set_ylabel(ylabel)
    ax.set_yscale("log")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def dataset_stats_table(datasets: Sequence[str], n: int = 512) -> str:
    """LaTeX table of per-dataset graph statistics — the analog of
    experiments/print_graph_stats.py:29-43."""
    from gnnbuilder_tpu_torch.data.datasets import load_dataset
    from gnnbuilder_tpu_torch.utils.stats import (
        compute_average_degree,
        compute_average_nodes_and_edges,
        compute_max_nodes_and_edges,
        compute_median_nodes_and_edges,
    )

    lines = [
        r"\begin{tabular}{lrrrrrr}",
        r"\toprule",
        r"dataset & max$_n$ & max$_e$ & avg$_n$ & avg$_e$ "
        r"& med$_n$ & avg deg \\",
        r"\midrule",
    ]
    for name in datasets:
        gs = load_dataset(name, n=n)
        mx = compute_max_nodes_and_edges(gs)
        av = compute_average_nodes_and_edges(gs)
        md = compute_median_nodes_and_edges(gs)
        deg = compute_average_degree(gs)
        lines.append(
            f"{name} & {mx[0]} & {mx[1]} & {av[0]:.1f} & {av[1]:.1f} "
            f"& {md[0]:.0f} & {deg:.2f} \\\\"
        )
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("results_dir")
    ap.add_argument("--metric", default="latency_s")
    ap.add_argument("--plot", default=None)
    args = ap.parse_args()
    df = load_results(args.results_dir)
    print(pivot(df, args.metric).to_string())
    if args.plot:
        print("wrote", plot_runtimes(df, args.plot, metric=args.metric))


if __name__ == "__main__":
    main()

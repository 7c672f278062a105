"""DSE measurement: build and time one design point on the card.

The JAX package's ``dse/measure.py`` on the port: a design point is a
``GNNModel`` of the config's widths, a batch of the dataset packed as the
config says, and a ``Program``; its latency comes from
``Program.benchmark_inner`` (k chained forwards replayed from CUDA
graphs) and its cost (flops, bytes accessed, peak device bytes) from
``Program.cost_analysis``.  The rows keep the JAX package's keys, so a
corpus of either package fits the same ``CostModel``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from gnnbuilder_tpu_torch.compile.program import Program
from gnnbuilder_tpu_torch.core.graph import resolve_device
from gnnbuilder_tpu_torch.data.datasets import DATASET_SPECS
from gnnbuilder_tpu_torch.dse.space import DSEConfig
from gnnbuilder_tpu_torch.nn.model import GNNModel

__all__ = ["measure_config", "measure_many", "config_key"]


def config_key(cfg: DSEConfig) -> str:
    """A config's key in a corpus CSV (``_key``): its fields, sorted."""
    return repr(sorted(cfg.to_dict().items()))


def _build_model(cfg: DSEConfig, node_dim: int, edge_dim: int) -> GNNModel:
    conv_kwargs = {"delta": 2.0} if cfg.conv == "pna" else {}
    return GNNModel(
        graph_input_feature_dim=node_dim,
        graph_input_edge_dim=edge_dim,
        gnn_conv=cfg.conv,
        gnn_hidden_dim=cfg.gnn_hidden_dim,
        gnn_num_layers=cfg.gnn_num_layers,
        gnn_output_dim=cfg.gnn_output_dim,
        gnn_skip_connection=cfg.gnn_skip_connection,
        pooling_aggrs=("add", "mean", "max"),
        mlp_hidden_dim=cfg.mlp_hidden_dim,
        mlp_hidden_layers=cfg.mlp_hidden_layers,
        mlp_out_dim=1,
        conv_kwargs=conv_kwargs,
    )


def _design_point(cfg: DSEConfig, dataset: str, seed: int, device):
    """(cfg, prog, batch) of one design point on ``device``: the model of
    the config's widths (LG and Simple at input == hidden == output, on
    node features zero-padded to that width), the first batch of
    ``canonical_batches`` (2 x max(batch_size, 32) graphs of ``dataset``;
    ``node_multiple`` 256 at batch >= 64, else 8, as
    ``model._padded_geometry`` assumes; block packing at ``block_size``),
    the config with the dataset's mean nodes and edges a graph, and a
    seeded ``Program`` of the config's precision.  ``ell_width == 0``
    drops the batch's ELL table (``nbr_nodes`` / ``nbr_edges``), as the
    JAX package does; nothing else of the batch changes."""
    from gnnbuilder_tpu_torch.bench.canonical import (
        SAME_WIDTH_CONVS,
        canonical_batches,
    )

    spec = DATASET_SPECS[dataset]
    eq_dims = cfg.conv in SAME_WIDTH_CONVS
    if eq_dims:
        cfg = dataclasses.replace(cfg, gnn_output_dim=cfg.gnn_hidden_dim)
    node_dim = cfg.gnn_hidden_dim if eq_dims else spec.node_dim
    model = _build_model(cfg, node_dim, spec.edge_dim)

    n_graphs = max(cfg.batch_size, 32)
    graphs, batches = canonical_batches(
        dataset,
        n_graphs=n_graphs * 2,
        batch_size=cfg.batch_size,
        seed=seed,
        node_multiple=256 if cfg.batch_size >= 64 else 8,
        block_size=getattr(cfg, "block_size", 0),
        node_dim=node_dim if eq_dims else None,
        device=device,
    )
    batch = batches[0]
    # the dataset statistics the cost model learns from
    cfg = dataclasses.replace(
        cfg,
        avg_nodes=float(np.mean([g.num_nodes for g in graphs])),
        avg_edges=float(np.mean([g.num_edges for g in graphs])),
    )
    if cfg.ell_width == 0 and batch.nbr_nodes is not None:
        batch = batch.replace(nbr_nodes=None, nbr_edges=None)

    prog = Program(
        model,
        max_nodes=batch.num_nodes,
        max_edges=batch.num_edges,
        max_graphs=batch.num_graphs,
        precision=cfg.precision,
        block_size=getattr(cfg, "block_size", 0),
        device=device,
    )
    prog.init_params(batch)
    return cfg, prog, batch


def measure_config(
    cfg: DSEConfig,
    dataset: str = "qm9",
    iters: int = 15,
    seed: int = 0,
    repeats: int = 5,
    protocol: str = "inner",
    timing_only: bool = False,
    device=None,
) -> dict:
    """Build and time one config on the card; returns a flat result row:
    the config (with the dataset's statistics), ``dataset``,
    ``num_nodes`` / ``num_edges`` (the padded batch), ``latency_us``,
    ``latency_per_graph_us``, ``graphs_per_s``, ``edges_per_s``,
    ``protocol``, ``overhead_us``, ``flops``, ``bytes_accessed``,
    ``peak_hbm_bytes`` (0 under ``timing_only``), ``compile_s`` and
    ``measure_s`` (the JAX package's keys).

    ``protocol``:
    * "inner" (default): ``Program.benchmark_inner(batch, iters=iters,
      repeats=repeats, dynamic=True)``, one CUDA graph of one forward
      replayed k times, the slope over two k; the row says
      "inner_upper_bound" where the fit was degenerate;
    * "chained": ``Program.benchmark(batch, iters=iters,
      warmup=repeats)``, CUDA events around eager forwards (``repeats``
      becomes the untimed warm-up forwards: ``benchmark`` takes one
      timed window, not repeats).

    ``compile_s`` is ``Program.compile``'s warm-up forward (skipped
    under ``timing_only``).  The design point's knobs are pinned through
    ``ops.dispatch.set_kernel_overrides`` and set back to None after,
    also on failure; the card's kernels take only None for the JAX
    package's Pallas schedule knobs, so a config that sets one raises.
    ``device`` None is the card; the CPU raises, as ``benchmark`` does:
    this never times the CPU."""
    from gnnbuilder_tpu_torch.ops import dispatch

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"measure_config times the card; {device} asked")
    if protocol not in ("inner", "chained"):
        raise ValueError(f"unknown protocol {protocol!r}")
    cfg, prog, batch = _design_point(cfg, dataset, seed, device)

    dispatch.set_kernel_overrides(
        tile_rows=cfg.tile_rows, gather_mode=cfg.gather_mode,
        window_mode=getattr(cfg, "window_mode", None),
        sub_rows=getattr(cfg, "sub_rows", None),
    )
    try:
        t0 = time.perf_counter()
        if not timing_only:
            prog.compile(batch)
        compile_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        if protocol == "inner":
            bench = prog.benchmark_inner(batch, iters=iters,
                                         repeats=repeats, dynamic=True)
        else:
            bench = prog.benchmark(batch, iters=iters, warmup=repeats)
        bench_s = time.perf_counter() - t0
        cost = {} if timing_only else prog.cost_analysis(batch)
    finally:
        dispatch.set_kernel_overrides(None, None, sub_rows=None,
                                      window_mode=None)

    row = dict(cfg.to_dict())
    row.update(
        dataset=dataset,
        num_nodes=batch.num_nodes,
        num_edges=batch.num_edges,
        latency_us=bench["latency_s"] * 1e6,
        latency_per_graph_us=bench["latency_s"] * 1e6 / cfg.batch_size,
        graphs_per_s=bench["graphs_per_s"],
        edges_per_s=bench["edges_per_s"],
        protocol=(
            protocol if protocol != "inner"
            else ("inner" if bench.get("resolved", True)
                  else "inner_upper_bound")
        ),
        overhead_us=bench.get("overhead_s", 0.0) * 1e6,
        flops=float(cost.get("flops", 0.0)),
        bytes_accessed=float(cost.get("bytes accessed", 0.0)),
        peak_hbm_bytes=float(cost.get("peak_hbm_bytes", 0.0)),
        compile_s=compile_s,
        measure_s=compile_s + bench_s,
    )
    return row


def measure_many(
    cfgs,
    dataset: str = "qm9",
    iters: int = 15,
    out_csv: Optional[str] = None,
    verbose: bool = True,
) -> list[dict]:
    """Measure a list of configs; with ``out_csv``, append each row to the
    CSV as it comes, and resume: a config whose ``_key`` the CSV already
    holds is skipped, and its row read back.  A design point that raises
    is printed and skipped.  When a row has a column the CSV's header
    lacks, the file is first rewritten under the union of both."""
    import csv
    import os

    done = set()
    rows = []
    if out_csv and os.path.exists(out_csv):
        with open(out_csv) as f:
            for existing in csv.DictReader(f):
                done.add(existing.get("_key"))
                rows.append(existing)

    writer = None
    fh = None
    try:
        for i, cfg in enumerate(cfgs):
            key = config_key(cfg)
            if key in done:
                continue
            try:
                row = measure_config(cfg, dataset=dataset, iters=iters)
            except Exception as e:  # noqa: BLE001 — one bad design point
                # must not end a sweep of hundreds; it is printed
                if verbose:
                    print(f"[{i + 1}/{len(cfgs)}] {cfg.conv} "
                          f"h{cfg.gnn_hidden_dim} b{cfg.batch_size} "
                          f"FAILED: {type(e).__name__}: {str(e)[:200]}",
                          flush=True)
                continue
            row["_key"] = key
            rows.append(row)
            if verbose:
                print(
                    f"[{i + 1}/{len(cfgs)}] {cfg.conv} h{cfg.gnn_hidden_dim} "
                    f"L{cfg.gnn_num_layers} b{cfg.batch_size} {cfg.precision} "
                    f"-> {row['latency_us']:.0f} us",
                    flush=True,
                )
            if out_csv:
                if writer is None:
                    # appending under a header that lacks one of this
                    # row's fields would misalign every new row: rewrite
                    # the file under the union schema first
                    fields = list(row)
                    if os.path.exists(out_csv):
                        with open(out_csv) as rfh:
                            old_fields = next(csv.reader(rfh), [])
                        if not set(fields) <= set(old_fields):
                            union = list(
                                dict.fromkeys(old_fields + fields)
                            )
                            with open(out_csv, "w", newline="") as wfh:
                                w = csv.DictWriter(wfh, fieldnames=union)
                                w.writeheader()
                                for r_old in rows[:-1]:
                                    w.writerow({k: r_old.get(k, "")
                                                for k in union})
                            fields = union
                        else:
                            fields = old_fields
                        fh = open(out_csv, "a", newline="")
                        writer = csv.DictWriter(fh, fieldnames=fields)
                    else:
                        fh = open(out_csv, "a", newline="")
                        writer = csv.DictWriter(fh, fieldnames=fields)
                        writer.writeheader()
                writer.writerow(row)
                fh.flush()
    finally:
        if fh:
            fh.close()
    return rows

"""Benchmark harness: the conv x dataset sweep of the reference's
experiments (build_base_benchmarks.py / build_gnnbuilder_benchmarks.py),
the JAX package's ``bench/harness.py`` on the card.

Backends:
  * ``gpu``          — the compiled ``Program`` on the CUDA card (the
                       fpga_par analog): latency at batch 1, 4 and 256,
                       best-batch throughput, timed with CUDA events
                       (``Program.benchmark``);
  * ``torch_cpu``    — the pure-torch golden model single-threaded on the
                       CPU (the reference's PyG-CPU baseline analog,
                       build_base_benchmarks.py:158-239; pinned with
                       torch.set_num_threads(1) instead of
                       sched_setaffinity); ``torch_cpu_b4`` merges four
                       graphs per forward (the reference's *_b4 arm);
  * ``cpu``          — the same ``Program`` on the CPU, where every kernel
                       runs its plain version (the reference's cpp_cpu
                       arm analog), timed on the host clock.

Results are written in the reference's flat results-file format — one value
per ``<metric>_<backend>_<conv>_<dataset>.txt`` (its experiments parse these
back in process_and_plot_data.py:22-45) — plus one machine-readable JSON,
merged with the rows of earlier runs.  Energy: a bound from the card's
power limit (``bench/energy.card_tdp_w``), RAPL on the CPU where exposed.

CLI:  python -m gnnbuilder_tpu_torch.bench.harness --backends gpu \\
          --convs gcn,pna --datasets qm9,esol
      python -m gnnbuilder_tpu_torch.bench.harness --backends cpu,torch_cpu
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import time
from typing import Sequence

__all__ = ["run_grid", "bench_gpu", "bench_torch_cpu", "bench_cpu"]

# the reference's benchmark grid (build_gnnbuilder_benchmarks.py:128-148)
DEFAULT_CONVS = ("gcn", "gin", "pna", "sage")
DEFAULT_DATASETS = ("qm9", "esol", "freesolv", "lipo", "hiv")

# the reference's own FPGA runs (BASELINE.md fpga_par: s/graph at batch 1),
# the denominator of the vs_fpga_par ratios
FPGA_PAR_BASELINE_S = {
    ("gcn", "qm9"): 0.498e-3,
    ("pna", "qm9"): 1.707e-3,
    ("sage", "qm9"): 0.439e-3,
}

# convs whose canonical model takes block packing where a dataset's graphs
# fit one 128-row block
_BLOCK_CONVS = ("gcn", "gin", "sage", "pna", "gat", "edge")


def _packing(conv: str, dataset: str, bs: int) -> tuple:
    """(node_multiple, block_size) of the batches of ``bs`` graphs: the
    JAX package's rule, taken as it is and not re-measured on the card.
    Block packing at 128 rows for the convs with a block route on datasets
    whose largest graph fits a block, once ``bs`` graphs hold at least
    ``core.graph._BLOCK_AUTO_MIN_NODES`` nodes on average (and ``bs`` > 8);
    standard packing below that."""
    from gnnbuilder_tpu_torch.core.graph import _BLOCK_AUTO_MIN_NODES
    from gnnbuilder_tpu_torch.data.datasets import DATASET_SPECS

    spec = DATASET_SPECS[dataset]
    block = 128 if conv in _BLOCK_CONVS and spec.max_nodes <= 128 else 0
    use_block = block if bs * spec.mean_nodes >= _BLOCK_AUTO_MIN_NODES else 0
    return (256 if bs > 8 else 8), (use_block if bs > 8 else 0)


def _program_arm(conv, dataset, batch_sizes, n_graphs, iters, device,
                 latency):
    """The canonical model's latency and throughput at each batch size on
    ``device``: the first batch of each size, ``latency(prog, batch,
    iters)`` seconds a forward."""
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.compile.program import Program

    out = {}
    for bs in batch_sizes:
        node_multiple, block_size = _packing(conv, dataset, bs)
        graphs, batches = canonical_batches(
            dataset,
            n_graphs=max(n_graphs, bs + 1),
            batch_size=bs,
            node_multiple=node_multiple,
            block_size=block_size,
            device=device,
        )
        b = batches[0]
        model = canonical_model(conv, dataset, graphs=graphs)
        prog = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                       max_graphs=b.num_graphs, device=device)
        prog.init_params(b)
        dt = latency(prog, b, iters)
        real_edges = int(b.edge_mask.sum())
        out[f"latency_b{bs}_s"] = dt
        out[f"graphs_per_s_b{bs}"] = bs / dt
        out[f"edges_per_s_b{bs}"] = real_edges / dt
    out["latency_s"] = out[f"latency_b{batch_sizes[0]}_s"]
    best = max(batch_sizes, key=lambda bs: out[f"graphs_per_s_b{bs}"])
    out["best_batch_size"] = best
    out["graphs_per_s"] = out[f"graphs_per_s_b{best}"]
    out["edges_per_s"] = out[f"edges_per_s_b{best}"]
    return out


def bench_gpu(
    conv: str,
    dataset: str,
    # batch=4 mirrors the reference's *_b4 sweep arm
    # (build_base_benchmarks.py:162,246)
    batch_sizes: Sequence[int] = (1, 4, 256),
    n_graphs: int = 512,
    iters: int = 20,
) -> dict:
    """Compiled-Program latency and throughput of the canonical model on
    the card: the median of three windows of CUDA events, each around
    ``iters`` (at least 12) back-to-back forwards (``Program.benchmark``,
    as the JAX arm takes the median of three).  Energy: the bound at the
    card's power limit."""
    import torch

    from gnnbuilder_tpu_torch.bench.energy import (
        card_tdp_w,
        energy_bound_j_per_graph,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("bench_gpu measures the CUDA card and this "
                           "machine has none; run the cpu backend")

    def latency(prog, b, iters):
        return prog.benchmark(b, iters=max(iters, 12),
                              repeats=3)["latency_s"]

    out = _program_arm(conv, dataset, batch_sizes, n_graphs, iters, "cuda",
                       latency)
    # a forward of a few ms is shorter than nvidia-smi's sampling period,
    # so what is stated is the bound at the power limit, suffixed _bound
    tdp = card_tdp_w()
    out["energy_j_per_graph_bound"] = energy_bound_j_per_graph(
        1.0 / out["graphs_per_s"], tdp)
    out["energy_tdp_w_assumed"] = tdp
    return out


def bench_torch_cpu(
    conv: str, dataset: str, n_graphs: int = 64, reps: int = 3,
    batch_size: int = 1,
) -> dict:
    """Pure-torch golden model, single-threaded CPU — the PyG-CPU baseline
    analog (build_base_benchmarks.py:158-239).  ``batch_size`` > 1 merges
    that many graphs per forward (offset edge indices + batch vector) like
    the reference's *_b4 sweep arm (build_base_benchmarks.py:162)."""
    import torch

    from gnnbuilder_tpu_torch.bench.canonical import CANONICAL
    from gnnbuilder_tpu_torch.bench.energy import (
        CPU_TDP_W,
        cpu_energy_j,
        energy_bound_j_per_graph,
    )
    from gnnbuilder_tpu_torch.data.datasets import DATASET_SPECS, load_dataset
    from gnnbuilder_tpu_torch.utils.stats import compute_pna_delta
    from gnnbuilder_tpu_torch.verify import torch_ref as tr

    torch.set_num_threads(1)
    spec = DATASET_SPECS[dataset]
    graphs = load_dataset(dataset, n=n_graphs)
    conv_kwargs = {}
    if conv == "pna":
        conv_kwargs["delta"] = compute_pna_delta(graphs)
    tmodel = tr.TorchGNNModel(
        graph_input_feature_dim=spec.node_dim,
        graph_input_edge_dim=spec.edge_dim,
        gnn_conv=conv,
        conv_kwargs=conv_kwargs,
        **CANONICAL,
    )
    tmodel.eval()
    if batch_size > 1:
        tensors = []
        for i in range(0, len(graphs) - batch_size + 1, batch_size):
            chunk = graphs[i: i + batch_size]
            off, xs, eis, bvec = 0, [], [], []
            for gi, g in enumerate(chunk):
                xs.append(torch.tensor(g.x))
                eis.append(torch.tensor(g.edge_index) + off)
                bvec.append(torch.full((g.num_nodes,), gi,
                                       dtype=torch.long))
                off += g.num_nodes
            tensors.append((
                torch.cat(xs, 0), torch.cat(eis, 1), torch.cat(bvec),
            ))
    else:
        tensors = [
            (torch.tensor(g.x), torch.tensor(g.edge_index)) for g in graphs
        ]

    def call(t):
        if batch_size > 1:
            tx, tei, bvec = t
            return tmodel(tx, tei, batch=bvec, num_graphs=batch_size)
        tx, tei = t
        return tmodel(tx, tei, num_graphs=1)

    def loop():
        for _ in range(reps):
            for t in tensors:
                call(t)

    with torch.no_grad():
        for t in tensors[:4]:  # warmup
            call(t)
        measured = cpu_energy_j(loop)  # RAPL when exposed (bare metal)
        if measured is not None:
            _, joules, dt_total = measured
            n_calls = reps * len(tensors)
            dt = dt_total / (n_calls * batch_size)
            return {
                "latency_s": dt,
                "graphs_per_s": 1.0 / dt,
                "energy_j_per_graph": joules / (n_calls * batch_size),
                "energy_w_avg": joules / dt_total,
            }
        t0 = time.perf_counter()
        loop()
        dt = (time.perf_counter() - t0) / (
            reps * len(tensors) * batch_size
        )
    return {
        "latency_s": dt,
        "graphs_per_s": 1.0 / dt,
        # no RAPL exposed: TDP-derived upper bound
        "energy_j_per_graph_bound": energy_bound_j_per_graph(dt, CPU_TDP_W),
        "energy_tdp_w_assumed": CPU_TDP_W,
    }


def _host_latency(prog, b, iters):
    """Host-clock seconds a forward (``bench/timing.marginal_time``: two
    call counts, the fence's cost cancelled), the call-count gap widened
    until the timed window clears the clock's jitter."""
    from gnnbuilder_tpu_torch.bench.timing import marginal_time

    n_hi = max(iters, 12)
    dt = marginal_time(prog.forward, b, n_hi=n_hi, repeats=3)
    if dt * (n_hi - 5) < 2e-3:
        gap = min(int(2e-3 / max(dt, 2e-5)) + 50, 400)
        dt = marginal_time(prog.forward, b, n_lo=gap // 5, n_hi=gap,
                           repeats=3)
    return dt


def bench_cpu(
    conv: str,
    dataset: str,
    batch_sizes: Sequence[int] = (1, 4, 256),
    n_graphs: int = 256,
    iters: int = 12,
) -> dict:
    """The compiled Program on the **CPU** — the counterpart of the JAX
    package's ``xla_cpu`` arm and the reference's ``cpp_cpu`` arm
    (build_gnnbuilder_benchmarks.py:156-232: the generated C++ kernel
    compiled for and timed on one CPU core).  Same model, same batches and
    packing as ``bench_gpu``; on the CPU every kernel runs its plain torch
    version, and the forward is timed on the host clock.  With RAPL
    exposed (bare metal), package energy is measured around a forward loop
    at the best batch size; else the TDP bound is reported."""

    from gnnbuilder_tpu_torch.bench.energy import (
        CPU_TDP_W,
        cpu_energy_j,
        energy_bound_j_per_graph,
        rapl_available,
    )

    out = _program_arm(conv, dataset, batch_sizes, n_graphs, iters, "cpu",
                       _host_latency)
    best = out["best_batch_size"]
    lat = out[f"latency_b{best}_s"]
    measured = None
    if lat > 0 and rapl_available():
        from gnnbuilder_tpu_torch.bench.canonical import (
            canonical_batches,
            canonical_model,
        )
        from gnnbuilder_tpu_torch.compile.program import Program

        graphs, batches = canonical_batches(
            dataset, n_graphs=max(n_graphs, best + 1), batch_size=best,
            node_multiple=256 if best > 8 else 8, device="cpu",
        )
        b = batches[0]
        model = canonical_model(conv, dataset, graphs=graphs)
        prog = Program(model, max_nodes=b.num_nodes, max_edges=b.num_edges,
                       max_graphs=b.num_graphs, device="cpu")
        prog.init_params(b)
        fwd = prog.compile(b)
        k = max(int(0.5 / lat), 3)  # ~0.5 s of work for a stable delta

        def loop():
            for _ in range(k):
                fwd(None, b)

        measured = cpu_energy_j(loop)
    if measured is not None:
        _, joules, dt_total = measured
        out["energy_j_per_graph"] = joules / (k * best)  # measured (RAPL)
        out["energy_w_avg"] = joules / dt_total
    else:
        out["energy_j_per_graph_bound"] = energy_bound_j_per_graph(
            1.0 / out["graphs_per_s"], CPU_TDP_W
        )
        out["energy_tdp_w_assumed"] = CPU_TDP_W
    return out


_BACKENDS = {
    "gpu": bench_gpu,
    "torch_cpu": bench_torch_cpu,
    # the reference's batch=4 sweep arm (build_base_benchmarks.py:162,246)
    "torch_cpu_b4": functools.partial(bench_torch_cpu, batch_size=4),
    # the reference's cpp_cpu arm analog: the same Program on the CPU
    "cpu": bench_cpu,
}


def run_grid(
    convs: Sequence[str] = DEFAULT_CONVS,
    datasets: Sequence[str] = DEFAULT_DATASETS,
    backends: Sequence[str] = ("gpu",),
    results_dir: str = "results",
    verbose: bool = True,
    **kw,
) -> list[dict]:
    """Run the grid; write reference-format flat files + results.json."""
    os.makedirs(results_dir, exist_ok=True)
    rows = []
    for backend in backends:
        fn = _BACKENDS[backend]
        # backends accept disjoint kwargs (iters/batch_sizes vs reps):
        # route only what each signature takes
        accepted = set(inspect.signature(fn).parameters)
        bkw = {k: v for k, v in kw.items() if k in accepted}
        for conv in convs:
            for ds in datasets:
                r = fn(conv, ds, **bkw)
                r.update(backend=backend, conv=conv, dataset=ds)
                base = FPGA_PAR_BASELINE_S.get((conv, ds))
                if base is not None:
                    r["vs_fpga_par"] = base / r["latency_s"]
                rows.append(r)
                # reference flat format: one value per file, parsed back by
                # process_and_plot_data.py:22-45
                metrics = ["latency_s", "graphs_per_s"]
                # the b4 point gets its own flat files, like the
                # reference's *_b4.txt results
                metrics += [m for m in ("latency_b4_s", "graphs_per_s_b4")
                            if m in r]
                for metric in metrics:
                    path = os.path.join(
                        results_dir, f"{metric}_{backend}_{conv}_{ds}.txt"
                    )
                    with open(path, "w") as f:
                        f.write(f"{r[metric]}\n")
                if verbose:
                    extra = (
                        f" ({r['vs_fpga_par']:.0f}x fpga_par)"
                        if "vs_fpga_par" in r
                        else ""
                    )
                    print(
                        f"{backend:10s} {conv:5s} {ds:8s} "
                        f"{r['latency_s'] * 1e3:8.3f} ms/graph"
                        f"{extra}",
                        flush=True,
                    )
    # merge with prior runs (other backends) instead of clobbering
    jpath = os.path.join(results_dir, "results.json")
    merged = []
    if os.path.exists(jpath):
        with open(jpath) as f:
            prior = json.load(f)
        ran = {(r["backend"], r["conv"], r["dataset"]) for r in rows}
        merged = [
            r for r in prior
            if (r["backend"], r["conv"], r["dataset"]) not in ran
        ]
    with open(jpath, "w") as f:
        json.dump(merged + rows, f, indent=1)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--convs", default=",".join(DEFAULT_CONVS))
    ap.add_argument("--datasets", default=",".join(DEFAULT_DATASETS))
    ap.add_argument("--backends", default="gpu")
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--n-graphs", type=int, default=512)
    args = ap.parse_args()
    run_grid(
        convs=args.convs.split(","),
        datasets=args.datasets.split(","),
        backends=args.backends.split(","),
        results_dir=args.results_dir,
        n_graphs=args.n_graphs,
    )


if __name__ == "__main__":
    main()

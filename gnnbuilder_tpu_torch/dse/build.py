"""Measure the card's DSE corpus, fit its cost models, retest its labels.

    python -m gnnbuilder_tpu_torch.dse.build [--n 82] [--datasets qm9,esol,hiv]
        [--seed 0] [--max-minutes M] [--csv PATH]    # measure (card)
    python -m gnnbuilder_tpu_torch.dse.build --retest 24 [--csv PATH]
        [--retest-json PATH]                         # retest (card)
    python -m gnnbuilder_tpu_torch.dse.build --fit-only [--csv PATH]

Measuring samples ``--n`` configs a dataset from ``space.DEFAULT_AXES``
(seed ``--seed`` + the dataset's index, as the JAX package's
``experiments/build_dse.py``) and times them with ``measure_many``
(``iters=12``) into the CSV (default the package's
``dse_models/perf_data.csv``).  It resumes: a config whose key the CSV
holds is skipped, so a sweep spans several runs, and ``--max-minutes``
stops it between design points.  The key holds no dataset, so a config
drawn for two datasets is measured once: 82 a dataset give 241 distinct
points over three datasets.  Each run appends what it measured, what
failed and the card (``nvidia-smi``'s name and power limit) to
``corpus_runs.json`` beside the CSV.

``--retest K`` measures K corpus points again in this process, K / 3 from
each band of ``model.LABEL_NOISE_BANDS`` (seeded, 7), and writes each
band's median relative spread |new - old| / mean(new, old) to
``label_retest.json`` beside the CSV: the bands that ``LABEL_NOISE_BANDS``
holds.

``--fit-only`` (the CPU is enough; needs scikit-learn) fits the latency
model per graph and the peak-memory model into ``build/dse/<hash of the
CSV>/`` (``model_direct.pk``, ``model_memory.pk``: what
``DSEEngine.from_pretrained`` loads) and writes ``report.json`` beside
the CSV: CV MAPE, MAPE by band of total latency, the retest bands, and
the seconds to predict a design against the seconds to measure one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from gnnbuilder_tpu_torch.dse import engine
from gnnbuilder_tpu_torch.dse.model import (
    LABEL_NOISE_BANDS,
    CostModel,
    cv_mape,
    cv_mape_banded,
    rows_to_configs,
)

ITERS = 12
RETEST_SEED = 7


def _card() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    return {"nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0)}


def _need_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("measuring the corpus needs the CUDA card")


def build(csv_path: str, n: int, datasets: list[str], seed: int,
          max_minutes: float) -> dict:
    """Measure the corpus into ``csv_path`` until done or out of time;
    returns this run's record."""
    from gnnbuilder_tpu_torch.dse.measure import config_key, measure_many
    from gnnbuilder_tpu_torch.dse.space import sample_space

    _need_card()
    t0 = time.perf_counter()
    record = dict(_card(), started=time.strftime("%Y-%m-%dT%H:%M:%S"),
                  n=n, seed=seed, iters=ITERS, measured=0, failed=[],
                  complete=False)
    before = len(engine.read_rows(csv_path)) if os.path.exists(csv_path) \
        else 0
    out_of_time = False
    for di, ds in enumerate(datasets):
        cfgs = sample_space(n, seed=seed + di)
        print(f"=== dataset {ds}: {len(cfgs)} configs ===", flush=True)
        for cfg in cfgs:
            if (time.perf_counter() - t0) / 60.0 > max_minutes:
                out_of_time = True
                break
            rows = measure_many([cfg], dataset=ds, iters=ITERS,
                                out_csv=csv_path)
            if config_key(cfg) not in {r.get("_key") for r in rows}:
                record["failed"].append(dict(dataset=ds, **cfg.to_dict()))
        if out_of_time:
            print(f"time budget of {max_minutes} min reached; run again "
                  f"to resume", flush=True)
            break
    after = len(engine.read_rows(csv_path)) if os.path.exists(csv_path) \
        else 0
    record.update(measured=after - before, rows=after,
                  complete=not out_of_time,
                  seconds=time.perf_counter() - t0)
    return record


def _bands_of(lat: np.ndarray) -> list[np.ndarray]:
    edges = [0.0] + [hi for hi, _ in LABEL_NOISE_BANDS]
    return [np.flatnonzero((lat >= lo) & (lat < hi))
            for lo, hi in zip(edges[:-1], edges[1:])]


def retest(csv_path: str, k: int) -> dict:
    """Measure ``k`` corpus points again (timing only) and return each
    ``LABEL_NOISE_BANDS`` band's relative spread."""
    from gnnbuilder_tpu_torch.dse.measure import measure_config

    _need_card()
    rows = engine.read_rows(csv_path)
    cfgs = rows_to_configs(rows)
    lat = np.asarray([float(r["latency_us"]) for r in rows])
    rng = np.random.default_rng(RETEST_SEED)
    bands = _bands_of(lat)
    per = k // len(bands)
    sample = []
    for ids in bands:
        sample += list(rng.choice(ids, size=min(per, len(ids)),
                                  replace=False))
    # a band short of points gives its share to the others
    rest = np.setdiff1d(np.arange(len(rows)), sample)
    if len(sample) < k and len(rest):
        sample += list(rng.choice(rest, size=min(k - len(sample),
                                                 len(rest)), replace=False))
    out = dict(_card(), started=time.strftime("%Y-%m-%dT%H:%M:%S"),
               protocol="inner, timing_only", iters=ITERS, rows=[],
               failed=[])
    for j, i in enumerate(sample):
        r, cfg = rows[int(i)], cfgs[int(i)]
        try:
            fresh = measure_config(cfg, dataset=r["dataset"], iters=ITERS,
                                   timing_only=True)
        except Exception as e:  # noqa: BLE001 — recorded, not hidden
            out["failed"].append(dict(row=int(i), error=f"{type(e).__name__}"
                                      f": {str(e)[:300]}"))
            print(f"[{j}] FAILED {type(e).__name__}: {e}", flush=True)
            continue
        old, new = float(r["latency_us"]), float(fresh["latency_us"])
        spread = abs(new - old) / max((new + old) / 2.0, 1e-9)
        out["rows"].append(dict(row=int(i), conv=r["conv"],
                                hidden=r["gnn_hidden_dim"],
                                batch=r["batch_size"], dataset=r["dataset"],
                                old_us=old, new_us=new, rel_spread=spread,
                                protocol_new=fresh["protocol"]))
        print(f"[{j + 1}/{len(sample)}] {r['conv']} h{r['gnn_hidden_dim']} "
              f"b{r['batch_size']} {r['dataset']}: {old:.1f} vs {new:.1f} "
              f"us (spread {spread:.3f})", flush=True)
    edges = [0.0] + [hi for hi, _ in LABEL_NOISE_BANDS]
    summary = {}
    for lo, hi in zip(edges[:-1], edges[1:]):
        sp = [x["rel_spread"] for x in out["rows"] if lo <= x["old_us"] < hi]
        label = f"{lo:g}-{hi:g}" if np.isfinite(hi) else f">={lo:g}"
        summary[label] = dict(
            n=len(sp),
            median_rel_spread=float(np.median(sp)) if sp else None,
            p90_rel_spread=float(np.percentile(sp, 90)) if sp else None)
    all_sp = [x["rel_spread"] for x in out["rows"]]
    summary["overall_median"] = float(np.median(all_sp)) if all_sp else None
    out["by_band_us"] = summary
    print(json.dumps(summary, indent=1), flush=True)
    return out


def fit(csv_path: str) -> dict:
    """Fit both models of the corpus into its cache directory and return
    the report."""
    rows = engine.read_rows(csv_path)
    kept = engine.kept_rows(rows)
    print(f"{len(rows)} corpus rows, {len(kept)} above the 1 us floor",
          flush=True)
    out_dir = engine.corpus_dir(csv_path)
    report = {"num_designs": len(rows), "num_fit": len(kept),
              "protocol": sorted({r.get("protocol", "") for r in rows}),
              "target": engine.PRETRAINED_TARGET,
              "model_dir": os.path.relpath(out_dir, os.path.dirname(
                  os.path.dirname(engine.CACHE_DIR)))}

    t0 = time.perf_counter()
    model = engine.fit_pretrained(rows)
    report["fit_s"] = time.perf_counter() - t0
    engine._save_atomic(model, os.path.join(out_dir, "model_direct.pk"))
    cfgs = rows_to_configs(kept)
    y_pg = np.asarray([float(r["latency_per_graph_us"]) for r in kept])
    total_us = np.asarray([float(r["latency_us"]) for r in kept])
    report["cv_mape_latency"] = cv_mape(cfgs, y_pg,
                                        target=engine.PRETRAINED_TARGET)
    report["cv_mape_latency_by_total_us"] = cv_mape_banded(
        cfgs, y_pg, band_by=total_us, target=engine.PRETRAINED_TARGET)
    print(f"latency model: CV MAPE {report['cv_mape_latency']:.4f}",
          flush=True)
    for band, st in report["cv_mape_latency_by_total_us"].items():
        print(f"  band {band} us: MAPE {st['mape']:.4f} (n={st['n']})",
              flush=True)

    mem = [r for r in rows if float(r.get("peak_hbm_bytes", 0) or 0) > 0]
    if mem:
        mcfgs = rows_to_configs(mem)
        y = np.asarray([float(r["peak_hbm_bytes"]) for r in mem])
        mmodel = CostModel(target="peak_hbm_bytes").fit(mcfgs, y)
        engine._save_atomic(mmodel, os.path.join(out_dir,
                                                 "model_memory.pk"))
        report["cv_mape_memory"] = cv_mape(mcfgs, y,
                                           target="peak_hbm_bytes")
        report["num_memory_rows"] = len(mem)
        print(f"memory model: CV MAPE {report['cv_mape_memory']:.4f} "
              f"({len(mem)} rows)", flush=True)

    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        model.predict(cfgs[:25])
    report["predict_s_per_design"] = (time.perf_counter() - t0) / (
        reps * min(25, len(cfgs)))
    report["measure_s_per_design"] = float(
        np.median([float(r["measure_s"]) for r in rows]))
    report["speedup"] = (report["measure_s_per_design"]
                         / report["predict_s_per_design"])
    retest_path = os.path.join(os.path.dirname(csv_path),
                               "label_retest.json")
    if os.path.exists(retest_path):
        with open(retest_path) as f:
            report["label_retest"] = json.load(f)["by_band_us"]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--csv", default=engine.CORPUS_CSV)
    ap.add_argument("--n", type=int, default=82, help="designs a dataset")
    ap.add_argument("--datasets", default="qm9,esol,hiv")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-minutes", type=float, default=1e9,
                    help="stop between design points after this long")
    ap.add_argument("--fit-only", action="store_true")
    ap.add_argument("--retest", type=int, default=0,
                    help="measure this many corpus points again")
    ap.add_argument("--retest-json", default=None,
                    help="where --retest writes (default: "
                         "label_retest.json beside the CSV)")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(args.csv))
    os.makedirs(here, exist_ok=True)
    if args.fit_only:
        report = fit(args.csv)
        with open(os.path.join(here, "report.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps(report, indent=1), flush=True)
    elif args.retest:
        out = retest(args.csv, args.retest)
        path = args.retest_json or os.path.join(here, "label_retest.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    else:
        record = build(args.csv, args.n, args.datasets.split(","),
                       args.seed, args.max_minutes)
        runs_path = os.path.join(here, "corpus_runs.json")
        runs = []
        if os.path.exists(runs_path):
            with open(runs_path) as f:
                runs = json.load(f)
        runs.append(record)
        with open(runs_path, "w") as f:
            json.dump(runs, f, indent=1)
        print(json.dumps({k: v for k, v in record.items()
                          if k != "failed"}), flush=True)
        print(f"{len(record['failed'])} design point(s) failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

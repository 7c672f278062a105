"""The GINE layer kernel's rows (12, 12b, 12i) and the reverse-table
gather's (row 7) on the card.

* Rows 12 (f32), 12b (bf16) and 12i (int8) of ``ops/cuda/gine_layer.py``:
  the six launches of a GINE forward, standard-packed (the b1024 train
  batch, N = 18,688) and block-packed (the first b1024 block batch, N =
  20,480), the canonical model (seeded weights, each layer on the
  per-layer plain path's input, weights brought to the mode beforehand);
  where the tree has ``layer_operands``, both weight paths: the caller's
  weights ("stream") and the Ring layout laid out beforehand ("ring"),
  and the layout of the six layers alone ("staging").
* Row 7 of ``ops/cuda/ell_bwd.py`` on the train batch: the six lin-only
  gathers of a GCN step (128 wide in five layers, 64 in the last), the
  six of a PNA step with PNA's seven coefficient blocks (half the
  extremum refs hit v), the same six over ``reverse_csr`` (the PNA step
  without a reverse table), and six tie counts over the forward table
  (cmp-only), each with the SHA-256 of its dv (the same on every tree
  whose sums are the same) and, where the tree has
  ``ell_gather_backward_ordered``, whether dv equals the slot-ordered
  loop bit for bit.
* The GINE, GIN and PNA train steps (Adam 1e-3; PNA also without the
  reverse table) by events and by device time per part, and
  ``Program.forward`` b1024 of GINE block- and standard-packed under f32,
  bf16 and int8 (with ``--paths``: also with the model's GINE layers
  held to the caller's-weights path).

    python gnnbuilder_tpu_torch/bench/gine_gather_rows.py [--root DIR]
        [--paths]

``--root`` imports ``gnnbuilder_tpu_torch`` from DIR (default: this
file's tree), so one call can time an older tree beside this one (a
``git archive`` of the parent commit) through the same public wrappers.
Rows: CUDA-event ms (10 after 2 warm-up rounds) and the device ms by
kernel under torch.profiler (5 rounds).  Forwards: events over 10 after
3.  Train steps: events over 10 steps after 3, then the profiler over 5.
Prints the card's name and power limit, then one JSON line.  Needs a
card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys

ITERS, WARMUP, PROF_ITERS = 10, 2, 5
GINE_MODES = {"12": "f32", "12b": "bf16", "12i": "int8"}


def _events(fn, iters=ITERS, warmup=WARMUP):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_split(fn, part_of, n=PROF_ITERS):
    """Device ms and kernel launches per call of fn by part
    (``part_of(kernel name)``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split, count = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        part = part_of(e.name.lower())
        us = e.time_range.end - e.time_range.start
        split[part] = split.get(part, 0.0) + us / 1e3 / n
        count[part] = count.get(part, 0) + 1 / n
    return split, count


def _part(name):
    """The port's kernel a launch belongs to, or a class of torch's."""
    for key in ("gine_layer", "ell_gather_bwd", "mp_layer", "pna_scatter",
                "pna_proj", "pna_agg", "pna_v", "readout"):
        if key in name:
            return key
    if "adam" in name or "multi_tensor" in name:
        return "Adam"
    if any(t in name for t in ("gemm", "cutlass", "xmma", "gemv")):
        return "torch matmul"
    return "other torch"


def _timed(fn):
    split, count = _device_split(fn, _part)
    kern = {k: v for k, v in split.items() if k in (
        "gine_layer", "ell_gather_bwd")}
    return dict(ms=_events(fn), device_ms=sum(kern.values()),
                split=split, launches=count)


def _sha(t):
    import torch

    torch.cuda.synchronize()
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def _layer_inputs(model, g):
    """(conv, h, skip) of each conv layer, h advanced through the
    per-layer plain path."""
    from gnnbuilder_tpu_torch.ops import dispatch

    L = model.gnn_num_layers
    h, out = g.node_feat, []
    dispatch.set_fused_mode("never")
    try:
        for i, c in enumerate(model.gnn_convs):
            skip = h if model.gnn_skip_connection and 0 < i < L - 1 else None
            out.append((c, h, skip))
            h = c(g, h, model.gnn_activation, skip)
    finally:
        dispatch.set_fused_mode("auto")
    return out


def _t(w):
    return w.detach().t().contiguous()


def _log(msg):
    print(msg, flush=True)


def gine_rows(report, gine, std, blk):
    """Rows 12, 12b, 12i: a forward's six per packing, mode and path."""
    import torch

    from gnnbuilder_tpu_torch.ops.cuda import gine_layer, mp_layer

    ring = hasattr(gine_layer, "layer_operands")
    for packing, g in (("standard", std), ("block", blk)):
        lays = [((h.contiguous(), c.lin_edge(g.edge_feat).contiguous(),
                  g.nbr_nodes, g.nbr_edges, g.in_degree),
                 dict(w0=_t(c.lin0.weight), b0=c.lin0.bias.detach(),
                      w1=_t(c.lin1.weight), b1=c.lin1.bias.detach(),
                      eps=c.eps, skip=sk, act=gine.gnn_activation))
                for c, h, sk in _layer_inputs(gine, g)]
        for row, mode in GINE_MODES.items():
            weights = [(kw["w0"], kw["w1"]) for _, kw in lays]
            ops = [mp_layer.prepare_layer(w0, w1, mode) + (None,)
                   for w0, w1 in weights]
            paths = {"stream": ops}
            if ring:
                paths["ring"] = gine_layer.layer_operands(weights, mode)
            for path, opl in paths.items():
                calls = []
                for (a, kw), (w0, w1, s0, s1, st) in zip(lays, opl):
                    k = dict(kw, w0=w0, w1=w1, mode=mode)
                    if mode == "int8":
                        k.update(s0=s0, s1=s1)
                    if st is not None:
                        k["staged"] = st
                    calls.append((a, k))

                def six(calls=calls):
                    for a, k in calls:
                        gine_layer.fused_gine_layer(*a, **k)

                res = _timed(six)
                key = f"{row} {packing} {path}"
                report["rows"][key] = res
                _log(f"row {key} six [N={g.num_nodes}]: {res['ms']:.4f} ms "
                     f"(events), device {res['device_ms']:.4f}")
            if ring:
                res = _timed(lambda: gine_layer.layer_operands(weights,
                                                               mode))
                res["device_ms"] = sum(res["split"].values())
                report["rows"][f"{row} {packing} staging"] = res
                _log(f"row {row} {packing} staging of six layers: "
                     f"{res['ms']:.4f} ms (events), device "
                     f"{res['device_ms']:.4f}, launches "
                     f"{sum(res['launches'].values()):.0f}")


def gather_rows(report, std):
    """Row 7's four term sets and modes: a step's six each."""
    import torch

    from gnnbuilder_tpu_torch.ops import ell
    from gnnbuilder_tpu_torch.ops.cuda import ell_bwd

    dev = std.nbr_nodes.device
    gen = torch.Generator(device=dev).manual_seed(31)
    n = std.num_nodes
    widths = [128] * 5 + [64]
    ptr, idx = ell.reverse_csr(std.nbr_nodes, std.in_degree)
    sets = {"lin-only": [], "PNA terms": [], "CSR PNA": [], "tie counts": []}
    for F in widths:
        v = torch.randn(n, F, generator=gen, device=dev)
        cs = torch.randn(n, 7 * F, generator=gen, device=dev)
        hit = torch.rand(n, F, generator=gen, device=dev) < 0.5
        first = v[std.rev_nbr_nodes[:, 0].long()]
        cs[:, 3 * F:4 * F] = torch.where(hit, first, cs[:, 3 * F:4 * F])
        ds = cs[:, :F].contiguous()
        ext = torch.where(hit, v[std.nbr_nodes[:, 0].long()], v)
        ones = torch.cat([v, torch.ones_like(v)], dim=-1)
        sets["lin-only"].append(("table", (ds, std.rev_nbr_nodes,
                                           std.out_degree, None, True,
                                           False, 0)))
        sets["PNA terms"].append(("table", (cs, std.rev_nbr_nodes,
                                            std.out_degree, v, True, True,
                                            2)))
        sets["CSR PNA"].append(("csr", (cs, ptr, idx, v, True, True, 2)))
        sets["tie counts"].append(("table", (ones, std.nbr_nodes,
                                             std.in_degree, ext, False,
                                             False, 1)))
    fn = {"table": ell_bwd.fused_gather_backward,
          "csr": ell_bwd.fused_gather_backward_csr}
    ordered = {"table": getattr(ell_bwd, "ell_gather_backward_ordered", None),
               "csr": getattr(ell_bwd, "ell_gather_backward_csr_ordered",
                              None)}
    for name, calls in sets.items():
        def six(calls=calls):
            return [fn[m](*a) for m, a in calls]

        res = _timed(six)
        outs = six()
        res["sha256"] = _sha(torch.cat([o.flatten() for o in outs]))
        if ordered["table"] is not None:
            res["equals_ordered"] = all(
                torch.equal(o, ordered[m](*a)) for o, (m, a) in
                zip(outs, calls))
        report["rows"][f"7 {name}"] = res
        _log(f"row 7 {name} six: {res['ms']:.4f} ms (events), device "
             f"{res['device_ms']:.4f}; sha256 {res['sha256'][:16]}"
             + (f"; equals the slot-ordered loop: {res['equals_ordered']}"
                if "equals_ordered" in res else ""))


def steps(report, tgraphs, std, models, no_rev=True):
    import torch

    from gnnbuilder_tpu_torch import train

    torch.set_grad_enabled(True)
    target = train.stack_targets(tgraphs[:1024], std.num_graphs,
                                 device=std.nbr_nodes.device)
    cells = [(c, std) for c in models]
    if no_rev:
        cells.append(("pna without reverse table",
                      std.replace(rev_nbr_nodes=None, out_degree=None)))
    for name, g in cells:
        model = models[name.split()[0]]
        step = train.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-3))
        ms = _events(lambda: step(g, target), warmup=3)
        split, count = _device_split(lambda: step(g, target), _part)
        report["train"][name] = dict(ms=ms, device_ms=sum(split.values()),
                                     split=split, launches=count)
        _log(f"{name} train step: {ms:.4f} ms (events), device busy "
             f"{sum(split.values()):.4f}: " + ", ".join(
                 f"{k} {v:.4f} ({count[k]:.0f})" for k, v in split.items()))
    torch.set_grad_enabled(False)


def forwards(report, tgraphs, std, blk, gine, paths):
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import canonical_model
    from gnnbuilder_tpu_torch.ops.cuda import gine_layer, mp_layer

    variants = {"": None}
    if paths and hasattr(gine_layer, "layer_operands"):
        def stream_only(weights, mode):
            return [mp_layer.prepare_layer(w0.detach().contiguous(),
                                           w1.detach().contiguous(), mode)
                    + (None,) for w0, w1 in weights]

        variants[" stream"] = stream_only
    orig = getattr(gine_layer, "layer_operands", None)
    for suffix, patch in variants.items():
        if patch is not None:
            gine_layer.layer_operands = patch
        try:
            for packing, g in (("block", blk), ("standard", std)):
                for precision in ("f32", "bf16", "int8"):
                    prog = Program(canonical_model("gine", "qm9",
                                                   graphs=tgraphs),
                                   max_nodes=g.num_nodes,
                                   max_edges=g.num_edges,
                                   max_graphs=g.num_graphs,
                                   block_size=128 if packing == "block"
                                   else 0,
                                   precision=precision,
                                   device=g.nbr_nodes.device, seed=41)
                    prog.set_params({k: v.to(g.nbr_nodes.device) for k, v
                                     in gine.state_dict().items()})
                    ms = _events(lambda: prog.forward(g), warmup=3)
                    key = f"gine {packing} {precision}{suffix}"
                    report["forward_ms"][key] = ms
                    _log(f"Program.forward {key}: {ms:.4f} ms")
        finally:
            if orig is not None:
                gine_layer.layer_operands = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__)
                                          .resolve().parents[2]))
    ap.add_argument("--paths", action="store_true",
                    help="also the GINE forwards and step on the "
                         "caller's-weights path")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.ops.cuda import _build, gine_layer, mp_layer

    if not torch.cuda.is_available():
        print("gine_gather_rows: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip()
    _log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.load()
    report = {"root": os.path.abspath(args.root), "smi": smi,
              "device": torch.cuda.get_device_name(0), "rows": {},
              "forward_ms": {}, "train": {}}
    torch.set_grad_enabled(False)
    tgraphs, (std,) = canonical_batches("qm9", n_graphs=1100,
                                        batch_size=1024, node_multiple=256,
                                        device=dev)
    bgraphs, (blk, *_) = canonical_batches("qm9", n_graphs=3072,
                                           batch_size=1024, block_size=128,
                                           node_multiple=1024, device=dev)
    models = {}
    for conv in ("gine", "gin", "pna"):
        models[conv] = canonical_model(conv, "qm9", graphs=tgraphs)
        Program(models[conv], device=dev, seed=41).init_params()
    gine_rows(report, models["gine"], std, blk)
    gather_rows(report, std)
    forwards(report, tgraphs, std, blk, models["gine"], args.paths)
    steps(report, tgraphs, std, models)
    if args.paths and hasattr(gine_layer, "layer_operands"):
        orig = gine_layer.layer_operands
        gine_layer.layer_operands = lambda ws, mode: [
            mp_layer.prepare_layer(w0.detach().contiguous(),
                                   w1.detach().contiguous(), mode) + (None,)
            for w0, w1 in ws]
        try:
            sub = {"train": {}}
            steps(sub, tgraphs, std, {"gine": models["gine"]}, False)
            report["train"]["gine stream"] = sub["train"]["gine"]
        finally:
            gine_layer.layer_operands = orig
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

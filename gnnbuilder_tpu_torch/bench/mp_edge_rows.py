"""The mp layer kernel's rows (4, 4b, 4i) and the EdgeConv kernel's (13,
13b) on the card.

* Rows 4 (f32), 4b (bf16) and 4i (int8) of ``ops/cuda/mp_layer.py``, gin
  and sage in ELL mode at the interior shape (128 in, hidden and out,
  skip, relu; f32 with s saved, as a train step launches it) on the b1024
  standard-packed train batch (N = 18,688): one launch each, with the
  SHA-256 of the saved s (the same on every tree whose neighbour sums
  are unchanged); gcn, lg and simple_sum in f32 beside them.
* The six launches of a GIN and of a SAGE standard forward in each mode
  (the canonical model, seeded weights, each layer on the per-layer
  plain path's input, weights brought to the mode beforehand); rows 13
  and 13b: the six launches of an EdgeConv block forward on the first
  b1024 block batch; row 12 (GINE's six, f32), whose FMA kernel shares
  ``csrc/dense_rows.cuh`` with the parent's rows 4 and 13.
* ``Program.forward`` b1024 of standard-packed GIN and SAGE under f32,
  bf16 and int8 and of block-packed EdgeConv under f32 and bf16; the GIN
  and SAGE train steps (Adam 1e-3) with their device time by part.
* Row 4's elementwise instances (gcn, lg, simple_sum, simple_mean): one
  launch each at 128 wide (skip, relu; f32 with s saved, bf16 without)
  in ELL mode on the train batch and in block mode on the first b1024
  block batch, with the SHA-256 of out and s, and each instance's
  registers and CTAs an SM (``gnnb_mp_layer_ew_info``); the GCN train
  step with its device time by part (six row-4 launches);
  ``Program.forward`` of LG, Simple-sum and Simple-mean on the block
  batch (input 128 wide, six row-4 launches each).  ``--ew`` runs this
  part alone.

    python gnnbuilder_tpu_torch/bench/mp_edge_rows.py [--root DIR] [--ew]

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

# the shared timing helpers; run as a script, this file's directory is
# on sys.path and the package is imported later, from --root
if __package__:
    from .timing import _device_split, _events
else:
    from timing import _device_split, _events

ROW_MODES = {"4": "f32", "4b": "bf16", "4i": "int8"}


KERNELS = ("mp_layer_tc", "mp_layer_ew", "mp_layer", "edge_proj",
           "edge_slot", "gine_layer")


def _kernel_part(name):
    """The kernel's name (this tree's launches apart), or "other"."""
    for key in KERNELS:
        if key in name:
            return key
    return "other"


def _timed(fn):
    split, _ = _device_split(fn, _kernel_part)
    return dict(ms=_events(fn),
                device_ms=sum(v for k, v in split.items() if k != "other"),
                split=split)


def _step_part(name):
    if "mp_layer" in name:
        return "mp_layer kernel"
    if "ell_gather_bwd" in name:
        return "ell_gather_bwd kernel"
    if "readout_kernel" in name:
        return "readout kernel"
    if "adam" in name or "multi_tensor" in name:
        return "Adam"
    if any(t in name for t in ("gemm", "cutlass", "xmma", "gemv")):
        return "torch matmul"
    return "other torch kernels"


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


EW_CONVS = ("gcn", "lg", "simple_sum", "simple_mean")
SAME_WIDTH = (("lg", "lg", {}),
              ("simple_sum", "simple", {"aggregation": "sum"}),
              ("simple_mean", "simple", {"aggregation": "mean"}))


def _elementwise(report, tgraphs, std):
    """Row 4's elementwise instances, the GCN train step and the LG /
    Simple block forwards into ``report``."""
    import hashlib

    import torch

    from gnnbuilder_tpu_torch import Program, train
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.ops.cuda import mp_layer

    def sha(t):
        torch.cuda.synchronize()
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()

    dev = std.nbr_nodes.device
    bgraphs, (blk, *_) = canonical_batches(
        "qm9", n_graphs=3072, batch_size=1024, block_size=128,
        node_multiple=1024, node_dim=128, device=dev)
    report.update(ew={}, ew_sha256={}, block_rows=blk.num_nodes)
    for packing, g in (("ell", std), ("block", blk)):
        gen = torch.Generator(device=dev).manual_seed(43)
        x = torch.randn(g.num_nodes, 128, generator=gen, device=dev)
        skip = torch.randn(g.num_nodes, 128, generator=gen, device=dev)
        b0 = torch.randn(128, generator=gen, device=dev) * .1
        badj = g.block_adj if packing == "block" else None
        for conv in EW_CONVS:
            for mode in ("f32", "bf16"):
                kw = dict(skip=skip, act="relu", block_adj=badj, mode=mode,
                          save_s=mode == "f32",
                          b0=b0 if conv == "gcn" else None)

                def run(kw=kw, conv=conv):
                    return mp_layer.fused_mp_layer(x, g.nbr_nodes,
                                                   g.in_degree, conv, **kw)

                key = f"{conv} {packing} {mode}"
                res = _timed(run)
                report["ew"][key] = res
                got = run()
                out, s = got if mode == "f32" else (got, None)
                report["ew_sha256"][key] = dict(
                    out=sha(out), s=None if s is None else sha(s))
                print(f"row 4 {key} [N={g.num_nodes}, 128 wide]: "
                      f"{res['ms']:.4f} ms (events), device "
                      f"{res['device_ms']:.4f}", flush=True)

    # every elementwise instance's registers and CTAs an SM
    import ctypes

    from gnnbuilder_tpu_torch.ops.cuda import _build

    lib = _build.load()
    if hasattr(lib, "gnnb_mp_layer_ew_info"):
        res = {}
        for block in (0, 1):
            for mode in ("f32", "bf16"):
                for conv in EW_CONVS:
                    for relu in (1, 0):
                        for vec in (1, 0):
                            vals = [ctypes.c_int() for _ in range(2)]
                            err = lib.gnnb_mp_layer_ew_info(
                                block, mp_layer.MODES[mode],
                                mp_layer.MP_CONVS[conv], relu, vec,
                                *map(ctypes.byref, vals))
                            if err:
                                raise RuntimeError(
                                    f"gnnb_mp_layer_ew_info: cudaError {err}")
                            res[f"{'block' if block else 'ell'} {mode} "
                                f"{conv} {'relu' if relu else 'any act'} "
                                f"{'float4' if vec else 'scalar'}"] = dict(
                                    registers=vals[0].value,
                                    ctas_per_sm=vals[1].value)
        report["ew_instances"] = res
        print("row 4 elementwise instances (registers, CTAs an SM): "
              + "; ".join(f"{k} {v['registers']}, {v['ctas_per_sm']}"
                          for k, v in res.items() if "relu float4" in k),
              flush=True)

    torch.set_grad_enabled(True)
    model = canonical_model("gcn", "qm9", graphs=tgraphs)
    Program(model, device=dev, seed=41).init_params()
    target = train.stack_targets(tgraphs[:1024], std.num_graphs, device=dev)
    step = train.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-3))
    ms = _events(lambda: step(std, target), warmup=3)
    split, _ = _device_split(lambda: step(std, target), _step_part)
    report["train"]["gcn"] = dict(ms=ms, device_ms=sum(split.values()),
                                  split=split)
    print(f"gcn train step: {ms:.4f} ms (events), device busy "
          f"{sum(split.values()):.4f}: " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    torch.set_grad_enabled(False)
    for name, conv, ckw in SAME_WIDTH:
        p = Program(canonical_model(conv, "qm9", graphs=bgraphs,
                                    conv_kwargs=ckw),
                    max_nodes=blk.num_nodes, max_edges=blk.num_edges,
                    max_graphs=blk.num_graphs, block_size=128, device=dev,
                    seed=23)
        p.init_params()
        fn = lambda: p.forward(blk)
        split, _ = _device_split(fn, _step_part)
        report["forward_ms"][f"{name} block"] = dict(
            ms=_events(fn, warmup=3), device_ms=sum(split.values()),
            split=split)
        print(f"Program.forward {name} block: "
              f"{report['forward_ms'][name + ' block']['ms']:.4f} ms "
              f"(events), busy {sum(split.values()):.4f}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__)
                                          .resolve().parents[2]))
    ap.add_argument("--ew", action="store_true",
                    help="time row 4's elementwise instances only")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from gnnbuilder_tpu_torch import Program, train
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.ops.cuda import (
        _build,
        edge_block,
        gine_layer,
        mp_layer,
    )

    if not torch.cuda.is_available():
        print("mp_edge_rows: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.load()
    report = {"root": os.path.abspath(args.root), "smi": smi,
              "device": torch.cuda.get_device_name(0), "rows": {},
              "s_sha256": {}, "forward_ms": {}, "train": {}}
    torch.set_grad_enabled(False)

    # rows 4, 4b, 4i: one launch at the interior shape
    tgraphs, (std,) = canonical_batches("qm9", n_graphs=1100,
                                        batch_size=1024, node_multiple=256,
                                        device=dev)
    n = std.num_nodes
    report["train_rows"] = n
    if args.ew:
        _elementwise(report, tgraphs, std)
        print(json.dumps(report), flush=True)
        return 0
    gen = torch.Generator(device=dev).manual_seed(29)

    def r(*shape, sc=None):
        sc = 1.0 / shape[0] ** 0.5 if sc is None else sc
        return torch.randn(*shape, generator=gen, device=dev) * sc

    x = r(n, 128, sc=1.0)
    skip = r(n, 128, sc=1.0)
    ops = {"gin": dict(w0=r(128, 128), b0=r(128, sc=.1), w1=r(128, 128),
                       b1=r(128, sc=.1), eps=0.2),
           "sage": dict(w0=r(128, 128), b0=r(128, sc=.1), w1=r(128, 128)),
           "gcn": dict(b0=r(128, sc=.1)), "lg": {}, "simple_sum": {}}
    for conv, kw in ops.items():
        for row, mode in ROW_MODES.items():
            if mode != "f32" and conv not in ("gin", "sage"):
                continue
            mkw = dict(kw, skip=skip, act="relu", mode=mode)
            if mode == "f32":
                mkw["save_s"] = True
            else:
                w0, w1, s0, s1 = mp_layer.prepare_layer(kw["w0"], kw["w1"],
                                                        mode)
                mkw.update(w0=w0, w1=w1, s0=s0, s1=s1)

            def run(mkw=mkw, conv=conv):
                return mp_layer.fused_mp_layer(x, std.nbr_nodes,
                                               std.in_degree, conv, **mkw)

            res = _timed(run)
            key = f"{row} {conv}"
            report["rows"][key] = res
            if mode == "f32" and conv in ("gin", "sage"):
                s = run()[1]
                torch.cuda.synchronize()
                report["s_sha256"][conv] = hashlib.sha256(
                    s.cpu().numpy().tobytes()).hexdigest()
            print(f"row {key} [N={n}]: {res['ms']:.4f} ms (events), device "
                  f"{res['device_ms']:.4f}", flush=True)

    # six launches of the GIN / SAGE standard forward per mode
    models = {}
    for conv in ("gin", "sage"):
        model = canonical_model(conv, "qm9", graphs=tgraphs)
        Program(model, device=dev, seed=41).init_params()
        models[conv] = model
        layers = []
        for c, h, sk in _layer_inputs(model, std):
            kw = dict(skip=sk, act=model.gnn_activation)
            if conv == "gin":
                kw.update(w0=_t(c.lin0.weight), b0=c.lin0.bias.detach(),
                          w1=_t(c.lin1.weight), b1=c.lin1.bias.detach(),
                          eps=c.eps)
            else:
                kw.update(w0=_t(c.lin_l.weight), b0=c.lin_l.bias.detach(),
                          w1=_t(c.lin_r.weight))
            layers.append((h.contiguous(), kw))
        for row, mode in ROW_MODES.items():
            lays = []
            for h, kw in layers:
                kw = dict(kw, mode=mode)
                if mode != "f32":
                    w0, w1, s0, s1 = mp_layer.prepare_layer(kw["w0"],
                                                            kw["w1"], mode)
                    kw.update(w0=w0, w1=w1, s0=s0, s1=s1)
                lays.append((h, kw))

            def six(lays=lays, conv=conv):
                for h, kw in lays:
                    mp_layer.fused_mp_layer(h, std.nbr_nodes, std.in_degree,
                                            conv, **kw)

            res = _timed(six)
            key = f"{row} {conv} six"
            report["rows"][key] = res
            print(f"row {key}: {res['ms']:.4f} ms (events), device "
                  f"{res['device_ms']:.4f}", flush=True)

    # row 12: GINE's six (f32, standard)
    gine = canonical_model("gine", "qm9", graphs=tgraphs)
    Program(gine, device=dev, seed=41).init_params()
    glay = [((h, c.lin_edge(std.edge_feat).contiguous(), std.nbr_nodes,
              std.nbr_edges, std.in_degree),
             dict(w0=_t(c.lin0.weight), b0=c.lin0.bias.detach(),
                  w1=_t(c.lin1.weight), b1=c.lin1.bias.detach(), eps=c.eps,
                  skip=sk, act=gine.gnn_activation))
            for c, h, sk in _layer_inputs(gine, std)]

    def gine_six():
        for a, kw in glay:
            gine_layer.fused_gine_layer(*a, **kw)

    res = _timed(gine_six)
    report["rows"]["12 gine six"] = res
    print(f"row 12 gine six: {res['ms']:.4f} ms (events), device "
          f"{res['device_ms']:.4f}", flush=True)

    # rows 13, 13b: six launches of the EdgeConv block forward
    bgraphs, (blk, *_) = canonical_batches("qm9", n_graphs=3072,
                                           batch_size=1024, block_size=128,
                                           node_multiple=1024, device=dev)
    edge = canonical_model("edge", "qm9", graphs=bgraphs)
    Program(edge, device=dev, seed=41).init_params()
    elay = [((h.contiguous(), blk.nbr_nodes, blk.in_degree),
             dict(w_pair=_t(c.lin0.weight), b0=c.lin0.bias.detach(),
                  w1=_t(c.lin1.weight), b1=c.lin1.bias.detach(),
                  aggregation=c.aggregation, skip=sk,
                  act=edge.gnn_activation))
            for c, h, sk in _layer_inputs(edge, blk)]
    report["block_rows"] = blk.num_nodes
    report["block_valid_slots"] = int(blk.in_degree.sum())
    for row, mode in (("13", "f32"), ("13b", "bf16")):
        lays = [(a, dict(kw, mode=mode) if mode == "f32" else dict(
            kw, mode=mode, w_pair=kw["w_pair"].to(torch.bfloat16),
            w1=kw["w1"].to(torch.bfloat16))) for a, kw in elay]

        def six(lays=lays):
            for a, kw in lays:
                edge_block.fused_edge_block_layer(*a, **kw)

        res = _timed(six)
        report["rows"][f"{row} edge six"] = res
        print(f"row {row} edge six [N={blk.num_nodes}]: {res['ms']:.4f} ms "
              f"(events), device {res['device_ms']:.4f}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in res["split"].items()),
              flush=True)

    # forwards
    cells = [(c, p, std) for c in ("gin", "sage")
             for p in ("f32", "bf16", "int8")]
    cells += [("edge", p, blk) for p in ("f32", "bf16")]
    for conv, precision, g in cells:
        m = models.get(conv, edge)
        prog = Program(canonical_model(conv, "qm9", graphs=tgraphs),
                       max_nodes=g.num_nodes, max_edges=g.num_edges,
                       max_graphs=g.num_graphs,
                       block_size=128 if conv == "edge" else 0,
                       precision=precision, device=dev, seed=41)
        prog.set_params({k: v.to(dev) for k, v in m.state_dict().items()})
        ms = _events(lambda: prog.forward(g), warmup=3)
        report["forward_ms"][f"{conv} {precision}"] = ms
        print(f"Program.forward {conv} {precision}: {ms:.4f} ms", flush=True)

    # GIN and SAGE train steps
    torch.set_grad_enabled(True)
    target = train.stack_targets(tgraphs[:1024], std.num_graphs, device=dev)
    for conv, model in models.items():
        step = train.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-3))
        ms = _events(lambda: step(std, target), warmup=3)
        split, _ = _device_split(lambda: step(std, target), _step_part)
        report["train"][conv] = dict(ms=ms, device_ms=sum(split.values()),
                                     split=split)
        print(f"{conv} train step: {ms:.4f} ms (events), device busy "
              f"{sum(split.values()):.4f}: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The GAT softmax backward's row (11) and the multi-aggregate's rows (8,
8b) on the card.

* Row 11 of ``ops/cuda/gat_bwd.py`` on the b1024 train batch (N =
  18,688): the six launches of a canonical heads-4 GAT train step (C =
  128 in five layers, 64 in the last; per layer h = x W of the per-layer
  plain path's input, its logit halves, a seeded dz), over the reverse
  table and over the reverse CSR (``reverse_csr`` included, as a step
  without a reverse table runs it), each with the SHA-256 of its six
  outputs.
* Rows 8 and 8b of ``ops/cuda/ell_agg.py``: one max and one sum launch of
  a 128-wide layer input over the train batch, and the six launches of a
  Simple max and a Simple min forward (standard-packed, 128 wide), of a
  five-aggregator PNA forward standard-packed (with u) and block-packed
  (min / max of v), each in f32 and bf16, with the SHA-256 of the
  outputs (the same on every tree whose sums are the same) and, where
  the tree has ``ell_aggregate_ordered``, whether they equal that
  slot-ordered loop bit for bit; ``scatter_reduce`` (amax over the edge
  list) and ``torch.sparse.mm`` (the sum) on the same input beside them.
* The GAT and five-aggregator PNA train steps (Adam 1e-3) by events and
  by device time per part; with ``--paths`` also the GAT step without its
  reverse table and ``Program.forward`` of Simple max / min and PNA5.

    python gnnbuilder_tpu_torch/bench/gat_agg_rows.py [--root DIR]
        [--paths]

``--root`` imports ``gnnbuilder_tpu_torch`` from DIR (default: this
file's tree), so one call can time an older tree beside this one (a
``git archive`` of the parent commit) through the same public wrappers.
Rows: CUDA-event ms (10 after 2 warm-up rounds) and the device ms by
kernel under torch.profiler (5 rounds).  Train steps: events over 10
steps after 3, then the profiler over 5.  Prints the card's name and
power limit, then one JSON line.  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import pathlib
import subprocess
import sys

# the shared helpers; run as a script, this file's directory is on
# sys.path and the package is imported later, from --root
if __package__:
    from .gine_gather_rows import (_device_split, _events, _layer_inputs,
                                   _log, _sha)
else:
    from gine_gather_rows import (_device_split, _events, _layer_inputs,
                                  _log, _sha)

PNA_ALL5 = ("sum", "mean", "min", "max", "std")
MEM_BYTES_PER_S = 3.35e12


def _part(name):
    """The port's kernel a launch belongs to, or a class of torch's."""
    for key in ("gat_bwd", "ell_agg", "gat_proj", "gat_attn",
                "ell_gather_bwd", "pna_", "readout"):
        if key in name:
            return key.rstrip("_")
    if "adam" in name or "multi_tensor" in name:
        return "Adam"
    if any(t in name for t in ("gemm", "cutlass", "xmma", "gemv")):
        return "torch matmul"
    return "other torch"


def _timed(fn, kernel, nbytes=None):
    """Events, the device ms of ``kernel``'s launches, the whole device
    busy time and, given the bytes the work must move, the achieved rate
    of them."""
    for _ in range(3):   # a profiler run now and then records no launch
        split, count = _device_split(fn, _part)
        if split.get(kernel, 0.0) > 0:
            break
    res = dict(ms=_events(fn), device_ms=split.get(kernel, 0.0),
               busy_ms=sum(split.values()), split=split, launches=count)
    if nbytes is not None and res["device_ms"] > 0:
        res["bytes"] = nbytes
        res["bound_ms"] = nbytes / MEM_BYTES_PER_S * 1e3
        res["tb_per_s"] = nbytes / res["device_ms"] / 1e9
    return res


def gat_calls(gat, std):
    """Row 11's six calls of a GAT train step (the canonical heads-4
    model's layer inputs, a seeded dz) and the bytes their bound counts."""
    import torch

    dev = std.nbr_nodes.device
    gen = torch.Generator(device=dev).manual_seed(37)
    calls, nbytes = [], 0
    n, wr = std.num_nodes, std.rev_nbr_nodes.shape[1]
    for c, x, _ in _layer_inputs(gat, std):
        hh = (x @ c.lin.weight.t()).contiguous()
        hv = hh.view(n, c.heads, -1)
        a_s = (hv * c.att_src).sum(-1).contiguous()
        a_d = (hv * c.att_dst).sum(-1).contiguous()
        dz = torch.randn(hh.shape, generator=gen, device=dev)
        calls.append((dz, hh, a_s, a_d, std.nbr_nodes, std.in_degree,
                      c.heads))
        hc = hh.shape[1]
        # dz, h and dh_val; a_src, a_dst and five [N, H] outputs; both
        # tables and the degrees, each once
        nbytes += 4 * (3 * n * hc + 7 * n * c.heads
                       + n * (std.ell_width + wr) + 2 * n)
    return calls, nbytes


REV_MODES = ("table", "csr")


def rev_kw(std, mode):
    return (dict(rev_nbr_nodes=std.rev_nbr_nodes, out_degree=std.out_degree)
            if mode == "table" else {})


def gat_rows(report, gat, std):
    """Row 11: a train step's six launches in each reverse mode."""
    import torch

    from gnnbuilder_tpu_torch.ops.cuda import gat_bwd
    from gnnbuilder_tpu_torch.ops.ell import reverse_csr

    fn = gat_bwd.fused_gat_scatter_backward
    takes_csr = "rev_csr" in inspect.signature(fn).parameters
    calls, nbytes = gat_calls(gat, std)
    for mode in REV_MODES:
        def six(mode=mode):
            # a step on a new batch: the reverse CSR built once (a tree
            # whose wrapper takes none builds it per layer)
            rkw = rev_kw(std, mode)
            if mode == "csr" and takes_csr:
                rkw["rev_csr"] = reverse_csr(std.nbr_nodes, std.in_degree,
                                             positions=True)
            return [fn(*a, **rkw) for a in calls]

        res = _timed(six, "gat_bwd", nbytes)
        res["sha256"] = _sha(torch.cat([t.flatten() for outs in six()
                                        for t in outs]))
        report["rows"][f"11 {mode}"] = res
        _log(f"row 11 {mode} six: {res['ms']:.4f} ms (events), device "
             f"{res['device_ms']:.4f} (busy {res['busy_ms']:.4f}), "
             f"{res.get('tb_per_s', 0.0):.2f} TB/s of the bound's bytes; "
             f"sha256 {res['sha256'][:16]}")


def agg_sets(std128, std, blk, models):
    """{name: (batch, [(args, kw)])}: row 8's launches of each path (the
    models' layer inputs), and one max and one sum launch of the Simple
    max model's layer-1 input."""
    sets = {}
    for name, g in (("simple_max", std128), ("simple_min", std128)):
        sets[name] = (g, [((h, g.nbr_nodes, g.in_degree,
                            (c.aggregation,)), {})
                          for c, h, _ in _layer_inputs(models[name], g)])
    for name, g, block in (("pna5_std", std, False),
                           ("pna5_block", blk, True)):
        ls = []
        for c, h, _ in _layer_inputs(models[name], g):
            u, v = c.pre_nn(h, h)
            if block:
                cmp = tuple(a for a in c.aggregators if a in ("max", "min"))
                ls.append(((v.contiguous(), g.nbr_nodes, g.in_degree, cmp),
                           {}))
            else:
                ls.append(((v.contiguous(), g.nbr_nodes, g.in_degree,
                            c.aggregators), dict(u=u.contiguous())))
        sets[name] = (g, ls)
    h1 = sets["simple_max"][1][1][0][0]
    for agg in ("max", "sum"):
        sets[f"{agg} layer 1"] = (std128, [((h1, std128.nbr_nodes,
                                             std128.in_degree, (agg,)), {})])
    return sets


def agg_bytes(g, ls):
    """The bytes row 8's launches ls must move on batch g: v (and u), the
    table and the degrees in, the output out, each once."""
    n, w = g.num_nodes, g.ell_width
    return sum(4 * (n * a[0].shape[1] * (2 if kw.get("u") is not None else 1)
                    + n * w + n + n * len(a[3]) * a[0].shape[1])
               for a, kw in ls)


def agg_rows(report, std128, std, blk, models):
    """Rows 8 and 8b: one max and one sum launch, the forwards' sixes."""
    import torch

    from gnnbuilder_tpu_torch.ops.cuda import ell_agg

    ordered = getattr(ell_agg, "ell_aggregate_ordered", None)
    sets = agg_sets(std128, std, blk, models)
    h1 = sets["max layer 1"][1][0][0][0]

    for name, (g, ls) in sets.items():
        for mode in ("f32", "bf16"):
            def run(ls=ls, mode=mode):
                return [ell_agg.fused_ell_aggregate(*a, mode=mode, **kw)
                        for a, kw in ls]

            res = _timed(run, "ell_agg", agg_bytes(g, ls))
            outs = run()
            res["sha256"] = _sha(torch.cat([o.flatten() for o in outs]))
            if ordered is not None:
                res["equals_ordered"] = all(
                    torch.equal(o, ordered(*a, mode=mode, **kw))
                    for o, (a, kw) in zip(outs, ls))
            key = f"{'8' if mode == 'f32' else '8b'} {name}"
            report["rows"][key] = res
            _log(f"row {key} ({len(ls)} launches): {res['ms']:.4f} ms "
                 f"(events), device {res['device_ms']:.4f}, "
                 f"{res.get('tb_per_s', 0.0):.2f} TB/s of the bound's "
                 f"bytes; sha256 {res['sha256'][:16]}"
                 + (f"; equals the slot-ordered loop: "
                    f"{res['equals_ordered']}" if ordered else ""))
    # the library yardsticks on the max and sum launches' input
    m_ = std128.edge_mask
    recv = std128.receivers[m_].long()
    send = std128.senders[m_].long()
    src = h1[send]
    idx = recv[:, None].expand_as(src)
    z = torch.zeros_like(h1)
    n = std128.num_nodes
    a = torch.sparse_coo_tensor(torch.stack([recv, send]),
                                torch.ones(len(recv), device=h1.device),
                                (n, n)).coalesce().to_sparse_csr()
    for key, fn in (("scatter_reduce amax", lambda: z.scatter_reduce(
            0, idx, src, "amax", include_self=False)),
                    ("sparse.mm sum", lambda: torch.sparse.mm(a, h1))):
        split, _ = _device_split(fn, _part)
        report["library"][key] = dict(ms=_events(fn),
                                      device_ms=sum(split.values()))
        _log(f"library {key}: {report['library'][key]['ms']:.4f} ms "
             f"(events), device {report['library'][key]['device_ms']:.4f}")


def steps(report, tgraphs, std, models, cells):
    import torch

    from gnnbuilder_tpu_torch import train

    torch.set_grad_enabled(True)
    target = train.stack_targets(tgraphs[:1024], std.num_graphs,
                                 device=std.nbr_nodes.device)
    for name in cells:
        model = models[name.split()[0]]
        g = (std.replace(rev_nbr_nodes=None, out_degree=None)
             if "without" in name else std)
        step = train.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-3))
        ms = _events(lambda: step(g, target), warmup=3)
        split, count = _device_split(lambda: step(g, target), _part)
        report["train"][name] = dict(ms=ms, busy_ms=sum(split.values()),
                                     split=split, launches=count)
        _log(f"{name} train step: {ms:.4f} ms (events), device busy "
             f"{sum(split.values()):.4f}: " + ", ".join(
                 f"{k} {v:.4f} ({count.get(k, 0):.0f})"
                 for k, v in split.items()))
    torch.set_grad_enabled(False)


def forwards(report, std128, std, blk, progs):
    for name, p, g in (("simple_max", progs["simple_max"], std128),
                       ("simple_min", progs["simple_min"], std128),
                       ("pna5_std", progs["pna5_std"], std),
                       ("pna5_block", progs["pna5_block"], blk)):
        ms = _events(lambda: p.forward(g), warmup=3)
        report["forward_ms"][name] = ms
        _log(f"Program.forward {name}: {ms:.4f} ms")


def setup(dev):
    """The b1024 train batch (QM9, node_multiple 256), the same at node
    width 128 (Simple), the first b1024 block batch, and the canonical
    models (seeded): GAT heads 4, Simple max and min, PNA with all five
    aggregators; (tgraphs, std, std128, blk, models, programs)."""
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )

    tgraphs, (std,) = canonical_batches("qm9", n_graphs=1100,
                                        batch_size=1024, node_multiple=256,
                                        device=dev)
    _, (std128,) = canonical_batches("qm9", n_graphs=1100, batch_size=1024,
                                     node_multiple=256, node_dim=128,
                                     device=dev)
    _, (blk, *_) = canonical_batches("qm9", n_graphs=3072,
                                     batch_size=1024, block_size=128,
                                     node_multiple=1024, device=dev)
    models, progs = {}, {}
    for name, conv, kw, g in (
            ("gat", "gat", dict(conv_kwargs=dict(heads=4)), std),
            ("simple_max", "simple", dict(conv_kwargs=dict(
                aggregation="max")), std128),
            ("simple_min", "simple", dict(conv_kwargs=dict(
                aggregation="min")), std128),
            ("pna5_block", "pna", dict(conv_kwargs=dict(
                aggregators=PNA_ALL5)), blk)):
        models[name] = canonical_model(conv, "qm9", graphs=tgraphs, **kw)
        progs[name] = Program(models[name], max_nodes=g.num_nodes,
                              max_edges=g.num_edges, max_graphs=g.num_graphs,
                              block_size=128 if g is blk else 0, device=dev,
                              seed=41)
        progs[name].init_params()
    models["pna5_std"] = models["pna5"] = models["pna5_block"]
    progs["pna5_std"] = Program(models["pna5_std"], max_nodes=std.num_nodes,
                                max_edges=std.num_edges,
                                max_graphs=std.num_graphs, device=dev)
    progs["pna5_std"].set_params(progs["pna5_block"].params)
    return tgraphs, std, std128, blk, models, progs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__)
                                          .resolve().parents[2]))
    ap.add_argument("--paths", action="store_true",
                    help="also the GAT step without its reverse table and "
                         "the Simple / PNA5 forwards")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from gnnbuilder_tpu_torch.ops.cuda import _build

    if not torch.cuda.is_available():
        print("gat_agg_rows: no CUDA device", file=sys.stderr)
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
              "library": {}, "forward_ms": {}, "train": {}}
    torch.set_grad_enabled(False)
    tgraphs, std, std128, blk, models, progs = setup(dev)
    gat_rows(report, models["gat"], std)
    agg_rows(report, std128, std, blk, models)
    cells = ["gat", "pna5"]
    if args.paths:
        cells.append("gat without reverse table")
        forwards(report, std128, std, blk, progs)
    steps(report, tgraphs, std, models, cells)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Chip smoke test of gnnbuilder_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``gnnbuilder_tpu_torch/csrc`` with nvcc (one
process per source, all started together), holds each against its plain
torch version at the shapes its path gives it, then drives three paths of
the canonical 6-layer model (hidden 128, output 64, seeded random
weights):

* PNA inference: ``Program.forward`` on three distinct 1024-graph
  block-packed QM9 batches (the PNA stack and readout kernels), checked
  against the per-layer plain path on the card and, on a small batch,
  against the plain path on the CPU; and a PNA forward on a batch whose
  70-in-degree hub leaves it without an ELL table, against the CPU;
* PNA training: ``make_train_step`` with Adam(1e-3) on one
  standard-packed 1024-graph QM9 batch (``node_multiple=256``, as the JAX
  package's benchmark trains), each step through the PNA layer kernel,
  the scatter kernel in its cstk mode and the reverse-table gather in all
  six layers and the readout kernel; gradients against the float64 plain
  path, bitwise-equal gradients from two steps off one state, a 5-step
  loss curve against the plain path on the card, and a small batch's step
  against the plain path on the CPU; then ``Program.forward`` on that
  batch, which runs the layer kernel too;
* GCN, GIN and SAGE inference: ``Program.forward`` on the three
  block-packed batches (the mp stack kernel for GCN and SAGE, GIN's
  per-layer path, the readout kernel), against the per-layer plain path
  on the card and, on a small batch, against the CPU.

For each path it sets every launch count to 0 just before and checks the
counts just after, then times the forwards, the train step and each
kernel with CUDA events and splits the train step's device time by kernel
with ``torch.profiler``.

Output: one flushed, timestamped line before and after every phase; the
ptxas report of the build; then, each on its own line, a ``kernels`` JSON
object, the card's name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when
CUDA is unavailable, when run without the package beside it, or when any
check fails.  Starts no threads; every subprocess has a timeout.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.time()
SMI_TIMEOUT_S = 30

# published H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# tolerance of every comparison below: max |got - want| <= TOL * max |want|
# (and all values finite).  The kernels take their sums in another order
# than the plain versions (and the stack takes the receiver term outside
# the neighbour reduce), so they agree to f32 rounding over 6 layers of
# 512-long dot products, ~1e-6 of the largest value, not bitwise.  A
# scale-relative bound keeps the check as tight for the small outputs of
# a randomly initialised model as for large ones.
TOL = 1e-4

BATCH_GRAPHS = 1024
N_BATCHES = 3


def log(msg):
    print(f"[{time.time() - T0:8.2f}s] {msg}", flush=True)


class phase:
    """Prints a line before and after a phase; an exception propagates."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"start {self.name}")
        self.t = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            log(f"done  {self.name} ({time.time() - self.t:.2f}s)")
        return False


def close_enough(got, want):
    """(ok, max abs error, max abs error / max |want|)."""
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    ok = bool(torch.isfinite(got).all()) and rel <= TOL
    return ok, err, rel


def time_ms(fn, iters, warmup=2):
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


def bound(flops, nbytes):
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def pna_widths(model):
    """(Fin, F, Fout) of each conv layer at the model's own widths, before
    the kernels' zero-padding to 128 lanes: the work a bound counts."""
    return [(c.in_channels, c.pre_nn.weight.shape[0], c.out_channels)
            for c in model.gnn_convs]


def layer_flops(n, edges, fin, f, fo, ops_per_gather):
    """The five products of a PNA layer over n rows, and ops_per_gather
    operations per gathered neighbour value."""
    return (2 * n * (2 * fin * f + 12 * f * fo + fin * fo + fo * fo)
            + ops_per_gather * edges * f)


def layer_weights(fin, f, fo):
    """Floats in one layer's w_pre, b_pre, k_post, b_post, w_lin, b_lin."""
    return 2 * fin * f + f + (fin + 12 * f) * fo + fo + fo * fo + fo

MP_CONVS = ("gcn", "gin", "sage")


def mp_widths(model):
    """(Fin, Fout) of each conv layer at the model's own widths."""
    return [(c.in_channels, c.out_channels) for c in model.gnn_convs]


def mp_flops(conv, n, edges, widths):
    """The stack's work at the given widths: its products (2 flops per
    multiply-add) and one add per real edge and aggregated feature."""
    total = 0
    for fin, fo in widths:
        if conv == "gcn":
            total += 2 * n * fin * fo + edges * fo
        elif conv == "gin":
            total += edges * fin + 2 * n * fin * fo + 2 * n * fo * fo
        else:
            total += edges * fin + 2 * 2 * n * fin * fo
    return total


def mp_weights(conv, widths):
    """Floats in the stack's weights and biases at the given widths."""
    per = {"gcn": lambda i, o: i * o + o,
           "gin": lambda i, o: i * o + o + o * o + o,
           "sage": lambda i, o: 2 * i * o + o}[conv]
    return sum(per(i, o) for i, o in widths)


TRAIN_GRAPHS = 1100      # bench.py's train arm: 1100 graphs, one b1024
TRAIN_STEPS = 5          # the loss curve held against the plain path
CURVE_TOL = 1e-3         # relative, per step


def layer_operands(model, g, pna_layer):
    """Each conv layer's kernel operands on batch ``g`` (padded to 128
    lanes, contiguous), as the model's layer kernel gets them, with the
    hidden state advanced through the kernel."""
    L = model.gnn_num_layers
    h = g.node_feat
    layers = []
    for i, c in enumerate(model.gnn_convs):
        skip = h if model.gnn_skip_connection and 0 < i < L - 1 else None
        ops = pna_layer.pad_operands(
            h, c.pre_nn.weight.t(), c.pre_nn.bias, c.post_nn.weight.t(),
            c.post_nn.bias, c.lin.weight.t(), c.lin.bias, skip)
        ops = [None if t is None else t.contiguous() for t in ops]
        args = (ops[0], g.nbr_nodes, g.in_degree, *ops[1:7], c.delta)
        kw = dict(skip=ops[7], act=model.gnn_activation)
        layers.append((args, kw))
        h = pna_layer.fused_pna_layer(*args, **kw)[:, :c.out_channels]
    return layers


def split_device_time(prof, n_steps):
    """Device ms per step from a torch.profiler run, by part of the train
    step: the port's kernels by name, Adam, the torch matrix products
    (the epilogue backward and forward-pass products), and the rest."""
    from torch.autograd import DeviceType

    parts = {"pna_layer kernel": 0.0, "pna_scatter_bwd kernel": 0.0,
             "ell_gather_bwd kernel": 0.0, "readout kernel": 0.0,
             "Adam": 0.0, "torch matmul": 0.0, "other torch kernels": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        if "pna_layer" in name:
            part = "pna_layer kernel"
        elif "scatter_bwd" in name:
            part = "pna_scatter_bwd kernel"
        elif "ell_gather_bwd" in name:
            part = "ell_gather_bwd kernel"
        elif "readout_kernel" in name:
            part = "readout kernel"
        elif "adam" in name or "multi_tensor" in name:
            part = "Adam"
        elif any(t in name for t in ("gemm", "cutlass", "xmma", "gemv")):
            part = "torch matmul"
        else:
            part = "other torch kernels"
        parts[part] += us / 1e3 / n_steps
    return parts


def hub_batch(graphs):
    """``graphs`` and a 71-node star whose hub has in-degree 70, packed at
    128 rows on the CPU: over ELL_MAX_WIDTH, so the batch ships no ELL
    table."""
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.data.datasets import Graph

    rng = np.random.default_rng(0)
    leaves = np.arange(1, 71)
    ei = np.concatenate([np.stack([leaves, 0 * leaves]),
                         np.stack([0 * leaves, leaves])], axis=1)
    star = Graph(x=rng.standard_normal((71, 11)).astype(np.float32),
                 edge_index=ei.astype(np.int64),
                 edge_attr=np.zeros((ei.shape[1], 4), np.float32))
    gs = list(graphs[:7]) + [star] + list(graphs[7:])
    b = build_graph_batch(gs, block_size=128, node_multiple=128,
                          device="cpu")
    if b.nbr_nodes is not None:
        raise AssertionError("the hub batch carries an ELL table")
    return gs, b


def grads_of(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def worst_grad(got, want):
    """(ok, max abs error, worst error / max |want| over the parameters,
    the parameter it is in)."""
    worst, abs_worst, name, ok = 0.0, 0.0, "", True
    for k in want:
        o, e, r = close_enough(got[k].double(), want[k].double())
        ok = ok and o
        abs_worst = max(abs_worst, e)
        if r >= worst:
            worst, name = r, k
    return ok, abs_worst, worst, name


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "runs on an NVIDIA card only", file=sys.stderr, flush=True)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.ops import dispatch, segment
    from gnnbuilder_tpu_torch.ops.cuda import (
        _build,
        ell_bwd,
        mp_block,
        pna_block,
        pna_layer,
        readout,
        scatter_bwd,
    )

    # the scatter kernel counts per mode: its cstk mode is the train
    # path's, its scatter (atomic) mode serves batches without a reverse
    # table
    counted = {"pna_block_stack": pna_block.fused_pna_block_stack,
               "readout": readout.fused_readout,
               "pna_layer": pna_layer.fused_pna_layer,
               "pna_scatter_bwd": scatter_bwd.fused_pna_scatter_cstk,
               "pna_scatter_bwd_atomic":
                   scatter_bwd.fused_pna_scatter_backward,
               "ell_gather_bwd": ell_bwd.fused_gather_backward,
               "mp_block_stack": mp_block.fused_mp_block_stack}

    def only(**nonzero):
        """The launch counts of a path that launches ``nonzero``."""
        return {k: nonzero.get(k, 0) for k in counted}

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counted.items()}

    torch.set_grad_enabled(False)   # inference until the train phases
    dev = torch.device("cuda")
    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=SMI_TIMEOUT_S, check=True,
        ).stdout.strip().splitlines()[0]
        name = torch.cuda.get_device_name(0)
        log(f"nvidia-smi: {smi}; torch: {name}, torch {torch.__version__}, "
            f"cuda {torch.version.cuda}, {torch.cuda.device_count()} card(s)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    with phase("build kernels (one nvcc per source, all started together)"):
        t = time.time()
        lib = _build.build()
        log(f"built in {time.time() - t:.2f}s: {lib}")
        print(f"--- ptxas\n{_build.build_log.strip()}", flush=True)

    with phase("data and model"):
        graphs, batches = canonical_batches(
            "qm9", n_graphs=BATCH_GRAPHS * N_BATCHES,
            batch_size=BATCH_GRAPHS, block_size=128, node_multiple=1024,
            device=dev,
        )
        b0 = batches[0]
        model = canonical_model("pna", "qm9", graphs=graphs)
        prog = Program(model, max_nodes=b0.num_nodes,
                       max_edges=b0.num_edges, max_graphs=b0.num_graphs,
                       block_size=128, device="cuda")
        prog.init_params()
        log(f"{len(batches)} batches: N={b0.num_nodes} E={b0.num_edges} "
            f"G={b0.num_graphs} ELL width={b0.ell_width}")

    report = {}
    with phase("kernels against their plain versions"):
        stacked, head = model._kernel_params(128)
        L = model.gnn_num_layers
        deltas = [c.delta for c in model.gnn_convs]
        skips = [0 < i < L - 1 for i in range(L)]
        x = torch.nn.functional.pad(b0.node_feat,
                                    (0, 128 - b0.feature_dim)).contiguous()
        skw = dict(deltas=deltas, skips=skips, act=model.gnn_activation)
        sargs = (x, b0.nbr_nodes, b0.in_degree, *stacked)
        got = pna_block.fused_pna_block_stack(*sargs, **skw)
        torch.cuda.synchronize()
        want = pna_block.pna_block_stack_plain(*sargs, **skw)
        torch.cuda.synchronize()
        ok, abs_err, rel_err = close_enough(got, want)
        log(f"pna_block_stack [N={x.shape[0]}, F=128, L={L}]: max abs "
            f"{abs_err:.3e}, {rel_err:.3e} of max |value| (tol {TOL})")
        if not ok:
            raise AssertionError("pna_block_stack disagrees with its plain "
                                 "version")
        report["pna_block_stack"] = dict(max_abs_err=abs_err)

        h = got[:, :model.gnn_output_dim].contiguous()
        aggrs = model.pooling_aggrs
        mx = segment.contiguous_segment_max(h, b0.graph_starts, b0.n_node,
                                            b0.max_graph_nodes_static)
        rargs = (h, b0.n_node, head)
        rkw = dict(aggrs=aggrs, mx=mx, act=model.mlp_activation,
                   out_act=model.output_activation, starts=b0.graph_starts)
        got_r = readout.fused_readout(*rargs, **rkw)
        torch.cuda.synchronize()
        want_r = readout.readout_plain(
            h, b0.n_node, b0.graph_starts, head, aggrs, mx,
            model.mlp_activation, model.output_activation)
        m = b0.graph_mask
        ok, abs_err, rel_err = close_enough(got_r[m], want_r[m])
        log(f"readout [N={h.shape[0]}, F={h.shape[1]}, G={b0.num_graphs}]: "
            f"max abs {abs_err:.3e}, {rel_err:.3e} of max |value| (tol "
            f"{TOL}; graph_mask rows)")
        if not ok or not bool(torch.isfinite(got_r).all()):
            raise AssertionError("readout disagrees with its plain version")
        report["readout"] = dict(max_abs_err=abs_err)

    with phase(f"main path: Program.forward on {N_BATCHES} x "
               f"{BATCH_GRAPHS}-graph batches"):
        zero_counts()
        outs = [prog.forward(b) for b in batches]
        torch.cuda.synchronize()
        launches = counts()
        log(f"launches during the main path: {launches}")
        if launches != only(pna_block_stack=N_BATCHES, readout=N_BATCHES):
            raise AssertionError("a kernel did not launch once per forward")
        for k in ("pna_block_stack", "readout"):
            report[k]["launches"] = launches[k]

    with phase("outputs against the per-layer plain path"):
        dispatch.set_fused_mode("never")
        try:
            refs = [prog.forward(b) for b in batches]
        finally:
            dispatch.set_fused_mode("auto")
        for i, (b, out, ref) in enumerate(zip(batches, outs, refs)):
            m = b.graph_mask
            if tuple(out.shape) != (b.num_graphs, model.mlp_out_dim):
                raise AssertionError(f"batch {i}: shape {tuple(out.shape)}")
            if not bool(torch.isfinite(out[m]).all()):
                raise AssertionError(f"batch {i}: non-finite output")
            ok, abs_err, rel_err = close_enough(out[m], ref[m])
            log(f"batch {i}: kernels vs per-layer plain on the card: max abs "
                f"{abs_err:.3e}, {rel_err:.3e} of max |value| (tol {TOL})")
            if not ok:
                raise AssertionError(f"batch {i}: outputs disagree")
        # small input: the kernel path on the card against the plain path
        # on the CPU with the same weights
        small_g, (small,) = canonical_batches(
            "qm9", n_graphs=64, batch_size=64, block_size=128,
            node_multiple=128, device="cpu")
        cpu_model = canonical_model("pna", "qm9", graphs=graphs)
        cpu_prog = Program(cpu_model, max_nodes=small.num_nodes,
                           max_edges=small.num_edges,
                           max_graphs=small.num_graphs, block_size=128,
                           device="cpu")
        cpu_prog.set_params({k: v.cpu() for k, v in prog.params.items()})
        dispatch.set_fused_mode("never")
        try:
            ref = cpu_prog.forward(small)
        finally:
            dispatch.set_fused_mode("auto")
        out = prog.forward(small.to(dev)).cpu()
        m = small.graph_mask
        ok, abs_err, rel_err = close_enough(out[m], ref[m])
        log(f"64-graph batch: card kernels vs CPU plain path: max abs "
            f"{abs_err:.3e}, {rel_err:.3e} of max |value| (tol {TOL})")
        if not ok:
            raise AssertionError("card disagrees with the CPU plain path")

    with phase("PNA forward on a batch without an ELL table (a 70-in-degree "
               "hub) against the CPU"):
        _, hub = hub_batch(graphs[:255])
        hub_model = canonical_model("pna", "qm9", graphs=graphs)
        size = dict(max_nodes=hub.num_nodes, max_edges=hub.num_edges,
                    max_graphs=hub.num_graphs, block_size=128)
        hub_prog = Program(hub_model, **size, device="cuda")
        hub_prog.set_params(prog.params)
        hub_cpu = Program(canonical_model("pna", "qm9", graphs=graphs),
                          **size, device="cpu")
        hub_cpu.set_params({k: v.cpu() for k, v in prog.params.items()})
        zero_counts()
        out = hub_prog.forward(hub.to(dev)).cpu()
        torch.cuda.synchronize()
        launches = counts()
        ref = hub_cpu.forward(hub)
        m = hub.graph_mask
        ok, abs_err, rel_err = close_enough(out[m], ref[m])
        log(f"N={hub.num_nodes}, largest in-degree "
            f"{int(hub.in_degree.max())}, ELL table {hub.nbr_nodes}: card vs "
            f"CPU max abs {abs_err:.3e}, {rel_err:.3e} of max |value| (tol "
            f"{TOL}); launches {launches}")
        if not ok or launches != only(readout=1):
            raise AssertionError("PNA without an ELL table disagrees with "
                                 "the CPU")

    with phase("train data and model"):
        from gnnbuilder_tpu_torch import train

        tgraphs, (tb,) = canonical_batches(
            "qm9", n_graphs=TRAIN_GRAPHS, batch_size=BATCH_GRAPHS,
            node_multiple=256, device=dev)
        tmodel = canonical_model("pna", "qm9", graphs=tgraphs)
        tprog = Program(tmodel, max_nodes=tb.num_nodes,
                        max_edges=tb.num_edges, max_graphs=tb.num_graphs,
                        device="cuda")
        state0 = {k: v.clone() for k, v in tprog.init_params().items()}
        target = train.stack_targets(tgraphs[:BATCH_GRAPHS], tb.num_graphs,
                                     device=dev)
        tm = tb.graph_mask
        log(f"train batch (standard packing): N={tb.num_nodes} "
            f"E={int(tb.in_degree.sum())} G={tb.num_graphs} ELL width="
            f"{tb.ell_width}")

    def fresh_step(mdl):
        return train.make_train_step(
            mdl, torch.optim.Adam(mdl.parameters(), lr=1e-3))

    with phase("train kernels against their plain versions (6 layers)"):
        layers = layer_operands(tmodel, tb, pna_layer)
        residuals = []
        err_layer = 0.0
        for i, (args, kw) in enumerate(layers):
            got = pna_layer.fused_pna_layer(*args, **kw, save_res=True)
            torch.cuda.synchronize()
            want = pna_layer.pna_layer_plain(*args, **kw, save_res=True)
            F_i = args[3].shape[1]
            empty = tb.in_degree == 0
            for name, a, w in zip(("out", "v", "agg_cat", "aux", "mid"),
                                  got, want):
                if name == "aux":
                    # tie counts and empty-row extrema exactly
                    if not (torch.equal(a[:, 3 * F_i:], w[:, 3 * F_i:])
                            and torch.equal(a[empty], w[empty])):
                        raise AssertionError(
                            f"pna_layer {i}: tie counts or empty-row "
                            f"extrema differ from the plain version")
                    a, w = a[~empty, :3 * F_i], w[~empty, :3 * F_i]
                ok, abs_err, rel_err = close_enough(a, w)
                err_layer = max(err_layer, abs_err)
                if not ok:
                    raise AssertionError(
                        f"pna_layer {i} {name}: {rel_err:.3e} of max "
                        f"|value| against its plain version (tol {TOL})")
            log(f"pna_layer {i} [N={args[0].shape[0]}, Fin="
                f"{args[0].shape[1]}, F={F_i}, Fout={args[7].shape[1]}]: "
                f"all outputs within tol, ties exact; "
                f"{int((got[3][:, 3 * F_i:] > 1).sum())} tied extrema")
            residuals.append(got)
        gen = torch.Generator(device=dev).manual_seed(7)
        sc_args, cs_args, g_args = [], [], []
        err_scatter = err_gather = 0.0
        for i, ((args, _), (_, v, agg, aux, _)) in enumerate(
                zip(layers, residuals)):
            F_i, Fout_i = args[3].shape[1], args[7].shape[1]
            ks_t = pna_layer.scaler_blocks(
                args[5], args[0].shape[1], F_i).t().contiguous()
            d_mid = torch.randn(tb.num_nodes, Fout_i, generator=gen,
                                device=dev)
            sa = (d_mid, aux, agg, tb.in_degree, tb.nbr_nodes, v, ks_t,
                  args[9])
            got = scatter_bwd.fused_pna_scatter_backward(*sa)
            again = scatter_bwd.fused_pna_scatter_backward(*sa)
            torch.cuda.synchronize()
            want = scatter_bwd.pna_scatter_backward_plain(*sa)
            ok, abs_err, rel_err = close_enough(got, want)
            err_scatter = max(err_scatter, abs_err)
            # atomic adds in another order each run: not bitwise stable
            rerun = float((again - got).abs().max())
            log(f"pna_scatter_bwd {i}: max abs {abs_err:.3e}, {rel_err:.3e} "
                f"of max |value| (tol {TOL}); two runs differ by max abs "
                f"{rerun:.3e}")
            if not ok:
                raise AssertionError(f"pna_scatter_bwd {i} disagrees with "
                                     f"its plain version")
            sc_args.append(sa)
            # the train path's route: cstk mode, then the reverse-table
            # gather, on this layer's real coefficients
            ca = (d_mid, aux, agg, tb.in_degree, ks_t, args[9])
            cstk = scatter_bwd.fused_pna_scatter_cstk(*ca)
            torch.cuda.synchronize()
            ok, abs_c, rel_c = close_enough(
                cstk, scatter_bwd.pna_scatter_cstk_plain(*ca))
            err_scatter = max(err_scatter, abs_c)
            if not ok:
                raise AssertionError(f"pna_scatter_bwd {i} (cstk mode) "
                                     f"disagrees with its plain version")
            ga = (cstk, tb.rev_nbr_nodes, tb.out_degree, v, True, True, 2)
            dv1 = ell_bwd.fused_gather_backward(*ga)
            dv2 = ell_bwd.fused_gather_backward(*ga)
            torch.cuda.synchronize()
            ok, abs_g, rel_g = close_enough(
                dv1, ell_bwd.ell_gather_backward_plain(*ga))
            err_gather = max(err_gather, abs_g)
            ok_s, _, rel_s = close_enough(dv1, want)
            log(f"pna_scatter_bwd {i} cstk mode: {rel_c:.3e} of max |value|; "
                f"ell_gather_bwd: {rel_g:.3e} of max |value| against its "
                f"plain version, {rel_s:.3e} against the scatter route's "
                f"plain dv (tol {TOL}); bitwise equal on two launches: "
                f"{torch.equal(dv1, dv2)}")
            if not (ok and ok_s):
                raise AssertionError(f"ell_gather_bwd {i} disagrees")
            if not torch.equal(dv1, dv2):
                raise AssertionError(f"ell_gather_bwd {i}: two launches "
                                     f"differ")
            cs_args.append(ca)
            g_args.append(ga)
        report["pna_layer"] = dict(max_abs_err=err_layer)
        report["pna_scatter_bwd"] = dict(max_abs_err=err_scatter)
        report["ell_gather_bwd"] = dict(max_abs_err=err_gather)

    torch.set_grad_enabled(True)
    with phase("train gradients against the plain path (one step)"):
        grads = {}
        for mode in ("auto", "never"):
            tmodel.load_state_dict(state0)
            dispatch.set_fused_mode(mode)
            try:
                fresh_step(tmodel)(tb, target)
            finally:
                dispatch.set_fused_mode("auto")
            grads[mode] = grads_of(tmodel)
        # the plain path in float64 as the exact reference of both
        m64 = canonical_model("pna", "qm9", graphs=tgraphs).to(dev).double()
        m64.load_state_dict({k: v.double() for k, v in state0.items()})
        dispatch.set_fused_mode("never")
        try:
            loss64 = train.masked_mse_loss(
                m64(tb.replace(node_feat=tb.node_feat.double())),
                target.double(), tm)
            loss64.backward()
        finally:
            dispatch.set_fused_mode("auto")
        grads["f64"] = grads_of(m64)
        del m64
        # the gate is the float64 plain path; the float32 plain path
        # lands further from it than the kernels do (its std over u + v
        # cancels on near-constant rows), so auto vs never is logged only
        for a, b in (("auto", "f64"), ("never", "f64"), ("auto", "never")):
            gate = (a, b) == ("auto", "f64")
            ok, abs_err, rel, k = worst_grad(grads[a], grads[b])
            log(f"gradients {a} vs {b}: worst {rel:.3e} of max |value| "
                f"({k}), max abs {abs_err:.3e}"
                + (f" (tol {TOL})" if gate else " (logged)"))
            if gate and not ok:
                raise AssertionError("kernel-path gradients disagree with "
                                     "the float64 plain path")

    with phase("train step reproducibility (two steps from one state)"):
        again = []
        for _ in range(2):
            tmodel.load_state_dict(state0)
            fresh_step(tmodel)(tb, target)
            torch.cuda.synchronize()
            again.append(grads_of(tmodel))
        same = [k for k in again[0] if torch.equal(again[0][k], again[1][k])]
        log(f"bitwise-equal gradients: {len(same)} of {len(again[0])} "
            f"parameters; equal to the first step above: "
            f"{all(torch.equal(again[0][k], grads['auto'][k]) for k in same)}")
        if len(same) != len(again[0]):
            raise AssertionError("two train steps from one state gave "
                                 "different gradients")

    with phase(f"main path: {TRAIN_STEPS} Adam steps on the train batch"):
        curves = {}
        for mode in ("auto", "never"):
            tmodel.load_state_dict(state0)
            step = fresh_step(tmodel)
            dispatch.set_fused_mode(mode)
            try:
                if mode == "auto":
                    zero_counts()
                curves[mode] = [float(step(tb, target))
                                for _ in range(TRAIN_STEPS)]
                torch.cuda.synchronize()
                if mode == "auto":
                    launches = counts()
            finally:
                dispatch.set_fused_mode("auto")
        log(f"launches during the train path: {launches}")
        want = only(pna_layer=6 * TRAIN_STEPS,
                    pna_scatter_bwd=6 * TRAIN_STEPS,
                    ell_gather_bwd=6 * TRAIN_STEPS, readout=TRAIN_STEPS)
        if launches != want:
            raise AssertionError(f"train path launches {launches}, "
                                 f"expected {want}")
        for k in ("pna_layer", "pna_scatter_bwd", "ell_gather_bwd"):
            report[k]["launches"] = launches[k]
        log(f"loss curve kernels: {curves['auto']}")
        log(f"loss curve plain:   {curves['never']}")
        for i, (a, b) in enumerate(zip(curves["auto"], curves["never"])):
            if not (math.isfinite(a) and abs(a - b) <= CURVE_TOL * abs(b)):
                raise AssertionError(f"step {i}: loss {a} against plain {b}")

    with phase("64-graph train step: card kernels vs CPU plain path"):
        # the reference is the CPU plain path in float64 (in float32 its
        # std over u + v cancels on near-constant rows; see above)
        sg, (sb,) = canonical_batches("qm9", n_graphs=64, batch_size=64,
                                      node_multiple=256, device="cpu")
        s_target = train.stack_targets(sg, sb.num_graphs, device="cpu")
        cpu_m = canonical_model("pna", "qm9", graphs=tgraphs).double()
        cpu_m.load_state_dict({k: v.cpu().double()
                               for k, v in state0.items()})
        dispatch.set_fused_mode("never")
        try:
            loss = train.masked_mse_loss(
                cpu_m(sb.replace(node_feat=sb.node_feat.double())),
                s_target.double(), sb.graph_mask)
            loss.backward()
        finally:
            dispatch.set_fused_mode("auto")
        l64 = float(loss.detach())
        tmodel.load_state_dict(state0)
        l_card = float(fresh_step(tmodel)(sb.to(dev), s_target.to(dev)))
        card = {n: t.cpu() for n, t in grads_of(tmodel).items()}
        ok, abs_err, rel, k = worst_grad(card, grads_of(cpu_m))
        log(f"loss card {l_card} vs CPU f64 {l64}; gradients worst "
            f"{rel:.3e} of max |value| ({k}) (tol {TOL})")
        if not ok or abs(l_card - l64) > CURVE_TOL * abs(l64):
            raise AssertionError("card train step disagrees with the CPU")
    torch.set_grad_enabled(False)

    with phase("standard-packed inference: Program.forward on the train "
               "batch"):
        tmodel.load_state_dict(state0)
        zero_counts()
        out_std = tprog.forward(tb)
        torch.cuda.synchronize()
        launches = counts()
        log(f"launches: {launches}")
        if launches != only(readout=1, pna_layer=6):
            raise AssertionError("standard-packed forward did not run the "
                                 "layer kernel in every layer")
        dispatch.set_fused_mode("never")
        try:
            ref_std = tprog.forward(tb)
        finally:
            dispatch.set_fused_mode("auto")
        ok, abs_err, rel_err = close_enough(out_std[tm], ref_std[tm])
        log(f"kernels vs per-layer plain: max abs {abs_err:.3e}, "
            f"{rel_err:.3e} of max |value| (tol {TOL})")
        if (not ok or tuple(out_std.shape) != (tb.num_graphs,
                                                 tmodel.mlp_out_dim)):
            raise AssertionError("standard-packed forward disagrees")

    with phase("GCN, GIN and SAGE: data, models and the mp stack kernel "
               "against its plain version"):
        mp_progs, mp_report = {}, {}
        xs = torch.nn.functional.pad(b0.node_feat,
                                     (0, 128 - b0.feature_dim)).contiguous()
        skips6 = [0 < i < L - 1 for i in range(L)]
        real = b0.node_mask
        err_mp = 0.0
        for conv in MP_CONVS:
            m_ = canonical_model(conv, "qm9", graphs=graphs)
            p_ = Program(m_, max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                         max_graphs=b0.num_graphs, block_size=128,
                         device="cuda", seed=11)
            p_.init_params()
            mp_progs[conv] = p_
            margs = (xs, b0.block_adj, b0.in_degree,
                     *m_._kernel_params(128)[0])
            mkw = dict(conv=conv, epss=[c.eps if conv == "gin" else 0.0
                                        for c in m_.gnn_convs],
                       skips=skips6, act=m_.gnn_activation)
            got = mp_block.fused_mp_block_stack(*margs, **mkw)
            torch.cuda.synchronize()
            want = mp_block.mp_stack_plain(*margs, **mkw)
            ok, abs_err, rel_err = close_enough(got[real], want[real])
            err_mp = max(err_mp, abs_err)
            log(f"mp_block_stack {conv} [N={xs.shape[0]}, F=128, L={L}]: max "
                f"abs {abs_err:.3e}, {rel_err:.3e} of max |value| (tol "
                f"{TOL}; node_mask rows)")
            if not ok:
                raise AssertionError(f"mp_block_stack {conv} disagrees with "
                                     f"its plain version")
            mp_report[conv] = dict(args=margs, kw=mkw, model=m_)
        # hidden 384: H and T no longer fit shared memory
        wide = canonical_model("sage", "qm9", graphs=graphs,
                               gnn_hidden_dim=384, gnn_output_dim=384)
        Program(wide, max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                max_graphs=b0.num_graphs, block_size=128, device="cuda",
                seed=12).init_params()
        x384 = torch.nn.functional.pad(b0.node_feat,
                                       (0, 384 - b0.feature_dim))
        wargs = (x384.contiguous(), b0.block_adj, b0.in_degree,
                 *wide._kernel_params(384)[0])
        wkw = dict(conv="sage", epss=[0.0] * L, skips=skips6, act="relu")
        got = mp_block.fused_mp_block_stack(*wargs, **wkw)
        torch.cuda.synchronize()
        ok, abs_err, rel_err = close_enough(
            got[real], mp_block.mp_stack_plain(*wargs, **wkw)[real])
        err_mp = max(err_mp, abs_err)
        wide_ms = time_ms(lambda: mp_block.fused_mp_block_stack(*wargs,
                                                                **wkw), 3)
        log(f"mp_block_stack sage at hidden 384: max abs {abs_err:.3e}, "
            f"{rel_err:.3e} of max |value| (tol {TOL}); {wide_ms:.4f} ms")
        if not ok:
            raise AssertionError("mp_block_stack at hidden 384 disagrees")
        report["mp_block_stack"] = dict(max_abs_err=err_mp,
                                        sage_hidden_384_ms=wide_ms)

    with phase(f"main path: Program.forward of canonical GCN, GIN and SAGE "
               f"on {N_BATCHES} x {BATCH_GRAPHS}-graph batches"):
        mp_launches = 0
        mp_outs = {}
        for conv in MP_CONVS:
            zero_counts()
            mp_outs[conv] = [mp_progs[conv].forward(b) for b in batches]
            torch.cuda.synchronize()
            launches = counts()
            stacked = N_BATCHES if conv != "gin" else 0
            log(f"{conv}: launches {launches}")
            if launches != only(mp_block_stack=stacked, readout=N_BATCHES):
                raise AssertionError(f"{conv}: launches {launches}")
            mp_launches += launches["mp_block_stack"]
        report["mp_block_stack"]["launches"] = mp_launches

    with phase("GCN, GIN and SAGE outputs against the per-layer plain path"):
        small_g, (small,) = canonical_batches(
            "qm9", n_graphs=64, batch_size=64, block_size=128,
            node_multiple=128, device="cpu")
        for conv in MP_CONVS:
            p_ = mp_progs[conv]
            dispatch.set_fused_mode("never")
            try:
                refs = [p_.forward(b) for b in batches]
            finally:
                dispatch.set_fused_mode("auto")
            for i, (b, out, ref) in enumerate(zip(batches, mp_outs[conv],
                                                  refs)):
                m = b.graph_mask
                ok, abs_err, rel_err = close_enough(out[m], ref[m])
                log(f"{conv} batch {i}: auto vs per-layer plain on the card: "
                    f"max abs {abs_err:.3e}, {rel_err:.3e} of max |value| "
                    f"(tol {TOL})")
                if (not ok or tuple(out.shape) != (b.num_graphs, 1)):
                    raise AssertionError(f"{conv} batch {i} disagrees")
            cpu_p = Program(canonical_model(conv, "qm9", graphs=graphs),
                            max_nodes=small.num_nodes,
                            max_edges=small.num_edges,
                            max_graphs=small.num_graphs, block_size=128,
                            device="cpu")
            cpu_p.set_params({k: v.cpu() for k, v in p_.params.items()})
            dispatch.set_fused_mode("never")
            try:
                ref = cpu_p.forward(small)
            finally:
                dispatch.set_fused_mode("auto")
            out = p_.forward(small.to(dev)).cpu()
            m = small.graph_mask
            ok, abs_err, rel_err = close_enough(out[m], ref[m])
            log(f"{conv} 64-graph batch: card vs CPU plain path: max abs "
                f"{abs_err:.3e}, {rel_err:.3e} of max |value| (tol {TOL})")
            if not ok:
                raise AssertionError(f"{conv}: card disagrees with the CPU")

    with phase("times (CUDA events)"):
        bench = prog.benchmark(b0, iters=20, warmup=3)
        log(f"forward b{BATCH_GRAPHS}: {bench['latency_s'] * 1e3:.4f} ms, "
            f"{bench['graphs_per_s']:.1f} graphs/s on {bench['device']} "
            f"({smi})")
        # bounds count the work at the model's own widths; the kernels run
        # the layers zero-padded to 128 lanes, logged as pad overhead
        widths = pna_widths(model)
        N, W = x.shape[0], b0.ell_width
        edges = int(b0.in_degree.sum())
        # stack: the five products per row and layer, ~5 ops per gathered
        # neighbour value (add, square-add, max, min); every input once,
        # the output once
        s_flops = sum(layer_flops(N, edges, *w, 5) for w in widths)
        s_pad = L * layer_flops(N, edges, 128, 128, 128, 5)
        s_bytes = 4 * (N * widths[0][0] + N * widths[-1][2] + N * W + N
                       + sum(layer_weights(*w) for w in widths))
        s_bound, s_by = bound(s_flops, s_bytes)
        report["pna_block_stack"].update(
            ms=time_ms(lambda: pna_block.fused_pna_block_stack(*sargs, **skw),
                       10),
            plain_ms=time_ms(lambda: pna_block.pna_block_stack_plain(
                *sargs, **skw), 3),
            bound_ms=s_bound, bound_by=s_by,
            flops=s_flops, padded_flops=s_pad, bytes=s_bytes)
        G, Fh = b0.num_graphs, h.shape[1]
        n_params = sum(w.numel() + c.numel() for w, c in head)
        pooled_rows = int(b0.n_node[b0.graph_mask].sum())
        r_flops = (pooled_rows * Fh + 2 * G * Fh
                   + G * 2 * sum(w.numel() for w, _ in head))
        r_bytes = 4 * (h.numel() + mx.numel() + 2 * G + n_params
                       + G * model.mlp_out_dim)
        r_bound, r_by = bound(r_flops, r_bytes)
        report["readout"].update(
            ms=time_ms(lambda: readout.fused_readout(*rargs, **rkw), 50),
            plain_ms=time_ms(lambda: readout.readout_plain(
                h, b0.n_node, b0.graph_starts, head, aggrs, mx,
                model.mlp_activation, model.output_activation), 20),
            bound_ms=r_bound, bound_by=r_by,
            flops=r_flops, bytes=r_bytes)

        # train kernels: the six launches of one step, at the shapes and on
        # the operands of the canonical model's layers
        def run_layers(fn):
            for args, kw in layers:
                fn(*args, **kw, save_res=True)

        def run_each(fn, arg_list):
            for a in arg_list:
                fn(*a)

        E = int(tb.in_degree.sum())
        Nt, Wt = tb.num_nodes, tb.ell_width
        Wr = tb.rev_nbr_nodes.shape[1]
        l_flops = l_bytes = c_flops = c_bytes = l_pad = c_pad = 0
        g_flops = g_bytes = g_pad = 0
        for (args, kw), (Fi, Fl, Fo) in zip(layers, pna_widths(tmodel)):
            # the five products, ~5 ops per gathered value (add,
            # square-add, max, min), 2 compares per gathered value for ties
            l_flops += layer_flops(Nt, E, Fi, Fl, Fo, 7)
            l_pad += layer_flops(Nt, E, args[0].shape[1], args[3].shape[1],
                                 args[7].shape[1], 7)
            # x, the table, the weights and skip in; out, v, agg_cat, aux
            # and mid out
            l_bytes += 4 * (Nt * Fi + Nt * Wt + Nt + layer_weights(Fi, Fl, Fo)
                            + (Nt * Fo if kw["skip"] is not None else 0)
                            + Nt * (2 * Fo + Fl + 4 * Fl + 5 * Fl))
            # the scatter kernel's cstk mode (the train path's): d_agg and
            # ~10 ops per row and feature for the coefficients; d_mid, aux,
            # the std block, the degrees and ks_t in, cstk [N, 7F] out
            c_flops += 2 * Nt * 3 * Fo * 4 * Fl + 10 * Nt * Fl
            c_pad += (2 * Nt * 3 * args[7].shape[1] * 4 * args[3].shape[1]
                      + 10 * Nt * args[3].shape[1])
            c_bytes += 4 * (Nt * Fo + Nt * 5 * Fl + Nt * Fl + Nt
                            + 3 * Fo * 4 * Fl + Nt * 7 * Fl)
            # the gather: per gathered value 8 ops (lin add; dev multiply,
            # subtract, add; two compares and adds); cstk, v, the reverse
            # table and out-degrees in, dv out
            g_flops += 8 * E * Fl
            g_pad += 8 * E * args[3].shape[1]
            g_bytes += 4 * (Nt * 7 * Fl + Nt * Fl + Nt * Wr + Nt + Nt * Fl)
        pads = {"pna_layer": l_pad, "pna_scatter_bwd": c_pad,
                "ell_gather_bwd": g_pad}
        report["pna_scatter_bwd"].update(
            atomic_mode_ms=time_ms(lambda: run_each(
                scatter_bwd.fused_pna_scatter_backward, sc_args), 10),
            atomic_mode_plain_ms=time_ms(lambda: run_each(
                scatter_bwd.pna_scatter_backward_plain, sc_args), 3))
        for name, fn, plain, fl, by in (
                ("pna_layer", lambda: run_layers(pna_layer.fused_pna_layer),
                 lambda: run_layers(pna_layer.pna_layer_plain),
                 l_flops, l_bytes),
                ("pna_scatter_bwd",
                 lambda: run_each(scatter_bwd.fused_pna_scatter_cstk,
                                  cs_args),
                 lambda: run_each(scatter_bwd.pna_scatter_cstk_plain,
                                  cs_args),
                 c_flops, c_bytes),
                ("ell_gather_bwd",
                 lambda: run_each(ell_bwd.fused_gather_backward, g_args),
                 lambda: run_each(ell_bwd.ell_gather_backward_plain, g_args),
                 g_flops, g_bytes)):
            b_ms, b_by = bound(fl, by)
            report[name].update(ms=time_ms(fn, 10), plain_ms=time_ms(plain, 3),
                                bound_ms=b_ms, bound_by=b_by, flops=fl,
                                padded_flops=pads[name], bytes=by,
                                per="train step (6 launches)")
        log(f"pna_scatter_bwd scatter (atomic) mode: "
            f"{report['pna_scatter_bwd']['atomic_mode_ms']:.4f} ms per step "
            f"(plain {report['pna_scatter_bwd']['atomic_mode_plain_ms']:.4f})")

        # mp stack: each conv's launch on the first block batch, its whole
        # forward, and GIN's kernel mode against GIN's per-layer convs
        Nb, Eb = b0.num_nodes, int(b0.in_degree.sum())
        by_conv, mp_fwd = {}, {}
        for conv in MP_CONVS:
            r_ = mp_report[conv]
            m_, margs, mkw = r_["model"], r_["args"], r_["kw"]
            widths = mp_widths(m_)
            fl = mp_flops(conv, Nb, Eb, widths)
            pad = mp_flops(conv, Nb, Eb, [(128, 128)] * L)
            # x, the block adjacency, the degrees and the weights in, h out
            by = 4 * (Nb * widths[0][0] + b0.block_adj.numel() + Nb
                      + mp_weights(conv, widths) + Nb * widths[-1][1])
            b_ms, b_by = bound(fl, by)
            by_conv[conv] = dict(
                ms=time_ms(lambda: mp_block.fused_mp_block_stack(
                    *margs, **mkw), 10),
                plain_ms=time_ms(lambda: mp_block.mp_stack_plain(
                    *margs, **mkw), 3),
                bound_ms=b_ms, bound_by=b_by, flops=fl, padded_flops=pad,
                bytes=by)
            fb = mp_progs[conv].benchmark(b0, iters=20, warmup=3)
            mp_fwd[conv] = dict(ms=fb["latency_s"] * 1e3,
                                graphs_per_s=fb["graphs_per_s"])
            log(f"{conv}: forward b{BATCH_GRAPHS} {mp_fwd[conv]['ms']:.4f} ms, "
                f"{fb['graphs_per_s']:.1f} graphs/s; mp_block_stack "
                f"{by_conv[conv]['ms']:.4f} ms (plain "
                f"{by_conv[conv]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by "
                f"{b_by}; runs {pad / fl - 1:.1%} more flops zero-padded)")
        gin_m = mp_report["gin"]["model"]

        def gin_per_layer():
            h_ = b0.node_feat
            for i, c in enumerate(gin_m.gnn_convs):
                h_ = c(b0, h_, gin_m.gnn_activation,
                       h_ if 0 < i < L - 1 else None)
            return h_

        gin_layers_ms = time_ms(gin_per_layer, 10)
        log(f"gin conv stack: kernel mode {by_conv['gin']['ms']:.4f} ms, "
            f"per-layer path (the auto policy) {gin_layers_ms:.4f} ms")
        report["mp_block_stack"].update(by_conv["gcn"], conv="gcn",
                                        by_conv=by_conv)
        for k, v in report.items():
            pad = (f"; runs {v['padded_flops'] / v['flops'] - 1:.1%} more "
                   f"flops zero-padded" if "padded_flops" in v else "")
            log(f"{k}: {v['ms']:.4f} ms (plain {v['plain_ms']:.4f} ms, "
                f"bound {v['bound_ms']:.4f} ms by {v['bound_by']}{pad})")

        torch.set_grad_enabled(True)
        tmodel.load_state_dict(state0)
        step = fresh_step(tmodel)
        train_ms = time_ms(lambda: step(tb, target), 10, warmup=3)
        dispatch.set_fused_mode("never")
        try:
            plain_train_ms = time_ms(lambda: step(tb, target), 3, warmup=1)
        finally:
            dispatch.set_fused_mode("auto")
        log(f"train step b{BATCH_GRAPHS}: {train_ms:.4f} ms (plain path "
            f"{plain_train_ms:.4f} ms) on {smi}")

    with phase("train step split (torch.profiler, 3 steps)"):
        from torch.profiler import ProfilerActivity, profile

        step(tb, target)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            for _ in range(3):
                step(tb, target)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t) * 1e3 / 3
        split = split_device_time(prof, 3)
        busy = sum(split.values())
        split_line = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        log(f"device ms per step by part: {split_line}; busy {busy:.4f} of "
            f"{wall_ms:.4f} ms wall")
    torch.set_grad_enabled(False)

    kernels = [
        dict(name="pna_block_stack", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/pna_block.cu",
             replaces="gnnbuilder_tpu/ops/pallas/pna_block.py:392",
             library_ms=None, **report["pna_block_stack"]),
        dict(name="readout", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/readout.cu",
             replaces="gnnbuilder_tpu/ops/pallas/readout.py:186",
             library_ms=None, **report["readout"]),
        dict(name="pna_layer", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/pna_layer.cu",
             replaces="gnnbuilder_tpu/ops/pallas/pna_layer.py:458",
             library_ms=None, **report["pna_layer"]),
        dict(name="pna_scatter_bwd", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/scatter_bwd.cu",
             replaces="gnnbuilder_tpu/ops/pallas/scatter_bwd.py:448",
             library_ms=None, **report["pna_scatter_bwd"]),
        dict(name="mp_block_stack", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/mp_block.cu",
             replaces="gnnbuilder_tpu/ops/pallas/mp_block.py:157",
             library_ms=None, **report["mp_block_stack"]),
        dict(name="ell_gather_bwd", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/ell_bwd.cu",
             replaces="gnnbuilder_tpu/ops/pallas/ell_bwd.py:259",
             library_ms=None, **report["ell_gather_bwd"]),
    ]
    print(json.dumps({
        "kernels": kernels,
        "forward": dict(batch_graphs=BATCH_GRAPHS,
                        ms=bench["latency_s"] * 1e3,
                        graphs_per_s=bench["graphs_per_s"]),
        "mp_forward": dict(batch_graphs=BATCH_GRAPHS, **mp_fwd,
                           gin_conv_stack_ms=dict(
                               kernel_mode=by_conv["gin"]["ms"],
                               per_layer=gin_layers_ms)),
        "train": dict(batch_graphs=BATCH_GRAPHS, nodes=tb.num_nodes,
                      step_ms=train_ms, plain_step_ms=plain_train_ms,
                      loss_curve=curves["auto"],
                      plain_loss_curve=curves["never"],
                      device_ms_per_step=split, profiled_wall_ms=wall_ms),
    }), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

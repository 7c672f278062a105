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
  six layers (each gather the bits of the slot-ordered loop
  ``ell_bwd.ell_gather_backward_ordered``) and the readout kernel; gradients against the float64 plain
  path, bitwise-equal gradients from two steps off one state, a 5-step
  loss curve against the plain path on the card, and a small batch's step
  against the plain path on the CPU; then ``Program.forward`` on that
  batch, which runs the layer kernel too;
* GCN, GIN and SAGE inference: ``Program.forward`` on the three
  block-packed batches (the mp stack kernel for GCN and SAGE, GIN's
  per-layer path, the readout kernel), against the per-layer plain path
  on the card and, on a small batch, against the CPU; per-layer GCN, GIN
  and SAGE training and LG / Simple forwards on the mp layer kernel;
* GAT with 4 heads (layers 11 -> 4 x 128 -> ... -> 4 x 64): the block
  attention kernel (row 9) and the windowed layer kernel (row 10)
  against their plain versions in each layer, row 11 (the softmax
  backward) in both of its modes, bitwise on two launches, with its
  instances' registers, shared memory and CTAs an SM and the rate at
  which it moves its bound's bytes; ``Program.forward`` on the three
  block-packed batches (row 9 in every layer) and on the standard-packed
  train batch (row 10); the train step (row 10 forward, row 11
  backward): gradients against the float64 plain path taken on the
  kernel path's ReLU decisions (the others logged), bitwise-equal gradients
  on two steps with and without the reverse table, a 3-step loss curve
  against the plain path; rows 9 and 10 project on the tensor cores
  (their instances' HGMMA / HMMA / IMMA counted in the SASS with row
  1's, and zero fails), timed on staged weights as the model's cache
  passes them, row 10's projection and attention launches apart, and
  the per-step cost of laying out a train step's live weights;
* GINE (edge features, row 12), EdgeConv (max, row 13) and the
  multi-aggregate (row 8) under Simple max / min (128 wide) and PNA with
  all five aggregators: each kernel against its plain version in every
  layer (row 12 on its weights' Ring layout, as the model launches it,
  and on the caller's weights; its instances' HMMA / IMMA / DMMA counted
  in the SASS, bf16's float64 Z checked), row 8 in f32 and bf16 the
  bits of the slot-ordered loop ``ell_agg.ell_aggregate_ordered`` in
  every layer of every path (its instances' registers and CTAs an SM
  logged), row 8's backward on both u-free routes against float64 and
  bitwise on two runs; ``Program.forward`` of GINE (block-packed and
  standard-packed), EdgeConv (block-packed), Simple max and min
  (standard-packed) and five-aggregator PNA (both packings) against the
  per-layer plain path; the GINE train step: gradients against the
  float64 plain path, bitwise-equal gradients on two steps with and
  without the reverse table, a 3-step loss curve against the plain path;
* the bf16 and int8 policies of ``Program`` on canonical PNA inference:
  the bf16 and int8 modes of rows 1, 2 and 5 against their plain versions
  in every layer; ``Program(precision=...).forward`` on the three
  block-packed batches (rows 1 and 2 in the policy's mode) and on the
  standard-packed train batch (row 5 in all six layers and row 2), each
  policy's error against f32 and, on a small batch, against the CPU in the
  same policy; ``calibrate_int8`` on two batches and a forward with static
  scales (the plain path); the modes' times and bounds (bf16 and int8
  products at the tensor cores' dense peaks);
* the bf16 and int8 modes of rows 3 (mp stack), 4 (mp layer), 8
  (multi-aggregate, bf16), 12 (GINE) and 13 (EdgeConv, bf16) against
  their plain versions in every layer of their paths at b1024;
  ``Program(precision=...).forward`` of GCN, GIN, SAGE, LG, Simple, GINE,
  EdgeConv, Simple max and five-aggregator PNA under both policies on
  the packings the gates send to those kernels, each with its launch
  counts per mode, its error against f32 and a 64-graph batch against
  the CPU in the same policy; row 6's generic entry (reverse CSR, then
  row 7's CSR gather) against its plain version; the times and bounds;
* canonical GAT (heads 4) under bf16 and int8: the bf16 mode of row 9
  and the bf16 and int8 modes of row 10 against their plain versions in
  every layer at b1024; ``Program(precision=...).forward`` on the three
  block-packed batches (row 9b under bf16, row 10i under int8) and on
  the standard-packed train batch (rows 10b, 10i), with per-mode launch
  counts, the error against f32 and a 64-graph batch against the CPU;
  then serving: ``GNNServer.from_program`` of GAT bf16 block-packed,
  int8 block-packed and int8 standard-packed (buckets from
  ``Program.from_dataset`` at 64 graphs) answering three bursts of 512
  QM9 requests, each on a fresh server after a warm-up one, the mode
  kernels' launches inside each server, every prediction against
  ``Program.forward`` of the same graphs, a server from
  ``export_bundle`` giving the same predictions, sustained graphs/s and
  p50 / p90 / p99 request latency (the median burst) beside one graph
  per synchronous forward, and the host syncs of one micro-batch by
  line; the modes' times and bounds;
* canonical GAT with QM9's edge features (``conv_kwargs={"heads": 4,
  "edge_dim": 4}``): the edge-logit modes of rows 9 (f32, bf16) and 10
  (f32, bf16, int8) against their plain versions in every layer at
  b1024; ``Program.forward`` on a block-packed batch of 1024 QM9 graphs
  with repeated (sender, receiver) pairs removed (row 9's edge mode in
  every layer), on the raw block-packed batch, which repeats pairs (row
  10's: the block route declines it), and on the standard-packed train
  batch (row 10's), against the plain path; the train step (row 10's
  edge mode forward, autograd of the plain layer backward): gradients
  against the float64 plain path on the kernel path's ReLU decisions,
  bitwise-equal gradients on two steps, a 3-step loss curve; the bf16
  policy on both packings (both kernels' bf16 edge modes) and int8 (no
  GAT kernel: the JAX gate declines an edge conv there), against f32
  and the CPU; the times, the edge terms' torch time per forward and the
  train step's profiler split;
* the measurement layer (``measurement_phases``): canonical PNA under
  f32, bf16 and int8 and GCN, GIN and SAGE under f32 on the b1024
  block-packed batches: ``Program.benchmark_inner`` (k chained forwards
  captured in CUDA graphs and replayed, static and dynamic) beside
  ``benchmark``'s CUDA events, ``cost_analysis``, ``program_min_bytes``,
  ``profile_program``'s fraction of the roofline and the energy bound per
  graph at the card's power limit; the same cost counted on the per-layer
  path and on the CPU; each fit resolved, the inner latency
  at most 1.05 x the events' per forward, every fraction of the roofline
  at most 1, a replayed chain's last forward against an eager one on
  each batch, the path's kernels in a profiled replay, and no host sync
  in a warm forward (``set_sync_debug_mode("error")``);
* the trainer's pieces and golden verification
  (``trainer_verify_phases``): the native packer's build seconds, its
  batches bit-equal to the numpy path's, both host times per b1024
  batch and per 64-graph micro-batch; 4 canonical PNA b1024 Adam steps
  fed by ``GraphLoader`` against the same chunks fed directly (batches,
  losses, weights bit for bit, the same host syncs a step); PNA, GAT and
  GINE b1024 steps with ``remat=True`` against ``False`` (loss and
  gradients bit for bit, the layer kernels replayed; peak memory and
  step ms of both); a PNA block forward under ``dispatch.no_fused``
  (no launch); ``verify.torch_ref`` models of the nine convs ported by
  ``verify.port`` into card Programs against torch_ref on the CPU, and
  PNA's ``run_parity_check`` on the card against CPU goldens from
  ``gen_testbench_data``;
* distribution (``parallel_phases``, ``gnnbuilder_tpu_torch.parallel``):
  a world of 1 over NCCL in this process, canonical PNA's halo forward
  (row 5 once per layer on the rank's [halo | local | halo] window)
  against ``Program.forward``, row 5 against its plain version on each
  window, three halo Adam steps (rows 5, 6 and 7's CSR mode on the
  windows) against ``make_train_step`` (losses and every gradient, two
  runs bit for bit, the window's reverse CSR built once a step), the
  all-gather strategy against the plain path, and one forward and step
  each of GCN, GIN, SAGE (row 4) and GAT (rows 10, 11); then a world of 2
  over gloo on the one card (two spawned processes, buffers staged
  through host memory): PNA's forward and step on dp = 2 against the
  world of 1, each rank's launches and its window's halos; CUDA-event
  times of the halo forward and step beside ``Program.forward`` and
  ``make_train_step``;
* design-space exploration (``dse_phases``, ``gnnbuilder_tpu_torch.
  dse``): ``measure_config`` on four QM9 design points (PNA b1024 block
  f32, GCN b256 without an ELL table under bf16, GAT b64 standard f32,
  GINE b256 block), each timed by ``Program.benchmark_inner`` over CUDA
  graphs with its row, its kernels' launches and its forward against the
  plain path; ``measure_many`` resuming a CSV; the ``ell_width``
  override reaching packing; ``from_pretrained`` -> ``tune_kernels`` ->
  ``verify`` where scikit-learn is installed;
* training under a precision policy (``policy_grad_phases``): one Adam
  step of PNA, GIN, SAGE, GCN, GAT (heads 4) and GINE at the canonical
  widths on the b1024 standard-packed train batch under
  ``Precision.bf16()`` and ``Precision.int8()`` through the layer
  kernels' autograd Functions (rows 5, 4, 10, 12 in the mode forward, the
  readout in it, rows 6, 7 and 11 backward), counted per mode; the
  gradients against the Functions' plain twins on the card
  (``dispatch.plain_twins``; each layer on its kernel-path input, and the
  whole model) and, on 64 graphs, against the CPU; two
  steps bitwise twice; each conv's f32, bf16 and int8 step ms with its
  device busy time; rows 4b, 4i, 5b and 5i with and without their
  residual stores; and ``Program(block_size=256)`` forwards of PNA, GCN,
  GIN, SAGE, LG, Simple and GAT on 1024 QM9 graphs block-packed at 256
  rows (no block kernel takes them: the layer kernels over the ELL
  table) against the per-layer plain path;
* the paper's conv x dataset grid (``harness_phases``,
  ``gnnbuilder_tpu_torch.bench.harness``): ``run_grid`` on the card for
  GCN, GIN, PNA and SAGE on QM9 and ESOL at batch 1, 4 (standard
  packing: rows 4 and 5) and 256 (128-row blocks: rows 1 and 3, GIN per
  layer), row 2 everywhere; first each arm as ``bench_gpu`` builds it,
  its first forward against the per-layer plain path with its launches
  and its device busy time; then the grid's ms a forward and a graph,
  graphs/s and ``vs_fpga_par``, and the ``torch_cpu`` baseline on (GCN,
  QM9) in the same run;
* the sharded repairs (``sharded_repair_phases``): a gloo world of two
  ranks on the one card runs canonical GCN under int8 with its weights
  sharded over tp = 2 and canonical edge GAT on dp = 2, both in the
  all-gather strategy, against the one-rank forward.

For each path it sets every launch count to 0 just before and checks the
counts just after, then times the forwards, the train step and each
kernel with CUDA events and splits the train step's device time by kernel
with ``torch.profiler``.

Output: one flushed, timestamped line before and after every phase; the
ptxas report of the build; a ``measurement`` JSON line per measurement
cell, a ``trainer_verify`` JSON line per part of that phase, a ``dse``
JSON line per design point, a ``policy_grad`` JSON line, the harness
grid's lines; then, each
on its own line, a ``kernels`` JSON object, the card's name and power
limit from nvidia-smi, and last ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result, when CUDA is unavailable, when run
without the package beside it, or when any check fails.  Its only
threads are the servers' and the loader's producer (every wait on them
has a timeout, each server is closed, each loader epoch is closed);
every subprocess has a timeout.
"""

import contextlib
import ctypes
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores, TF32, bf16 and int8 on them, and HBM bandwidth
from gnnbuilder_tpu_torch.bench.roofline import (
    PEAK_BF16_FLOPS,
    PEAK_BYTES_PER_S,
    PEAK_F32_FLOPS,
    PEAK_INT8_OPS,
    PEAK_TF32_FLOPS,
)

T0 = time.time()
SMI_TIMEOUT_S = 30

# tolerance of every comparison below: max |got - want| <= TOL * max |want|
# (and all values finite).  The kernels take their sums in another order
# than the plain versions (and the stack takes the receiver term outside
# the neighbour reduce), so they agree to f32 rounding over 6 layers of
# 512-long dot products, ~1e-6 of the largest value, not bitwise.  A
# scale-relative bound keeps the check as tight for the small outputs of
# a randomly initialised model as for large ones.
TOL = 1e-4
# rows 8, 12 and 13 against their plain versions, layer by layer: each
# kernel sums the same terms as its plain version in slot order, so they
# agree to a few roundings of the largest value; row 8's backward to
# 2e-5 (its coefficients divide by a std that can be sqrt(1e-5))
KERNEL_TOL = 1e-5
BWD_TOL = 2e-5

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


def close_enough(got, want, tol=TOL):
    """(ok, max abs error, max abs error / max |want|)."""
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    ok = bool(torch.isfinite(got).all()) and rel <= tol
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


def kernel_split(fn, iters=20, warmup=2):
    """Device ms per call of ``fn`` by CUDA kernel name: the kernels' self
    time under torch.profiler over ``iters`` calls (a profile that caught
    no device event is retaken, up to three times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                us = e.self_cuda_time_total if us is None else us
                out[e.key] = out.get(e.key, 0.0) + us / 1e3 / iters
        if sum(out.values()) > 0:
            break
    return out


def device_ms(fn, iters=20, warmup=2):
    """Device time per call of ``fn``: the sum of ``kernel_split``.  For
    calls shorter than the host's launch overhead, CUDA events around
    back-to-back calls (``time_ms``) measure the host's launch rate
    instead."""
    return sum(kernel_split(fn, iters, warmup).values())


def timed(fn, iters):
    """(device ms, CUDA-event ms) per call of ``fn``."""
    return device_ms(fn, iters), time_ms(fn, iters)


def bound(flops, nbytes):
    t_ops = flops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bound_f32_products(products, other, nbytes):
    """The least time for f32-accurate products and ``other`` f32 CUDA-core
    operations: the products at the f32 FMA rate or in three TF32 passes
    on the tensor cores, whichever is faster, the rest at the f32 rate;
    against the bytes over the memory rate."""
    t_ops = (min(products / PEAK_F32_FLOPS, 3 * products / PEAK_TF32_FLOPS)
             + other / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# the tensor-core instructions of each instance of the kernels whose
# products run on them, in the built library's SASS (sm_90: HGMMA for
# wgmma, HMMA for f16 / bf16 / tf32 mma.sync, IMMA for int8, DMMA for
# f64)
TC_OPS = ("HGMMA", "HMMA", "IMMA", "DMMA")
STACK_MODES = {"f32": 0, "bf16": 1, "int8": 2}
# kernel: (SASS name pattern, info entry, {instance: info arguments}).
# The GAT instances are MODE x chunk width (64 * np); their edge-logit
# modes are a runtime argument of the block kernel and live in row 10's
# attention launch, which runs no product.  Row 5's projection (its x
# products and its final Linear) has an instance per mode, its aggregate
# launch f32 and bf16 (the int8 mode runs the f32 one), its v launch
# (float64 products) one, for f32 and int8.
TC_KERNELS = {
    "pna_block_stack": (r"pna_block_stack_kernelILi(\d)E",
                        "gnnb_pna_block_info",
                        {(c,): (c,) for c in STACK_MODES.values()}),
    "pna_proj": (r"pna_proj_kernelILi(\d)E", "gnnb_pna_layer_info",
                 {(c,): (0, c) for c in STACK_MODES.values()}),
    "pna_agg": (r"pna_agg_kernelILi(\d)E", "gnnb_pna_layer_info",
                {(c,): (1, c) for c in (0, 1)}),
    "pna_v": (r"pna_v_kernel()", "gnnb_pna_layer_info", {(0,): (2, 0)}),
    "gat_proj_tc": (r"gat_proj_tc_kernelILi(\d)ELi(\d)E",
                    "gnnb_gat_proj_info",
                    {(c, n): (c, n) for c in (0, 1, 2) for n in (1, 2)}),
    "gat_block_tc": (r"gat_block_tc_kernelILi(\d)ELi(\d)E",
                     "gnnb_gat_block_info",
                     {(c, n): (c, n) for c in (0, 1) for n in (1, 2)}),
    # mode x where H and T live (1: shared memory, F = 128)
    "mp_block_stack": (r"mp_block_stack_kernelILi(\d)ELb(\d)E",
                       "gnnb_mp_block_info",
                       {(c, ht): (c, ht) for c in STACK_MODES.values()
                        for ht in (1, 0)}),
    # f32 only; its resources at d_mid 128 wide, 128 rows a CTA (the
    # launcher's choice there)
    "pna_scatter_bwd": (r"pna_scatter_bwd_kernel()", "gnnb_scatter_bwd_info",
                        {(0,): (128, 128)}),
    # row 4's gin / sage kernel, mode x block mode x rows a CTA (128; 64
    # where 128 do not fit: hidden 384); its resources at 128 wide in,
    # hidden and out (384 for 64 rows), for gin and for sage (their shared
    # memory differs), the same SASS
    "mp_layer_tc gin": (r"mp_layer_tc_kernelILi(\d)ELb(\d)ELi(\d+)E",
                        "gnnb_mp_layer_info",
                        {(c, b, r): (c, b, 0, r, 128 if r == 128 else 384)
                         for c in STACK_MODES.values() for b in (0, 1)
                         for r in (128, 64)}),
    "mp_layer_tc sage": (r"mp_layer_tc_kernelILi(\d)ELb(\d)ELi(\d+)E",
                         "gnnb_mp_layer_info",
                         {(c, b, r): (c, b, 1, r, 128 if r == 128 else 384)
                          for c in STACK_MODES.values() for b in (0, 1)
                          for r in (128, 64)}),
    # row 13's projection and slot launches (the slot launch's instance
    # for F % 4 == 0), f32 and bf16, at 128 wide
    "edge_proj_tc": (r"edge_proj_tc_kernelILb(\d)E", "gnnb_edge_block_info",
                     {(c,): (0, c) for c in (0, 1)}),
    "edge_slot_tc": (r"edge_slot_tc_kernelILb(\d)ELi4E", "gnnb_edge_block_info",
                     {(c,): (1, c) for c in (0, 1)}),
    # row 12, mode x rows a CTA x weight path (1: the Ring layout, 0: the
    # caller's weights) x CTAs an SM (the launch bounds); at 128 wide in,
    # hidden and out, but the caller's-weights path at 64 rows in f32 and
    # int8 at 384 (hidden 384, where it takes over)
    "gine_layer": (r"gine_layer_kernelILi(\d)ELi(\d+)ELb(\d)ELi(\d)E",
                   "gnnb_gine_layer_info",
                   {k: k + (384 if k[1:3] == (64, 0) and k[0] != 1
                            else 128,)
                    for k in [(c, 64, 1, 3) for c in (0, 2)]
                    + [(c, 64, 1, 2) for c in (0, 1, 2)]
                    + [(c, 128, 0, 2) for c in (0, 2)]
                    + [(c, 64, 0, 2) for c in (0, 1, 2)]}),
}


def tc_label(kern, key):
    """An instance's name: its mode, for GAT its chunk width, for the mp
    stack where H and T live."""
    mode = {v: k for k, v in STACK_MODES.items()}[key[0]]
    if kern == "mp_block_stack":
        return f"{mode} {'H in shared' if key[1] else 'H in device'}"
    if kern.startswith("mp_layer_tc"):
        return f"{mode} {'block' if key[1] else 'ELL'} {key[2]} rows"
    if kern == "gine_layer":
        return (f"{mode} {key[1]} rows, {'ring' if key[2] else 'caller'}"
                f"'s weights, {key[3]} CTAs an SM")
    return mode if len(key) == 1 else f"{mode} cw{64 * key[1]}"


def tc_kernel_resources(lib_path, lib, nvcc_path):
    """{kernel: {instance: {"HMMA": n, ..., "registers": r,
    "shared_bytes": b, "ctas_per_sm": c}}} for every instance of
    ``TC_KERNELS``: SASS counts from ``cuobjdump -sass`` of the library,
    the rest from the CUDA runtime (the kernels' info entries)."""
    import ctypes
    import re

    cuobjdump = os.path.join(os.path.dirname(nvcc_path), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {k: {tc_label(k, i): dict.fromkeys(TC_OPS, 0) for i in inst}
           for k, (_, _, inst) in TC_KERNELS.items()}
    cur = []   # every entry whose pattern names this function
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            cur = []
            for k, (pat, _, inst) in TC_KERNELS.items():
                m = re.search(pat, fn.group(1))
                # a kernel of one instance has an empty group
                key = m and (tuple(int(x) for x in m.groups() if x)
                             or next(iter(inst)))
                if m and key in inst:
                    cur.append(out[k][tc_label(k, key)])
            continue
        for op in TC_OPS:
            if cur and re.search(rf"\b{op}\b", line):
                for c in cur:
                    c[op] += 1
    for k, (_, entry, inst) in TC_KERNELS.items():
        info = getattr(lib, entry)
        info.restype = ctypes.c_int
        info.argtypes = ([ctypes.c_int] * len(next(iter(inst.values())))
                         + [ctypes.POINTER(ctypes.c_int)] * 3)
        for key, iargs in inst.items():
            vals = [ctypes.c_int() for _ in range(3)]
            err = info(*iargs, *map(ctypes.byref, vals))
            if err != 0:
                raise RuntimeError(f"{entry}{iargs}: cudaError {err}")
            out[k][tc_label(k, key)].update(registers=vals[0].value,
                                         shared_bytes=vals[1].value,
                                         ctas_per_sm=vals[2].value)
    return out


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


def mp_products(conv, n, widths):
    """The flops of the stack's products alone (2 per multiply-add)."""
    per = {"gcn": 1, "gin": None, "sage": 2}[conv]
    return sum(2 * n * fin * fo * per if per else
               2 * n * fin * fo + 2 * n * fo * fo for fin, fo in widths)


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
             "mp_layer kernel": 0.0, "ell_gather_bwd kernel": 0.0,
             "gat_proj_tc kernel": 0.0, "gat_attn kernel": 0.0,
             "gat_block_tc kernel": 0.0, "gat_bwd kernel": 0.0,
             "gine_layer kernel": 0.0, "edge_block kernel": 0.0,
             "ell_agg kernel": 0.0,
             "readout kernel": 0.0, "Adam": 0.0, "torch matmul": 0.0,
             "other torch kernels": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.lower()
        if "gine_layer" in name:
            part = "gine_layer kernel"
        elif "edge_proj" in name or "edge_slot" in name:
            part = "edge_block kernel"
        elif "ell_agg" in name:
            part = "ell_agg kernel"
        elif any(k in name for k in ("pna_layer", "pna_proj", "pna_agg",
                                       "pna_v_kernel")):
            part = "pna_layer kernel"
        elif "mp_layer" in name:
            part = "mp_layer kernel"
        elif "scatter_bwd" in name:
            part = "pna_scatter_bwd kernel"
        elif "ell_gather_bwd" in name:
            part = "ell_gather_bwd kernel"
        elif "gat_bwd" in name:
            part = "gat_bwd kernel"
        elif "gat_proj_tc" in name:
            part = "gat_proj_tc kernel"
        elif "gat_attn" in name:
            part = "gat_attn kernel"
        elif "gat_block_tc" in name:
            part = "gat_block_tc kernel"
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


# this slice: the per-layer mp kernel (row 4), GCN / GIN / SAGE training,
# LG and Simple
MP_LAYER_CONVS = ("gin", "sage", "gcn", "lg", "simple_sum", "simple_mean")
SAME_WIDTH = (("lg", "lg", {}),
              ("simple_sum", "simple", {"aggregation": "sum"}),
              ("simple_mean", "simple", {"aggregation": "mean"}))
MP_TRAIN_STEPS = 3


def mp_layer_operands(conv, F, gen, dev):
    """(operands, Fout) of one row-4 launch at input width F: gin and sage
    128 wide out (the canonical hidden width), the rest F."""
    def r(*shape, sc=None):
        sc = 1.0 / math.sqrt(shape[0]) if sc is None else sc
        return torch.randn(*shape, generator=gen, device=dev) * sc

    if conv == "gin":
        return dict(w0=r(F, 128), b0=r(128, sc=0.1), w1=r(128, 128),
                    b1=r(128, sc=0.1), eps=0.2), 128
    if conv == "sage":
        return dict(w0=r(F, 128), b0=r(128, sc=0.1), w1=r(F, 128)), 128
    if conv == "gcn":
        return dict(b0=r(F, sc=0.1)), F
    return {}, F


def mp_layer_work(conv, n, edges, table_words, F, H, Fout, skip, act,
                  save_s):
    """(flops, bytes) of one row-4 launch: one add per real edge and
    aggregated feature, the epilogue's products (2 per multiply-add) and
    elementwise operations; v, the table (ELL ids or block counts), the
    degrees, the weights and skip in, out (and s) out, each once."""
    flops = edges * F
    if conv == "gin":
        flops += 2 * n * F + 2 * n * (F * H + H * Fout) + 2 * n * H
        weights = F * H + H + H * Fout + Fout
    elif conv == "sage":
        flops += n * F + 4 * n * F * Fout + n * Fout
        weights = 2 * F * Fout + Fout
    else:
        flops += {"gcn": 3, "lg": 1, "simple_mean": 1,
                  "simple_sum": 0}[conv] * n * F
        weights = F if conv == "gcn" else 0
    flops += n * Fout * (int(skip) + int(act))
    nbytes = 4 * (n * F + table_words + n + weights
                  + n * Fout * (1 + int(skip)) + (n * F if save_s else 0))
    return flops, nbytes


def one_way_star_batch(graphs, dev):
    """``graphs`` and a 71-node star whose hub sends to 70 leaves,
    standard-packed: every in-degree is at most 4, so the batch has its
    ELL table, but the hub's out-degree is over 64, so no reverse
    table."""
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.data.datasets import Graph

    rng = np.random.default_rng(1)
    leaves = np.arange(1, 71)
    star = Graph(x=rng.standard_normal((71, 11)).astype(np.float32),
                 edge_index=np.stack([0 * leaves, leaves]).astype(np.int64),
                 edge_attr=np.zeros((70, 4), np.float32))
    gs = list(graphs[:7]) + [star] + list(graphs[7:])
    return build_graph_batch(gs, node_multiple=256, device=dev)


def adjacency_csr(g, transpose=False):
    """The batch's [N, N] edge counts A (A[i, j] = edges j -> i), or A^T,
    as a torch CSR on the batch's device, for the library yardstick
    ``torch.sparse.mm``; built outside any timing."""
    m = g.edge_mask
    rows, cols = g.receivers[m].long(), g.senders[m].long()
    if transpose:
        rows, cols = cols, rows
    N = g.num_nodes
    a = torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                torch.ones(len(rows), device=g.device),
                                (N, N)).coalesce()
    return a.to_sparse_csr()


def mp_times(report, *, tb, mp_modes, g_args, sc_args, mp_models,
             fwd_cells, target, fresh_step):
    """This slice's times: row 4 per conv and mode and row 7's lin-only
    and CSR modes by device time (``device_ms``) and by CUDA events, each
    with its plain version, bound and, where one PyTorch call computes
    the same function, ``torch.sparse.mm``; the three train steps and the
    five forwards by CUDA events.  Fills ``report``; returns the train
    steps' and forwards' times."""
    from gnnbuilder_tpu_torch.ops import dispatch, ell
    from gnnbuilder_tpu_torch.ops.cuda import ell_bwd, mp_layer, scatter_bwd

    dev = tb.device
    gen = torch.Generator(device=dev).manual_seed(29)
    # row 4: one launch per conv and mode at the interior layer shape
    # (128 wide, skip, relu; ELL with s saved, the train path's; block
    # without, the forward's); simple_sum bare (no skip, activation or s),
    # so that one sparse product computes the same function
    by_conv = {}
    for mode, (g_, badj) in mp_modes.items():
        n_, e_ = g_.num_nodes, int(g_.in_degree.sum())
        words = n_ * (128 if badj is not None else g_.ell_width)
        a_csr = adjacency_csr(g_)
        x_ = torch.randn(n_, 128, generator=gen, device=dev)
        for conv in MP_LAYER_CONVS:
            ops, Fout = mp_layer_operands(conv, 128, gen, dev)
            bare = conv == "simple_sum"
            sk = None if bare else torch.randn(n_, Fout, generator=gen,
                                               device=dev)
            act = None if bare else "relu"
            save_s = mode == "ell" and not bare
            kw = dict(ops, skip=sk, act=act, save_s=save_s, block_adj=badj)
            H = ops["w0"].shape[1] if conv == "gin" else 0
            fl, by = mp_layer_work(conv, n_, e_, words, 128, H, Fout,
                                   sk is not None, act is not None, save_s)
            # gin's and sage's products run on the tensor cores
            prod = {"gin": 2 * n_ * (128 * H + H * Fout),
                    "sage": 4 * n_ * 128 * Fout}.get(conv)
            b_ms, b_by = (bound(fl, by) if prod is None else
                          bound_f32_products(prod, fl - prod, by))
            ms, ev = timed(lambda: mp_layer.fused_mp_layer(
                x_, g_.nbr_nodes, g_.in_degree, conv, **kw), 20)
            pms, pev = timed(lambda: mp_layer.mp_layer_plain(
                x_, g_.nbr_nodes, g_.in_degree, conv, **kw), 5)
            lib = (timed(lambda: torch.sparse.mm(a_csr, x_), 20) if bare
                   else (None, None))
            ent = dict(ms=ms, event_ms=ev, plain_ms=pms, plain_event_ms=pev,
                       bound_ms=b_ms, bound_by=b_by, flops=fl, bytes=by,
                       library_ms=lib[0], library_event_ms=lib[1], N=n_,
                       skip=sk is not None, act=act, save_s=save_s)
            by_conv[f"{conv} {mode}"] = ent
            libs = ("" if lib[0] is None else
                    f", torch.sparse.mm {lib[0]:.4f} ({lib[1]:.4f})")
            log(f"mp_layer {conv} {mode} [N={n_}, 128 wide], device ms "
                f"(event ms): {ms:.4f} ({ev:.4f}), plain {pms:.4f} "
                f"({pev:.4f}){libs}; bound {b_ms:.4f} ms by {b_by}")
    head = by_conv["gcn ell"]
    report["mp_layer"].update(
        {k: head[k] for k in ("ms", "event_ms", "plain_ms", "plain_event_ms",
                              "bound_ms", "bound_by", "flops", "bytes",
                              "library_ms")},
        per="one gcn launch in ELL mode on the train batch, 128 wide, "
            "skip, relu, s saved (by_conv: every conv and mode)",
        by_conv=by_conv)

    # row 7, lin-only: the six gathers of one GCN train step (ds 128 wide
    # in five layers, 64 in the last) over the reverse table; the library
    # yardstick is A^T ds as one sparse product per layer
    n_, e_ = tb.num_nodes, int(tb.in_degree.sum())
    at_csr = adjacency_csr(tb, transpose=True)
    widths = [128] * 5 + [64]
    dss = [torch.randn(n_, w, generator=gen, device=dev) for w in widths]
    lin = [(d, tb.rev_nbr_nodes, tb.out_degree, None, True, False, 0)
           for d in dss]
    Wr = tb.rev_nbr_nodes.shape[1]
    fl = sum(e_ * w for w in widths)
    by = sum(4 * (2 * n_ * w + n_ * Wr + n_) for w in widths)
    b_ms, b_by = bound(fl, by)

    def each(fn, arg_list):
        for a in arg_list:
            fn(*a)

    for a in lin:   # the slot-ordered loop's bits (lin-only, F 128 and 64)
        if not torch.equal(ell_bwd.fused_gather_backward(*a),
                           ell_bwd.ell_gather_backward_ordered(*a)):
            raise AssertionError("ell_gather_bwd lin-only: not the bits of "
                                 "the slot-ordered loop")
    ms, ev = timed(lambda: each(ell_bwd.fused_gather_backward, lin), 20)
    pms, pev = timed(lambda: each(ell_bwd.ell_gather_backward_plain, lin), 5)
    lms, lev = timed(lambda: [torch.sparse.mm(at_csr, d) for d in dss], 20)
    report["ell_gather_bwd"].update(
        ms=ms, event_ms=ev, plain_ms=pms, plain_event_ms=pev, library_ms=lms,
        library_event_ms=lev, bound_ms=b_ms, bound_by=b_by, flops=fl,
        bytes=by, per="GCN train step, lin-only terms (6 launches)")

    # row 7, CSR mode: the PNA step's six gathers over the reverse CSR, the
    # whole table-less route per PNA step, and lin-only over the CSR
    ptr, idx = ell.reverse_csr(tb.nbr_nodes, tb.in_degree)
    csr = [(a[0], ptr, idx, *a[3:]) for a in g_args]
    fl = bz = 0
    for a in csr:
        F_ = a[3].shape[1]
        fl += 8 * e_ * F_
        bz += 4 * (n_ * 7 * F_ + 2 * n_ * F_ + n_ + 1 + e_)
    b_ms, b_by = bound(fl, bz)
    lin_csr = [(d, ptr, idx, None, True, False, 0) for d in dss]
    ms, ev = timed(lambda: each(ell_bwd.fused_gather_backward_csr, csr), 20)
    pms, pev = timed(lambda: each(ell_bwd.ell_gather_backward_csr_plain,
                                  csr), 5)
    lin_ms, lin_ev = timed(lambda: each(ell_bwd.fused_gather_backward_csr,
                                        lin_csr), 20)
    rc_ms, rc_ev = timed(lambda: ell.reverse_csr(tb.nbr_nodes,
                                                 tb.in_degree), 20)
    rt_ms, rt_ev = timed(lambda: each(scatter_bwd.fused_pna_scatter_backward,
                                      sc_args), 10)
    report["ell_gather_bwd_csr"].update(
        ms=ms, event_ms=ev, plain_ms=pms, plain_event_ms=pev, library_ms=None,
        bound_ms=b_ms, bound_by=b_by, flops=fl, bytes=bz,
        per="PNA train step without a reverse table (6 launches)",
        lin_only_ms=lin_ms, lin_only_event_ms=lin_ev, reverse_csr_ms=rc_ms,
        reverse_csr_event_ms=rc_ev, route_ms=rt_ms, route_event_ms=rt_ev,
        route_plain_event_ms=time_ms(lambda: each(
            scatter_bwd.pna_scatter_backward_plain, sc_args), 3))
    for k in ("ell_gather_bwd", "ell_gather_bwd_csr"):
        r = report[k]
        r["achieved_bytes_per_s"] = r["bytes"] / (r["ms"] * 1e-3)
        log(f"{k} ({r['per']}): {r['achieved_bytes_per_s'] / 1e12:.3f} TB/s "
            f"of the bound's bytes")
        log(f"{k} ({r['per']}), device ms (event ms): {r['ms']:.4f} "
            f"({r['event_ms']:.4f}), plain {r['plain_ms']:.4f} "
            f"({r['plain_event_ms']:.4f})"
            + ("" if r["library_ms"] is None else
               f", torch.sparse.mm {r['library_ms']:.4f} "
               f"({r['library_event_ms']:.4f})")
            + f"; bound {r['bound_ms']:.4f} ms by {r['bound_by']}")
    r = report["ell_gather_bwd_csr"]
    log(f"table-less PNA dv route per step, device ms (event ms): "
        f"{r['route_ms']:.4f} ({r['route_event_ms']:.4f}), plain "
        f"({r['route_plain_event_ms']:.4f}); reverse_csr "
        f"{r['reverse_csr_ms']:.4f} ({r['reverse_csr_event_ms']:.4f}); CSR "
        f"lin-only gathers {r['lin_only_ms']:.4f} "
        f"({r['lin_only_event_ms']:.4f}) per GCN step")

    # the three train steps and the five forwards
    torch.set_grad_enabled(True)
    steps = {}
    for conv, (m_, _, st_) in mp_models.items():
        m_.load_state_dict(st_)
        step_ = fresh_step(m_)
        ms = time_ms(lambda: step_(tb, target), 10, warmup=3)
        dispatch.set_fused_mode("never")
        try:
            plain = time_ms(lambda: step_(tb, target), 3, warmup=1)
        finally:
            dispatch.set_fused_mode("auto")
        steps[conv] = dict(step_ms=ms, plain_step_ms=plain)
        log(f"{conv} train step b{BATCH_GRAPHS}: {ms:.4f} ms (plain path "
            f"{plain:.4f} ms)")
    torch.set_grad_enabled(False)
    forwards = {}
    for name, (p_, bs_) in fwd_cells.items():
        if name in mp_models:
            m_, _, st_ = mp_models[name]
            m_.load_state_dict(st_)
        fb = p_.benchmark(bs_[0], iters=20, warmup=3)
        forwards[name] = dict(ms=fb["latency_s"] * 1e3,
                              graphs_per_s=fb["graphs_per_s"],
                              N=bs_[0].num_nodes)
        log(f"{name} forward b{BATCH_GRAPHS} (N={bs_[0].num_nodes}): "
            f"{forwards[name]['ms']:.4f} ms, {fb['graphs_per_s']:.1f} "
            f"graphs/s")
    return dict(train=steps, forward=forwards)



GAT_HEADS = 4            # the JAX package's GAT A/B and hardware checks
GAT_TRAIN_STEPS = 3


def gat_layer_args(model, g, block):
    """Each GAT layer's operands on batch ``g`` as the model's kernel gets
    them, the hidden state advanced through the plain version (so each
    kernel launch is held against its plain version on the same input):
    ((x, table or block_adj, w, att_src, att_dst, bias, heads), kw); with
    edge features kw also holds the layer's edge terms."""
    from gnnbuilder_tpu_torch.ops.cuda import gat_block, gat_layer

    from gnnbuilder_tpu_torch.ops import ell

    L = model.gnn_num_layers
    h = g.node_feat
    layers = []
    for i, c in enumerate(model.gnn_convs):
        skip = h if model.gnn_skip_connection and 0 < i < L - 1 else None
        ops = [t.detach().contiguous() for t in (
            h, c.lin.weight.t(), c.att_src, c.att_dst, c.bias)]
        table = (g.block_adj,) if block else (g.nbr_nodes, g.in_degree)
        args = (ops[0], *table, *ops[1:], c.heads)
        kw = dict(neg_slope=c.negative_slope, self_loops=c.add_self_loops,
                  skip=skip, act=model.gnn_activation)
        if c.edge_dim is not None:
            # the edge terms as GATConv forms them for each kernel
            a_edge, a_self = c._edge_logits(g)
            if block:
                kw.update(edge_table=gat_block.build_block_edge_logits(
                    g.senders, g.receivers, g.edge_mask, a_edge,
                    g.num_nodes, g.block_size_static), self_extra=a_self)
            else:
                kw.update(edge_logits=ell.ell_gather_valid(
                    a_edge, g.nbr_edges, g.in_degree), self_edge_logit=a_self)
        if block:
            kw["concat"] = c.concat
            h = gat_block.gat_block_layer_plain(*args, **kw)
        else:
            h = gat_layer.gat_layer_plain(*args, **kw)
        layers.append((args, kw))
    return layers


def gat_staged(layers, key):
    """``layers`` (of row 9 or 10, in any mode) with the kernel's staged
    weights made once and passed as ``staged``, as the model's inference
    cache passes them: timed launches then time the kernels alone."""
    from gnnbuilder_tpu_torch.ops.cuda import gat_layer

    out = []
    for args, kw in layers:
        mode = kw.get("mode", "f32")
        if key == "gat_block":
            st = gat_layer.stage_projection(args[-5], args[-1], mode,
                                            kw.get("wa_src"), kw.get("wa_dst"))
        else:
            st = gat_layer.stage_projection(args[-5], args[-1], mode)
        out.append((args, dict(kw, staged=st)))
    return out


def gat_work(layers, g, block):
    """(flops, bytes) of one forward's six row-9 or row-10 launches at the
    model's widths: the projection (2 Fin HC per row), the attention
    terms (4 HC per row), per edge (distinct block pairs for row 9, ELL
    slots for row 10) and per self slot 2 HC for the weighted sum and ~8
    per head for the logit, max, exp and sum; x, the table (ELL ids or
    one 128-float adjacency row per node), the degrees, the weights,
    skip in and out out, each once."""
    n = g.num_nodes
    e = (int((g.block_adj > 0).sum()) if block
         else int(g.in_degree.sum()))
    flops = nbytes = 0
    for args, kw in layers:
        fin, hc, heads = args[0].shape[1], args[-5].shape[1], args[-1]
        out_w = args[-2].shape[0]
        flops += (2 * n * fin * hc + 4 * n * hc
                  + (e + n) * (2 * hc + 8 * heads))
        table = n * 128 if block else n * g.ell_width + n
        nbytes += 4 * (n * fin + table + fin * hc + 2 * hc + out_w
                       + n * out_w * (2 if kw["skip"] is not None else 1))
    return flops, nbytes


def gat_products(layers, g):
    """The projection's products of one forward's six launches of row 9
    or 10 (2 Fin HC flops a row), the part of ``gat_work`` that runs on
    the tensor cores."""
    return sum(2 * g.num_nodes * args[0].shape[1] * args[-5].shape[1]
               for args, _ in layers)


def gat_bwd_work(bwd_args, g):
    """(flops, bytes) of one train step's six row-11 launches: per edge
    and head the dot dalpha (2 C), the value term (2 C) and ~20 for the
    logit, exp, alpha and dpre; per self slot the dot; dz, h, a_src,
    a_dst, both tables and the degrees in, dh_val and the five [N, H]
    outputs out, each once."""
    n, e = g.num_nodes, int(g.in_degree.sum())
    wr = g.rev_nbr_nodes.shape[1]
    flops = nbytes = 0
    for a in bwd_args:
        hc, heads = a[0].shape[1], a[6]
        flops += e * (4 * hc + 20 * heads) + n * 2 * hc
        nbytes += 4 * (3 * n * hc + 7 * n * heads + n * (g.ell_width + wr)
                       + 2 * n)
    return flops, nbytes


def gat_bwd_resources(g):
    """Registers, shared memory and CTAs an SM of each row-11 instance at
    the batch's table widths and 4 heads (``gnnb_gat_bwd_info``), logged;
    {name: {...}}."""
    from gnnbuilder_tpu_torch.ops.cuda import _build

    info = _build.load().gnnb_gat_bwd_info
    info.restype = ctypes.c_int
    out = {}
    W, H = g.ell_width, GAT_HEADS
    for cph, cname in ((32, "C = 128"), (16, "C = 64"), (0, "general")):
        for kind, kname in ((0, "receiver (table)"), (3, "receiver (CSR)"),
                            (1, "sender (table)"), (2, "sender (CSR)")):
            if cph == 0 and kind == 3:
                continue   # the general receiver serves both modes
            regs, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            err = info(kind, cph, W, H, ctypes.byref(regs),
                       ctypes.byref(smem), ctypes.byref(ctas))
            if err:
                raise RuntimeError(f"gnnb_gat_bwd_info: cudaError {err}")
            out[f"{cname} {kname}"] = dict(
                registers=regs.value, shared_bytes=smem.value,
                ctas_per_sm=ctas.value)
    log("gat_bwd instances (registers, shared bytes, CTAs an SM): "
        + "; ".join(f"{k} {v['registers']}, {v['shared_bytes']}, "
                    f"{v['ctas_per_sm']}" for k, v in out.items()))
    return out


def ell_agg_resources():
    """Registers and CTAs an SM of each row-8 instance
    (``gnnb_ell_agg_info``), logged; {name: {...}}."""
    from gnnbuilder_tpu_torch.ops.cuda import _build

    info = _build.load().gnnb_ell_agg_info
    info.restype = ctypes.c_int
    out = {}
    for set_, sname in enumerate(("run-time codes", "max", "min", "mean",
                                  "sum", "min max", "PNA five")):
        for bf16 in (0, 1):
            for vec in (1, 0):
                regs, ctas = ctypes.c_int(), ctypes.c_int()
                err = info(set_, bf16, vec, ctypes.byref(regs),
                           ctypes.byref(ctas))
                if err:
                    raise RuntimeError(f"gnnb_ell_agg_info: cudaError {err}")
                out[f"{sname} {'bf16' if bf16 else 'f32'} "
                    f"{'float4' if vec else 'scalar'}"] = dict(
                        registers=regs.value, ctas_per_sm=ctas.value)
    log("ell_agg instances (registers, CTAs an SM): "
        + "; ".join(f"{k} {v['registers']}, {v['ctas_per_sm']}"
                    for k, v in out.items()))
    return out


def gat_phases(report, *, dev, graphs, batches, b0, tgraphs, tb, target,
               zero_counts, counts, only, fresh_step, smi):
    """GAT (heads 4, concat): rows 9, 10 and 11 against their plain
    versions at the canonical model's shapes, the three GAT paths
    (block-packed inference, standard-packed inference, training) with
    their launch counts and outputs or gradients against the plain path,
    bitwise-equal gradients on two steps with and without the reverse
    table, and the times.  Fills ``report``; returns the summary for the
    last JSON line."""
    from gnnbuilder_tpu_torch import Program, train
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.bench.grad_precision import (
        conv_output_masks,
        grads_on_relu_pattern,
    )
    from gnnbuilder_tpu_torch.ops import dispatch, ell
    from gnnbuilder_tpu_torch.ops.cuda import gat_block, gat_bwd, gat_layer

    kw_gat = dict(conv_kwargs=dict(heads=GAT_HEADS))
    out = {}
    torch.set_grad_enabled(False)
    with phase(f"GAT (heads {GAT_HEADS}): models, and rows 9 and 10 against "
               f"their plain versions in each of the 6 layers"):
        model = canonical_model("gat", "qm9", graphs=graphs, **kw_gat)
        prog = Program(model, max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                       max_graphs=b0.num_graphs, block_size=128,
                       device=dev, seed=31)
        prog.init_params()
        log("GAT layer widths (in -> heads x channels): " + ", ".join(
            f"{c.lin.in_features}->{c.heads}x{c.out_channels}"
            for c in model.gnn_convs)
            + f"; pooled width {model.mlp_head.linear_layers[0].in_features}")
        blk_layers = gat_layer_args(model, b0, block=True)
        std_layers = gat_layer_args(model, tb, block=False)
        for name, layers, fn, plain, g_ in (
                ("gat_block", blk_layers, gat_block.fused_gat_block_layer,
                 gat_block.gat_block_layer_plain, b0),
                ("gat_layer", std_layers, gat_layer.fused_gat_layer,
                 gat_layer.gat_layer_plain, tb)):
            err = 0.0
            real = g_.node_mask
            for i, (args, kw) in enumerate(layers):
                got = fn(*args, **kw)
                torch.cuda.synchronize()
                ok, abs_err, rel_err = close_enough(
                    got[real], plain(*args, **kw)[real])
                err = max(err, abs_err)
                if not ok:
                    raise AssertionError(
                        f"{name} layer {i}: {rel_err:.3e} of max |value| "
                        f"against its plain version (tol {TOL})")
            report[name] = dict(max_abs_err=err)
            log(f"{name} [N={g_.num_nodes}]: all 6 layers within tol ({TOL}"
                f"; node_mask rows), max abs {err:.3e}")

    with phase(f"main path: Program.forward of canonical GAT on "
               f"{N_BATCHES} x {BATCH_GRAPHS}-graph block batches"):
        zero_counts()
        outs = [prog.forward(b) for b in batches]
        torch.cuda.synchronize()
        launches = counts()
        log(f"launches: {launches}")
        if launches != only(gat_block=6 * N_BATCHES, readout=N_BATCHES):
            raise AssertionError("GAT block forward: every layer did not "
                                 "take row 9")
        report["gat_block"]["launches"] = launches["gat_block"]
        dispatch.set_fused_mode("never")
        try:
            refs = [prog.forward(b) for b in batches]
        finally:
            dispatch.set_fused_mode("auto")
        for i, (b, o_, r_) in enumerate(zip(batches, outs, refs)):
            m = b.graph_mask
            ok, abs_err, rel_err = close_enough(o_[m], r_[m])
            log(f"batch {i}: kernels vs per-layer plain on the card: max abs "
                f"{abs_err:.3e}, {rel_err:.3e} of max |value| (tol {TOL})")
            if not ok or tuple(o_.shape) != (b.num_graphs, 1):
                raise AssertionError(f"GAT batch {i} disagrees")
        _, (small,) = canonical_batches(
            "qm9", n_graphs=64, batch_size=64, block_size=128,
            node_multiple=128, device="cpu")
        cpu_p = Program(canonical_model("gat", "qm9", **kw_gat),
                        max_nodes=small.num_nodes, max_edges=small.num_edges,
                        max_graphs=small.num_graphs, block_size=128,
                        device="cpu")
        cpu_p.set_params({k: v.cpu() for k, v in prog.params.items()})
        dispatch.set_fused_mode("never")
        try:
            ref = cpu_p.forward(small)
        finally:
            dispatch.set_fused_mode("auto")
        o_ = prog.forward(small.to(dev)).cpu()
        m = small.graph_mask
        ok, abs_err, rel_err = close_enough(o_[m], ref[m])
        log(f"64-graph batch: card kernels vs CPU plain path: max abs "
            f"{abs_err:.3e}, {rel_err:.3e} of max |value| (tol {TOL})")
        if not ok:
            raise AssertionError("GAT: card disagrees with the CPU")

    with phase("standard-packed GAT inference: Program.forward on the train "
               "batch"):
        tprog = Program(model, max_nodes=tb.num_nodes, max_edges=tb.num_edges,
                        max_graphs=tb.num_graphs, device=dev)
        tprog.set_params(prog.params)
        zero_counts()
        o_std = tprog.forward(tb)
        torch.cuda.synchronize()
        launches = counts()
        log(f"launches: {launches}")
        if launches != only(gat_layer=6, readout=1):
            raise AssertionError("GAT standard forward: every layer did not "
                                 "take row 10")
        dispatch.set_fused_mode("never")
        try:
            r_std = tprog.forward(tb)
        finally:
            dispatch.set_fused_mode("auto")
        m = tb.graph_mask
        ok, abs_err, rel_err = close_enough(o_std[m], r_std[m])
        log(f"kernels vs per-layer plain: max abs {abs_err:.3e}, "
            f"{rel_err:.3e} of max |value| (tol {TOL})")
        if not ok:
            raise AssertionError("GAT standard-packed forward disagrees")

    with phase("row 11 against its plain version in each of the 6 layers, "
               "over the reverse table and the reverse CSR"):
        gen = torch.Generator(device=dev).manual_seed(37)
        bwd_args, err = [], 0.0
        for i, (args, kw) in enumerate(std_layers):
            x, _, _, w, att_s, att_d, _, heads = args
            hh = x @ w
            hv = hh.view(x.shape[0], heads, -1)
            a_s = (hv * att_s).sum(-1).contiguous()
            a_d = (hv * att_d).sum(-1).contiguous()
            dz = torch.randn(hh.shape, generator=gen, device=dev)
            a = (dz, hh.contiguous(), a_s, a_d, tb.nbr_nodes, tb.in_degree,
                 heads)
            want = gat_bwd.gat_scatter_backward_plain(*a)
            for label, rkw in (("reverse table", dict(
                    rev_nbr_nodes=tb.rev_nbr_nodes,
                    out_degree=tb.out_degree)),
                               ("reverse CSR", dict(rev_csr=tb.rev_csr))):
                one = gat_bwd.fused_gat_scatter_backward(*a, **rkw)
                two = gat_bwd.fused_gat_scatter_backward(*a, **rkw)
                torch.cuda.synchronize()
                for name, g1, g2, w_ in zip(
                        ("dh_val", "da_src", "dsum", "s", "m", "den"),
                        one, two, want):
                    ok, abs_err, rel_err = close_enough(g1, w_)
                    err = max(err, abs_err)
                    if not ok:
                        raise AssertionError(
                            f"gat_bwd layer {i} ({label}) {name}: "
                            f"{rel_err:.3e} of max |value| against its "
                            f"plain version (tol {TOL})")
                    if not torch.equal(g1, g2):
                        raise AssertionError(f"gat_bwd layer {i} ({label}) "
                                             f"{name}: two launches differ")
            bwd_args.append(a + (tb.rev_nbr_nodes, tb.out_degree))
        report["gat_bwd"] = dict(max_abs_err=err,
                                 instances=gat_bwd_resources(tb))
        log(f"gat_bwd: six outputs of all 6 layers within tol ({TOL}) in "
            f"both modes, max abs {err:.3e}; bitwise equal on two launches")

    torch.set_grad_enabled(True)
    with phase("GAT training: gradients of one step against the plain path, "
               "and two steps from one state with and without the reverse "
               "table"):
        tm = canonical_model("gat", "qm9", graphs=tgraphs, **kw_gat)
        tp = Program(tm, max_nodes=tb.num_nodes, max_edges=tb.num_edges,
                     max_graphs=tb.num_graphs, device=dev, seed=41)
        st = {k: v.clone() for k, v in tp.init_params().items()}
        tb_nr = tb.replace(rev_nbr_nodes=None, out_degree=None)
        per_route = {}
        for label, g_ in (("reverse table", tb), ("reverse CSR", tb_nr)):
            again = []
            for _ in range(2):
                tm.load_state_dict(st)
                step = fresh_step(tm)
                zero_counts()
                step(g_, target)
                torch.cuda.synchronize()
                launches = counts()
                if launches != only(gat_layer=6, gat_bwd=6, readout=1):
                    raise AssertionError(f"GAT step ({label}) launches "
                                         f"{launches}")
                again.append(grads_of(tm))
            same = [k for k in again[0]
                    if torch.equal(again[0][k], again[1][k])]
            log(f"{label}: launches {launches}; bitwise-equal gradients "
                f"{len(same)} of {len(again[0])}")
            if len(same) != len(again[0]):
                raise AssertionError(f"GAT ({label}): two train steps from "
                                     f"one state gave different gradients")
            per_route[label] = again[0]
        ok, _, rel, k = worst_grad(per_route["reverse CSR"],
                                   per_route["reverse table"])
        log(f"reverse CSR vs reverse table gradients: worst {rel:.3e} of "
            f"max |value| ({k})")
        kern = per_route["reverse table"]
        tm.load_state_dict(st)
        masks = conv_output_masks(tm, tb)
        flips = [int(((a > 0) != b)[tb.node_mask].sum()) for a, b in
                 zip(masks, conv_output_masks(tm, tb, "never"))]
        log(f"layer outputs whose ReLU goes the other way in the kernel "
            f"forward than in the float32 plain forward, per layer: {flips}")
        refs = {}
        for name, dt in (("float64", torch.float64),
                         ("float32", torch.float32)):
            mr = canonical_model("gat", "qm9", graphs=tgraphs,
                                 **kw_gat).to(dev).to(dt)
            mr.load_state_dict({k_: v.to(dt) for k_, v in st.items()})
            gb = tb.replace(node_feat=tb.node_feat.to(dt))
            refs[name] = grads_on_relu_pattern(mr, gb, target.to(dt), masks)
            dispatch.set_fused_mode("never")
            try:
                mr.zero_grad()
                train.masked_mse_loss(mr(gb), target.to(dt),
                                      tb.graph_mask).backward()
            finally:
                dispatch.set_fused_mode("auto")
            refs[name + " own"] = grads_of(mr)
            del mr
        # the gate: the float64 plain path on the kernel path's ReLU
        # decisions (a layer output within float32 rounding of 0 can take
        # its ReLU another way in the kernel forward than in a plain one,
        # which moves a gradient ~1e-3 of its max); the rest are logged
        grads_rep = {}
        for name in ("float64", "float32", "float64 own", "float32 own"):
            gate = name == "float64"
            ok, abs_err, rel, k = worst_grad(kern, refs[name])
            grads_rep[name] = rel
            which = ("its own ReLU decisions" if "own" in name
                     else "the kernel path's ReLU decisions")
            log(f"gradients vs the {name.split()[0]} plain path on {which}: "
                f"worst {rel:.3e} of max |value| ({k}), max abs "
                f"{abs_err:.3e}" + (f" (tol {TOL})" if gate else " (logged)"))
            if gate and not ok:
                raise AssertionError("GAT gradients disagree with the "
                                     "float64 plain path on the kernel "
                                     "path's ReLU decisions")
        out["gradients_worst_rel"] = grads_rep
        out["relu_flips_kernel_vs_plain"] = flips

    with phase(f"main path: {GAT_TRAIN_STEPS} Adam steps of canonical GAT on "
               f"the train batch"):
        curves = {}
        for mode in ("auto", "never"):
            tm.load_state_dict(st)
            step = fresh_step(tm)
            dispatch.set_fused_mode(mode)
            try:
                if mode == "auto":
                    zero_counts()
                curves[mode] = [float(step(tb, target))
                                for _ in range(GAT_TRAIN_STEPS)]
                torch.cuda.synchronize()
                if mode == "auto":
                    launches = counts()
            finally:
                dispatch.set_fused_mode("auto")
        log(f"launches {launches}; losses {curves['auto']}, plain "
            f"{curves['never']}")
        want = only(gat_layer=6 * GAT_TRAIN_STEPS,
                    gat_bwd=6 * GAT_TRAIN_STEPS, readout=GAT_TRAIN_STEPS)
        if launches != want:
            raise AssertionError(f"GAT train launches {launches}, expected "
                                 f"{want}")
        for i, (a, b) in enumerate(zip(curves["auto"], curves["never"])):
            if not (math.isfinite(a) and abs(a - b) <= CURVE_TOL * abs(b)):
                raise AssertionError(f"GAT step {i}: loss {a} against plain "
                                     f"{b}")
        report["gat_layer"]["launches"] = launches["gat_layer"]
        report["gat_bwd"]["launches"] = launches["gat_bwd"]
        out["loss_curve"], out["plain_loss_curve"] = (curves["auto"],
                                                      curves["never"])

    with phase("GAT times (CUDA events; torch.profiler device times)"):
        def run_layers(fn, layers):
            for args, kw in layers:
                fn(*args, **kw)

        def run_bwd(fn, rev):
            # a step on a new batch without a reverse table builds its
            # reverse CSR once (GraphBatch.rev_csr)
            kw = (dict(rev_nbr_nodes=tb.rev_nbr_nodes,
                       out_degree=tb.out_degree) if rev else
                  dict(rev_csr=ell.reverse_csr(tb.nbr_nodes, tb.in_degree,
                                               positions=True)))
            for a in bwd_args:
                fn(*a[:7], **kw)

        def run_bwd_plain():
            for a in bwd_args:
                gat_bwd.gat_scatter_backward_plain(*a[:7])

        torch.set_grad_enabled(False)
        blk_staged = gat_staged(blk_layers, "gat_block")
        std_staged = gat_staged(std_layers, "gat_layer")
        for name, fn, plain, work, per in (
                ("gat_block",
                 lambda: run_layers(gat_block.fused_gat_block_layer,
                                    blk_staged),
                 lambda: run_layers(gat_block.gat_block_layer_plain,
                                    blk_layers),
                 gat_work(blk_layers, b0, True),
                 f"one block-packed b{BATCH_GRAPHS} forward (6 launches)"),
                ("gat_layer",
                 lambda: run_layers(gat_layer.fused_gat_layer, std_staged),
                 lambda: run_layers(gat_layer.gat_layer_plain, std_layers),
                 gat_work(std_layers, tb, False),
                 f"one standard-packed b{BATCH_GRAPHS} forward (6 "
                 f"launches)"),
                ("gat_bwd", lambda: run_bwd(
                    gat_bwd.fused_gat_scatter_backward, True),
                 run_bwd_plain, gat_bwd_work(bwd_args, tb),
                 f"one b{BATCH_GRAPHS} train step (6 launches, reverse "
                 f"table)")):
            if name == "gat_bwd":
                b_ms, b_by = bound(*work)
            else:   # f32-accurate products at min(67 T, 3 x 495 T)
                prod = gat_products(blk_layers if name == "gat_block"
                                    else std_layers,
                                    b0 if name == "gat_block" else tb)
                b_ms, b_by = bound_f32_products(prod, work[0] - prod,
                                                work[1])
            ms, ev = timed(fn, 10)
            pms, pev = timed(plain, 3)
            report[name].update(
                ms=ms, event_ms=ev, plain_ms=pms, plain_event_ms=pev,
                bound_ms=b_ms, bound_by=b_by, flops=work[0], bytes=work[1],
                library_ms=None, per=per)
            log(f"{name} per {per}: device {ms:.4f} ms (events {ev:.4f}), "
                f"plain {pms:.4f} ({pev:.4f}); bound {b_ms:.4f} ms by {b_by}"
                f" ({b_ms / ms:.1%} of it)")
        # row 10's two launches apart, and what a train step pays to lay
        # out its six layers' live weights on each call
        parts = kernel_split(lambda: run_layers(gat_layer.fused_gat_layer,
                                                std_staged), 10)
        proj = sum(v for k, v in parts.items() if "gat_proj" in k)
        attn = sum(v for k, v in parts.items() if "gat_attn" in k)
        report["gat_layer"].update(projection_ms=proj, attention_ms=attn)
        stage_ms = time_ms(lambda: [gat_layer.stage_projection(
            a[-5], a[-1], "f32") for a, _ in std_layers], 10)
        out["staging_ms_per_step"] = stage_ms
        log(f"gat_layer per standard forward: projection {proj:.4f} ms, "
            f"attention {attn:.4f} ms (device); laying out the six layers' "
            f"f32 weights {stage_ms:.4f} ms (events) on {smi}")
        ms, ev = timed(lambda: run_bwd(gat_bwd.fused_gat_scatter_backward,
                                       False), 10)
        rate = report["gat_bwd"]["bytes"] / report["gat_bwd"]["ms"] / 1e9
        report["gat_bwd"].update(csr_ms=ms, csr_event_ms=ev,
                                 tb_per_s_of_bound_bytes=rate)
        log(f"gat_bwd over the reverse CSR (reverse_csr included, once a "
            f"step): device {ms:.4f} ms (events {ev:.4f}) per step; the "
            f"table mode moves the bound's bytes at {rate:.2f} TB/s")
        fb = prog.benchmark(b0, iters=20, warmup=3)
        out["forward_block"] = dict(ms=fb["latency_s"] * 1e3,
                                    graphs_per_s=fb["graphs_per_s"])
        std_ms = time_ms(lambda: tprog.forward(tb), 20, warmup=3)
        out["forward_standard"] = dict(
            ms=std_ms, graphs_per_s=int(tb.graph_mask.sum()) / std_ms * 1e3)
        log(f"GAT forward b{BATCH_GRAPHS}: block-packed "
            f"{out['forward_block']['ms']:.4f} ms "
            f"({fb['graphs_per_s']:.1f} graphs/s), standard-packed "
            f"{std_ms:.4f} ms on {smi}")
        torch.set_grad_enabled(True)
        tm.load_state_dict(st)
        step = fresh_step(tm)
        step_ms = time_ms(lambda: step(tb, target), 10, warmup=3)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            for _ in range(3):
                step(tb, target)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t) * 1e3 / 3
        split = split_device_time(prof, 3)
        busy = sum(split.values())
        log(f"GAT train step b{BATCH_GRAPHS}: {step_ms:.4f} ms (events); "
            f"device ms per step by part: "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items() if v)
            + f"; busy {busy:.4f} of {wall_ms:.4f} ms wall")
        out.update(step_ms=step_ms, device_ms_per_step=split,
                   profiled_wall_ms=wall_ms)
    torch.set_grad_enabled(False)
    return out


# this slice: GINE (row 12), EdgeConv (row 13) and the multi-aggregate
# (row 8) under Simple max / min and five-aggregator PNA
PNA_ALL5 = ("sum", "mean", "min", "max", "std")
GINE_TRAIN_STEPS = 3


def plain_layer_inputs(model, g):
    """(conv, h, skip) of each conv layer on batch ``g``, h advanced
    through the per-layer plain path, so each kernel launch below is held
    against its plain version on the same input."""
    from gnnbuilder_tpu_torch.ops import dispatch

    L = model.gnn_num_layers
    h = g.node_feat
    out = []
    dispatch.set_fused_mode("never")
    try:
        for i, c in enumerate(model.gnn_convs):
            skip = h if model.gnn_skip_connection and 0 < i < L - 1 else None
            out.append((c, h, skip))
            h = c(g, h, model.gnn_activation, skip)
    finally:
        dispatch.set_fused_mode("auto")
    return out


def gine_args(model, g):
    """Row 12's ((x, pe, nbr_nodes, nbr_edges, in_degree), kw) per layer as
    the model launches it: with its weights' Ring layout (``staged``,
    ``gine_layer.layer_operands`` of all layers at once)."""
    from gnnbuilder_tpu_torch.ops.cuda.gine_layer import layer_operands

    t = lambda w: w.t().contiguous()
    staged = [o[4] for o in layer_operands(
        [(c.lin0.weight.t(), c.lin1.weight.t()) for c in model.gnn_convs])]
    return [((h, c.lin_edge(g.edge_feat).contiguous(), g.nbr_nodes,
              g.nbr_edges, g.in_degree),
             dict(w0=t(c.lin0.weight), b0=c.lin0.bias, w1=t(c.lin1.weight),
                  b1=c.lin1.bias, eps=c.eps, skip=sk,
                  act=model.gnn_activation, staged=st))
            for (c, h, sk), st in zip(plain_layer_inputs(model, g), staged)]


def caller_weights(fn):
    """``fn`` (row 12's wrapper) on the caller's weights: no layout."""
    return lambda *args, **kw: fn(*args, **dict(kw, staged=None))


def edge_args(model, g):
    """Row 13's ((x, nbr_nodes, in_degree), kw) per layer."""
    t = lambda w: w.t().contiguous()
    return [((h, g.nbr_nodes, g.in_degree),
             dict(w_pair=t(c.lin0.weight), b0=c.lin0.bias,
                  w1=t(c.lin1.weight), b1=c.lin1.bias,
                  aggregation=c.aggregation, skip=sk,
                  act=model.gnn_activation))
            for c, h, sk in plain_layer_inputs(model, g)]


def agg_args(model, g, block=False):
    """Row 8's ((v, nbr_nodes, in_degree, aggregators), kw) per layer as
    the model's convs launch it: Simple's max or min of h; PNA's
    aggregators of u + v on a standard batch, its max and min of v
    alone on a block batch."""
    out = []
    for c, h, _ in plain_layer_inputs(model, g):
        if not hasattr(c, "pre_nn"):
            out.append(((h, g.nbr_nodes, g.in_degree, (c.aggregation,)), {}))
            continue
        u, v = c.pre_nn(h, h)
        if block:
            cmp = tuple(a for a in c.aggregators if a in ("max", "min"))
            out.append(((v.contiguous(), g.nbr_nodes, g.in_degree, cmp), {}))
        else:
            out.append(((v.contiguous(), g.nbr_nodes, g.in_degree,
                         c.aggregators), dict(u=u.contiguous())))
    return out


def hold_layers(name, fn, plain, layers, g):
    """Each layer's launch of ``fn`` against ``plain`` on node_mask rows
    (KERNEL_TOL); returns the largest absolute error."""
    err = 0.0
    real = g.node_mask
    for i, (args, kw) in enumerate(layers):
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        ok, abs_err, rel_err = close_enough(
            got[real], plain(*args, **kw)[real], KERNEL_TOL)
        err = max(err, abs_err)
        if not ok:
            raise AssertionError(
                f"{name} layer {i}: {rel_err:.3e} of max |value| against "
                f"its plain version (tol {KERNEL_TOL})")
    log(f"{name} [N={g.num_nodes}]: all {len(layers)} layers within tol "
        f"({KERNEL_TOL}; node_mask rows), max abs {err:.3e}")
    return err


def gine_work(layers, g):
    """(flops, bytes) of one forward's row-12 launches at the model's
    widths: per real edge and feature an add, a max and an add; the two
    products; x, pe, both tables, the degrees, the weights and skip in,
    out out, each once."""
    n, e, w = g.num_nodes, int(g.in_degree.sum()), g.ell_width
    flops = nbytes = 0
    for args, kw in layers:
        f, pe_rows = args[0].shape[1], args[1].shape[0]
        hdim, fo = kw["w0"].shape[1], kw["w1"].shape[1]
        flops += 3 * e * f + 2 * n * (f * hdim + hdim * fo)
        nbytes += 4 * (n * f + pe_rows * f + 2 * n * w + n + f * hdim + hdim
                       + hdim * fo + fo + n * fo
                       * (2 if kw["skip"] is not None else 1))
    return flops, nbytes


def edge_work(layers, g):
    """(flops, bytes) of one forward's row-13 launches (max): lin0's two
    products per row; per real edge the add and relu of t and lin1 (2 F
    Fout); x, the table, the degrees, the weights and skip in, out out."""
    n, e, w = g.num_nodes, int(g.in_degree.sum()), g.ell_width
    flops = nbytes = 0
    for args, kw in layers:
        fin = args[0].shape[1]
        f, fo = kw["w_pair"].shape[1], kw["w1"].shape[1]
        flops += 4 * n * fin * f + e * (2 * f + 2 * f * fo)
        nbytes += 4 * (n * fin + n * w + n + 2 * fin * f + f + f * fo + fo
                       + n * fo * (2 if kw["skip"] is not None else 1))
    return flops, nbytes


def gine_products(layers, g):
    """The products of ``gine_work``: both MLP products per row."""
    n = g.num_nodes
    return sum(2 * n * (args[0].shape[1] * kw["w0"].shape[1]
                        + kw["w0"].shape[1] * kw["w1"].shape[1])
               for args, kw in layers)


def edge_products(layers, g):
    """The products of ``edge_work``: lin0's two per row and lin1 per real
    edge (the valid slots only)."""
    n, e = g.num_nodes, int(g.in_degree.sum())
    return sum(4 * n * args[0].shape[1] * kw["w_pair"].shape[1]
               + 2 * e * kw["w_pair"].shape[1] * kw["w1"].shape[1]
               for args, kw in layers)


def agg_work(layers, g):
    """(flops, bytes) of row-8 launches: per real edge and feature the
    shift add (with u), one add for sum / mean / std, two more for std's
    square, one compare each for max and min, and ~4 per output element;
    v (and u), the table and the degrees in, the output out, each once."""
    n, e, w = g.num_nodes, int(g.in_degree.sum()), g.ell_width
    flops = nbytes = 0
    for args, kw in layers:
        f, aggs = args[0].shape[1], args[3]
        has_u = kw.get("u") is not None
        lin = any(a in aggs for a in ("sum", "mean", "std"))
        ops = (int(has_u) + int(lin) + (2 if "std" in aggs else 0)
               + int("max" in aggs) + int("min" in aggs))
        flops += e * f * ops + 4 * n * len(aggs) * f
        nbytes += 4 * (n * f * (2 if has_u else 1) + n * w + n
                       + n * len(aggs) * f)
    return flops, nbytes


def edge_agg_phases(report, *, dev, graphs, batches, b0, tgraphs, tb,
                    target, zero_counts, counts, only, fresh_step, smi):
    """GINE (row 12), EdgeConv (row 13) and the multi-aggregate (row 8)
    under Simple max / min and five-aggregator PNA: each kernel against
    its plain version in every layer, row 8's backward on both u-free
    routes, the paths' forwards with their launch counts against the
    per-layer plain path, GINE's train step (gradients, bitwise on two
    steps with and without the reverse table, a loss curve) and the
    times.  Fills ``report``; returns the summary for the last JSON
    line."""
    from gnnbuilder_tpu_torch import Program, train
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.bench.grad_precision import (
        conv_output_masks,
        grads_on_relu_pattern,
    )
    from gnnbuilder_tpu_torch.ops import dispatch
    from gnnbuilder_tpu_torch.ops.cuda import edge_block, ell_agg, gine_layer

    out = {}
    torch.set_grad_enabled(False)

    def program(conv, g, seed, block, **kw):
        m = canonical_model(conv, "qm9", graphs=graphs, **kw)
        p = Program(m, max_nodes=g.num_nodes, max_edges=g.num_edges,
                    max_graphs=g.num_graphs, block_size=128 if block else 0,
                    device=dev, seed=seed)
        p.init_params()
        return m, p

    with phase("GINE, EdgeConv, Simple max / min and five-aggregator PNA: "
               "models, and rows 12, 13 and 8 against their plain versions "
               "in each of the 6 layers"):
        _, (tb128,) = canonical_batches(
            "qm9", n_graphs=TRAIN_GRAPHS, batch_size=BATCH_GRAPHS,
            node_multiple=256, node_dim=128, device=dev)
        gine_m, gine_p = program("gine", b0, 51, True)
        edge_m, edge_p = program("edge", b0, 53, True)
        smax_m, smax_p = program("simple", tb128, 0, False,
                                 conv_kwargs=dict(aggregation="max"))
        smin_m, smin_p = program("simple", tb128, 0, False,
                                 conv_kwargs=dict(aggregation="min"))
        pna_kw = dict(conv_kwargs=dict(aggregators=PNA_ALL5))
        pna5_m, pna5_p = program("pna", b0, 57, True, **pna_kw)
        log(f"GINE lin_edge {gine_m.gnn_convs[0].lin_edge.in_features} -> "
            f"{gine_m.gnn_convs[0].lin_edge.out_features}; EdgeConv "
            f"aggregation {edge_m.gnn_convs[0].aggregation}; PNA "
            f"aggregators {PNA_ALL5}; Simple at 128 (N={tb128.num_nodes})")
        layers = {
            "gine_std": gine_args(gine_m, tb),
            "gine_block": gine_args(gine_m, b0),
            "edge_block": edge_args(edge_m, b0),
            "simple_max": agg_args(smax_m, tb128),
            "simple_min": agg_args(smin_m, tb128),
            "pna5_std": agg_args(pna5_m, tb),
            "pna5_block": agg_args(pna5_m, b0, block=True),
        }
        err_g = max(hold_layers(f"gine_layer ({k}{path})", fn,
                                gine_layer.gine_layer_plain, layers[k], g_)
                    for k, g_ in (("gine_std", tb), ("gine_block", b0))
                    for path, fn in (
                        (", the Ring layout", gine_layer.fused_gine_layer),
                        (", the caller's weights",
                         caller_weights(gine_layer.fused_gine_layer))))
        err_e = hold_layers("edge_block", edge_block.fused_edge_block_layer,
                            edge_block.edge_block_layer_plain,
                            layers["edge_block"], b0)
        err_a = max(hold_layers(f"ell_agg ({k})",
                                ell_agg.fused_ell_aggregate,
                                ell_agg.ell_aggregate_plain, layers[k], g_)
                    for k, g_ in (("simple_max", tb128),
                                  ("simple_min", tb128), ("pna5_std", tb),
                                  ("pna5_block", b0)))
        # row 8 forms each element as the slot-ordered loop does: the
        # same bits, in both modes, in every layer of every path
        for k, g_ in (("simple_max", tb128), ("simple_min", tb128),
                      ("pna5_std", tb), ("pna5_block", b0)):
            for mode in ("f32", "bf16"):
                for i, (args, kw) in enumerate(layers[k]):
                    got = ell_agg.fused_ell_aggregate(*args, mode=mode, **kw)
                    want = ell_agg.ell_aggregate_ordered(*args, mode=mode,
                                                         **kw)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"ell_agg ({k}, {mode}) layer {i}: not the "
                            f"slot-ordered loop's bits")
        log("ell_agg: every layer of simple_max, simple_min, pna5_std and "
            "pna5_block in f32 and bf16 the slot-ordered loop's bits")
        report["gine_layer"] = dict(max_abs_err=err_g)
        report["edge_block"] = dict(max_abs_err=err_e)
        report["ell_agg"] = dict(max_abs_err=err_a, equals_ordered=True,
                                 instances=ell_agg_resources())

    with phase("row 8's backward (tie counts and row 7's gather) over the "
               "reverse table and the reverse CSR against float64, twice"):
        gen = torch.Generator(device=dev).manual_seed(59)
        cases = {"PNA layer 1 v, all five":
                 (layers["pna5_std"][1][0][0], PNA_ALL5, tb),
                 "Simple max layer 1 input (ties at 0)":
                 (layers["simple_max"][1][0][0], ("max", "min"), tb128)}
        bwd_err = 0.0
        for label, (v, aggs, g_) in cases.items():
            ct = torch.randn(v.shape[0], len(aggs) * v.shape[1],
                             generator=gen, device=dev)
            ct[~g_.node_mask] = 0.0
            torch.set_grad_enabled(True)
            v64 = v.double().requires_grad_()
            ell_agg.ell_aggregate_plain(v64, g_.nbr_nodes, g_.in_degree,
                                        aggs).backward(ct.double())
            for route, gb in (("reverse table", g_), (
                    "reverse CSR", g_.replace(rev_nbr_nodes=None,
                                              out_degree=None))):
                got = []
                for _ in range(2):
                    vv = v.clone().requires_grad_()
                    ell_agg.fused_ell_aggregate_vjp(
                        vv, gb.nbr_nodes, gb.in_degree, aggs,
                        rev_nbr_nodes=gb.rev_nbr_nodes,
                        out_degree=gb.out_degree).backward(ct)
                    got.append(vv.grad)
                torch.cuda.synchronize()
                ok, abs_err, rel = close_enough(got[0].double(), v64.grad,
                                                BWD_TOL)
                bwd_err = max(bwd_err, abs_err)
                log(f"{label} ({route}): dv {rel:.3e} of max |value| off "
                    f"float64 (tol {BWD_TOL}), max abs {abs_err:.3e}; "
                    f"bitwise equal on two runs: "
                    f"{torch.equal(got[0], got[1])}")
                if not ok or not torch.equal(got[0], got[1]):
                    raise AssertionError(f"row 8 backward ({label}, {route})")
            torch.set_grad_enabled(False)
        report["ell_agg"]["backward_max_abs_err"] = bwd_err

    paths = {
        "gine_block": (gine_p, batches, dict(gine_layer=6)),
        "gine_std": (None, [tb], dict(gine_layer=6)),
        "edge_block": (edge_p, batches, dict(edge_block=6)),
        "simple_max": (smax_p, [tb128], dict(ell_agg=6)),
        "simple_min": (smin_p, [tb128], dict(ell_agg=6)),
        "pna5_std": (None, [tb], dict(ell_agg=6)),
        "pna5_block": (pna5_p, batches, dict(ell_agg=6)),
    }
    gine_tp = Program(gine_m, max_nodes=tb.num_nodes, max_edges=tb.num_edges,
                      max_graphs=tb.num_graphs, device=dev)
    gine_tp.set_params(gine_p.params)
    pna5_tp = Program(pna5_m, max_nodes=tb.num_nodes, max_edges=tb.num_edges,
                      max_graphs=tb.num_graphs, device=dev)
    pna5_tp.set_params(pna5_p.params)
    paths["gine_std"] = (gine_tp,) + paths["gine_std"][1:]
    paths["pna5_std"] = (pna5_tp,) + paths["pna5_std"][1:]
    launched = {"gine_layer": 0, "edge_block": 0, "ell_agg": 0}
    for name, (p_, bs_, per) in paths.items():
        with phase(f"main path: Program.forward of {name} on {len(bs_)} x "
                   f"{BATCH_GRAPHS}-graph batch(es)"):
            zero_counts()
            outs_ = [p_.forward(b) for b in bs_]
            torch.cuda.synchronize()
            launches = counts()
            want = only(readout=len(bs_),
                        **{k: v * len(bs_) for k, v in per.items()})
            if launches != want:
                raise AssertionError(f"{name} forward launches {launches}, "
                                     f"expected {want}")
            for k in per:
                launched[k] += launches[k]
            dispatch.set_fused_mode("never")
            try:
                refs_ = [p_.forward(b) for b in bs_]
            finally:
                dispatch.set_fused_mode("auto")
            worst = 0.0
            for i, (b, o_, r_) in enumerate(zip(bs_, outs_, refs_)):
                m = b.graph_mask
                ok, _, rel_err = close_enough(o_[m], r_[m])
                worst = max(worst, rel_err)
                if not ok or tuple(o_.shape) != (b.num_graphs, 1):
                    raise AssertionError(f"{name} forward {i} disagrees "
                                         f"({rel_err:.3e} of max |value|)")
            log(f"{name}: launches {launches}; outputs within "
                f"{worst:.3e} of max |value| of the per-layer plain path "
                f"(tol {TOL}) on {len(bs_)} batch(es) of N="
                f"{bs_[0].num_nodes}")

    torch.set_grad_enabled(True)
    with phase("GINE training: gradients of one step against the plain path, "
               "and two steps from one state with and without the reverse "
               "table"):
        tm = canonical_model("gine", "qm9", graphs=tgraphs)
        tp = Program(tm, max_nodes=tb.num_nodes, max_edges=tb.num_edges,
                     max_graphs=tb.num_graphs, device=dev, seed=61)
        st = {k: v.clone() for k, v in tp.init_params().items()}
        per_route = {}
        for label, g_ in (("reverse table", tb), (
                "no reverse table", tb.replace(rev_nbr_nodes=None,
                                               out_degree=None))):
            again = []
            for _ in range(2):
                tm.load_state_dict(st)
                step = fresh_step(tm)
                zero_counts()
                step(g_, target)
                torch.cuda.synchronize()
                launches = counts()
                if launches != only(gine_layer=6, readout=1):
                    raise AssertionError(f"GINE step ({label}) launches "
                                         f"{launches}")
                again.append(grads_of(tm))
            same = [k for k in again[0]
                    if torch.equal(again[0][k], again[1][k])]
            log(f"{label}: launches {launches}; bitwise-equal gradients "
                f"{len(same)} of {len(again[0])}")
            if len(same) != len(again[0]):
                raise AssertionError(f"GINE ({label}): two train steps from "
                                     f"one state gave different gradients")
            per_route[label] = again[0]
        kern = per_route["reverse table"]
        tm.load_state_dict(st)
        masks = conv_output_masks(tm, tb)
        flips = [int(((a > 0) != b)[tb.node_mask].sum()) for a, b in
                 zip(masks, conv_output_masks(tm, tb, "never"))]
        log(f"layer outputs whose ReLU goes the other way in the kernel "
            f"forward than in the float32 plain forward, per layer: {flips}")
        refs = {}
        for name, dt in (("float64", torch.float64),
                         ("float32", torch.float32)):
            mr = canonical_model("gine", "qm9", graphs=tgraphs).to(dev).to(dt)
            mr.load_state_dict({k_: v.to(dt) for k_, v in st.items()})
            gb = tb.replace(node_feat=tb.node_feat.to(dt),
                            edge_feat=tb.edge_feat.to(dt))
            dispatch.set_fused_mode("never")
            try:
                mr.zero_grad()
                train.masked_mse_loss(mr(gb), target.to(dt),
                                      tb.graph_mask).backward()
            finally:
                dispatch.set_fused_mode("auto")
            refs[name] = grads_of(mr)
            refs[name + " on the kernel path's ReLU decisions"] = \
                grads_on_relu_pattern(mr, gb, target.to(dt), masks)
            del mr
        grads_rep = {}
        for name, ref_ in refs.items():
            ok, abs_err, rel, k = worst_grad(kern, ref_)
            grads_rep[name] = rel
            log(f"gradients vs the {name} plain path: worst {rel:.3e} of "
                f"max |value| ({k}), max abs {abs_err:.3e}")
        # the gate: the float64 plain path, on its own ReLU decisions or,
        # where a layer output within float32 rounding of 0 took its ReLU
        # the other way in the kernel forward, on the kernel path's
        gate = ("float64" if grads_rep["float64"] <= TOL else
                "float64 on the kernel path's ReLU decisions")
        log(f"gate: the {gate} plain path, {grads_rep[gate]:.3e} of max "
            f"(tol {TOL})")
        if grads_rep[gate] > TOL:
            raise AssertionError("GINE gradients disagree with the float64 "
                                 "plain path")
        out["gradients_worst_rel"] = grads_rep
        out["gradient_gate"] = gate
        out["relu_flips_kernel_vs_plain"] = flips

    with phase(f"main path: {GINE_TRAIN_STEPS} Adam steps of canonical GINE "
               f"on the train batch"):
        curves = {}
        for mode in ("auto", "never"):
            tm.load_state_dict(st)
            step = fresh_step(tm)
            dispatch.set_fused_mode(mode)
            try:
                if mode == "auto":
                    zero_counts()
                curves[mode] = [float(step(tb, target))
                                for _ in range(GINE_TRAIN_STEPS)]
                torch.cuda.synchronize()
                if mode == "auto":
                    launches = counts()
            finally:
                dispatch.set_fused_mode("auto")
        log(f"launches {launches}; losses {curves['auto']}, plain "
            f"{curves['never']}")
        want = only(gine_layer=6 * GINE_TRAIN_STEPS,
                    readout=GINE_TRAIN_STEPS)
        if launches != want:
            raise AssertionError(f"GINE train launches {launches}, expected "
                                 f"{want}")
        for i, (a, b) in enumerate(zip(curves["auto"], curves["never"])):
            if not (math.isfinite(a) and abs(a - b) <= CURVE_TOL * abs(b)):
                raise AssertionError(f"GINE step {i}: loss {a} against "
                                     f"plain {b}")
        launched["gine_layer"] += launches["gine_layer"]
        out["loss_curve"], out["plain_loss_curve"] = (curves["auto"],
                                                      curves["never"])
    for k, n in launched.items():
        report[k]["launches"] = n

    with phase("GINE, EdgeConv and row 8 times (CUDA events; "
               "torch.profiler device times)"):
        torch.set_grad_enabled(False)

        def run(fn, ls):
            def go():
                for args, kw in ls:
                    fn(*args, **kw)
            return go

        def entry(name, key, fn, plain, ls, g_, work, per, lib=None,
                  products=None):
            # row 13's products run on the tensor cores: 3 x TF32 bound
            b_ms, b_by = (bound(*work) if products is None else
                          bound_f32_products(products, work[0] - products,
                                             work[1]))
            ms, ev = timed(run(fn, ls), 10)
            pms, pev = timed(run(plain, ls), 3)
            lms, lev = timed(lib, 10) if lib is not None else (None, None)
            ent = dict(ms=ms, event_ms=ev, plain_ms=pms, plain_event_ms=pev,
                       bound_ms=b_ms, bound_by=b_by, flops=work[0],
                       bytes=work[1], library_ms=lms, library_event_ms=lev,
                       per=per, tb_per_s_of_bound_bytes=work[1] / ms / 1e9)
            libs = "" if lms is None else f", library {lms:.4f} ({lev:.4f})"
            log(f"{name} {key} per {per}: device {ms:.4f} ms (events "
                f"{ev:.4f}), plain {pms:.4f} ({pev:.4f}){libs}; bound "
                f"{b_ms:.4f} ms by {b_by} ({b_ms / ms:.1%} of it; "
                f"{work[1] / ms / 1e9:.2f} TB/s of its bytes)")
            return ent

        # row 12's products run on the tensor cores: 3 x TF32 bound; the
        # main path reads the Ring layout, timed beside the caller's
        # weights and the layout's own device time
        report["gine_layer"].update(entry(
            "gine_layer", "standard", gine_layer.fused_gine_layer,
            gine_layer.gine_layer_plain, layers["gine_std"], tb,
            gine_work(layers["gine_std"], tb),
            f"one standard-packed b{BATCH_GRAPHS} forward (6 launches)",
            products=gine_products(layers["gine_std"], tb)))
        report["gine_layer"]["block"] = entry(
            "gine_layer", "block", gine_layer.fused_gine_layer,
            gine_layer.gine_layer_plain, layers["gine_block"], b0,
            gine_work(layers["gine_block"], b0),
            f"one block-packed b{BATCH_GRAPHS} forward (6 launches)",
            products=gine_products(layers["gine_block"], b0))
        for k, g_ in (("gine_std", tb), ("gine_block", b0)):
            cw, cwev = timed(run(caller_weights(gine_layer.fused_gine_layer),
                                 layers[k]), 10)
            wts = [(kw["w0"], kw["w1"]) for _, kw in layers[k]]
            st_ms, st_ev = timed(lambda: gine_layer.layer_operands(wts), 10)
            report["gine_layer"].setdefault("caller_weights_ms", {})[k] = cw
            report["gine_layer"].setdefault("layout_ms", {})[k] = st_ms
            log(f"gine_layer {k}: the caller's weights {cw:.4f} ms device "
                f"(events {cwev:.4f}); the six layers' Ring layout "
                f"{st_ms:.4f} ms device (events {st_ev:.4f}) on {smi}")
        report["edge_block"].update(entry(
            "edge_block", "block", edge_block.fused_edge_block_layer,
            edge_block.edge_block_layer_plain, layers["edge_block"], b0,
            edge_work(layers["edge_block"], b0),
            f"one block-packed b{BATCH_GRAPHS} forward (6 launches)",
            products=edge_products(layers["edge_block"], b0)))
        # row 8's library yardsticks: the max of the neighbour rows as one
        # scatter_reduce over the edge list (sources gathered outside the
        # timing; include_self=False on zeros keeps 0 on an empty row), and
        # the sum as one torch.sparse.mm on the CSR of the edge counts
        m_ = tb128.edge_mask
        recv = tb128.receivers[m_].long()
        send = tb128.senders[m_].long()
        h1 = layers["simple_max"][1][0][0]
        src = h1[send]
        idx = recv[:, None].expand_as(src)
        z = torch.zeros_like(h1)
        lib_max = z.scatter_reduce(0, idx, src, "amax", include_self=False)
        ok, _, _ = close_enough(lib_max, ell_agg.ell_aggregate_plain(
            h1, tb128.nbr_nodes, tb128.in_degree, ("max",)))
        if not ok:
            raise AssertionError("the scatter_reduce yardstick computes "
                                 "another function")
        one_max = [((h1, tb128.nbr_nodes, tb128.in_degree, ("max",)), {})]
        by = {"simple_max layer 1": entry(
            "ell_agg", "max", ell_agg.fused_ell_aggregate,
            ell_agg.ell_aggregate_plain, one_max, tb128,
            agg_work(one_max, tb128), "one launch: max of a 128-wide "
            "layer input over the train batch", lambda: z.scatter_reduce(
                0, idx, src, "amax", include_self=False))}
        a_csr = adjacency_csr(tb128)
        one_sum = [((h1, tb128.nbr_nodes, tb128.in_degree, ("sum",)), {})]
        by["sum layer 1"] = entry(
            "ell_agg", "sum", ell_agg.fused_ell_aggregate,
            ell_agg.ell_aggregate_plain, one_sum, tb128,
            agg_work(one_sum, tb128), "one launch: sum of a 128-wide "
            "layer input over the train batch",
            lambda: torch.sparse.mm(a_csr, h1))
        by["pna5_std"] = entry(
            "ell_agg", "pna5 u", ell_agg.fused_ell_aggregate,
            ell_agg.ell_aggregate_plain, layers["pna5_std"], tb,
            agg_work(layers["pna5_std"], tb), "one standard-packed "
            f"b{BATCH_GRAPHS} five-aggregator PNA forward (6 launches, u)")
        by["pna5_block"] = entry(
            "ell_agg", "pna5 block", ell_agg.fused_ell_aggregate,
            ell_agg.ell_aggregate_plain, layers["pna5_block"], b0,
            agg_work(layers["pna5_block"], b0), "one block-packed "
            f"b{BATCH_GRAPHS} five-aggregator PNA forward (6 launches, "
            f"max and min)")
        by["simple_max"] = entry(
            "ell_agg", "simple max", ell_agg.fused_ell_aggregate,
            ell_agg.ell_aggregate_plain, layers["simple_max"], tb128,
            agg_work(layers["simple_max"], tb128),
            f"one standard-packed b{BATCH_GRAPHS} Simple-max forward (6 "
            f"launches, 128 wide)")
        # the headline: one max launch, whose function one library call
        # (scatter_reduce) computes
        report["ell_agg"].update(by["simple_max layer 1"], by_config=by,
                                 library="scatter_reduce amax over the "
                                 "edge list, include_self=False on zeros")

        fwd = {}
        for name, (p_, bs_, _) in paths.items():
            fwd[name] = time_ms(lambda: p_.forward(bs_[0]), 20, warmup=3)
        log(f"forwards b{BATCH_GRAPHS} (ms, events): " + ", ".join(
            f"{k} {v:.4f}" for k, v in fwd.items()) + f" on {smi}")
        out["forward_ms"] = fwd
        torch.set_grad_enabled(True)
        tm.load_state_dict(st)
        step = fresh_step(tm)
        step_ms = time_ms(lambda: step(tb, target), 10, warmup=3)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            for _ in range(3):
                step(tb, target)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t) * 1e3 / 3
        split = split_device_time(prof, 3)
        busy = sum(split.values())
        log(f"GINE train step b{BATCH_GRAPHS}: {step_ms:.4f} ms (events); "
            f"device ms per step by part: "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items() if v)
            + f"; busy {busy:.4f} of {wall_ms:.4f} ms wall")
        out.update(step_ms=step_ms, device_ms_per_step=split,
                   profiled_wall_ms=wall_ms)
    torch.set_grad_enabled(False)
    return out


# ---------------------------------------------------------------------------
# this slice: the bf16 and int8 policies of Program on canonical PNA
# inference, through the bf16 and int8 modes of rows 1, 2 and 5

PREC_MODES = ("bf16", "int8")
# each mode against its plain version in the same mode, layer by layer
# on the same input: the sums run in another order, which can move a
# bf16 rounding or an int8 level at its boundary (one int8 level of a
# 128-wide row moves an output by ~1e-3 of max)
MODE_TOL = {"bf16": 2e-3, "int8": 5e-3}
# a whole model on the card against the same Program on the CPU: the
# moved roundings and levels compound through 6 layers and the head
CHAIN_TOL = {"bf16": 5e-3, "int8": 5e-2}
# the value each product family of a mode runs at, per operation
MODE_PEAK = {"bf16": PEAK_BF16_FLOPS, "int8": PEAK_INT8_OPS}
WEIGHT_BYTES = {"bf16": 2, "int8": 1}


def bound_mixed(terms, nbytes):
    """The least time for ``terms`` [(operations, peak rate)] and
    ``nbytes``: the larger of the summed operation times and the bytes
    over the memory rate."""
    t_ops = sum(ops / peak for ops, peak in terms)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def precision_phases(report, *, dev, graphs, batches, b0, tb, prog,
                     counted, zero_counts, smi, tc, tcl):
    """Program(precision="bf16" | "int8") of canonical PNA: the bf16 and
    int8 modes of rows 1, 2 and 5 against their plain versions in every
    layer, the block-packed main path (3 x b1024, rows 1 and 2) and the
    standard-packed one (the train batch, row 5 x 6 and row 2) under both
    policies with their launch counts, calibrate_int8 and a forward with
    static scales, each policy's error against f32 and against the CPU,
    and the times.  Fills ``report``; returns the summary for the last
    JSON line."""
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.ops import segment
    from gnnbuilder_tpu_torch.ops.cuda import pna_block, pna_layer, readout

    kernels = {"pna_block_stack": pna_block.fused_pna_block_stack,
               "readout": readout.fused_readout,
               "pna_layer": pna_layer.fused_pna_layer}
    out = {}
    model = prog.model
    L = model.gnn_num_layers
    deltas = [c.delta for c in model.gnn_convs]
    skips = [0 < i < L - 1 for i in range(L)]
    aggrs = model.pooling_aggrs
    size = dict(max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                max_graphs=b0.num_graphs, block_size=128)

    def program(precision, device=dev, **kw):
        p = Program(canonical_model("pna", "qm9", graphs=graphs),
                    precision=precision, device=device, **(kw or size))
        p.set_params({k: v.to(device) for k, v in prog.params.items()})
        return p

    def mode_counts(mode):
        return {k: fn.mode_launches[mode] for k, fn in kernels.items()}

    def totals():
        return {k: fn.launches for k, fn in counted.items()}

    torch.set_grad_enabled(False)
    stacked, head = model._kernel_params(128)
    x = torch.nn.functional.pad(b0.node_feat,
                                (0, 128 - b0.feature_dim)).contiguous()
    with phase("precision: rows 1, 2 and 5 in bf16 and int8 against their "
               "plain versions in each of the 6 layers"):
        ops = {}
        for mode in PREC_MODES:
            st, sc = pna_block.prepare_stack(stacked, mode)
            h, errs = x, []
            for l in range(L):
                one = ([t[l:l + 1] for t in st],
                       None if sc is None else [s[l:l + 1] for s in sc])
                args = (h, b0.nbr_nodes, b0.in_degree, *one[0])
                kw = dict(deltas=deltas[l:l + 1], skips=skips[l:l + 1],
                          act=model.gnn_activation, mode=mode,
                          scales=one[1])
                got = pna_block.fused_pna_block_stack(*args, **kw)
                torch.cuda.synchronize()
                want = pna_block.pna_block_stack_plain(*args, **kw)
                e = rel_err(got, want)
                errs.append(float((got - want).abs().max()))
                if not bool(torch.isfinite(got).all()) or e > MODE_TOL[mode]:
                    raise AssertionError(f"pna_block_stack {mode} layer "
                                         f"{l}: {e:.3e} of max |value|")
                h = want.contiguous()
            log(f"pna_block_stack {mode}: per layer max abs "
                f"{[f'{v:.2e}' for v in errs]} (tol {MODE_TOL[mode]} of "
                f"max |value|)")
            hs = h[:, :model.gnn_output_dim].contiguous()
            mx = segment.contiguous_segment_max(
                hs, b0.graph_starts, b0.n_node, b0.max_graph_nodes_static)
            hd, hsc = readout.prepare_head(head, mode)
            rkw = dict(aggrs=aggrs, mx=mx, act=model.mlp_activation,
                       out_act=model.output_activation,
                       starts=b0.graph_starts, mode=mode, scales=hsc)
            got_r = readout.fused_readout(hs, b0.n_node, hd, **rkw)
            torch.cuda.synchronize()
            want_r = readout.readout_plain(
                hs, b0.n_node, b0.graph_starts, hd, aggrs, mx,
                model.mlp_activation, model.output_activation, mode, hsc)
            m = b0.graph_mask
            e = rel_err(got_r[m], want_r[m])
            log(f"readout {mode}: {e:.3e} of max |value| (tol "
                f"{MODE_TOL[mode]}; graph_mask rows)")
            if not bool(torch.isfinite(got_r[m]).all()) or e > MODE_TOL[mode]:
                raise AssertionError(f"readout {mode} disagrees")
            report[f"pna_block_stack_{mode}"] = dict(max_abs_err=max(errs),
                                                     resources=tc[mode])
            report[f"readout_{mode}"] = dict(
                max_abs_err=float((got_r[m] - want_r[m]).abs().max()))

            hl, errs, largs = tb.node_feat, [], []
            for i, c in enumerate(model.gnn_convs):
                skip = hl if skips[i] else None
                o = pna_layer.pad_operands(
                    hl, c.pre_nn.weight.t(), c.pre_nn.bias,
                    c.post_nn.weight.t(), c.post_nn.bias, c.lin.weight.t(),
                    c.lin.bias, skip)
                o = [None if t is None else t.contiguous() for t in o]
                w_pre, k_post, w_lin, s_lin = pna_layer.prepare_layer(
                    o[1], o[3], o[5], mode)
                args = (o[0], tb.nbr_nodes, tb.in_degree, w_pre, o[2],
                        k_post, o[4], w_lin, o[6], c.delta)
                kw = dict(skip=o[7], act=model.gnn_activation, mode=mode,
                          s_lin=s_lin)
                got = pna_layer.fused_pna_layer(*args, **kw)
                torch.cuda.synchronize()
                want = pna_layer.pna_layer_plain(*args, **kw)
                e = rel_err(got, want)
                errs.append(float((got - want).abs().max()))
                if not bool(torch.isfinite(got).all()) or e > MODE_TOL[mode]:
                    raise AssertionError(f"pna_layer {mode} layer {i}: "
                                         f"{e:.3e} of max |value|")
                largs.append((args, kw))
                hl = want[:, :c.out_channels]
            log(f"pna_layer {mode}: per layer max abs "
                f"{[f'{v:.2e}' for v in errs]} (tol {MODE_TOL[mode]})")
            report[f"pna_layer_{mode}"] = dict(max_abs_err=max(errs))
            ops[mode] = dict(stack=(st, sc), head=(hd, hsc, hs, mx),
                             layers=largs)

    progs = {p: program(p) for p in ("f32",) + PREC_MODES}
    with phase(f"main path: Program.forward under bf16 and under int8 on "
               f"{N_BATCHES} x {BATCH_GRAPHS}-graph block-packed batches"):
        f32_outs = [progs["f32"].forward(b) for b in batches]
        out["error_vs_f32"] = {}
        for prec in PREC_MODES:
            zero_counts()
            outs = [progs[prec].forward(b) for b in batches]
            torch.cuda.synchronize()
            got = mode_counts(prec)
            tot = totals()
            log(f"{prec}: launches in mode {got}; all counts {tot}")
            if (got != {"pna_block_stack": N_BATCHES, "readout": N_BATCHES,
                        "pna_layer": 0}
                    or sum(tot.values()) != 2 * N_BATCHES):
                raise AssertionError(f"{prec}: a kernel did not launch in "
                                     f"its {prec} mode once per forward")
            report[f"pna_block_stack_{prec}"]["launches"] = got[
                "pna_block_stack"]
            report[f"readout_{prec}"]["launches"] = got["readout"]
            errs = []
            for b, o, r in zip(batches, outs, f32_outs):
                m = b.graph_mask
                if (tuple(o.shape) != (b.num_graphs, model.mlp_out_dim)
                        or o.dtype != torch.float32
                        or not bool(torch.isfinite(o[m]).all())):
                    raise AssertionError(f"{prec}: bad output")
                errs.append(rel_err(o[m], r[m]))
            out["error_vs_f32"][prec] = errs
            log(f"{prec} against f32 (graph_mask rows, share of max "
                f"|value|): {[f'{e:.3e}' for e in errs]}")
        # a small input: the card's kernels against the CPU's plain
        # versions of the same modes, same weights
        _, (small,) = canonical_batches(
            "qm9", n_graphs=64, batch_size=64, block_size=128,
            node_multiple=128, device="cpu")
        ssize = dict(max_nodes=small.num_nodes, max_edges=small.num_edges,
                     max_graphs=small.num_graphs, block_size=128)
        for prec in PREC_MODES:
            o = program(prec, **ssize).forward(small.to(dev)).cpu()
            r = program(prec, device="cpu", **ssize).forward(small)
            m = small.graph_mask
            e = rel_err(o[m], r[m])
            log(f"{prec}, 64-graph batch: card kernels vs CPU plain "
                f"versions: {e:.3e} of max |value| (tol {CHAIN_TOL[prec]})")
            if e > CHAIN_TOL[prec]:
                raise AssertionError(f"{prec}: card disagrees with the CPU")

    with phase("main path: Program.forward under bf16 and under int8 on "
               "the standard-packed train batch"):
        tsize = dict(max_nodes=tb.num_nodes, max_edges=tb.num_edges,
                     max_graphs=tb.num_graphs, block_size=0)
        tprogs = {p: program(p, **tsize) for p in ("f32",) + PREC_MODES}
        ref = tprogs["f32"].forward(tb)
        m = tb.graph_mask
        out["standard_error_vs_f32"] = {}
        for prec in PREC_MODES:
            zero_counts()
            o = tprogs[prec].forward(tb)
            torch.cuda.synchronize()
            got = mode_counts(prec)
            log(f"{prec}: launches in mode {got}; all counts {totals()}")
            if (got != {"pna_block_stack": 0, "readout": 1, "pna_layer": L}
                    or sum(totals().values()) != L + 1):
                raise AssertionError(f"{prec}: the layer kernel did not run "
                                     f"in its {prec} mode in every layer")
            report[f"pna_layer_{prec}"]["launches"] = got["pna_layer"]
            if not bool(torch.isfinite(o[m]).all()):
                raise AssertionError(f"{prec}: non-finite output")
            e = rel_err(o[m], ref[m])
            out["standard_error_vs_f32"][prec] = e
            log(f"{prec} against f32: {e:.3e} of max |value|")

    with phase("calibrate_int8 on two batches, then a forward with static "
               "scales"):
        p8 = program("int8")
        t = time.time()
        scales = p8.calibrate_int8(batches[:2])
        torch.cuda.synchronize()
        log(f"{len(scales)} sites calibrated in {time.time() - t:.2f}s: "
            f"{ {k: round(v, 6) for k, v in scales.items()} }")
        zero_counts()
        o = p8.forward(batches[2])
        torch.cuda.synchronize()
        got = mode_counts("int8")
        log(f"static forward: launches in int8 mode {got} (the gates of "
            f"rows 1, 2 and 5 decline under a calibration); all counts "
            f"{totals()}")
        if any(got.values()):
            raise AssertionError("a kernel ran its int8 mode under static "
                                 "scales")
        m = batches[2].graph_mask
        if not bool(torch.isfinite(o[m]).all()):
            raise AssertionError("static int8 forward: non-finite output")
        e32 = rel_err(o[m], f32_outs[2][m])
        log(f"static int8 against f32: {e32:.3e} of max |value|")
        cpu = program("int8", device="cpu", **ssize)
        cpu.int8_scales = scales
        p8s = program("int8", **ssize)
        p8s.int8_scales = scales
        r = cpu.forward(small)
        o = p8s.forward(small.to(dev)).cpu()
        ms = small.graph_mask
        e = rel_err(o[ms], r[ms])
        log(f"static int8, 64-graph batch: card vs CPU {e:.3e} of max "
            f"|value| (tol {CHAIN_TOL['int8']})")
        if e > CHAIN_TOL["int8"]:
            raise AssertionError("static int8: card disagrees with the CPU")
        out["static_int8"] = dict(sites=len(scales), error_vs_f32=e32,
                                  card_vs_cpu=e)

    with phase("precision times (CUDA events; torch.profiler device "
               "times)"):
        widths = pna_widths(model)
        N, W = b0.num_nodes, b0.ell_width
        E = int(b0.in_degree.sum())
        Nt, Wt = tb.num_nodes, tb.ell_width
        Et = int(tb.in_degree.sum())
        G, Fh = b0.num_graphs, model.gnn_output_dim
        pooled_rows = int(b0.n_node[b0.graph_mask].sum())

        def products(n, fin, f, fo):
            return 2 * n * (2 * fin * f + 12 * f * fo + fin * fo + fo * fo)

        for mode in PREC_MODES:
            pk, wb = MODE_PEAK[mode], WEIGHT_BYTES[mode]
            st, sc = ops[mode]["stack"]
            sargs = (x, b0.nbr_nodes, b0.in_degree, *st)
            skw = dict(deltas=deltas, skips=skips, act=model.gnn_activation,
                       mode=mode, scales=sc)
            prod = sum(products(N, *w) for w in widths)
            agg = sum(5 * E * w[1] for w in widths)
            nw = sum(layer_weights(*w) for w in widths)
            nb = sum(w[1] + 2 * w[2] for w in widths)      # the biases
            # int8: ~4 operations per quantized value (|.|-max, divide,
            # round and clamp) and 2 per dequantized output
            quant = (sum(N * (w[0] + 4 * w[1] + w[2]) * 4
                         + N * (2 * w[1] + 3 * w[2] + 2 * w[2]) * 2
                         for w in widths) if mode == "int8" else 0)
            by = (4 * (N * widths[0][0] + N * widths[-1][2] + N * W + N
                       + nb) + wb * (nw - nb)
                  + (4 * sum(2 * w[1] + 5 * w[2] for w in widths)
                     if mode == "int8" else 0))
            b_ms, b_by = bound_mixed(
                [(prod, pk), (agg + quant, PEAK_F32_FLOPS)], by)
            staged = pna_block.stage_stack(st, mode)
            fn = lambda: pna_block.fused_pna_block_stack(*sargs, **skw,
                                                         staged=staged)
            dms, ems = timed(fn, 10)
            report[f"pna_block_stack_{mode}"].update(
                ms=ems, device_ms=dms,
                plain_ms=time_ms(lambda: pna_block.pna_block_stack_plain(
                    *sargs, **skw), 3),
                bound_ms=b_ms, bound_by=b_by, flops=prod + agg + quant,
                bytes=by)

            hd, hsc, hs, mx = ops[mode]["head"]
            rkw = dict(aggrs=aggrs, mx=mx, act=model.mlp_activation,
                       out_act=model.output_activation,
                       starts=b0.graph_starts, mode=mode, scales=hsc)
            mlp = G * 2 * sum(w.numel() for w, _ in hd)
            pool = pooled_rows * Fh + 2 * G * Fh
            rq = (G * sum(w.shape[0] * 4 + w.shape[1] * 2 for w, _ in hd)
                  if mode == "int8" else 0)
            r_by = (4 * (hs.numel() + mx.numel() + 2 * G
                         + sum(c.numel() for _, c in hd)
                         + G * model.mlp_out_dim)
                    + wb * sum(w.numel() for w, _ in hd)
                    + (4 * sum(s.numel() for s in hsc) if hsc else 0))
            b_ms, b_by = bound_mixed(
                [(mlp, pk), (pool + rq, PEAK_F32_FLOPS)], r_by)
            packed = readout.pack_head(hd, hsc, mode)
            pkw = {k: v for k, v in rkw.items() if k != "scales"}
            fn = lambda: readout.fused_readout(hs, b0.n_node, packed, **pkw)
            dms, ems = timed(fn, 50)
            sm_dms, sm_ems = timed(lambda: segment.contiguous_segment_max(
                hs, b0.graph_starts, b0.n_node, b0.max_graph_nodes_static),
                50)
            log(f"readout {mode} (packed head), device ms (event ms): "
                f"{dms:.4f} ({ems:.4f}); contiguous_segment_max "
                f"{sm_dms:.4f} ({sm_ems:.4f})")
            report[f"readout_{mode}"].update(
                ms=ems, device_ms=dms, segment_max_ms=sm_ems,
                segment_max_device_ms=sm_dms,
                plain_ms=time_ms(lambda: readout.readout_plain(
                    hs, b0.n_node, b0.graph_starts, hd, aggrs, mx,
                    model.mlp_activation, model.output_activation, mode,
                    hsc), 20),
                bound_ms=b_ms, bound_by=b_by, flops=mlp + pool + rq,
                bytes=r_by)

            largs = ops[mode]["layers"]
            # the layouts the model caches for inference
            lst = [pna_layer.stage_layer(a[3], a[5], a[7], mode)
                   for a, _ in largs]

            def run(fn, _largs=largs, _lst=lst):
                for (a, k), st in zip(_largs, _lst):
                    if fn is pna_layer.fused_pna_layer:
                        k = dict(k, staged=st)
                    fn(*a, **k)

            lprod = sum(products(Nt, *w) for w in widths)
            # int8 quantizes the final Linear only: the rest at f32
            lin = sum(2 * Nt * w[2] * w[2] for w in widths)
            # int8's f32 products at the faster of the FMA and 3 x TF32
            terms = ([(lprod, pk)] if mode == "bf16"
                     else [(lin, pk), (lprod - lin,
                                       max(PEAK_F32_FLOPS,
                                           PEAK_TF32_FLOPS / 3))])
            lagg = sum(5 * Et * w[1] for w in widths)
            lq = (sum(Nt * w[2] * 4 + Nt * w[2] * 2 for w in widths)
                  if mode == "int8" else 0)
            terms.append((lagg + lq, PEAK_F32_FLOPS))
            fw = (lambda fi, f, fo: 2 * fi * f + (fi + 12 * f) * fo) \
                if mode == "int8" else (lambda fi, f, fo: 0)
            l_by = sum(
                4 * (Nt * fi + Nt * Wt + Nt + f + 2 * fo + Nt * fo
                     + (Nt * fo if skips[i] else 0))
                + (4 * fw(fi, f, fo) + wb * fo * fo + 4 * fo
                   if mode == "int8" else
                   wb * (2 * fi * f + (fi + 12 * f) * fo + fo * fo))
                for i, (fi, f, fo) in enumerate(widths))
            b_ms, b_by = bound_mixed(terms, l_by)
            dms, ems = timed(lambda: run(pna_layer.fused_pna_layer), 10)
            report[f"pna_layer_{mode}"].update(
                resources=dict(
                    proj=tcl["pna_proj"][mode],
                    agg=tcl["pna_agg"]["bf16" if mode == "bf16" else "f32"],
                    **({} if mode == "bf16" else {"v": tcl["pna_v"]["f32"]})),
                ms=ems, device_ms=dms,
                plain_ms=time_ms(lambda: run(pna_layer.pna_layer_plain), 3),
                bound_ms=b_ms, bound_by=b_by,
                flops=sum(t for t, _ in terms), bytes=l_by,
                per="6 layers, inference (no residuals)")
            for k in ("pna_block_stack", "readout", "pna_layer"):
                v = report[f"{k}_{mode}"]
                log(f"{k} {mode}: {v['ms']:.4f} ms (device "
                    f"{v['device_ms']:.4f} ms; plain {v['plain_ms']:.4f} ms; "
                    f"bound {v['bound_ms']:.4f} ms by {v['bound_by']})")
        fwd = {}
        for prec in ("f32",) + PREC_MODES:
            bb = progs[prec].benchmark(b0, iters=20, warmup=3)
            bt = tprogs[prec].benchmark(tb, iters=10, warmup=2)
            fwd[prec] = dict(block_ms=bb["latency_s"] * 1e3,
                             block_graphs_per_s=bb["graphs_per_s"],
                             standard_ms=bt["latency_s"] * 1e3,
                             standard_graphs_per_s=bt["graphs_per_s"])
            log(f"Program.forward {prec}: block b{BATCH_GRAPHS} "
                f"{fwd[prec]['block_ms']:.4f} ms, standard "
                f"{fwd[prec]['standard_ms']:.4f} ms on {smi}")
        out["forward"] = fwd
    return out


# ---------------------------------------------------------------------------
# this slice: the bf16 and int8 modes of rows 3, 4, 8, 12 and 13, so that
# every conv but GAT runs its kernels under Program's policies, and row
# 6's generic entry

# kernel: (TPU source, line of the TPU function, the modes it has)
SLICE_KERNELS = {
    "mp_block_stack": ("mp_block", 157, PREC_MODES),
    "mp_layer": ("mp_layer", 341, PREC_MODES),
    "ell_agg": ("ell_agg", 205, ("bf16",)),
    "gine_layer": ("gine_layer", 253, PREC_MODES),
    "edge_block": ("edge_block", 151, ("bf16",)),
}
# model: (conv, conv_kwargs, node width, the packings the JAX gates send
# to one of the slice's kernels)
SLICE_MODELS = {
    "gcn": ("gcn", {}, None, ("block", "standard")),
    "gin": ("gin", {}, None, ("standard",)),
    "sage": ("sage", {}, None, ("block", "standard")),
    "lg": ("lg", {}, 128, ("block", "standard")),
    "simple": ("simple", {}, 128, ("block", "standard")),
    "gine": ("gine", {}, None, ("block", "standard")),
    "edge": ("edge", {}, None, ("block",)),
    "simple_max": ("simple", {"aggregation": "max"}, 128, ("standard",)),
    "pna5": ("pna", {"aggregators": PNA_ALL5}, None, ("block", "standard")),
}


# the slice's forwards on the card against the same Program on the CPU:
# the card's and the CPU's matrix products round their sums in other
# orders, and an ulp before one of a mode's roundings moves a bf16 value
# by 2^-8 (or an int8 level); through six layers the moved values
# compound, and PNA's std amplifies them on near-constant rows (measured,
# five-aggregator PNA block-packed under bf16: 1e-7 of max after layer 0,
# 1.3e-3 after layer 5, 2.1e-3 to 6.5e-3 at the head)
SLICE_CPU_TOL = {"bf16": 1e-2, "int8": 5e-2}


def slice_expected(name, packing, prec, L):
    """{kernel: {mode: launches}} of one forward of ``name`` under
    ``prec``: the JAX gates' choices (a kernel with a bf16 mode only keeps
    float32 under int8; EdgeConv's gate declines under int8)."""
    keep = "bf16" if prec == "bf16" else "f32"
    if name in ("gcn", "sage") and packing == "block":
        return {"mp_block_stack": {prec: 1}}
    if name in ("gcn", "lg", "simple"):
        return {"mp_layer": {keep: L}}
    if name in ("gin", "sage"):
        return {"mp_layer": {prec: L}}
    if name == "gine":
        return {"gine_layer": {prec: L}}
    if name == "edge":
        return {"edge_block": {"bf16": L}} if prec == "bf16" else {}
    return {"ell_agg": {keep: L}}


def mp_args(model, g, block):
    """Row 4's ((v, nbr_nodes, in_degree, conv), kw) per layer as the
    model's convs launch it, the hidden state advanced through the plain
    path."""
    t = lambda w: w.t().contiguous()
    deg = g.in_degree.to(torch.float32)[:, None]
    out = []
    for c, h, sk in plain_layer_inputs(model, g):
        kw = dict(skip=sk, act=model.gnn_activation,
                  block_adj=g.block_adj if block else None)
        name = type(c).__name__
        if name == "GCNConv":
            v = c.lin(h) * torch.rsqrt(deg + 1.0)
            conv, kw["b0"] = "gcn", c.bias
        elif name == "GINConv":
            v, conv = h, "gin"
            kw.update(w0=t(c.lin0.weight), b0=c.lin0.bias,
                      w1=t(c.lin1.weight), b1=c.lin1.bias, eps=c.eps)
        elif name == "SAGEConv":
            v, conv = h, "sage"
            kw.update(w0=t(c.lin_l.weight), b0=c.lin_l.bias,
                      w1=t(c.lin_r.weight))
        elif name == "LGConv":
            dis = torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1.0)),
                              torch.zeros_like(deg))
            v, conv = h * dis, "lg"
        else:
            v, conv = h, "simple_sum"
        out.append(((v.contiguous(), g.nbr_nodes, g.in_degree, conv), kw))
    return out


def in_mode(layers, key, mode):
    """The (args, kw) of ``layers`` with their float32 weights brought to
    ``mode`` as the call sites bring them."""
    from gnnbuilder_tpu_torch.ops.cuda.gine_layer import layer_operands
    from gnnbuilder_tpu_torch.ops.cuda.mp_layer import prepare_layer

    if key == "gine_layer":   # all layers' Ring layouts in one gather
        ops = layer_operands([(kw["w0"], kw["w1"]) for _, kw in layers],
                             mode)
        return [(args, dict(kw, mode=mode, w0=w0, w1=w1, s0=s0, s1=s1,
                            staged=st))
                for (args, kw), (w0, w1, s0, s1, st) in zip(layers, ops)]
    out = []
    for args, kw in layers:
        kw = dict(kw, mode=mode)
        if key == "mp_layer" and "w0" in kw:
            w0, w1, s0, s1 = prepare_layer(kw["w0"], kw["w1"], mode)
            kw.update(w0=w0, w1=w1, s0=s0, s1=s1)
        if key == "edge_block":
            kw.update(w_pair=kw["w_pair"].to(torch.bfloat16),
                      w1=kw["w1"].to(torch.bfloat16))
        out.append((args, kw))
    return out


def mode_work(key, layers, g, mode):
    """([(operations, peak)], bytes) of the launches ``layers`` of
    ``key`` in ``mode``: the products at the mode's tensor-core peak (in
    int8 only the quantized ones), everything else (aggregation,
    elementwise work, ~4 operations per quantized value and 2 per
    dequantized output) at the float32 peak; weights at the mode's width,
    every other input and output once in float32."""
    pk, wb = MODE_PEAK[mode], WEIGHT_BYTES[mode]
    n, e = g.num_nodes, int(g.in_degree.sum())
    prod = rest = nbytes = 0
    for args, kw in layers:
        if key == "mp_layer":
            conv, F = args[3], args[0].shape[1]
            H = kw["w0"].shape[1] if conv == "gin" else 0
            Fout = (kw["w1"].shape[1] if conv == "gin" else
                    kw["w0"].shape[1] if conv == "sage" else F)
            words = n * (128 if kw.get("block_adj") is not None
                         else g.ell_width)
            fl, by = mp_layer_work(conv, n, e, words, F, H, Fout,
                                   kw["skip"] is not None, True, False)
            p = (2 * n * (F * H + H * Fout) if conv == "gin" else
                 4 * n * F * Fout if conv == "sage" else 0)
            w = F * H + H * Fout if conv == "gin" else (
                2 * F * Fout if conv == "sage" else 0)
            q = (n * (F + H) * 4 + n * (H + Fout) * 2 if conv == "gin" else
                 2 * n * F * 4 + 2 * n * Fout * 2) if mode == "int8" else 0
        elif key == "gine_layer":
            fl, by = gine_work([(args, kw)], g)
            F, H = args[0].shape[1], kw["w0"].shape[1]
            Fout = kw["w1"].shape[1]
            p, w = 2 * n * (F * H + H * Fout), F * H + H * Fout
            q = (n * (F + H) * 4 + n * (H + Fout) * 2
                 if mode == "int8" else 0)
        elif key == "edge_block":
            fl, by = edge_work([(args, kw)], g)
            fin, F = args[0].shape[1], kw["w_pair"].shape[1]
            Fout = kw["w1"].shape[1]
            p = 4 * n * fin * F + 2 * e * F * Fout
            w, q = 2 * fin * F + F * Fout, 0
        else:
            fl, by = agg_work([(args, kw)], g)
            p = w = q = 0
        prod += p
        rest += fl - p + q
        nbytes += by - (4 - wb) * w
    return [(prod, pk), (rest, PEAK_F32_FLOPS)], nbytes


def slice_phases(report, *, dev, graphs, b0, tb, counted, zero_counts, smi):
    """The bf16 and int8 modes of rows 3, 4, 8, 12 and 13: each against
    its plain version in every layer of its path at b1024;
    ``Program(precision=...).forward`` of GCN, GIN, SAGE, LG, Simple,
    GINE, EdgeConv, Simple max and five-aggregator PNA under both
    policies on the packings the gates send to the kernels, each with its
    per-mode launch counts, its error against f32 and a small batch
    against the CPU in the same policy; row 6's generic entry against its
    plain version; the times.  Fills ``report``; returns the summary for
    the last JSON line."""
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.ops.cuda import (
        edge_block,
        ell_agg,
        ell_bwd,
        gine_layer,
        mp_block,
        mp_layer,
        scatter_bwd,
    )

    fns = {"mp_block_stack": (mp_block.fused_mp_block_stack,
                              mp_block.mp_stack_plain),
           "mp_layer": (mp_layer.fused_mp_layer, mp_layer.mp_layer_plain),
           "ell_agg": (ell_agg.fused_ell_aggregate,
                       ell_agg.ell_aggregate_plain),
           "gine_layer": (gine_layer.fused_gine_layer,
                          gine_layer.gine_layer_plain),
           "edge_block": (edge_block.fused_edge_block_layer,
                          edge_block.edge_block_layer_plain)}
    out = {}
    torch.set_grad_enabled(False)
    with phase("slice models: GCN, GIN, SAGE, LG, Simple, GINE, EdgeConv, "
               "Simple max and five-aggregator PNA, block- and "
               "standard-packed b1024"):
        _, (b128,) = canonical_batches(
            "qm9", n_graphs=BATCH_GRAPHS, batch_size=BATCH_GRAPHS,
            block_size=128, node_multiple=1024, node_dim=128, device=dev)
        _, (tb128,) = canonical_batches(
            "qm9", n_graphs=TRAIN_GRAPHS, batch_size=BATCH_GRAPHS,
            node_multiple=256, node_dim=128, device=dev)
        _, (small,) = canonical_batches(
            "qm9", n_graphs=64, batch_size=64, block_size=128,
            node_multiple=128, device="cpu")
        _, (small128,) = canonical_batches(
            "qm9", n_graphs=64, batch_size=64, block_size=128,
            node_multiple=128, node_dim=128, device="cpu")
        bats = {("block", None): b0, ("standard", None): tb,
                ("block", 128): b128, ("standard", 128): tb128}
        smalls = {None: small, 128: small128}
        models = {}
        for i, (name, (conv, kw, nd, packs)) in enumerate(
                SLICE_MODELS.items()):
            m = canonical_model(conv, "qm9", graphs=graphs,
                                conv_kwargs=dict(kw))
            p = Program(m, max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                        max_graphs=b0.num_graphs, block_size=128,
                        device=dev, seed=70 + i)
            p.init_params()
            models[name] = (m, p.params)
        log(f"{len(models)} models; batches N = block {b0.num_nodes} / "
            f"{b128.num_nodes} (128 wide), standard {tb.num_nodes} / "
            f"{tb128.num_nodes}")

    def layer_sets(name, packing):
        """{kernel: [(args, kw)] per layer} of ``name`` on ``packing``."""
        conv, _, nd, _ = SLICE_MODELS[name]
        m = models[name][0]
        g = bats[packing, nd]
        block = packing == "block"
        if conv == "gine":
            return g, {"gine_layer": gine_args(m, g)}
        if conv == "edge":
            return g, {"edge_block": edge_args(m, g)}
        if name in ("simple_max", "pna5"):
            return g, {"ell_agg": agg_args(m, g, block=block)}
        return g, {"mp_layer": mp_args(m, g, block)}

    layer_cache = {}
    with phase("slice: rows 4, 8, 12 and 13 in their modes against their "
               "plain versions in each of the 6 layers of every model and "
               "packing; row 3 in both modes per layer"):
        errs = {}
        for name, (conv, _, _, packs) in SLICE_MODELS.items():
            for packing in packs:
                if name in ("gcn", "sage") and packing == "block":
                    continue          # the stack, below
                g, sets = layer_sets(name, packing)
                for key, layers in sets.items():
                    layer_cache[name, packing, key, "f32"] = (g, layers)
                    for mode in SLICE_KERNELS[key][2]:
                        if key == "mp_layer" and mode == "int8" and (
                                layers[0][0][3] not in mp_layer.QUANT_CONVS):
                            continue
                        ls = in_mode(layers, key, mode)
                        layer_cache[name, packing, key, mode] = (g, ls)
                        fn, plain = fns[key]
                        # no rounding follows a sum inside row 8 or the
                        # elementwise convs of row 4: they agree with their
                        # plain versions to float32 rounding
                        exact = key == "ell_agg" or (
                            key == "mp_layer" and layers[0][0][3]
                            not in mp_layer.QUANT_CONVS)
                        tol = KERNEL_TOL if exact else MODE_TOL[mode]
                        worst = 0.0
                        for i, (args, kw) in enumerate(ls):
                            got = fn(*args, **kw)
                            torch.cuda.synchronize()
                            want = plain(*args, **kw)
                            m_ = g.node_mask
                            e_ = rel_err(got[m_], want[m_])
                            worst = max(worst, float(
                                (got[m_] - want[m_]).abs().max()))
                            if (not bool(torch.isfinite(got[m_]).all())
                                    or e_ > tol):
                                raise AssertionError(
                                    f"{key} {mode} ({name}, {packing}) "
                                    f"layer {i}: {e_:.3e} of max |value|")
                        errs.setdefault(f"{key}_{mode}", {})[
                            f"{name} {packing}"] = worst
                        log(f"{key} {mode} ({name}, {packing}, N="
                            f"{g.num_nodes}): 6 layers within {tol} of max "
                            f"|value|, max abs {worst:.2e}")
        for conv in ("gcn", "gin", "sage"):
            m = canonical_model(conv, "qm9", graphs=graphs).to(dev)
            p_ = models.get(conv)
            if p_ is not None:
                m.load_state_dict(p_[1])
            stacked, _ = m._kernel_params(128)
            L = m.gnn_num_layers
            for mode in PREC_MODES:
                h = torch.nn.functional.pad(
                    b0.node_feat, (0, 128 - b0.feature_dim)).contiguous()
                worst = 0.0
                for l, c in enumerate(m.gnn_convs):
                    st, sc = mp_block.prepare_mp_stack(
                        [t[l:l + 1] for t in stacked], mode)
                    args = (h, b0.block_adj, b0.in_degree, *st)
                    ekw = dict(epss=[getattr(c, "eps", 0.0)],
                               skips=[0 < l < L - 1], act=m.gnn_activation)
                    got = mp_block.fused_mp_block_stack(
                        *args, conv=conv, mode=mode, scales=sc, **ekw)
                    torch.cuda.synchronize()
                    want = mp_block.mp_stack_plain(
                        *args, conv, ekw["epss"], ekw["skips"], ekw["act"],
                        mode, sc)
                    e_ = rel_err(got, want)
                    worst = max(worst, float((got - want).abs().max()))
                    if not bool(torch.isfinite(got).all()) or \
                            e_ > MODE_TOL[mode]:
                        raise AssertionError(f"mp_block_stack {mode} {conv} "
                                             f"layer {l}: {e_:.3e}")
                    h = want.contiguous()
                errs.setdefault(f"mp_block_stack_{mode}", {})[conv] = worst
                log(f"mp_block_stack {mode} ({conv}, N={b0.num_nodes}): 6 "
                    f"layers within {MODE_TOL[mode]}, max abs {worst:.2e}")
        for k, v in errs.items():
            report[k] = dict(max_abs_err=max(v.values()), by_config=dict(
                max_abs_err=v), launches=0)

    with phase("slice: row 6's generic entry (reverse CSR, then row 7's "
               "CSR gather) against its plain version on the train batch"):
        gen = torch.Generator(device=dev).manual_seed(61)
        n_, F_ = tb.num_nodes, 128
        v_ = torch.randn(n_, F_, generator=gen, device=dev)
        nb_ = tb.nbr_nodes.long()
        cstk = torch.cat([torch.randn(n_, 3 * F_, generator=gen, device=dev),
                          v_[nb_[:, 0]], torch.randn(n_, F_, generator=gen,
                                                     device=dev)], dim=1)
        terms = dict(has_lin=True, has_dev=True, n_cmp=1)
        before = ell_bwd.fused_gather_backward_csr.launches
        got = scatter_bwd.fused_scatter_backward(
            cstk, tb.nbr_nodes, tb.in_degree, v_, **terms)
        torch.cuda.synchronize()
        launched = ell_bwd.fused_gather_backward_csr.launches - before
        want = scatter_bwd.scatter_backward_plain(
            cstk.double(), tb.nbr_nodes, tb.in_degree, v_.double(), **terms)
        ok, a_err, r_err = close_enough(got, want.float(), BWD_TOL)
        again = scatter_bwd.fused_scatter_backward(
            cstk, tb.nbr_nodes, tb.in_degree, v_, **terms)
        log(f"fused_scatter_backward (lin, dev, 1 cmp; N={n_}, F={F_}): "
            f"{r_err:.3e} of max |value| against float64 plain (tol "
            f"{BWD_TOL}); {launched} CSR gather launch; bitwise on a second "
            f"run: {bool(torch.equal(got, again))}")
        if not ok or launched != 1 or not torch.equal(got, again):
            raise AssertionError("row 6's generic entry disagrees")
        out["scatter_generic"] = dict(max_abs_err=a_err, rel_err=r_err)

    progs, fwd_err, launches = {}, {}, {}
    with phase("slice main path: Program.forward under bf16 and int8 of "
               "every model on its kernel packings, launch counts per mode"):
        for name, (conv, kw, nd, packs) in SLICE_MODELS.items():
            m0, params = models[name]
            L = m0.gnn_num_layers
            for packing in packs:
                g = bats[packing, nd]
                size = dict(max_nodes=g.num_nodes, max_edges=g.num_edges,
                            max_graphs=g.num_graphs,
                            block_size=128 if packing == "block" else 0)

                def program(prec, device=dev, **sz):
                    p_ = Program(canonical_model(conv, "qm9", graphs=graphs,
                                                 conv_kwargs=dict(kw)),
                                 precision=prec, device=device,
                                 **(sz or size))
                    p_.set_params({k: v.to(device) for k, v in
                                   params.items()})
                    return p_

                ps = {p: program(p) for p in ("f32",) + PREC_MODES}
                progs[name, packing] = ps
                ref = ps["f32"].forward(g)
                for prec in PREC_MODES:
                    zero_counts()
                    o = ps[prec].forward(g)
                    torch.cuda.synchronize()
                    want = slice_expected(name, packing, prec, L)
                    got = {k: {md: n for md, n in
                               counted[k].mode_launches.items() if n}
                           for k in SLICE_KERNELS}
                    got = {k: v for k, v in got.items() if v}
                    head = {md: n for md, n in counted[
                        "readout"].mode_launches.items() if n}
                    total = sum(fn.launches for fn in counted.values())
                    n_want = sum(sum(v.values()) for v in want.values())
                    log(f"{name} {packing} {prec}: launches {got}, readout "
                        f"{head}; all counts {total}")
                    if (got != want or head != {prec: 1}
                            or total != n_want + 1):
                        raise AssertionError(
                            f"{name} {packing} {prec}: launches {got} "
                            f"(readout {head}, total {total}); want {want}")
                    for k, v in got.items():
                        for md, n in v.items():
                            launches[k, md] = launches.get((k, md), 0) + n
                    m_ = g.graph_mask
                    if (tuple(o.shape) != (g.num_graphs, 1)
                            or not bool(torch.isfinite(o[m_]).all())):
                        raise AssertionError(f"{name} {prec}: bad output")
                    e32 = rel_err(o[m_], ref[m_])
                    sm = smalls[nd]
                    ssize = dict(max_nodes=sm.num_nodes,
                                 max_edges=sm.num_edges,
                                 max_graphs=sm.num_graphs,
                                 block_size=size["block_size"] and 128)
                    sb = sm if packing == "block" else sm.replace(
                        block_adj=None)
                    oc = program(prec, **ssize).forward(sb.to(dev)).cpu()
                    rc = program(prec, device="cpu", **ssize).forward(sb)
                    ms_ = sb.graph_mask
                    ecpu = rel_err(oc[ms_], rc[ms_])
                    fwd_err[f"{name} {packing} {prec}"] = dict(
                        vs_f32=e32, card_vs_cpu=ecpu)
                    log(f"{name} {packing} {prec}: against f32 {e32:.3e} "
                        f"of max |value| (graph_mask rows); 64 graphs, card "
                        f"vs CPU {ecpu:.3e} (tol {SLICE_CPU_TOL[prec]})")
                    if ecpu > SLICE_CPU_TOL[prec]:
                        raise AssertionError(f"{name} {packing} {prec}: "
                                             f"card disagrees with the CPU")
        for key, (_, _, modes) in SLICE_KERNELS.items():
            for mode in modes:
                n = launches.get((key, mode), 0)
                report[f"{key}_{mode}"]["launches"] = n
                if n == 0:
                    raise AssertionError(f"{key} never ran its {mode} mode "
                                         f"on the main path")
        out["error"] = fwd_err

    with phase("slice times (torch.profiler device times; CUDA events)"):
        def run(fn, ls):
            def go():
                for args, kw in ls:
                    fn(*args, **kw)
            return go

        def entry(key, mode, g, ls, per, lib=None, f32=None):
            """The launches ``ls`` in ``mode`` timed beside their plain
            version, the same launches in float32 (``f32``) and ``lib``."""
            fn, plain = fns[key]
            terms, nbytes = mode_work(key, ls, g, mode)
            b_ms, b_by = bound_mixed(terms, nbytes)
            ms, ev = timed(run(fn, ls), 10)
            if not ms:      # the profiler caught no device time: events
                ms = ev
            pms, pev = timed(run(plain, ls), 3)
            fms = timed(run(fn, f32), 10)[0] if f32 is not None else None
            lms, lev = timed(lib, 10) if lib is not None else (None, None)
            log(f"{key} {mode} per {per}: device {ms:.4f} ms (events "
                f"{ev:.4f}), plain {pms:.4f} ({pev:.4f})"
                + ("" if fms is None else f", f32 kernel {fms:.4f}")
                + ("" if lms is None else f", library {lms:.4f} ({lev:.4f})")
                + f"; bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.2%} of it)"
                f" on {smi}")
            return dict(ms=ms, event_ms=ev, plain_ms=pms, plain_event_ms=pev,
                        f32_kernel_ms=fms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lms, library_event_ms=lev,
                        flops=sum(t for t, _ in terms), bytes=nbytes,
                        per=per)

        heads = {("mp_layer", "bf16"): ("gin", "standard"),
                 ("mp_layer", "int8"): ("gin", "standard"),
                 ("gine_layer", "bf16"): ("gine", "standard"),
                 ("gine_layer", "int8"): ("gine", "standard"),
                 ("edge_block", "bf16"): ("edge", "block"),
                 ("ell_agg", "bf16"): ("simple_max", "standard")}
        for (key, mode), (name, packing) in heads.items():
            g, ls = layer_cache[name, packing, key, mode]
            by = {}
            for (n2, p2, k2, m2), (g2, ls2) in layer_cache.items():
                if (k2, m2) == (key, mode):
                    by[f"{n2} {p2}"] = entry(
                        key, mode, g2, ls2, f"one {p2}-packed "
                        f"b{BATCH_GRAPHS} {n2} forward (6 launches)",
                        f32=layer_cache[n2, p2, k2, "f32"][1])
            head = by[f"{name} {packing}"]
            if key == "ell_agg":
                # one max launch of a 128-wide layer input, whose function
                # one library call computes (f32 row 8's yardstick)
                h1 = ls[1][0][0]
                m_ = g.edge_mask
                src = h1[g.senders[m_].long()]
                idx = g.receivers[m_].long()[:, None].expand_as(src)
                z = torch.zeros_like(h1)
                one = [((h1, g.nbr_nodes, g.in_degree, ("max",)),
                        dict(mode="bf16"))]
                head = entry(key, mode, g, one, "one launch: max of a "
                             "128-wide layer input over the train batch",
                             lambda: z.scatter_reduce(0, idx, src, "amax",
                                                      include_self=False),
                             f32=[(one[0][0], {})])
            report[f"{key}_{mode}"].update(head, by_config=dict(
                report[f"{key}_{mode}"]["by_config"], times=by))
        for mode in PREC_MODES:
            by = {}
            for conv in ("gcn", "gin", "sage"):
                m = canonical_model(conv, "qm9", graphs=graphs).to(dev)
                if conv in models:
                    m.load_state_dict(models[conv][1])
                st, sc = mp_block.prepare_mp_stack(m._kernel_params(128)[0],
                                                   mode)
                L = m.gnn_num_layers
                x = torch.nn.functional.pad(
                    b0.node_feat, (0, 128 - b0.feature_dim)).contiguous()
                skw = dict(conv=conv, epss=[getattr(c, "eps", 0.0)
                                            for c in m.gnn_convs],
                           skips=[0 < i < L - 1 for i in range(L)],
                           act=m.gnn_activation, mode=mode, scales=sc)
                n, e = b0.num_nodes, int(b0.in_degree.sum())
                widths = mp_widths(m)
                fl = mp_flops(conv, n, e, widths)
                prod = sum(2 * n * i * o * (1 if conv == "gcn" else 2)
                           if conv != "gin" else 2 * n * (i * o + o * o)
                           for i, o in widths)
                quant = (sum(n * (i + o) * 4 + n * 2 * o * 2
                             for i, o in widths) if mode == "int8" else 0)
                nw = mp_weights(conv, widths)
                nbias = sum(o * (2 if conv == "gin" else 1)
                            for _, o in widths)
                nbytes = (4 * (n * widths[0][0] + n * widths[-1][1]
                               + n * 128 + n + nbias)
                          + WEIGHT_BYTES[mode] * (nw - nbias))
                b_ms, b_by = bound_mixed(
                    [(prod, MODE_PEAK[mode]),
                     (fl - prod + quant, PEAK_F32_FLOPS)], nbytes)
                ms, ev = timed(lambda: mp_block.fused_mp_block_stack(
                    x, b0.block_adj, b0.in_degree, *st, **skw), 10)
                ms = ms or ev   # events where the profiler caught nothing
                pms, pev = timed(lambda: mp_block.mp_stack_plain(
                    x, b0.block_adj, b0.in_degree, *st, conv, skw["epss"],
                    skw["skips"], skw["act"], mode, sc), 3)
                f32kw = dict(skw, mode="f32", scales=None)
                fms = timed(lambda: mp_block.fused_mp_block_stack(
                    x, b0.block_adj, b0.in_degree, *m._kernel_params(128)[0],
                    **f32kw), 10)[0]
                by[conv] = dict(ms=ms, event_ms=ev, plain_ms=pms,
                                plain_event_ms=pev, f32_kernel_ms=fms,
                                bound_ms=b_ms, bound_by=b_by,
                                flops=fl + quant, bytes=nbytes)
                log(f"mp_block_stack {mode} {conv} (one launch, 6 layers, "
                    f"N={n}): device {ms:.4f} ms (events {ev:.4f}), plain "
                    f"{pms:.4f} ({pev:.4f}), f32 kernel {fms:.4f}; bound "
                    f"{b_ms:.4f} ms by {b_by} ({b_ms / ms:.2%} of it) on "
                    f"{smi}")
            report[f"mp_block_stack_{mode}"].update(
                by["gcn"], library_ms=None, conv="gcn",
                per=f"one block-packed b{BATCH_GRAPHS} GCN stack (6 "
                    f"layers)", by_config=dict(
                        report[f"mp_block_stack_{mode}"]["by_config"],
                        times=by))
        fwd = {}
        for (name, packing), ps in progs.items():
            g = bats[packing, SLICE_MODELS[name][2]]
            row = {}
            for prec, p_ in ps.items():
                bt = p_.benchmark(g, iters=10, warmup=2)
                row[prec] = bt["latency_s"] * 1e3
            fwd[f"{name} {packing}"] = row
            log(f"Program.forward {name} {packing} b{BATCH_GRAPHS}: "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items())
                + f" on {smi}")
        out["forward_ms"] = fwd
    return out


# ---------------------------------------------------------------------------
# this slice: the bf16 mode of row 9 and the bf16 and int8 modes of row 10,
# so that canonical GAT runs its kernels under Program's policies, and
# serving (GNNServer over Program, export_bundle) at those policies

# kernel: (TPU source, line of the TPU function, the modes it has)
GAT_MODE_KERNELS = {"gat_block": ("gat_block", 164, ("bf16",)),
                    "gat_layer": ("gat_layer", 308, PREC_MODES)}
# the served configurations: (policy, block size)
SERVE_CELLS = (("bf16", 128), ("int8", 128), ("int8", 0))
SERVE_REQUESTS = 512     # QM9 graphs answered by each server
SERVE_BATCH = 64         # the micro-batch (serve_bench.py's bucket)
SERVE_BURSTS = 3         # timed bursts, each on a fresh server
SERVE_B1 = 64            # graphs timed one per synchronous forward
SERVE_WAIT_S = 300.0     # the longest wait on any request
# a served prediction against Program.forward of the same graphs, and a
# bundle's server against the live one: a graph's rows take the same
# operations in any batch, but for the float32 rounding of sums over
# other padding
SERVE_TOL = 1e-5


def count_syncs(fn):
    """(count, {"file:line": count}) of the synchronizing CUDA operations
    (a stream or device synchronize, a blocking copy between host and
    card) that PyTorch reports while ``fn()`` runs, under
    ``torch.cuda.set_sync_debug_mode("warn")``, by the Python line that
    made each."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            at = f"{os.path.basename(w.filename)}:{w.lineno}"
            where[at] = where.get(at, 0) + 1
    return sum(where.values()), where


class gc_pauses:
    """The garbage collector's pauses while the block runs, in ms, in
    ``self.ms`` (from ``gc.callbacks``, whichever thread collects)."""

    def __enter__(self):
        self.ms, self._t = [], None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.ms.append((time.perf_counter() - self._t) * 1e3)
            self._t = None

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)


def host_ms(fn, iters=5):
    """Median host wall time of ``fn()`` in ms, the card drained before
    each call and not waited for after it."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def gat_mode_work(layers, g, block, mode):
    """([(operations, peak)], bytes) of one forward's six launches of row
    9 or 10 in ``mode``: the projection's products at the mode's
    tensor-core peak (row 9b also its bf16 logit terms x . wa, 4 Fin H a
    row, in place of the 4 HC of h . att), the rest as ``gat_work`` counts
    it at the float32 peak, int8's ~4 operations per quantized value and
    2 per dequantized product too; w at the mode's width (int8 with its
    column scales, row 9b with its two [Fin, H] bf16 logit weights), every
    other input and output once in float32."""
    flops, nbytes = gat_work(layers, g, block)
    pk, wb = MODE_PEAK[mode], WEIGHT_BYTES[mode]
    n = g.num_nodes
    prod = rest = 0
    for args, _ in layers:
        fin, hc, heads = args[0].shape[1], args[-5].shape[1], args[-1]
        prod += 2 * n * fin * hc
        rest -= 2 * n * fin * hc
        if block:
            prod += 4 * n * fin * heads
            rest -= 4 * n * hc
            nbytes += 2 * 2 * fin * heads
        if mode == "int8":
            rest += 4 * n * fin + 2 * n * hc
            nbytes += 4 * hc
        nbytes -= (4 - wb) * fin * hc
    return [(prod, pk), (flops + rest, PEAK_F32_FLOPS)], nbytes


def gat_in_mode(layers, key, mode):
    """The (args, kw) of row 9's or row 10's ``layers`` with w brought to
    ``mode`` as GATConv brings it (``prepare_block``, ``prepare_layer``)."""
    from gnnbuilder_tpu_torch.ops.cuda import gat_block, gat_layer

    out = []
    for args, kw in layers:
        args, kw = list(args), dict(kw, mode=mode)
        w = args[-5]
        if key == "gat_block":
            args[-5], kw["wa_src"], kw["wa_dst"] = gat_block.prepare_block(
                w, args[-4], args[-3], mode)
        else:
            args[-5], kw["sw"] = gat_layer.prepare_layer(w, mode)
        out.append((tuple(args), kw))
    return out


def serving_phases(report, *, dev, graphs, batches, b0, tb, counted,
                   zero_counts, smi):
    """Canonical GAT (heads 4) under bf16 and int8: rows 9b, 10b and 10i
    against their plain versions in every layer at b1024;
    ``Program(precision=...).forward`` on the three block-packed batches
    and the standard-packed train batch, with its per-mode launch counts,
    its error against f32 and a 64-graph batch against the CPU; then
    ``GNNServer.from_program`` of GAT bf16 block-packed, int8 block-packed
    and int8 standard-packed answering ``SERVE_BURSTS`` bursts of
    ``SERVE_REQUESTS`` QM9 requests at micro-batches of <= 64 (buckets
    from ``Program.from_dataset``), the mode kernels' launches inside
    each server, every prediction against
    ``Program.forward`` of the same graphs, ``export_bundle`` then
    ``GNNServer.from_bundle`` giving the same predictions, sustained
    graphs/s and request latency beside one graph per synchronous
    forward; the modes' times.  Fills ``report``; returns the summary for
    the last JSON line."""
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.ops.cuda import gat_block, gat_layer
    from gnnbuilder_tpu_torch.serve import GNNServer

    fns = {"gat_block": (gat_block.fused_gat_block_layer,
                         gat_block.gat_block_layer_plain),
           "gat_layer": (gat_layer.fused_gat_layer,
                         gat_layer.gat_layer_plain)}
    kw_gat = dict(conv_kwargs=dict(heads=GAT_HEADS))
    out = {}
    torch.set_grad_enabled(False)

    def gat_model():
        return canonical_model("gat", "qm9", graphs=graphs, **kw_gat)

    with phase("GAT modes: rows 9b, 10b and 10i against their plain "
               "versions in each of the 6 layers"):
        base = Program(gat_model(), max_nodes=b0.num_nodes,
                       max_edges=b0.num_edges, max_graphs=b0.num_graphs,
                       block_size=128, device=dev, seed=83)
        params = base.init_params()
        f32_layers = {"gat_block": (b0, gat_layer_args(base.model, b0, True)),
                      "gat_layer": (tb, gat_layer_args(base.model, tb,
                                                       False))}
        mode_layers = {}
        for key, (_, _, modes) in GAT_MODE_KERNELS.items():
            g, layers = f32_layers[key]
            fn, plain = fns[key]
            for mode in modes:
                ls = gat_in_mode(layers, key, mode)
                worst = 0.0
                for i, (args, kw) in enumerate(ls):
                    got = fn(*args, **kw)
                    torch.cuda.synchronize()
                    want = plain(*args, **kw)
                    m_ = g.node_mask
                    e_ = rel_err(got[m_], want[m_])
                    worst = max(worst, float(
                        (got[m_] - want[m_]).abs().max()))
                    if (not bool(torch.isfinite(got[m_]).all())
                            or e_ > MODE_TOL[mode]):
                        raise AssertionError(f"{key} {mode} layer {i}: "
                                             f"{e_:.3e} of max |value|")
                mode_layers[key, mode] = ls
                report[f"{key}_{mode}"] = dict(max_abs_err=worst)
                log(f"{key} {mode} (N={g.num_nodes}): 6 layers within "
                    f"{MODE_TOL[mode]} of max |value|, max abs {worst:.2e}")

    def program(prec, block_size, device=dev, **size):
        g = b0 if block_size else tb
        size = size or dict(max_nodes=g.num_nodes, max_edges=g.num_edges,
                            max_graphs=g.num_graphs)
        p = Program(gat_model(), precision=prec, block_size=block_size,
                    device=device, **size)
        p.set_params({k: v.to(device) for k, v in params.items()})
        return p

    def mode_counts():
        return {k: {md: n for md, n in counted[k].mode_launches.items() if n}
                for k in (*GAT_MODE_KERNELS, "readout")}

    def want_counts(prec, block, n):
        key = "gat_block" if block and prec == "bf16" else "gat_layer"
        return {"gat_block": {}, "gat_layer": {}, key: {prec: 6 * n},
                "readout": {prec: n}}

    launches = {}
    with phase(f"main path: Program.forward of canonical GAT under bf16 and "
               f"int8 on {N_BATCHES} x {BATCH_GRAPHS}-graph block-packed "
               f"batches and the standard-packed train batch"):
        _, (small,) = canonical_batches(
            "qm9", n_graphs=64, batch_size=64, block_size=128,
            node_multiple=128, device="cpu")
        fwd_err, progs = {}, {}
        for block, bats in ((128, batches), (0, [tb])):
            packing = "block" if block else "standard"
            ps = {p: program(p, block) for p in ("f32",) + PREC_MODES}
            progs[packing] = ps
            refs = [ps["f32"].forward(b) for b in bats]
            for prec in PREC_MODES:
                zero_counts()
                outs = [ps[prec].forward(b) for b in bats]
                torch.cuda.synchronize()
                got = mode_counts()
                total = sum(fn.launches for fn in counted.values())
                want = want_counts(prec, block, len(bats))
                log(f"GAT {packing} {prec}: launches {got}; all counts "
                    f"{total}")
                if got != want or total != 7 * len(bats):
                    raise AssertionError(f"GAT {packing} {prec}: launches "
                                         f"{got}, want {want}")
                for k, v in got.items():
                    for md, n in v.items():
                        launches[k, md] = launches.get((k, md), 0) + n
                errs = []
                for b, o, r in zip(bats, outs, refs):
                    m_ = b.graph_mask
                    if (tuple(o.shape) != (b.num_graphs, 1)
                            or not bool(torch.isfinite(o[m_]).all())):
                        raise AssertionError(f"GAT {prec}: bad output")
                    errs.append(rel_err(o[m_], r[m_]))
                ssize = dict(max_nodes=small.num_nodes,
                             max_edges=small.num_edges,
                             max_graphs=small.num_graphs)
                sb = small if block else small.replace(block_adj=None)
                oc = program(prec, block, **ssize).forward(
                    sb.to(dev)).cpu()
                rc = program(prec, block, device="cpu", **ssize).forward(sb)
                ms_ = sb.graph_mask
                ecpu = rel_err(oc[ms_], rc[ms_])
                fwd_err[f"{packing} {prec}"] = dict(vs_f32=errs,
                                                   card_vs_cpu=ecpu)
                log(f"GAT {packing} {prec}: against f32 "
                    f"{[f'{e:.3e}' for e in errs]} of max |value|; 64 "
                    f"graphs, card vs CPU {ecpu:.3e} (tol "
                    f"{SLICE_CPU_TOL[prec]})")
                if ecpu > SLICE_CPU_TOL[prec]:
                    raise AssertionError(f"GAT {packing} {prec}: card "
                                         f"disagrees with the CPU")
        for key, (_, _, modes) in GAT_MODE_KERNELS.items():
            for mode in modes:
                report[f"{key}_{mode}"]["launches"] = launches[key, mode]
        out["error"] = fwd_err

    serve = {}
    requests = graphs[:SERVE_REQUESTS]
    for prec, block in SERVE_CELLS:
        packing = "block" if block else "standard"
        with phase(f"serving: GNNServer.from_program of canonical GAT "
                   f"{prec} {packing}-packed, {len(requests)} QM9 requests "
                   f"at micro-batches of <= {SERVE_BATCH}, then its "
                   f"export_bundle"):
            prog = Program.from_dataset(gat_model(), graphs,
                                        batch_size=SERVE_BATCH,
                                        block_size=block, precision=prec,
                                        device=dev)
            prog.set_params({k: v.to(dev) for k, v in params.items()})
            # the bucket's example: the largest graphs, so that the widths
            # the bundle pins (largest graph, ELL widths) cover every one
            example = prog.batch(sorted(
                graphs, key=lambda g: g.num_nodes)[-SERVE_BATCH:])
            want = torch.cat([
                prog.forward(prog.batch(requests[i:i + SERVE_BATCH]))[
                    :len(requests[i:i + SERVE_BATCH])].cpu()
                for i in range(0, len(requests), SERVE_BATCH)])
            runs = {}
            kw_srv = dict(max_batch=SERVE_BATCH, max_wait_ms=1.0)
            # a first server warms what the process keeps between servers
            # (pinned host buffers, the card's allocator); each timed burst
            # then runs on a fresh one, whose from_program warms the
            # forward (compile) before its threads start, so that its
            # counts, stats and latencies are the burst's alone
            with GNNServer.from_program(prog, example, **kw_srv) as srv:
                srv.predict(requests[:SERVE_BATCH], timeout=SERVE_WAIT_S)
            bursts = []
            for _ in range(SERVE_BURSTS):
                with GNNServer.from_program(prog, example, **kw_srv) as srv:
                    zero_counts()
                    with gc_pauses() as gcp:
                        t = time.perf_counter()
                        got = srv.predict(requests, timeout=SERVE_WAIT_S)
                        dt = time.perf_counter() - t
                    bursts.append(dict(graphs_per_s=len(requests) / dt,
                                       counts=mode_counts(),
                                       gc_ms=sum(gcp.ms),
                                       gc_max_ms=max(gcp.ms, default=0.0),
                                       **srv.stats()))
                if bursts[-1]["counts"] != want_counts(
                        prec, block, bursts[-1]["batches"]):
                    raise AssertionError(
                        f"serving {prec} {packing}: launches "
                        f"{bursts[-1]['counts']} in "
                        f"{bursts[-1]['batches']} micro-batches: the mode "
                        f"kernels did not run in every layer of every one")
                runs[f"burst {len(bursts)}"] = torch.from_numpy(got)
            # the burst of median throughput stands for the cell
            mid = sorted(bursts, key=lambda r: r["graphs_per_s"])[
                SERVE_BURSTS // 2]
            n_b, got_counts = mid["batches"], mid["counts"]
            # the served path's host work and synchronizations, one
            # 64-graph micro-batch at a time
            chunk = requests[:SERVE_BATCH]
            packed = srv._pack(chunk)
            syncs = {name: count_syncs(f) for name, f in (
                ("pack", lambda: srv._pack(chunk)),
                ("build_graph_batch", lambda: prog.batch(chunk)),
                ("forward", lambda: prog.forward(packed)))}
            host = dict(
                pack_ms=host_ms(lambda: srv._pack(chunk)),
                build_graph_batch_ms=host_ms(lambda: prog.batch(chunk)),
                forward_host_ms=host_ms(lambda: prog.forward(packed)),
                forward_ms=time_ms(lambda: prog.forward(packed), 10),
                **{f"syncs_{k}": n for k, (n, _) in syncs.items()},
                sync_lines={k: at for k, (_, at) in syncs.items() if at})
            log(f"{prec} {packing}, one micro-batch of {len(chunk)}: the "
                f"server's packing {host['pack_ms']:.3f} ms on the host "
                f"({host['syncs_pack']} syncs), build_graph_batch on the "
                f"card {host['build_graph_batch_ms']:.3f} ms "
                f"({host['syncs_build_graph_batch']} syncs), "
                f"Program.forward {host['forward_host_ms']:.3f} ms on the "
                f"host, {host['forward_ms']:.3f} ms by events "
                f"({host['syncs_forward']} syncs); syncs by line "
                f"{host['sync_lines']}")
            with tempfile.TemporaryDirectory() as d:
                prog.export_bundle(d, example)
                with GNNServer.from_bundle(d, max_batch=SERVE_BATCH,
                                           max_wait_ms=1.0,
                                           device=dev) as srv:
                    runs["bundle"] = torch.from_numpy(
                        srv.predict(requests, timeout=SERVE_WAIT_S))
            log(f"{prec} {packing}: {n_b} micro-batches (avg "
                f"{len(requests) / n_b:.1f} graphs); launches in the "
                f"server {got_counts}")
            errs = {}
            for name, r_ in runs.items():
                ref_ = want if name.startswith("burst") else runs["burst 1"]
                errs[name] = rel_err(r_, ref_)
                if (tuple(r_.shape) != tuple(ref_.shape)
                        or not bool(torch.isfinite(r_).all())
                        or errs[name] > SERVE_TOL):
                    raise AssertionError(f"serving {prec} {packing} "
                                         f"({name}): {errs[name]:.3e} of "
                                         f"max |value|")
            b1 = Program.from_dataset(gat_model(), graphs, batch_size=1,
                                      block_size=block, precision=prec,
                                      device=dev)
            b1.set_params({k: v.to(dev) for k, v in params.items()})
            one = [b1.batch([g]) for g in requests[:SERVE_B1]]
            b1.compile(one[0])
            lat = []
            for b in one:
                t1 = time.perf_counter()
                b1.forward(b).cpu()
                lat.append((time.perf_counter() - t1) * 1e3)
            row = dict(
                requests=len(requests), micro_batches=n_b,
                bucket=dict(max_nodes=prog.bucket.max_nodes,
                            max_edges=prog.bucket.max_edges,
                            max_graphs=prog.bucket.max_graphs),
                graphs_per_s=mid["graphs_per_s"], p50_ms=mid["p50_ms"],
                p90_ms=mid["p90_ms"], p99_ms=mid["p99_ms"],
                bursts=[{k: r[k] for k in ("graphs_per_s", "p50_ms",
                                           "p90_ms", "p99_ms", "gc_ms",
                                           "gc_max_ms")}
                        for r in bursts],
                b1_p50_ms=float(np.percentile(lat, 50)),
                b1_graphs_per_s=1e3 / float(np.mean(lat)),
                vs_forward=max(v for k, v in errs.items()
                               if k.startswith("burst")),
                bundle_vs_live=errs["bundle"], micro_batch=host)
            serve[f"{prec} {packing}"] = row
            log(f"{prec} {packing}: {row['graphs_per_s']:.1f} graphs/s "
                f"sustained; request latency p50 {row['p50_ms']:.3f} / p90 "
                f"{row['p90_ms']:.3f} / p99 {row['p99_ms']:.3f} ms (all "
                f"{len(requests)} submitted at once; the median of "
                f"{SERVE_BURSTS} bursts, each "
                f"{[round(r['graphs_per_s'], 1) for r in bursts]} graphs/s, "
                f"p99 {[round(r['p99_ms'], 3) for r in bursts]} ms, "
                f"garbage-collector pauses "
                f"{[round(r['gc_ms'], 3) for r in bursts]} ms, longest "
                f"{[round(r['gc_max_ms'], 3) for r in bursts]}); one "
                f"graph per synchronous forward p50 "
                f"{row['b1_p50_ms']:.3f} ms ({row['b1_graphs_per_s']:.1f} "
                f"graphs/s); predictions vs Program.forward "
                f"{row['vs_forward']:.2e}, bundle vs live "
                f"{errs['bundle']:.2e} of max |value| (tol {SERVE_TOL}) on "
                f"{smi}")
    out["serving"] = serve

    with phase("GAT mode times (torch.profiler device times; CUDA events)"):
        def run(fn, ls):
            def go():
                for args, kw in ls:
                    fn(*args, **kw)
            return go

        for (key, mode), ls in mode_layers.items():
            g, f32 = f32_layers[key]
            block = key == "gat_block"
            fn, plain = fns[key]
            terms, nbytes = gat_mode_work(ls, g, block, mode)
            b_ms, b_by = bound_mixed(terms, nbytes)
            ms, ev = timed(run(fn, gat_staged(ls, key)), 10)
            ms = ms or ev   # events where the profiler caught nothing
            pms, pev = timed(run(plain, ls), 3)
            fms = timed(run(fn, gat_staged(f32, key)), 10)[0]
            per = (f"one {'block' if block else 'standard'}-packed "
                   f"b{BATCH_GRAPHS} forward (6 launches)")
            report[f"{key}_{mode}"].update(
                ms=ms, event_ms=ev, plain_ms=pms, plain_event_ms=pev,
                f32_kernel_ms=fms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, flops=sum(t for t, _ in terms),
                bytes=nbytes, per=per)
            log(f"{key} {mode} per {per}: device {ms:.4f} ms (events "
                f"{ev:.4f}), plain {pms:.4f} ({pev:.4f}), f32 kernel "
                f"{fms:.4f}; bound {b_ms:.4f} ms by {b_by} ({b_ms / ms:.2%} "
                f"of it) on {smi}")
        fwd = {}
        for packing, ps in progs.items():
            g = b0 if packing == "block" else tb
            fwd[packing] = {p: p_.benchmark(g, iters=10, warmup=2)[
                "latency_s"] * 1e3 for p, p_ in ps.items()}
            log(f"Program.forward GAT {packing} b{BATCH_GRAPHS}: "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in
                            fwd[packing].items()) + f" on {smi}")
        out["forward_ms"] = fwd
    return out


# ---------------------------------------------------------------------------
# this slice: GAT with edge features (GATConv edge_dim, QM9's bond one-hot)
# through the edge-logit modes of rows 9 and 10

EDGE_GAT = dict(conv_kwargs=dict(heads=GAT_HEADS, edge_dim=4))
EDGE_TRAIN_STEPS = 3
# kernel: (key of its rows in the report, TPU source, line, its modes on
# the path); row 10's int8 edge mode is held against its plain version and
# timed, but no gate sends an edge conv to it
EDGE_KERNELS = {"gat_block": ("gat_block_edge", "gat_block", 164,
                              ("f32", "bf16")),
                "gat_layer": ("gat_layer_edge", "gat_layer", 308,
                              ("f32", "bf16"))}


def top_ops(prof, n_calls, k=6):
    """The ``k`` CUDA kernels with the most self device time in a
    torch.profiler run, as [(name, ms per call)] over ``n_calls``."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        rows.append((e.key[:80], (e.self_cuda_time_total if us is None
                                  else us) / 1e3 / n_calls))
    return sorted(rows, key=lambda r: -r[1])[:k]


def edge_gat_work(layers, g, block, mode="f32"):
    """([(operations, peak)], bytes) of one forward's six launches of row
    9 or 10 in its edge-logit mode: ``gat_work`` or ``gat_mode_work``,
    plus per edge and head the added term and its 4-byte load (the pairs
    the block kernel visits, the valid slots of the layer kernel: only
    those entries of the [T, H, 128, 128] table or [N, W, H] slots are
    read) and per node and head the self term."""
    n = g.num_nodes
    e = (int((g.block_adj > 0).sum()) if block
         else int(g.in_degree.sum()))
    if mode == "f32":
        flops, nbytes = gat_work(layers, g, block)
        prod = gat_products(layers, g)
        # f32-accurate products: the f32 rate or three TF32 passes
        terms = [(prod, max(PEAK_F32_FLOPS, PEAK_TF32_FLOPS / 3)),
                 (flops - prod, PEAK_F32_FLOPS)]
    else:
        terms, nbytes = gat_mode_work(layers, g, block, mode)
    for args, _ in layers:
        heads = args[-1]
        terms.append(((e + n) * heads, PEAK_F32_FLOPS))
        nbytes += 4 * (e + n) * heads
    return terms, nbytes


def edge_gat_phases(report, *, dev, graphs, b0, tgraphs, tb, target,
                    counted, zero_counts, counts, only, fresh_step, smi):
    """Canonical GAT (heads 4) with QM9's edge features (``edge_dim=4``):
    rows 9e, 9eb, 10e, 10eb and 10ei against their plain versions in each
    of the 6 layers at b1024; ``Program.forward`` on a block-packed batch
    of 1024 simple QM9 graphs (row 9e), on the raw block-packed batch
    that repeats pairs (row 10e: the block route declines it) and on the
    standard-packed train batch (row 10e), each against the plain path;
    the train step (row 10e forward, the plain layer's autograd backward):
    gradients against the float64 plain path on the kernel path's ReLU
    decisions, bitwise-equal gradients on two steps, a 3-step loss curve;
    the bf16 policy on both packings (rows 9eb, 10eb) and int8 (no GAT
    kernel: the JAX gate declines an edge conv); the times.  Fills
    ``report``; returns the summary for the last JSON line."""
    from gnnbuilder_tpu_torch import Program, train
    from gnnbuilder_tpu_torch.bench.canonical import canonical_model
    from gnnbuilder_tpu_torch.bench.grad_precision import (
        conv_output_masks,
        grads_on_relu_pattern,
    )
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.data.datasets import drop_repeated_edges
    from gnnbuilder_tpu_torch.ops import dispatch, ell
    from gnnbuilder_tpu_torch.ops.cuda import gat_block, gat_layer

    fns = {"gat_block": (gat_block.fused_gat_block_layer,
                         gat_block.gat_block_layer_plain),
           "gat_layer": (gat_layer.fused_gat_layer,
                         gat_layer.gat_layer_plain)}
    out = {}
    torch.set_grad_enabled(False)

    def edge_model(gs=graphs):
        return canonical_model("gat", "qm9", graphs=gs, **EDGE_GAT)

    def edge_counts():
        return {k: {md: n for md, n in counted[k].edge_launches.items()
                    if n} for k in fns}

    with phase("edge GAT: data, models, and rows 9e, 9eb, 10e, 10eb and "
               "10ei against their plain versions in each of the 6 layers"):
        sgraphs = drop_repeated_edges(graphs[:BATCH_GRAPHS])
        sb = build_graph_batch(sgraphs, block_size=128,
                               node_multiple=1024, device=dev)
        if sb.multigraph_static or not b0.multigraph_static:
            raise AssertionError("the simple batch repeats a pair, or the "
                                 "raw one does not")
        real = int(sb.edge_mask.sum())
        dropped = sum(g.edge_index.shape[1] for g in
                      graphs[:BATCH_GRAPHS]) - real
        log(f"simple block batch: N={sb.num_nodes} E={sb.num_edges} ({real} "
            f"real, {dropped} repeated pairs dropped) G={sb.num_graphs}; "
            f"the raw batch repeats a pair: {b0.multigraph_static}")
        prog = Program(edge_model(), max_nodes=sb.num_nodes,
                       max_edges=sb.num_edges, max_graphs=sb.num_graphs,
                       block_size=128, device=dev, seed=53)
        params = prog.init_params()
        model = prog.model
        layer_sets = {"gat_block": (sb, gat_layer_args(model, sb, True)),
                      "gat_layer": (tb, gat_layer_args(model, tb, False))}
        mode_layers, errs = {}, {}
        for key, (g, f32_layers) in layer_sets.items():
            fn, plain = fns[key]
            modes = EDGE_KERNELS[key][3] + (("int8",) if key == "gat_layer"
                                            else ())
            for mode in modes:
                ls = (f32_layers if mode == "f32"
                      else gat_in_mode(f32_layers, key, mode))
                tol = KERNEL_TOL if mode == "f32" else MODE_TOL[mode]
                worst = worst_rel = 0.0
                for i, (args, kw) in enumerate(ls):
                    got = fn(*args, **kw)
                    torch.cuda.synchronize()
                    m_ = g.node_mask
                    ok, abs_err, rel = close_enough(
                        got[m_], plain(*args, **kw)[m_], tol)
                    worst, worst_rel = max(worst, abs_err), max(worst_rel,
                                                                rel)
                    if not ok:
                        raise AssertionError(
                            f"{key} edge {mode} layer {i}: {rel:.3e} of max "
                            f"|value| against its plain version (tol {tol})")
                mode_layers[key, mode] = ls
                errs[key, mode] = worst
                log(f"{key} edge {mode} (N={g.num_nodes}): 6 layers within "
                    f"{tol} of max |value|, worst {worst_rel:.3e}, max abs "
                    f"{worst:.3e}")

    def name_of(key, mode):
        return EDGE_KERNELS[key][0] + ("" if mode == "f32" else f"_{mode}")

    launches = {}
    with phase("main path: Program.forward of canonical edge GAT on the "
               "block-packed batch of simple graphs, the raw block-packed "
               "batch and the standard-packed train batch"):
        tprog = Program(edge_model(), max_nodes=tb.num_nodes,
                        max_edges=tb.num_edges, max_graphs=tb.num_graphs,
                        device=dev)
        tprog.set_params(params)
        mprog = Program(edge_model(), max_nodes=b0.num_nodes,
                        max_edges=b0.num_edges, max_graphs=b0.num_graphs,
                        block_size=128, device=dev)
        mprog.set_params(params)
        fwd_err = {}
        for label, p_, g, key in (("simple block", prog, sb, "gat_block"),
                                  ("raw block", mprog, b0, "gat_layer"),
                                  ("standard", tprog, tb, "gat_layer")):
            zero_counts()
            o_ = p_.forward(g)
            torch.cuda.synchronize()
            got, edge = counts(), edge_counts()
            log(f"{label}: launches {got}; edge-mode launches {edge}")
            if got != only(**{key: 6}, readout=1) or edge != {
                    **dict.fromkeys(fns, {}), key: {"f32": 6}}:
                raise AssertionError(f"edge GAT {label}: every layer did "
                                     f"not take {key}'s edge mode")
            launches[key, "f32"] = launches.get((key, "f32"), 0) + 6
            dispatch.set_fused_mode("never")
            try:
                r_ = p_.forward(g)
            finally:
                dispatch.set_fused_mode("auto")
            m = g.graph_mask
            ok, abs_err, rel = close_enough(o_[m], r_[m])
            fwd_err[label] = rel
            log(f"{label}: kernels vs per-layer plain on the card: max abs "
                f"{abs_err:.3e}, {rel:.3e} of max |value| (tol {TOL})")
            if not ok or tuple(o_.shape) != (g.num_graphs, 1):
                raise AssertionError(f"edge GAT {label} forward disagrees")
        small = build_graph_batch(drop_repeated_edges(graphs[:64]),
                                  block_size=128, node_multiple=128,
                                  device="cpu")
        cpu_p = Program(edge_model(), max_nodes=small.num_nodes,
                        max_edges=small.num_edges,
                        max_graphs=small.num_graphs, block_size=128,
                        device="cpu")
        cpu_p.set_params({k: v.cpu() for k, v in params.items()})
        dispatch.set_fused_mode("never")
        try:
            ref = cpu_p.forward(small)
        finally:
            dispatch.set_fused_mode("auto")
        o_ = prog.forward(small.to(dev)).cpu()
        m = small.graph_mask
        ok, abs_err, rel = close_enough(o_[m], ref[m])
        fwd_err["64 simple graphs, card vs CPU"] = rel
        log(f"64 simple graphs: card kernels vs CPU plain path: max abs "
            f"{abs_err:.3e}, {rel:.3e} of max |value| (tol {TOL})")
        if not ok:
            raise AssertionError("edge GAT: card disagrees with the CPU")
        out["forward_error"] = fwd_err

    torch.set_grad_enabled(True)
    with phase("edge GAT training: gradients of one step against the float64 "
               "plain path, two steps from one state, and "
               f"{EDGE_TRAIN_STEPS} Adam steps against the plain path"):
        tm = edge_model(tgraphs)
        tp = Program(tm, max_nodes=tb.num_nodes, max_edges=tb.num_edges,
                     max_graphs=tb.num_graphs, device=dev, seed=59)
        st = {k: v.clone() for k, v in tp.init_params().items()}
        again = []
        for _ in range(2):
            tm.load_state_dict(st)
            step = fresh_step(tm)
            zero_counts()
            step(tb, target)
            torch.cuda.synchronize()
            got, edge = counts(), edge_counts()
            if got != only(gat_layer=6, readout=1) or edge != {
                    "gat_block": {}, "gat_layer": {"f32": 6}}:
                raise AssertionError(f"edge GAT step launches {got}, edge "
                                     f"{edge}")
            again.append(grads_of(tm))
        same = [k for k in again[0] if torch.equal(again[0][k], again[1][k])]
        log(f"launches {got}; bitwise-equal gradients {len(same)} of "
            f"{len(again[0])}")
        if len(same) != len(again[0]):
            raise AssertionError("edge GAT: two train steps from one state "
                                 "gave different gradients")
        kern = again[0]
        tm.load_state_dict(st)
        masks = conv_output_masks(tm, tb)
        mr = edge_model(tgraphs).to(dev).double()
        mr.load_state_dict({k: v.double() for k, v in st.items()})
        gb = tb.replace(node_feat=tb.node_feat.double(),
                        edge_feat=tb.edge_feat.double())
        want = grads_on_relu_pattern(mr, gb, target.double(), masks)
        del mr
        ok, abs_err, rel, k = worst_grad(kern, want)
        edge_rel = {k_: close_enough(kern[k_].double(), want[k_])[2]
                    for k_ in kern if "edge" in k_}
        log(f"gradients vs the float64 plain path on the kernel path's ReLU "
            f"decisions: worst {rel:.3e} of max |value| ({k}), max abs "
            f"{abs_err:.3e} (tol {TOL}); lin_edge / att_edge worst "
            f"{max(edge_rel.values()):.3e}")
        if not ok:
            raise AssertionError("edge GAT gradients disagree with the "
                                 "float64 plain path")
        out["gradients_worst_rel"] = rel
        out["edge_gradients_worst_rel"] = max(edge_rel.values())
        curves = {}
        for mode in ("auto", "never"):
            tm.load_state_dict(st)
            step = fresh_step(tm)
            dispatch.set_fused_mode(mode)
            try:
                if mode == "auto":
                    zero_counts()
                curves[mode] = [float(step(tb, target))
                                for _ in range(EDGE_TRAIN_STEPS)]
                torch.cuda.synchronize()
                if mode == "auto":
                    got = counts()
            finally:
                dispatch.set_fused_mode("auto")
        log(f"launches {got}; losses {curves['auto']}, plain "
            f"{curves['never']}")
        if got != only(gat_layer=6 * EDGE_TRAIN_STEPS,
                       readout=EDGE_TRAIN_STEPS):
            raise AssertionError(f"edge GAT train launches {got}")
        launches["gat_layer", "f32"] += 6 * EDGE_TRAIN_STEPS
        for i, (a, b) in enumerate(zip(curves["auto"], curves["never"])):
            if not (math.isfinite(a) and abs(a - b) <= CURVE_TOL * abs(b)):
                raise AssertionError(f"edge GAT step {i}: loss {a} against "
                                     f"plain {b}")
        out["loss_curve"], out["plain_loss_curve"] = (curves["auto"],
                                                      curves["never"])
    torch.set_grad_enabled(False)

    with phase("main path: Program.forward of canonical edge GAT under bf16 "
               "and int8 on the simple block-packed batch and the "
               "standard-packed train batch"):
        small_std = build_graph_batch(drop_repeated_edges(graphs[:64]),
                                      node_multiple=8, device="cpu")
        pol_err = {}
        for label, g, block, sm in (("block", sb, 128, small),
                                    ("standard", tb, 0, small_std)):
            f32 = (prog if block else tprog).forward(g)
            for prec in PREC_MODES:
                def program(device, g_):
                    p_ = Program(edge_model(), precision=prec,
                                 max_nodes=g_.num_nodes,
                                 max_edges=g_.num_edges,
                                 max_graphs=g_.num_graphs, block_size=block,
                                 device=device)
                    p_.set_params({k: v.to(device) for k, v in
                                   params.items()})
                    return p_

                zero_counts()
                o_ = program(dev, g).forward(g)
                torch.cuda.synchronize()
                got = {k: {md: n for md, n in getattr(
                           fn, "mode_launches", {"f32": fn.launches}).items()
                           if n} for k, fn in counted.items() if fn.launches}
                edge = edge_counts()
                key = "gat_block" if block else "gat_layer"
                want = {"readout": {prec: 1}}
                want_edge = dict.fromkeys(fns, {})
                if prec == "bf16":
                    want[key] = {prec: 6}
                    want_edge[key] = {prec: 6}
                    launches[key, prec] = launches.get((key, prec), 0) + 6
                log(f"{label} {prec}: launches {got}; edge {edge}")
                if got != want or edge != want_edge:
                    raise AssertionError(f"edge GAT {label} {prec}: "
                                         f"launches {got}, want {want}")
                m = g.graph_mask
                if not bool(torch.isfinite(o_[m]).all()):
                    raise AssertionError(f"edge GAT {label} {prec}: not "
                                         f"finite")
                oc = program(dev, sm).forward(sm.to(dev)).cpu()
                rc = program("cpu", sm).forward(sm)
                ecpu = rel_err(oc[sm.graph_mask], rc[sm.graph_mask])
                pol_err[f"{label} {prec}"] = dict(
                    vs_f32=rel_err(o_[m], f32[m]), card_vs_cpu=ecpu)
                log(f"{label} {prec}: against f32 "
                    f"{pol_err[f'{label} {prec}']['vs_f32']:.3e} of max "
                    f"|value|; 64 graphs, card vs CPU {ecpu:.3e} (tol "
                    f"{SLICE_CPU_TOL[prec]})")
                if ecpu > SLICE_CPU_TOL[prec]:
                    raise AssertionError(f"edge GAT {label} {prec}: card "
                                         f"disagrees with the CPU")
        out["policy_error"] = pol_err

    with phase("edge GAT times (torch.profiler device times; CUDA events)"):
        def run(fn, ls):
            def go():
                for args, kw in ls:
                    fn(*args, **kw)
            return go

        for (key, mode), ls in mode_layers.items():
            g, f32_layers = layer_sets[key]
            block = key == "gat_block"
            fn, plain = fns[key]
            terms, nbytes = edge_gat_work(ls, g, block, mode)
            b_ms, b_by = bound_mixed(terms, nbytes)
            ms, ev = timed(run(fn, gat_staged(ls, key)), 10)
            ms = ms or ev   # events where the profiler caught nothing
            pms, pev = timed(run(plain, ls), 3)
            # the same kernel without the edge terms, in the same call
            bare = [(a, {k: v for k, v in kw.items() if k not in (
                "edge_table", "self_extra", "edge_logits",
                "self_edge_logit")}) for a, kw in ls]
            nms = timed(run(fn, gat_staged(bare, key)), 10)[0]
            per = (f"one {'block' if block else 'standard'}-packed "
                   f"b{BATCH_GRAPHS} forward (6 launches)")
            row = dict(ms=ms, event_ms=ev, plain_ms=pms, plain_event_ms=pev,
                       no_edge_kernel_ms=nms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, max_abs_err=errs[key, mode],
                       launches=launches.get((key, mode), 0),
                       flops=sum(t for t, _ in terms), bytes=nbytes, per=per)
            log(f"{key} edge {mode} per {per}: device {ms:.4f} ms (events "
                f"{ev:.4f}), plain {pms:.4f} ({pev:.4f}), the kernel without "
                f"edge terms {nms:.4f}; bound {b_ms:.4f} ms by {b_by} "
                f"({b_ms / ms:.2%} of it) on {smi}")
            if mode in EDGE_KERNELS[key][3]:
                report[name_of(key, mode)] = row
            else:
                out["gat_layer_edge_int8_off_path"] = row

        # the edge terms GATConv forms per forward, in torch
        def terms(g, block):
            def go():
                for c in model.gnn_convs:
                    a_edge, a_self = c._edge_logits(g)
                    if block:
                        gat_block.build_block_edge_logits(
                            g.senders, g.receivers, g.edge_mask, a_edge,
                            g.num_nodes, 128)
                    else:
                        ell.ell_gather_valid(a_edge, g.nbr_edges,
                                             g.in_degree)
            return go

        from torch.profiler import ProfilerActivity, profile

        prep = {}
        for label, g, blk in (("block", sb, True), ("standard", tb, False)):
            prep[label] = dict(zip(("device_ms", "event_ms"),
                                   timed(terms(g, blk), 10)))
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    terms(g, blk)()
                torch.cuda.synchronize()
            prep[label]["top_ops_ms"] = top_ops(prof, 3)
        fwd = {label: p_.benchmark(g, iters=10, warmup=2)["latency_s"] * 1e3
               for label, p_, g in (("simple block", prog, sb),
                                    ("raw block", mprog, b0),
                                    ("standard", tprog, tb))}
        log(f"edge terms per forward (6 layers: _edge_logits and the "
            f"block table / the slot gather): {prep}; Program.forward "
            f"b{BATCH_GRAPHS}: {fwd} ms on {smi}")
        torch.set_grad_enabled(True)
        tm.load_state_dict(st)
        step = fresh_step(tm)
        step_ms = time_ms(lambda: step(tb, target), 10, warmup=3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            for _ in range(3):
                step(tb, target)
            torch.cuda.synchronize()
            wall_ms = (time.time() - t) * 1e3 / 3
        split = split_device_time(prof, 3)
        busy = sum(split.values())
        step_top = top_ops(prof, 3)
        log(f"edge GAT train step b{BATCH_GRAPHS}: {step_ms:.4f} ms (events);"
            f" device ms per step by part: "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items() if v)
            + f"; busy {busy:.4f} of {wall_ms:.4f} ms wall; top kernels "
            f"{step_top}")
        torch.set_grad_enabled(False)
        out.update(edge_terms_ms=prep, forward_ms=fwd, step_ms=step_ms,
                   device_ms_per_step=split, step_top_ops_ms=step_top,
                   profiled_wall_ms=wall_ms)
    return out


# the measurement layer on the main paths: canonical PNA under each policy
# (rows 1 / 1b / 1i and 2 / 2b / 2i) and GCN, GIN, SAGE under f32 (rows 3
# and 2; GIN's per-layer path and row 2), each on the b1024 block batches
MEASURE_CELLS = (("pna", "f32"), ("pna", "bf16"), ("pna", "int8"),
                 ("gcn", "f32"), ("gin", "f32"), ("sage", "f32"))
# the kernels a profiled replay of each conv's captured forward must show
MEASURE_KERNELS = {"pna": ("pna_block_stack_kernel", "readout_kernel"),
                   "gcn": ("mp_block_stack_kernel", "readout_kernel"),
                   "sage": ("mp_block_stack_kernel", "readout_kernel"),
                   "gin": ("readout_kernel",)}
# benchmark_inner's latency may exceed the events' per forward by at most
# this factor (the events include the host's gaps; the slope does not)
INNER_SLACK = 1.05


def replay_kernels(run):
    """{kernel name: launches} of one ``run(1)`` (a graph replay) under
    torch.profiler (retaken, up to three times, when it caught no device
    event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(1)
    torch.cuda.synchronize()
    names = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(1)
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                names[e.name] = names.get(e.name, 0) + 1
        if names:
            break
    return names


def measurement_phases(*, dev, graphs, batches, prog, mp_progs, smi):
    """``Program.benchmark_inner`` (static and dynamic: chained forwards
    replayed from CUDA graphs), ``benchmark``'s events, ``cost_analysis``,
    ``program_min_bytes``, ``profile_program`` and the energy bound per
    graph for each of ``MEASURE_CELLS`` on the b1024 block batches, with
    the checks: the same flops and bytes counted on the per-layer path
    and on the CPU, every fit resolved, the inner latency at most
    ``INNER_SLACK`` times the events' per forward, every fraction of the
    roofline at most 1, a replayed chain's last forward within TOL of an
    eager one on each batch, the path's kernels in a profiled replay, and
    a warm forward raising nothing under
    ``torch.cuda.set_sync_debug_mode("error")``.  Prints one
    ``measurement`` JSON line per cell; returns {cell: results}."""
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import canonical_model
    from gnnbuilder_tpu_torch.bench.energy import (
        card_tdp_w,
        energy_bound_j_per_graph,
    )
    from gnnbuilder_tpu_torch.bench.roofline import (
        program_min_bytes,
        roofline_report,
    )
    from gnnbuilder_tpu_torch.ops import dispatch
    from gnnbuilder_tpu_torch.utils.profiling import profile_program

    b0 = batches[0]
    tdp = card_tdp_w()
    results = {}
    for conv, policy in MEASURE_CELLS:
        cell = f"{conv} {policy}"
        with phase(f"measurement: {cell} block b{BATCH_GRAPHS} (inner chain "
                   f"in CUDA graphs, events, cost, roofline, energy)"):
            p = prog if conv == "pna" else mp_progs[conv]
            if policy != "f32":
                p = Program(canonical_model(conv, "qm9", graphs=graphs),
                            max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                            max_graphs=b0.num_graphs, block_size=128,
                            precision=policy, device="cuda")
                p.set_params(prog.params)
            p.forward(b0)
            torch.cuda.synchronize()
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                p.forward(b0)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            torch.cuda.synchronize()
            errs, kernels = [], {}
            carry = torch.zeros((), device=dev)
            for i, b in enumerate(batches):
                with p._captured_chain(b, 2, carry) as (run, out):
                    run(1)
                    torch.cuda.synchronize()
                    got = out.clone()
                    if i == 0:
                        kernels = replay_kernels(run)
                want = p.forward(b)
                m = b.graph_mask
                ok, _, rel = close_enough(got[m], want[m])
                errs.append(rel)
                if not ok:
                    raise AssertionError(f"{cell}: a replayed chain's last "
                                         f"forward on batch {i} is {rel:.3e} "
                                         f"of max off an eager one")
            # the path's kernels among a replay's launches
            found = {w: sum(n for k, n in kernels.items() if w in k)
                     for w in MEASURE_KERNELS[conv]}
            if not all(found.values()):
                raise AssertionError(f"{cell}: a profiled replay launched "
                                     f"{found} of {sum(kernels.values())} "
                                     f"kernels: {sorted(kernels)}")
            inner = p.benchmark_inner(b0, iters=20, repeats=5)
            inner_dyn = p.benchmark_inner(b0, iters=20, repeats=5,
                                          dynamic=True)
            ev = p.benchmark(b0, iters=20, warmup=3)
            cost = p.cost_analysis(b0)
            # the count is the route's and the device's alike: the per-layer
            # plain path on the card, and the same Program on the CPU
            cpu = Program(canonical_model(conv, "qm9", graphs=graphs),
                          max_nodes=b0.num_nodes, max_edges=b0.num_edges,
                          max_graphs=b0.num_graphs, block_size=128,
                          precision=policy, device="cpu")
            cpu.set_params({k: v.cpu() for k, v in p.params.items()})
            dispatch.set_fused_mode("never")
            try:
                others = [p.cost_analysis(b0),
                          cpu.cost_analysis(b0.to("cpu"))]
            finally:
                dispatch.set_fused_mode("auto")
            for c_ in others:
                if (c_["flops"], c_["bytes accessed"]) != (
                        cost["flops"], cost["bytes accessed"]):
                    raise AssertionError(f"{cell}: cost_analysis differs by "
                                         f"route or device: {c_} {cost}")
            min_bytes = program_min_bytes(p, b0)
            prof = profile_program(p, b0, iters=20)
            graphs_ = int(b0.graph_mask.sum())
            edges_ = int(b0.edge_mask.sum())
            roof_inner = roofline_report(
                inner["latency_s"], flops=cost["flops"],
                min_bytes=min_bytes, xla_bytes=cost["bytes accessed"],
                num_edges=edges_, device=dev)
            res = dict(
                cell=cell, batch_graphs=BATCH_GRAPHS, nodes=b0.num_nodes,
                real_edges=edges_, smi=smi,
                inner={k: inner[k] for k in ("latency_s", "overhead_s",
                                             "resolved", "times_s")},
                inner_dynamic={k: inner_dyn[k] for k in (
                    "latency_s", "overhead_s", "resolved", "times_s")},
                events_latency_s=ev["latency_s"],
                flops=cost["flops"], bytes_accessed=cost["bytes accessed"],
                peak_hbm_bytes=cost["peak_hbm_bytes"],
                temp_size_in_bytes=cost["temp_size_in_bytes"],
                min_bytes=min_bytes,
                fraction_of_roofline=prof["fraction_of_roofline"],
                fraction_of_roofline_inner=roof_inner[
                    "fraction_of_roofline"],
                bound=prof["bound"],
                power_limit_w=tdp,
                energy_bound_j_per_graph=energy_bound_j_per_graph(
                    inner["latency_s"] / graphs_, tdp),
                chain_vs_eager=errs, replay_kernels=found,
                replay_launches=sum(kernels.values()))
            print("measurement " + json.dumps(res), flush=True)
            for name, r in (("static", inner), ("dynamic", inner_dyn)):
                if not r["resolved"]:
                    raise AssertionError(f"{cell}: benchmark_inner "
                                         f"({name}) unresolved: {r}")
                if r["latency_s"] > INNER_SLACK * ev["latency_s"]:
                    raise AssertionError(
                        f"{cell}: benchmark_inner ({name}) "
                        f"{r['latency_s']:.6e} s > {INNER_SLACK} x the "
                        f"events' {ev['latency_s']:.6e} s")
            for name, f in (("events", prof["fraction_of_roofline"]),
                            ("inner", roof_inner["fraction_of_roofline"])):
                if not f <= 1.0:
                    raise AssertionError(f"{cell}: fraction of roofline "
                                         f"({name}) {f} > 1")
            log(f"{cell}: inner {inner['latency_s'] * 1e3:.4f} ms "
                f"(dynamic {inner_dyn['latency_s'] * 1e3:.4f}, overhead "
                f"{inner['overhead_s'] * 1e3:.4f} ms a call), events "
                f"{ev['latency_s'] * 1e3:.4f} ms; {cost['flops']:.4e} flops, "
                f"{cost['bytes accessed']:.4e} bytes accessed, peak HBM "
                f"{cost['peak_hbm_bytes']:.4e}, min bytes {min_bytes:.4e}; "
                f"roofline {prof['fraction_of_roofline']:.4f} (events), "
                f"{roof_inner['fraction_of_roofline']:.4f} (inner); energy "
                f"<= {res['energy_bound_j_per_graph']:.4e} J/graph ({smi})")
            results[cell] = res
    return results


# the trainer and verification phase: loader steps, remat steps, the
# golden checks over this many QM9 graphs
LOADER_STEPS = 4
REMAT_CONVS = (("pna", {}), ("gat", {"heads": GAT_HEADS}), ("gine", {}))
GOLDEN_GRAPHS = 64
# the nine convs of the golden check: name -> (conv, conv_kwargs)
GOLDEN_CONVS = {"gcn": ("gcn", {}), "gin": ("gin", {}),
                "gine": ("gine", {}), "sage": ("sage", {}),
                "pna": ("pna", None), "gat": ("gat", {}),
                "gat-edge": ("gat", {"edge_dim": 4}), "edge": ("edge", {}),
                "lg": ("lg", {}), "simple": ("simple", {})}
# parity MAE against CPU goldens, of max |golden|
PARITY_TOL = 1e-5


def batch_diff(a, b):
    """The first field of two GraphBatches that differs (dtype, shape,
    bits or static value), else None; tensors compared on ``b``'s
    device."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            if (x is None or y is None or x.dtype != y.dtype
                    or x.shape != y.shape
                    or not torch.equal(x.to(y.device), y)):
                return f.name
        elif x != y:
            return f.name
    return None


def plain_packing():
    """A context in which ``core.packing`` runs its numpy plain versions
    in place of the native packer (for the before / after times)."""
    import contextlib
    from unittest import mock

    from gnnbuilder_tpu_torch.core import packing

    stack = contextlib.ExitStack()
    for name in ("concat_graphs", "sort_and_csr", "build_ell"):
        stack.enter_context(mock.patch.object(
            packing, name, getattr(packing, f"{name}_plain")))
    return stack


def trainer_verify_phases(*, dev, graphs, batches, b0, prog, tgraphs, tb,
                          target, state0, fresh_step, zero_counts, counts,
                          only, smi, native_build_s):
    """The trainer's pieces and golden verification on the card, each
    result on a ``trainer_verify`` JSON line; returns them all.

    * native packer: its build seconds; the three b1024 block batches and
      the standard train batch packed by it bit-equal to the numpy path
      and to the batches the run packed; host ms per b1024 batch and per
      64-graph serving micro-batch for both;
    * loader: canonical PNA takes ``LOADER_STEPS`` b1024 standard-packed
      Adam steps fed by ``GraphLoader`` (shuffled, two epochs of the
      3,072 block graphs) and as many fed the same chunks packed
      directly: every batch field, the losses and the weights after bit
      for bit, the host syncs of a step the same; step ms both ways and
      the producer's pack ms per batch;
    * remat: PNA, GAT and GINE b1024 steps with ``remat=True`` against
      ``False``: the loss and every gradient bit for bit, the layer
      kernels replayed in the backward; peak allocated bytes and step ms
      of both;
    * ``no_fused``: a PNA block forward inside launches no kernel, outside
      rows 1 and 2 as before; the outputs within TOL;
    * golden: a ``verify.torch_ref`` model of each of the nine convs at
      canonical widths, its weights ported by ``verify.port`` into a card
      ``Program`` (block-packed ``GOLDEN_GRAPHS`` QM9 graphs), its forward
      within TOL of the torch_ref forward on the CPU; canonical PNA's
      ``gen_testbench_data`` from a CPU Program, ``run_parity_check`` on
      the card, the MAE at most ``PARITY_TOL`` of max |golden|."""
    import dataclasses

    from gnnbuilder_tpu_torch import Program, train
    from gnnbuilder_tpu_torch.bench.canonical import canonical_model
    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.data.loader import GraphLoader
    from gnnbuilder_tpu_torch.nn.model import GNNModel
    from gnnbuilder_tpu_torch.ops import dispatch
    from gnnbuilder_tpu_torch.utils.stats import compute_pna_delta
    from gnnbuilder_tpu_torch.verify import golden
    from gnnbuilder_tpu_torch.verify import port as vport
    from gnnbuilder_tpu_torch.verify import torch_ref

    out = {}

    def emit(part, res):
        res = dict(part=part, smi=smi, **res)
        print("trainer_verify " + json.dumps(res), flush=True)
        out[part] = res

    with phase("native packer: bit-equal to the numpy path, host ms per "
               "batch"):
        def pack(gs, b, **kw):
            return build_graph_batch(
                gs, node_budget=b.num_nodes, edge_budget=b.num_edges,
                graph_budget=b.num_graphs, device="cpu", **kw)

        cases = [(f"block b{BATCH_GRAPHS} #{i}",
                  graphs[i * BATCH_GRAPHS:(i + 1) * BATCH_GRAPHS], b,
                  dict(block_size=128)) for i, b in enumerate(batches)]
        cases.append((f"standard train b{BATCH_GRAPHS}",
                      tgraphs[:BATCH_GRAPHS], tb, dict(node_multiple=256)))
        per_batch = {}
        for name, gs, b, kw in cases:
            native = pack(gs, b, **kw)
            with plain_packing():
                plain = pack(gs, b, **kw)
            for what, other in (("numpy", plain), ("the run's", b)):
                diff = batch_diff(native, other)
                if diff is not None:
                    raise AssertionError(f"native packing of {name}: "
                                         f"{diff} differs from {what} "
                                         f"batch")
            t_native = host_ms(lambda: pack(gs, b, **kw), iters=3)
            with plain_packing():
                t_plain = host_ms(lambda: pack(gs, b, **kw), iters=3)
            per_batch[name] = dict(native_ms=t_native, numpy_ms=t_plain)
            log(f"packing {name}: native {t_native:.3f} ms, numpy "
                f"{t_plain:.3f} ms on the host; bit-equal")
        micro = {}
        for name, kw in (("standard", {}), ("block", dict(block_size=128))):
            gs = graphs[:64]
            t_native = host_ms(lambda: build_graph_batch(gs, device="cpu",
                                                         **kw))
            with plain_packing():
                t_plain = host_ms(lambda: build_graph_batch(
                    gs, device="cpu", **kw))
            micro[name] = dict(native_ms=t_native, numpy_ms=t_plain)
            log(f"serving micro-batch of 64 ({name}): native "
                f"{t_native:.3f} ms, numpy {t_plain:.3f} ms")
        emit("native_packer", dict(build_s=native_build_s,
                                   per_b1024_batch=per_batch,
                                   per_64_graph_micro_batch=micro))

    with phase(f"GraphLoader: {LOADER_STEPS} PNA b{BATCH_GRAPHS} steps fed "
               f"by the loader against the same chunks fed directly"), \
            torch.enable_grad():
        lkw = dict(batch_size=BATCH_GRAPHS, shuffle=True, seed=0,
                   node_multiple=256, device=dev)
        loader = GraphLoader(graphs, **lkw)
        twin = GraphLoader(graphs, **lkw)
        chunks = twin._chunks()
        twin._epoch = 1
        chunks = (chunks + twin._chunks())[:LOADER_STEPS]

        def direct(c):
            return (build_graph_batch(
                c, node_budget=loader.node_budget,
                edge_budget=loader.edge_budget,
                graph_budget=loader.graph_budget, node_multiple=256,
                device=dev),
                train.stack_targets(c, loader.graph_budget, device=dev))

        fed = [direct(c) for c in chunks]

        def pna():
            m = canonical_model("pna", "qm9", graphs=tgraphs).to(dev)
            m.load_state_dict(state0)
            return m

        pack_s = []

        def epochs():
            while True:
                yield from loader.epoch()
                pack_s.extend(loader.pack_seconds)

        ma, mb = pna(), pna()
        sa, sb = fresh_step(ma), fresh_step(mb)
        def timed_steps(step, batches):
            """(losses, host ms of each step to the card's end)."""
            losses, ms = [], []
            torch.cuda.synchronize()
            for b, y in batches:
                t = time.perf_counter()
                losses.append(step(b, y))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            return losses, ms

        it = epochs()
        got = []

        def from_loader():
            for _ in range(LOADER_STEPS):
                got.append(next(it))
                yield got[-1]

        torch.cuda.synchronize()
        t = time.perf_counter()
        la, ms_loader = timed_steps(sa, from_loader())
        loader_ms = (time.perf_counter() - t) * 1e3 / LOADER_STEPS
        it.close()
        pack_ms = [s * 1e3 for s in pack_s + loader.pack_seconds]
        lb, ms_direct = timed_steps(sb, fed)
        direct_ms = sum(ms_direct) / LOADER_STEPS
        for i, ((b, y), (db, dy)) in enumerate(zip(got, fed)):
            diff = batch_diff(b, db)
            if diff is not None or not torch.equal(y, dy):
                raise AssertionError(f"loader batch {i}: {diff or 'target'}"
                                     f" differs from build_graph_batch's")
        if not all(torch.equal(x, z) for x, z in zip(la, lb)):
            raise AssertionError(f"loader-fed losses {la} differ from the "
                                 f"directly fed {lb}")
        for (k, p), q in zip(ma.named_parameters(), mb.parameters()):
            if not torch.equal(p, q):
                raise AssertionError(f"loader-fed weights differ: {k}")
        # the host syncs of one step, fed by the loader (the copy of its
        # next batch included) and fed a batch already on the card
        it = epochs()
        next(it)
        n_loader, at_loader = count_syncs(lambda: sa(*next(it)))
        it.close()
        fresh = direct(chunks[1])
        n_direct, at_direct = count_syncs(lambda: sb(*fresh))
        if n_loader != n_direct:
            raise AssertionError(f"a loader-fed step syncs {n_loader} times "
                                 f"({at_loader}), a direct one {n_direct} "
                                 f"({at_direct})")
        emit("loader", dict(
            steps=LOADER_STEPS, losses=[float(x) for x in la],
            step_ms_loader=loader_ms, step_ms_direct=direct_ms,
            each_step_ms_loader=ms_loader, each_step_ms_direct=ms_direct,
            producer_pack_ms=pack_ms, syncs_per_step=n_loader,
            sync_lines=at_loader, budgets=[loader.node_budget,
                                           loader.edge_budget,
                                           loader.graph_budget]))
        log(f"loader: {LOADER_STEPS} steps bit-equal (losses "
            f"{[round(float(x), 6) for x in la]}), {loader_ms:.3f} ms a "
            f"step fed by the loader (each {np.round(ms_loader, 3)}, the "
            f"wait for its batch included), {direct_ms:.3f} ms fed directly "
            f"(each {np.round(ms_direct, 3)}); the producer packs "
            f"{np.round(pack_ms, 3)} ms a batch; "
            f"{n_loader} host syncs a step both ways ({smi})")
        del got, fed, ma, mb, sa, sb

    with phase(f"remat: PNA, GAT and GINE b{BATCH_GRAPHS} steps with and "
               f"without"), torch.enable_grad():
        def grads(m):
            m.zero_grad(set_to_none=True)
            loss = train.masked_mse_loss(m(tb), target, tb.graph_mask)
            loss.backward()
            return loss.detach(), {k: p.grad for k, p in
                                   m.named_parameters()}

        remat = {}
        for conv, ck in REMAT_CONVS:
            torch.manual_seed(0)
            ms = [canonical_model(conv, "qm9", graphs=tgraphs,
                                  conv_kwargs=dict(ck), remat=r).to(dev)
                  for r in (False, True)]
            ms[1].load_state_dict(ms[0].state_dict())
            res, launch = [], []
            for m in ms:
                zero_counts()
                res.append(grads(m))
                torch.cuda.synchronize()
                launch.append({k: v for k, v in counts().items() if v})
            (l0, g0), (l1, g1) = res
            bad = [k for k in g0 if not torch.equal(g0[k], g1[k])]
            if not torch.equal(l0, l1) or bad:
                raise AssertionError(f"remat {conv}: loss {float(l0)} / "
                                     f"{float(l1)}, gradients differ: {bad}")
            layer = {"pna": "pna_layer", "gat": "gat_layer",
                     "gine": "gine_layer"}[conv]
            if not launch[1].get(layer, 0) > launch[0].get(layer, 0) > 0:
                raise AssertionError(f"remat {conv}: {layer} launched "
                                     f"{launch} (plain, remat): the replay "
                                     f"ran no layer kernel")
            row = dict(launches_plain=launch[0], launches_remat=launch[1])
            n_grads = len(g0)
            del res, g0, g1, l0, l1
            for name, m in zip(("plain", "remat"), ms):
                m.zero_grad(set_to_none=True)
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                grads(m)
                torch.cuda.synchronize()
                row[f"peak_bytes_{name}"] = (torch.cuda.max_memory_allocated()
                                             - base)
                step = fresh_step(m)
                row[f"step_ms_{name}"] = time_ms(lambda: step(tb, target),
                                                 iters=3, warmup=1)
            remat[conv] = row
            log(f"remat {conv}: loss and {n_grads} gradients bit-equal; "
                f"launches {launch[0]} plain, {launch[1]} remat; peak "
                f"{row['peak_bytes_plain'] / 2**20:.1f} MiB plain, "
                f"{row['peak_bytes_remat'] / 2**20:.1f} MiB remat above the "
                f"resident; step {row['step_ms_plain']:.3f} ms plain, "
                f"{row['step_ms_remat']:.3f} ms remat ({smi})")
            del ms
        emit("remat", remat)

    with phase("no_fused: a PNA block forward launches no kernel inside"):
        zero_counts()
        with_k = prog.forward(b0)
        torch.cuda.synchronize()
        c_k = counts()
        zero_counts()
        with dispatch.no_fused():
            without = prog.forward(b0)
        torch.cuda.synchronize()
        c_p = counts()
        m = b0.graph_mask
        ok, _, rel = close_enough(without[m], with_k[m])
        if (c_k != only(pna_block_stack=1, readout=1) or c_p != only()
                or not ok):
            raise AssertionError(f"no_fused: launches {c_k} outside, {c_p} "
                                 f"inside, outputs {rel:.3e} of max apart")
        emit("no_fused", dict(launches_outside={k: v for k, v in c_k.items()
                                                if v},
                              launches_inside=sum(c_p.values()),
                              rel_err=rel))
        log(f"no_fused: no launch inside, rows 1 and 2 outside; outputs "
            f"{rel:.3e} of max apart")

    with phase(f"golden: torch_ref models of the nine convs ported into "
               f"card Programs, {GOLDEN_GRAPHS} QM9 graphs; PNA's goldens "
               f"from the CPU, parity on the card"):
        delta = compute_pna_delta(tgraphs)
        base = [g for g in graphs[:GOLDEN_GRAPHS]]
        conv_rows, pna_prog = {}, None
        for name, (conv, ck) in GOLDEN_CONVS.items():
            same = conv in ("lg", "simple")
            fin = 128 if same else base[0].x.shape[1]
            gs = [dataclasses.replace(g, x=np.pad(
                g.x, ((0, 0), (0, fin - g.x.shape[1])))) for g in base]
            kw = dict(graph_input_feature_dim=fin, gnn_hidden_dim=128,
                      gnn_num_layers=6, gnn_output_dim=128 if same else 64,
                      gnn_conv=conv, gnn_skip_connection=True,
                      graph_input_edge_dim=4,
                      pooling_aggrs=("add", "mean", "max"),
                      mlp_hidden_dim=64, mlp_hidden_layers=4, mlp_out_dim=1,
                      conv_kwargs={"delta": delta} if ck is None else ck)
            torch.manual_seed(0)
            tm = torch_ref.TorchGNNModel(**kw)
            offs = np.cumsum([0] + [g.x.shape[0] for g in gs])
            with torch.no_grad():
                want = tm(torch.from_numpy(np.concatenate([g.x for g in gs])),
                          torch.from_numpy(np.concatenate(
                              [g.edge_index + o for g, o in zip(gs, offs)],
                              axis=1)),
                          torch.from_numpy(np.repeat(
                              np.arange(len(gs)), np.diff(offs))),
                          num_graphs=len(gs),
                          edge_attr=torch.from_numpy(np.concatenate(
                              [g.edge_attr for g in gs])))
            p = Program.from_dataset(GNNModel(**kw), gs, batch_size=len(gs),
                                     block_size=128, device="cuda")
            p.set_params(vport.port_model(conv, tm))
            b = p.batch(gs)
            zero_counts()
            got = p.forward(b)[:len(gs)].cpu()
            launches = {k: v for k, v in counts().items() if v}
            ok, _, rel = close_enough(got, want)
            conv_rows[name] = dict(rel_err=rel, launches=launches)
            log(f"golden {name}: the card's Program.forward {rel:.3e} of "
                f"max off torch_ref (launches {launches})")
            if not ok:
                raise AssertionError(f"golden {name}: {rel:.3e} of max off "
                                     f"torch_ref")
            if conv == "pna":
                pna_kw, pna_params = kw, {k: v.cpu() for k, v in
                                          p.params.items()}
        bucket = dict(max_nodes=256, max_edges=512, max_graphs=2,
                      block_size=128)
        cpu_p = Program(GNNModel(**pna_kw), device="cpu", **bucket)
        cpu_p.set_params(pna_params)
        card_p = Program(GNNModel(**pna_kw), device="cuda", **bucket)
        card_p.set_params(pna_params)
        with tempfile.TemporaryDirectory() as d:
            t = time.time()
            info = cpu_p.gen_testbench_data(base, d)
            gen_s = time.time() - t
            gmax = max(float(np.abs(o).max())
                       for o in golden.load_golden_outputs(d))
            zero_counts()
            t = time.time()
            rep = card_p.run_parity_check(base, d)
            parity_s = time.time() - t
            launches = {k: v for k, v in counts().items() if v}
        mae = rep["model_output_mae"]
        emit("golden", dict(convs=conv_rows, pna_parity=dict(
            num_graphs=rep["num_graphs"], mae=mae, max_abs_golden=gmax,
            mae_of_max=mae / gmax, out_dim=info["out_dim"],
            gen_testbench_s=gen_s, parity_s=parity_s, launches=launches)))
        log(f"golden PNA: run_parity_check on the card against CPU goldens "
            f"of {rep['num_graphs']} graphs: MAE {mae:.3e} ({mae / gmax:.3e}"
            f" of max |golden| {gmax:.3e}); launches {launches}")
        if (rep["num_graphs"] != len(base) or not mae <= PARITY_TOL * gmax
                or launches.get("pna_block_stack") != len(base)
                or launches.get("readout") != len(base)):
            raise AssertionError(f"golden PNA parity: {rep}, launches "
                                 f"{launches}")
    return out


# the parallel phase: a world of 1 over NCCL in this process, then a
# world of 2 over gloo on the one card in two spawned processes
PAR_STEPS = 3
PAR_CONVS = ("gcn", "gin", "sage", "gat")
PAR_WORLD = 2
PAR_TIMEOUT_S = 300


def _par_model(conv, tgraphs, dev, state=None):
    """A canonical model on the card with ``state`` (or its own seeded
    weights) and that state."""
    from gnnbuilder_tpu_torch import Program
    from gnnbuilder_tpu_torch.bench.canonical import canonical_model

    kw = dict(conv_kwargs=dict(heads=GAT_HEADS)) if conv == "gat" else {}
    m = canonical_model(conv, "qm9", graphs=tgraphs, **kw).to(dev)
    if state is None:
        p = Program(m, max_nodes=8, max_edges=8, max_graphs=2, device=dev,
                    seed=53)
        state = {k: v.clone() for k, v in p.init_params().items()}
    m.load_state_dict(state)
    return m, state


def _halo_window_stats(sb, h, mesh):
    """(sum |left halo|, sum |right halo|, valid ELL slots whose sender
    lies in a halo) of this rank's window."""
    from gnnbuilder_tpu_torch.ops import ell
    from gnnbuilder_tpu_torch.parallel.halo import halo_exchange

    xw = halo_exchange(sb.node_feat, h, "dp", mesh)
    n = sb.num_nodes
    base = mesh.index("dp") * n
    ids = sb.nbr_nodes.long()
    valid = ell.ell_mask(sb.nbr_nodes, sb.in_degree)
    outside = valid & ((ids < base) | (ids >= base + n))
    return (float(xw[:h].abs().sum()), float(xw[-h:].abs().sum()),
            int(outside.sum()))


def _gloo_rank(rank, world, init_file, state0, q):
    """One rank of the two-rank gloo world on the one card: canonical PNA's
    halo forward and one halo Adam step on dp = 2 (the library already
    built by the parent), its launch counts and its window's halos."""
    try:
        import torch.distributed as dist

        from gnnbuilder_tpu_torch import train
        from gnnbuilder_tpu_torch.bench.canonical import canonical_batches
        from gnnbuilder_tpu_torch.ops.cuda import (
            ell_bwd,
            pna_layer,
            readout,
            scatter_bwd,
        )
        from gnnbuilder_tpu_torch.parallel.mesh import make_mesh
        from gnnbuilder_tpu_torch.parallel.sharding import shard_batch
        from gnnbuilder_tpu_torch.parallel.train import (
            _halo_size,
            make_sharded_forward,
            make_sharded_train_step,
        )

        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        mesh = make_mesh(device_type="cuda")
        tgraphs, (tb,) = canonical_batches(
            "qm9", n_graphs=TRAIN_GRAPHS, batch_size=BATCH_GRAPHS,
            node_multiple=256, device="cpu")
        dev = mesh.device
        model, _ = _par_model("pna", tgraphs, dev, state0)
        target = train.stack_targets(tgraphs[:BATCH_GRAPHS], tb.num_graphs,
                                     device=dev)
        sb = shard_batch(mesh, tb, halo=True)
        h = _halo_size(tb, mesh)
        kernels = {"pna_layer": pna_layer.fused_pna_layer,
                   "pna_scatter_bwd": scatter_bwd.fused_pna_scatter_cstk,
                   "ell_gather_bwd_csr": ell_bwd.fused_gather_backward_csr,
                   "ell_gather_bwd": ell_bwd.fused_gather_backward,
                   "readout": readout.fused_readout}

        def zero():
            for fn in kernels.values():
                fn.launches = 0

        def launched():
            return {k: fn.launches for k, fn in kernels.items()}

        with torch.no_grad():
            left, right, into = _halo_window_stats(sb, h, mesh)
            fwd = make_sharded_forward(model, mesh, tb, halo=True)
            zero()
            out = fwd(None, sb)
            torch.cuda.synchronize()
            fwd_counts = launched()
        step, init = make_sharded_train_step(
            model, lambda ps: torch.optim.Adam(ps, lr=1e-3), mesh, tb,
            halo=True)
        with torch.enable_grad():
            p, o = init(state0)
            zero()
            p, o, loss = step(p, o, sb, target)
            torch.cuda.synchronize()
            step_counts = launched()
        # numpy, pickled by value: a torch tensor would travel as a
        # shared-memory handle that dies with this process
        res = dict(out=out.cpu().numpy(), loss=float(loss),
                   grads={k: v.grad.cpu().numpy() for k, v in p.items()},
                   fwd_counts=fwd_counts, step_counts=step_counts,
                   halo_sums=(left, right), into_halo=into,
                   n_local=sb.num_nodes, halo=h)
        dist.barrier()
        dist.destroy_process_group()
        q.put((rank, res, None))
    except BaseException:
        import traceback

        q.put((rank, None, traceback.format_exc()))


def _gloo_world(state0, target=None):
    """Spawn the gloo world of ``target`` (``_gloo_rank`` when None; each
    rank gets ``state0`` on the CPU, or None), wait for every rank (with
    a time limit) and return their results; on any failure terminate the
    ranks and raise."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="gnnb_gloo_")
    init_file = os.path.join(tmp, "pg")
    cpu_state = (None if state0 is None else
                 {k: v.detach().cpu() for k, v in state0.items()})
    procs = [ctx.Process(target=target or _gloo_rank,
                         args=(r, PAR_WORLD, init_file, cpu_state, q))
             for r in range(PAR_WORLD)]
    for p_ in procs:
        p_.start()
    deadline = time.time() + PAR_TIMEOUT_S
    results = [None] * PAR_WORLD
    try:
        for _ in range(PAR_WORLD):
            try:
                rank, res, err = q.get(
                    timeout=max(deadline - time.time(), 1.0))
            except queue_mod.Empty:
                raise AssertionError(f"gloo world: no result within "
                                     f"{PAR_TIMEOUT_S} s")
            if err is not None:
                raise AssertionError(f"gloo rank {rank} failed:\n{err}")
            results[rank] = res
        for p_ in procs:
            p_.join(timeout=max(deadline - time.time(), 1.0))
            if p_.exitcode != 0:
                raise AssertionError(f"gloo rank exited with "
                                     f"{p_.exitcode}")
    finally:
        for p_ in procs:
            if p_.is_alive():
                p_.terminate()
                p_.join(timeout=10)
    return results


def parallel_phases(*, dev, tgraphs, tb, target, state0, fresh_step,
                    zero_counts, counts, only, smi):
    """``gnnbuilder_tpu_torch.parallel`` on the card; returns the
    ``parallel`` report and its ``kernels`` entry.

    (a) a world of 1 over NCCL in this process: canonical PNA's halo
        forward (row 5 on the window in each layer) against
        ``Program.forward`` of the same weights; row 5 against its plain
        version on each layer's window; three halo Adam steps (rows 5, 6
        and 7's CSR mode on the window; its reverse CSR built once a
        step) against ``make_train_step``: the losses against its own
        three Adam steps, every gradient against its gradient at the same
        weights, and two runs bit for bit; the all-gather strategy (``halo=False``,
        no kernel) against the plain path; one forward and one step each
        of GCN, GIN, SAGE (row 4; row 7's CSR mode) and GAT (rows 10 and
        11) against the single-device path;
    (b) a world of 2 over gloo on the one card (spawned after the build):
        PNA's halo forward and one step on dp = 2 against (a), each
        rank's launch counts of rows 5, 6 and 7 and its window's halos;
    (c) CUDA-event times of the world-1 halo forward and step against
        ``Program.forward`` and ``make_train_step``."""
    import torch.distributed as dist

    from gnnbuilder_tpu_torch import Program, train
    from gnnbuilder_tpu_torch.ops import dispatch, ell
    from gnnbuilder_tpu_torch.ops.cuda import pna_layer
    from gnnbuilder_tpu_torch.parallel import halo as halo_mod
    from gnnbuilder_tpu_torch.parallel.mesh import make_mesh
    from gnnbuilder_tpu_torch.parallel.sharding import shard_batch
    from gnnbuilder_tpu_torch.parallel.train import (
        _halo_size,
        make_sharded_forward,
        make_sharded_train_step,
    )

    out = {}
    m = tb.graph_mask
    pg_dir = tempfile.mkdtemp(prefix="gnnb_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{pg_dir}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device_type="cuda")
        h = _halo_size(tb, mesh)
        sb = shard_batch(mesh, tb, halo=True)
        sb_ag = shard_batch(mesh, tb, halo=False)

        def adam(ps):
            return torch.optim.Adam(ps, lr=1e-3)

        with phase(f"parallel (a): world of 1 over NCCL ({mesh}), halo "
                   f"{h}: canonical PNA's halo forward against "
                   f"Program.forward, row 5 on each layer's window "
                   f"against its plain version"):
            pmodel, _ = _par_model("pna", tgraphs, dev, state0)
            pprog = Program(pmodel, max_nodes=tb.num_nodes,
                            max_edges=tb.num_edges, max_graphs=tb.num_graphs,
                            device=dev)
            pprog.set_params(state0)
            hmodel, _ = _par_model("pna", tgraphs, dev, state0)
            fwd = make_sharded_forward(hmodel, mesh, tb, halo=True)
            with torch.no_grad():
                ref = pprog.forward(tb)
                calls0 = halo_mod.halo_wrap_layer.calls
                zero_counts()
                got = fwd(None, sb)
                torch.cuda.synchronize()
                launches = counts()
                wraps = halo_mod.halo_wrap_layer.calls - calls0
            ok, abs_err, rel_err = close_enough(got[m], ref[m])
            log(f"halo forward against Program.forward: max abs "
                f"{abs_err:.3e}, {rel_err:.3e} of max |value| (tol {TOL}); "
                f"{wraps} windows; launches {launches}")
            if not ok or launches != only(pna_layer=6) or wraps != 6:
                raise AssertionError("the halo forward disagrees with "
                                     "Program.forward or missed row 5")
            got_w1 = got.cpu()
            out["pna_forward"] = dict(max_abs_err=abs_err, rel_err=rel_err,
                                      launches=launches["pna_layer"],
                                      windows=wraps)
            # each layer's window, as halo_wrap_layer builds it
            n = tb.num_nodes
            n_pad = halo_mod.halo_pad_rows(n, h)
            win = halo_mod._Scope(mesh, "dp", h).window(
                tb.nbr_nodes, tb.in_degree, n_pad)
            F0 = tb.feature_dim
            x0 = torch.cat([tb.node_feat.new_zeros(h, F0), tb.node_feat,
                            tb.node_feat.new_zeros(n_pad - h - n, F0)])

            class _Win:
                node_feat, nbr_nodes, in_degree = x0, win.nbr_ext, win.deg_ext

            with torch.no_grad():
                wlayers = layer_operands(hmodel, _Win, pna_layer)
                err_w = 0.0
                for i, (args, kw) in enumerate(wlayers):
                    a = pna_layer.fused_pna_layer(*args, **kw)
                    b = pna_layer.pna_layer_plain(*args, **kw)
                    ok, e_, r_ = close_enough(a, b)
                    err_w = max(err_w, e_)
                    if not ok:
                        raise AssertionError(f"row 5 on window {i}: {r_:.3e}"
                                             f" of max |value|")
                E = int(tb.in_degree.sum())
                W = tb.ell_width
                w_flops = w_bytes = w_gather = 0
                for (args, kw), (Fi, Fl, Fo) in zip(wlayers,
                                                    pna_widths(hmodel)):
                    w_flops += layer_flops(n_pad, E, Fi, Fl, Fo, 5)
                    w_gather += 5 * E * Fl
                    w_bytes += 4 * (n_pad * Fi + n_pad * W + n_pad
                                    + layer_weights(Fi, Fl, Fo)
                                    + (n_pad * Fo if kw["skip"] is not None
                                       else 0) + n_pad * Fo)
                b_ms, b_by = bound_f32_products(w_flops - w_gather, w_gather,
                                                w_bytes)

                def run_w(fn):
                    for args, kw in wlayers:
                        fn(*args, **kw)

                w_ms = time_ms(lambda: run_w(pna_layer.fused_pna_layer), 10)
                w_plain = time_ms(lambda: run_w(pna_layer.pna_layer_plain), 3)
            log(f"row 5 on the 6 windows (N={n_pad}): max abs {err_w:.3e} "
                f"against the plain version; {w_ms:.4f} ms (plain "
                f"{w_plain:.4f} ms, bound {b_ms:.4f} ms by {b_by}) on {smi}")
            entry = dict(
                name="parallel", route="cuda",
                source="gnnbuilder_tpu_torch/csrc/pna_layer.cu",
                replaces="gnnbuilder_tpu/ops/pallas/pna_layer.py:927",
                launches=launches["pna_layer"], max_abs_err=err_w,
                ms=w_ms, plain_ms=w_plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                per="row 5 on canonical PNA's 6 halo windows, one forward")

        with phase(f"parallel (a): {PAR_STEPS} halo Adam steps of canonical "
                   f"PNA against make_train_step (losses and every "
                   f"gradient), twice, bit for bit"):
            built = []
            orig_csr = ell.reverse_csr

            def counting_csr(*a, **k):
                built.append(1)
                return orig_csr(*a, **k)

            def halo_run():
                hm, _ = _par_model("pna", tgraphs, dev, state0)
                step, init = make_sharded_train_step(hm, adam, mesh, tb,
                                                     halo=True)
                with torch.enable_grad():
                    p, o = init(state0)
                    losses, grads, step_counts, befores = [], [], None, []
                    for i in range(PAR_STEPS):
                        befores.append({k: v.detach().clone()
                                        for k, v in p.items()})
                        zero_counts()
                        built.clear()
                        ell.reverse_csr = counting_csr
                        try:
                            p, o, loss = step(p, o, sb, target)
                        finally:
                            ell.reverse_csr = orig_csr
                        torch.cuda.synchronize()
                        if i == 0:
                            step_counts = (counts(), len(built))
                        losses.append(loss.clone())
                        grads.append({k: v.grad.clone()
                                      for k, v in p.items()})
                return losses, grads, step_counts, (step, p, o), befores

            runs = [halo_run() for _ in range(2)]
            (h_losses, h_grads, (st_counts, n_csr), hstep, befores), again = (
                runs[0], runs[1])
            if st_counts != only(pna_layer=6, pna_scatter_bwd=6,
                                 ell_gather_bwd_csr=6) or n_csr != 1:
                raise AssertionError(f"halo step launches {st_counts}, "
                                     f"{n_csr} reverse CSRs built")
            same = all(torch.equal(a, b) for a, b in zip(h_losses, again[0]))
            same = same and all(torch.equal(g1[k], g2[k])
                                for g1, g2 in zip(h_grads, again[1])
                                for k in g1)
            if not same:
                raise AssertionError("two halo runs differ")
            # the reference's own Adam trajectory from the same weights
            rmodel, _ = _par_model("pna", tgraphs, dev, state0)
            rstep = fresh_step(rmodel)
            r_losses, r_grads = [], []
            with torch.enable_grad():
                for _ in range(PAR_STEPS):
                    r_losses.append(rstep(tb, target).clone())
                    r_grads.append({k: v.grad.clone()
                                    for k, v in rmodel.named_parameters()})
            ok, l_err, l_rel = close_enough(torch.stack(h_losses),
                                            torch.stack(r_losses))
            # every step's gradients against make_train_step's at the same
            # weights (the halo run's before that step): from the second
            # step on, the two trajectories' weights differ where Adam's
            # first update (+-lr whatever the gradient's size) took a
            # gradient of ~0 with another sign in each
            fmodel, _ = _par_model("pna", tgraphs, dev, state0)
            fstep = train.make_train_step(
                fmodel, torch.optim.SGD(fmodel.parameters(), lr=0.0))
            g_err = free_err = 0.0
            for s_, (gh, gr) in enumerate(zip(h_grads, r_grads)):
                fmodel.load_state_dict(befores[s_])
                with torch.enable_grad():
                    fstep(tb, target)
                for k, v in fmodel.named_parameters():
                    ok_k, _, rel_k = close_enough(gh[k], v.grad)
                    g_err = max(g_err, rel_k)
                    ok = ok and ok_k
                    if not ok_k:
                        log(f"step {s_} {k}: {rel_k:.3e} of max |grad|")
                    free_err = max(free_err,
                                   close_enough(gh[k], gr[k])[2])
            log(f"halo losses {[float(x) for x in h_losses]} against "
                f"{[float(x) for x in r_losses]} ({l_rel:.3e} of max); "
                f"gradients within {g_err:.3e} of max (tol {TOL}) of "
                f"make_train_step's at the same weights ({free_err:.3e} "
                f"against its own trajectory's); launches a step "
                f"{st_counts}; reverse CSR built {n_csr} time(s) a step; two "
                f"runs bit for bit")
            if not ok:
                raise AssertionError("halo steps disagree with "
                                     "make_train_step")
            out["pna_steps"] = dict(
                losses=[float(x) for x in h_losses],
                ref_losses=[float(x) for x in r_losses], loss_rel_err=l_rel,
                grad_rel_err=g_err, trajectory_grad_rel_err=free_err,
                launches=st_counts, reverse_csr=n_csr,
                bitwise=True)

        with phase("parallel (a): the all-gather strategy (halo=False) "
                   "against the plain path"):
            amodel, _ = _par_model("pna", tgraphs, dev, state0)
            afwd = make_sharded_forward(amodel, mesh, tb, halo=False)
            with torch.no_grad():
                zero_counts()
                got_ag = afwd(None, sb_ag)
                torch.cuda.synchronize()
                launches = counts()
                dispatch.set_fused_mode("never")
                try:
                    plain = pmodel(tb)
                finally:
                    dispatch.set_fused_mode("auto")
            ok, abs_err, rel_err = close_enough(got_ag[m], plain[m])
            log(f"all-gather forward against the plain path: {rel_err:.3e} "
                f"of max |value|; launches {launches}")
            if not ok or launches != only():
                raise AssertionError("the all-gather forward disagrees")
            out["allgather_forward"] = dict(rel_err=rel_err)

        with phase(f"parallel (a): one halo forward and one halo step each "
                   f"of canonical {', '.join(PAR_CONVS)}"):
            per_conv = {}
            for conv in PAR_CONVS:
                cm, st = _par_model(conv, tgraphs, dev)
                cprog = Program(cm, max_nodes=tb.num_nodes,
                                max_edges=tb.num_edges,
                                max_graphs=tb.num_graphs, device=dev)
                cprog.set_params(st)
                kern = "gat_layer" if conv == "gat" else "mp_layer"
                bwd = "gat_bwd" if conv == "gat" else "ell_gather_bwd_csr"
                hm, _ = _par_model(conv, tgraphs, dev, st)
                cfwd = make_sharded_forward(hm, mesh, tb, halo=True)
                with torch.no_grad():
                    ref = cprog.forward(tb)
                    zero_counts()
                    got = cfwd(None, sb)
                    torch.cuda.synchronize()
                    f_launch = counts()
                ok_f, _, f_rel = close_enough(got[m], ref[m])
                step, init = make_sharded_train_step(hm, adam, mesh, tb,
                                                     halo=True)
                rm, _ = _par_model(conv, tgraphs, dev, st)
                rstep = fresh_step(rm)
                with torch.enable_grad():
                    p, o = init(st)
                    zero_counts()
                    p, o, loss = step(p, o, sb, target)
                    torch.cuda.synchronize()
                    s_launch = counts()
                    rloss = rstep(tb, target)
                ok_l, _, l_rel = close_enough(loss.reshape(1),
                                              rloss.reshape(1))
                g_rel = 0.0
                ok_g = True
                for k, v in rm.named_parameters():
                    ok_k, _, r_k = close_enough(p[k].grad, v.grad)
                    ok_g = ok_g and ok_k
                    g_rel = max(g_rel, r_k)
                log(f"{conv}: forward {f_rel:.3e} of max, launches "
                    f"{f_launch}; step loss {l_rel:.3e}, gradients "
                    f"{g_rel:.3e} of max, launches {s_launch}")
                if not (ok_f and ok_l and ok_g):
                    raise AssertionError(f"{conv}: the halo path disagrees "
                                         f"with the single-device one")
                if (f_launch != only(**{kern: 6})
                        or s_launch != only(**{kern: 6, bwd: 6})):
                    raise AssertionError(f"{conv}: halo launches {f_launch},"
                                         f" {s_launch}")
                per_conv[conv] = dict(forward_rel_err=f_rel,
                                      loss_rel_err=l_rel, grad_rel_err=g_rel,
                                      forward_launches=f_launch[kern],
                                      step_launches={kern: s_launch[kern],
                                                     bwd: s_launch[bwd]})
            out["convs"] = per_conv

        with phase("parallel (c): CUDA-event times of the world-1 halo "
                   "forward and step"):
            with torch.no_grad():
                t_halo = time_ms(lambda: fwd(None, sb), 10)
                t_prog = time_ms(lambda: pprog.forward(tb), 10)
            step_, p_, o_ = hstep
            with torch.enable_grad():
                t_hstep = time_ms(lambda: step_(p_, o_, sb, target), 5)
                rmodel.load_state_dict(state0)
                rstep = fresh_step(rmodel)
                t_rstep = time_ms(lambda: rstep(tb, target), 5)
            log(f"parallel times b{BATCH_GRAPHS} (N={tb.num_nodes}) on "
                f"{smi}: halo forward {t_halo:.4f} ms (Program.forward "
                f"{t_prog:.4f} ms); halo step {t_hstep:.4f} ms "
                f"(make_train_step {t_rstep:.4f} ms)")
            from torch.profiler import ProfilerActivity, profile

            def busy(fn, n=3):
                """(device ms by part, busy, wall ms) a call."""
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t = time.time()
                    for _ in range(n):
                        fn()
                    torch.cuda.synchronize()
                    wall = (time.time() - t) * 1e3 / n
                split = split_device_time(prof, n)
                return split, sum(split.values()), wall

            with torch.no_grad():
                splits = {"halo forward": busy(lambda: fwd(None, sb)),
                          "Program.forward": busy(
                              lambda: pprog.forward(tb))}
            for k, (split, b_, w_) in splits.items():
                log(f"{k}: device busy {b_:.4f} of {w_:.4f} ms wall "
                    f"(torch.profiler, 3 calls); by part "
                    + ", ".join(f"{p} {v:.4f}" for p, v in split.items()
                                if v))
            out["times"] = dict(halo_forward_ms=t_halo,
                                program_forward_ms=t_prog,
                                halo_step_ms=t_hstep,
                                train_step_ms=t_rstep, smi=smi,
                                busy={k: dict(busy_ms=v[1], wall_ms=v[2],
                                              by_part=v[0])
                                      for k, v in splits.items()})
    finally:
        dist.destroy_process_group()

    with phase(f"parallel (b): a world of {PAR_WORLD} over gloo on the one "
               f"card (spawned ranks): PNA's halo forward and one step on "
               f"dp = {PAR_WORLD} against the world of 1"):
        ranks = _gloo_world(state0)
        ref_g = {k: v.cpu() for k, v in h_grads[0].items()}
        ref_l = float(h_losses[0])
        per_rank = []
        for r, res in enumerate(ranks):
            res["out"] = torch.from_numpy(res["out"])
            res["grads"] = {k: torch.from_numpy(v)
                            for k, v in res["grads"].items()}
            ok_f, _, f_rel = close_enough(res["out"][m.cpu()],
                                          got_w1[m.cpu()])
            l_rel = abs(res["loss"] - ref_l) / max(abs(ref_l), 1e-30)
            g_rel = max(close_enough(res["grads"][k], ref_g[k])[2]
                        for k in ref_g)
            log(f"gloo rank {r}: {res['n_local']} rows, halo {res['halo']}, "
                f"|left halo| {res['halo_sums'][0]:.3e}, |right halo| "
                f"{res['halo_sums'][1]:.3e}, {res['into_halo']} ELL slots "
                f"read the halo; forward {f_rel:.3e}, loss {l_rel:.3e}, "
                f"gradients {g_rel:.3e} of max against the world of 1; "
                f"forward launches {res['fwd_counts']}, step launches "
                f"{res['step_counts']}")
            facing = res["halo_sums"][1 if r == 0 else 0]
            want_f = dict(pna_layer=6, pna_scatter_bwd=0,
                          ell_gather_bwd_csr=0, ell_gather_bwd=0, readout=0)
            want_s = dict(pna_layer=6, pna_scatter_bwd=6,
                          ell_gather_bwd_csr=6, ell_gather_bwd=0, readout=0)
            if not (ok_f and l_rel <= TOL and g_rel <= TOL and facing > 0
                    and res["fwd_counts"] == want_f
                    and res["step_counts"] == want_s):
                raise AssertionError(f"gloo rank {r} disagrees with the "
                                     f"world of 1 or missed its kernels")
            per_rank.append(dict(forward_rel_err=f_rel, loss_rel_err=l_rel,
                                 grad_rel_err=g_rel,
                                 halo_sums=res["halo_sums"],
                                 into_halo=res["into_halo"],
                                 fwd_counts=res["fwd_counts"],
                                 step_counts=res["step_counts"]))
        out["gloo_world"] = per_rank
    print("parallel " + json.dumps(out), flush=True)
    return out, entry


# the DSE phase: design points of ``dse.measure.measure_config`` on QM9
# (DSEConfig's defaults otherwise: hidden 128, output 64, 3 layers), each
# with the kernels its forward must launch
DSE_POINTS = (
    ("pna b1024 block f32",
     dict(conv="pna", batch_size=1024, block_size=128),
     ("pna_block_stack", "readout")),
    ("gcn b256 ell_width=0 bf16",
     dict(conv="gcn", batch_size=256, ell_width=0, precision="bf16"),
     ("readout",)),
    ("gat b64 standard f32", dict(conv="gat", batch_size=64),
     ("gat_layer", "readout")),
    ("gine b256 block f32",
     dict(conv="gine", batch_size=256, block_size=128),
     ("gine_layer", "readout")),
)
DSE_ITERS = 12
# the keys of a measure_config row beside the config's (the JAX package's)
DSE_ROW_KEYS = ("dataset", "num_nodes", "num_edges", "latency_us",
                "latency_per_graph_us", "graphs_per_s", "edges_per_s",
                "protocol", "overhead_us", "flops", "bytes_accessed",
                "peak_hbm_bytes", "compile_s", "measure_s")


def dse_phases(*, dev, zero_counts, counts, smi):
    """The design-space exploration on the card (``gnnbuilder_tpu_torch.
    dse``): ``measure_config`` called directly on each of ``DSE_POINTS``
    (``Program.benchmark_inner`` over CUDA graphs, ``cost_analysis``):
    the row and its keys, the kernels launched (counts set to 0 just
    before), the design point's forward against the plain path of the
    same Program (TOL under f32, ``SLICE_CPU_TOL`` for a model under a
    policy); ``measure_many`` resuming a temporary CSV;
    ``set_kernel_overrides(ell_width=0)`` reaching packing on the card;
    and, where scikit-learn imports, ``DSEEngine.from_pretrained`` ->
    ``tune_kernels(apply=True)`` -> ``verify`` of the best point.  Prints
    a ``dse`` JSON line per point; returns the results."""
    import csv

    from gnnbuilder_tpu_torch.core.graph import build_graph_batch
    from gnnbuilder_tpu_torch.data.datasets import load_dataset
    from gnnbuilder_tpu_torch.dse import (
        DSEConfig,
        DSEEngine,
        measure_config,
        measure_many,
    )
    from gnnbuilder_tpu_torch.dse.measure import _design_point, config_key
    from gnnbuilder_tpu_torch.ops import dispatch

    out = {"points": {}, "smi": smi}
    for name, kw, need in DSE_POINTS:
        with phase(f"dse: measure_config {name} (qm9)"):
            cfg = DSEConfig(**kw)
            zero_counts()
            row = measure_config(cfg, dataset="qm9", iters=DSE_ITERS)
            torch.cuda.synchronize()
            launches = {k: v for k, v in counts().items() if v}
            absent = [k for k in DSE_ROW_KEYS + tuple(cfg.to_dict())
                      if k not in row]
            if absent:
                raise AssertionError(f"dse {name}: row lacks {absent}")
            if not (row["latency_us"] > 0 and row["peak_hbm_bytes"] > 0
                    and row["flops"] > 0
                    and row["protocol"].startswith("inner")):
                raise AssertionError(f"dse {name}: row {row}")
            missed = [k for k in need if not launches.get(k)]
            if missed:
                raise AssertionError(f"dse {name}: launched {launches}, "
                                     f"none of {missed}")
            # the same design point (seeded), kernels against plain
            _, prog, b = _design_point(cfg, "qm9", 0, dev)
            got = prog.forward(b)
            dispatch.set_fused_mode("never")
            try:
                want = prog.forward(b)
            finally:
                dispatch.set_fused_mode("auto")
            tol = (TOL if cfg.precision == "f32"
                   else SLICE_CPU_TOL[cfg.precision])
            m = b.graph_mask
            ok, _, rel = close_enough(got[m], want[m], tol)
            if not ok or tuple(got.shape) != (b.num_graphs, 1):
                raise AssertionError(f"dse {name}: forward {rel:.3e} of max "
                                     f"off the plain path (tol {tol})")
            res = dict(point=name, row=row, launches=launches,
                       forward_rel_err=rel, tol=tol, smi=smi)
            print("dse " + json.dumps(res), flush=True)
            log(f"dse {name}: {row['latency_us']:.2f} us a forward "
                f"({row['protocol']}), {row['graphs_per_s']:.1f} graphs/s, "
                f"peak {row['peak_hbm_bytes']:.4e} bytes, measured in "
                f"{row['measure_s']:.2f} s; launches {launches}; forward "
                f"{rel:.3e} of max off the plain path ({smi})")
            out["points"][name] = res

    with phase("dse: measure_many resumes a temporary CSV"):
        small = [DSEConfig(conv=c, batch_size=64, gnn_num_layers=2)
                 for c in ("gcn", "sage", "gin")]
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "corpus.csv")
            first = measure_many(small[:2], dataset="esol", iters=4,
                                 out_csv=path, verbose=False)
            rows = measure_many(small, dataset="esol", iters=4,
                                out_csv=path, verbose=False)
            with open(path) as f:
                on_disk = list(csv.DictReader(f))
        resumed = [isinstance(r["latency_us"], str) for r in rows]
        if (len(first) != 2 or len(on_disk) != 3
                or resumed != [True, True, False]
                or [r["_key"] for r in on_disk] != [
                    config_key(c) for c in small]):
            raise AssertionError(f"dse: measure_many resumed {resumed}, "
                                 f"{len(on_disk)} rows on disk")
        log("dse: measure_many measured 2 points, then resumed them from "
            "the CSV and measured the third")
        out["resume"] = dict(measured_first=2, resumed=2, measured_then=1)

    with phase("dse: set_kernel_overrides(ell_width=0) reaches packing on "
               "the card"):
        graphs = load_dataset("qm9", n=16, seed=0)
        try:
            dispatch.set_kernel_overrides(ell_width=0)
            b0 = build_graph_batch(graphs, device=dev)
            dispatch.set_kernel_overrides(ell_width=None)
            b1 = build_graph_batch(graphs, device=dev)
        finally:
            dispatch.set_kernel_overrides(ell_width=None)
        if not (b0.nbr_nodes is None and b1.nbr_nodes is not None
                and b1.nbr_nodes.is_cuda):
            raise AssertionError("dse: the ell_width override did not "
                                 "reach packing")
        log("dse: ell_width=0 packed no table, None the automatic one")

    with phase("dse: from_pretrained -> tune_kernels -> verify"):
        try:
            import sklearn  # noqa: F401
        except ImportError:
            sklearn = None
        if sklearn is None:
            log("dse: scikit-learn is not installed here, so "
                "DSEEngine.from_pretrained cannot fit the shipped card "
                "corpus; that fit runs where scikit-learn is installed "
                "(the CPU tests hold it against the JAX package's)")
            out["pretrained"] = None
        else:
            eng = DSEEngine.from_pretrained("qm9")
            try:
                r = eng.tune_kernels("pna", batch_size=1024, apply=True)
                truth = eng.verify([r["best"]], iters=DSE_ITERS)[0]
            finally:
                dispatch.set_kernel_overrides(ell_width=None)
            if not truth["latency_per_graph_us"] > 0:
                raise AssertionError(f"dse: verify gave {truth}")
            out["pretrained"] = dict(
                best=r["best"].to_dict(), applied=r["applied"],
                predicted_us_per_graph=r["predicted_us_per_graph"],
                measured_us_per_graph=truth["latency_per_graph_us"])
            log(f"dse: tuned pna b1024 to {r['applied']}: predicted "
                f"{r['predicted_us_per_graph']:.4f} us a graph, measured "
                f"{truth['latency_per_graph_us']:.4f} ({smi})")
    return out


# the train step under a precision policy (policy_grad_phases): each conv
# with its conv_kwargs, at the canonical widths
POLICY_CONVS = {"pna": None, "gin": None, "sage": None, "gcn": None,
                "gat": {"heads": GAT_HEADS}, "gine": None}
# each layer's kernel Function against its plain twin on the same card,
# both on the inputs the kernel path gave that layer
POLICY_TWIN_TOL = 1e-4
# a whole model's gradients against another order of the same sums: the
# card's kernels against the plain twins, 6 layers on the b1024 batch
# (MODEL), and the card against the CPU, 64 graphs (CPU).  A float32 sum
# taken in another order moves a bf16 rounding or an int8 level where it
# lands near a boundary, and with it a ReLU decision near 0; the next
# layer reads the moved value, so the moves spread layer by layer
POLICY_MODEL_TOL = {"bf16": 2e-2, "int8": 5e-2}
POLICY_CPU_TOL = {"bf16": 1e-2, "int8": 5e-2}
POLICY_TIMED_STEPS = 10
# the 256-row block forwards: conv -> (conv_kwargs, node width)
BLOCK256_CONVS = {"pna": (None, None), "gcn": (None, None),
                  "gin": (None, None), "sage": (None, None),
                  "lg": (None, 128), "simple": (None, 128),
                  "gat": ({"heads": GAT_HEADS}, None)}


def policy_kernel(conv):
    """The counted layer kernel a conv's layers launch forward."""
    return {"pna": "pna_layer", "gine": "gine_layer",
            "gat": "gat_layer"}.get(conv, "mp_layer")


def policy_expected(conv, policy, L):
    """{counted kernel: launches} of one train step of ``conv`` under
    ``policy`` on a batch with a reverse table: the layer kernel forward,
    the readout, and the backwards' kernels (rows 6 and 7 for PNA, row 7
    for the mp convs, row 11 for GAT under bf16; int8 GAT's backward is
    autograd of the float32 plain layer and GINE's a torch recompute)."""
    out = {policy_kernel(conv): L, "readout": 1}
    if conv == "pna":
        out.update(pna_scatter_bwd=L, ell_gather_bwd=L)
    elif conv in ("gin", "sage", "gcn"):
        out["ell_gather_bwd"] = L
    elif conv == "gat" and policy == "bf16":
        out["gat_bwd"] = L
    return out


def layer_twin_errs(model, g, policy, seed=33):
    """Per layer of ``model`` under ``policy``: (the largest error, of
    max, of the gradients of x, the skip and the conv's parameters, its
    kernel Function against its plain twin (``dispatch.plain_twins``),
    both on the inputs the kernel path gave that layer; the ReLU
    decisions the two forwards took apart).  A ReLU backward reads its
    own forward's output, and a mode's output moves by a bf16 rounding or
    an int8 level where another summation order lands near a boundary:
    where the two decisions differ the two backwards differentiate two
    functions, so the seeded cotangent is 0 there."""
    from gnnbuilder_tpu_torch.compile.precision import Precision
    from gnnbuilder_tpu_torch.ops import dispatch

    seen = []
    hooks = [conv.register_forward_pre_hook(
        lambda _m, args, i=i: seen.append((i, args)))
        for i, conv in enumerate(model.gnn_convs)]
    try:
        with Precision.from_name(policy).activate():
            model(g)
    finally:
        for hk in hooks:
            hk.remove()
    gen = torch.Generator(device=g.node_feat.device).manual_seed(seed)
    errs, flips = [], []
    for i, (gg, h, act, skip) in seen:
        conv, runs = model.gnn_convs[i], []
        for twin in (False, True):
            x = h.detach().clone().requires_grad_()
            sk = (None if skip is None
                  else skip.detach().clone().requires_grad_())
            ctx = dispatch.plain_twins() if twin else contextlib.nullcontext()
            with Precision.from_name(policy).activate(), ctx:
                ops = (model._gat_operands() or model._pna_operands(gg)
                       or model._gine_operands(gg))
                y = conv(gg, x, act, sk,
                         **({} if ops is None else {"operands": ops[i]}))
            runs.append((x, sk, y))
        ct = torch.randn(y.shape, generator=gen, device=y.device)
        if act == "relu":
            apart = (runs[0][2] > 0) != (runs[1][2] > 0)
            ct = ct.masked_fill(apart, 0.0)
            flips.append(int(apart.sum()))
        else:
            flips.append(0)
        res = []
        for x, sk, y in runs:
            model.zero_grad(set_to_none=True)
            y.backward(ct)
            got = {n: q.grad for n, q in conv.named_parameters()}
            got["x"] = x.grad
            if sk is not None:
                got["skip"] = sk.grad
            res.append(got)
        if any(v is None for r in res for v in r.values()):
            raise AssertionError(f"layer {i} under {policy}: a gradient is "
                                 f"None")
        errs.append(max(rel_err(res[0][k], res[1][k]) for k in res[1]))
    return errs, flips


def pna_mode_work(widths, n, e, w, skips, mode, residuals):
    """([(operations, peak)], bytes) of row 5's six launches in ``mode``
    (``precision_phases``' count); with ``residuals`` also v, agg_cat,
    aux and mid written, once each."""
    pk, wb = MODE_PEAK[mode], WEIGHT_BYTES[mode]
    prod = sum(2 * n * (2 * fi * f + 12 * f * fo + fi * fo + fo * fo)
               for fi, f, fo in widths)
    lin = sum(2 * n * fo * fo for _, _, fo in widths)
    terms = ([(prod, pk)] if mode == "bf16" else
             [(lin, pk), (prod - lin, max(PEAK_F32_FLOPS,
                                          PEAK_TF32_FLOPS / 3))])
    quant = (sum(n * fo * 6 for _, _, fo in widths) if mode == "int8"
             else 0)
    terms.append((sum(5 * e * f for _, f, _ in widths) + quant,
                  PEAK_F32_FLOPS))
    nbytes = 0
    for (fi, f, fo), sk in zip(widths, skips):
        nbytes += 4 * (n * fi + n * w + n + f + 2 * fo + n * fo
                       + (n * fo if sk else 0))
        nbytes += (4 * (2 * fi * f + (fi + 12 * f) * fo) + wb * fo * fo
                   + 4 * fo if mode == "int8" else
                   wb * (2 * fi * f + (fi + 12 * f) * fo + fo * fo))
        if residuals:
            nbytes += 4 * n * (10 * f + fo)
    return terms, nbytes


def policy_grad_phases(report, *, dev, tgraphs, tb, target, counted,
                       zero_counts, counts, only, smi):
    """Training under the bf16 and int8 policies through the layer
    kernels' autograd Functions, and the 256-row block forwards.

    Per conv of ``POLICY_CONVS`` (canonical widths, 6 layers, seeded
    weights) and policy: one Adam step of ``make_train_step`` on the b1024
    standard-packed train batch inside ``Precision.from_name(p)
    .activate()`` (the counts set to 0 just before and read just after:
    the layer kernel in the policy's mode in every layer, the readout in
    it, rows 6 and 7, or 11, in the backward); the gradients of the
    kernel Functions against their plain twins (``dispatch.plain_twins``,
    no launch): each layer on the inputs the kernel path gave it
    (``layer_twin_errs``, on the ReLU decisions both forwards took) at
    ``POLICY_TWIN_TOL`` of max, the whole model
    at ``POLICY_MODEL_TOL``; two Adam steps from one
    state twice, losses and weights the same bits; a 64-graph batch's
    gradients against the CPU's at ``POLICY_CPU_TOL``; then CUDA-event ms
    of the f32, bf16 and int8 steps with the device busy time of three
    profiled ones.  The mode instances of rows 4 and 5 with and without
    their residual stores, timed in one process, with the bound restated
    for the stores.  ``Program(block_size=256)`` forwards of
    ``BLOCK256_CONVS`` on 1024 QM9 graphs block-packed at 256 rows: no
    block or stack kernel (each wrapper's ``BLOCK_ROWS`` is the
    library's 128), the layer kernels over the ELL table, within TOL of
    the per-layer plain path.  Returns the results."""
    from torch.profiler import ProfilerActivity, profile

    from gnnbuilder_tpu_torch import Program, train
    from gnnbuilder_tpu_torch.bench.canonical import (
        canonical_batches,
        canonical_model,
    )
    from gnnbuilder_tpu_torch.compile.precision import Precision
    from gnnbuilder_tpu_torch.ops import dispatch
    from gnnbuilder_tpu_torch.ops.cuda import (
        _build,
        gat_block,
        mp_block,
        mp_layer,
        pna_block,
        pna_layer,
    )

    out = {"steps": {}, "residuals": {}, "block256": {}}
    torch.set_grad_enabled(True)
    sgraphs, (sb,) = canonical_batches("qm9", n_graphs=64, batch_size=64,
                                       node_multiple=256, device="cpu")
    starget = train.stack_targets(sgraphs, sb.num_graphs, device="cpu")
    sbc, starget_c = sb.to(dev), starget.to(dev)

    def grads(model, g, tgt, policy, twin=False):
        model.zero_grad()
        with Precision.from_name(policy).activate():
            ctx = dispatch.plain_twins() if twin else contextlib.nullcontext()
            with ctx:
                loss = train.masked_mse_loss(model(g), tgt, g.graph_mask)
                loss.backward()
        return {k: p.grad.detach().clone()
                for k, p in model.named_parameters()}

    def worst(got, want):
        return max(rel_err(got[k].double().cpu(), want[k].double().cpu())
                   for k in want)

    for conv, kw in POLICY_CONVS.items():
        with phase(f"policy_grad {conv}: a b{BATCH_GRAPHS} train step under "
                   f"bf16 and int8 through the layer kernels"):
            torch.manual_seed(31)
            model = canonical_model(conv, "qm9", graphs=tgraphs,
                                    conv_kwargs=dict(kw or {})).to(dev)
            state0 = {k: v.clone() for k, v in model.state_dict().items()}
            L = model.gnn_num_layers
            kern = counted[policy_kernel(conv)]
            res = {}
            for policy in PREC_MODES:
                mode = "f32" if (conv, policy) == ("gcn", "int8") else policy
                model.load_state_dict(state0)
                step = train.make_train_step(
                    model, torch.optim.Adam(model.parameters(), lr=1e-3))
                zero_counts()
                with Precision.from_name(policy).activate():
                    loss = float(step(tb, target).detach())
                torch.cuda.synchronize()
                launched = counts()
                want = only(**policy_expected(conv, policy, L))
                if launched != want:
                    raise AssertionError(f"{conv} {policy} step launches "
                                         f"{launched}, expected {want}")
                if (kern.mode_launches[mode] != L
                        or counted["readout"].mode_launches[policy] != 1):
                    raise AssertionError(
                        f"{conv} {policy}: the layer kernel ran "
                        f"{kern.mode_launches}, the readout "
                        f"{counted['readout'].mode_launches}")
                fwd_launches = dict(launched)
                # the kernel Functions against their plain twins, one state
                model.load_state_dict(state0)
                g_k = grads(model, tb, target, policy)
                before = counts()
                g_t = grads(model, tb, target, policy, twin=True)
                torch.cuda.synchronize()
                if counts() != before:
                    raise AssertionError(f"{conv} {policy}: the plain twins "
                                         f"launched a kernel")
                model_err = worst(g_k, g_t)
                if not all(torch.isfinite(v).all() for v in g_k.values()):
                    raise AssertionError(f"{conv} {policy}: a gradient is "
                                         f"not finite")
                if model_err > POLICY_MODEL_TOL[policy]:
                    raise AssertionError(f"{conv} {policy}: the model's "
                                         f"gradients {model_err:.3e} of max "
                                         f"off the plain twins'")
                model.load_state_dict(state0)
                layer_errs, flips = layer_twin_errs(model, tb, policy)
                twin_err = max(layer_errs)
                if twin_err > POLICY_TWIN_TOL:
                    raise AssertionError(f"{conv} {policy}: per layer, "
                                         f"gradients {layer_errs} of max off "
                                         f"the plain twins'")
                # two Adam steps from one state, twice: the same bits
                runs = []
                for _ in range(2):
                    model.load_state_dict(state0)
                    step = train.make_train_step(
                        model, torch.optim.Adam(model.parameters(),
                                                lr=1e-3))
                    with Precision.from_name(policy).activate():
                        ls = [step(tb, target).detach() for _ in range(2)]
                    runs.append((torch.stack(ls),
                                 {k: v.clone() for k, v in
                                  model.state_dict().items()}))
                bitwise = torch.equal(runs[0][0], runs[1][0]) and all(
                    torch.equal(runs[0][1][k], runs[1][1][k])
                    for k in runs[0][1])
                if not bitwise:
                    raise AssertionError(f"{conv} {policy}: two steps are "
                                         f"not the same bits twice")
                # a small batch against the CPU
                model.load_state_dict(state0)
                g_c = grads(model, sbc, starget_c, policy)
                cpu_model = canonical_model(conv, "qm9", graphs=tgraphs,
                                            conv_kwargs=dict(kw or {}))
                cpu_model.load_state_dict({k: v.cpu()
                                           for k, v in state0.items()})
                g_cpu = grads(cpu_model, sb, starget, policy)
                cpu_err = worst(g_c, g_cpu)
                if cpu_err > POLICY_CPU_TOL[policy]:
                    raise AssertionError(f"{conv} {policy}: 64-graph "
                                         f"gradients {cpu_err:.3e} of max "
                                         f"off the CPU's")
                res[policy] = dict(loss=loss, launches=fwd_launches,
                                   kernel_mode=mode, twin_err=twin_err,
                                   layer_twin_errs=layer_errs,
                                   relu_decisions_apart=flips,
                                   model_twin_err=model_err,
                                   cpu_err=cpu_err, bitwise_twice=bitwise,
                                   two_step_losses=runs[0][0].tolist())
                log(f"{conv} {policy}: step launches "
                    f"{ {k: v for k, v in fwd_launches.items() if v} } "
                    f"({policy_kernel(conv)} in {mode}); gradients off "
                    f"the plain twins per layer "
                    f"{[f'{e:.2e}' for e in layer_errs]} of max (tol "
                    f"{POLICY_TWIN_TOL}; ReLU decisions apart {flips}), "
                    f"the whole model {model_err:.3e} "
                    f"(tol {POLICY_MODEL_TOL[policy]}); 64 graphs against "
                    f"the CPU {cpu_err:.3e} (tol {POLICY_CPU_TOL[policy]});"
                    f" two steps the same bits twice")
            # the step times under each policy, f32 beside them
            for prec in ("f32",) + PREC_MODES:
                model.load_state_dict(state0)
                step = train.make_train_step(
                    model, torch.optim.Adam(model.parameters(), lr=1e-3))
                with Precision.from_name(prec).activate():
                    ms = time_ms(lambda: step(tb, target),
                                 POLICY_TIMED_STEPS, warmup=3)
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        for _ in range(3):
                            step(tb, target)
                        torch.cuda.synchronize()
                split = split_device_time(prof, 3)
                busy = sum(split.values())
                res.setdefault(prec, {}).update(
                    step_ms=ms, device_busy_ms=busy,
                    device_ms_by_part={k: v for k, v in split.items() if v})
                log(f"{conv} {prec} train step b{BATCH_GRAPHS}: {ms:.4f} ms "
                    f"(events, {POLICY_TIMED_STEPS} steps), device busy "
                    f"{busy:.4f} ms ({smi})")
            out["steps"][conv] = res
            del model
    torch.set_grad_enabled(False)

    with phase("policy_grad: the mode instances of rows 4 and 5 with and "
               "without their residual stores"):
        torch.manual_seed(31)
        pmodel = canonical_model("pna", "qm9", graphs=tgraphs).to(dev)
        layers = layer_operands(pmodel, tb, pna_layer)
        widths = pna_widths(pmodel)
        n, e, w = tb.num_nodes, int(tb.in_degree.sum()), tb.ell_width
        skips = [kw_["skip"] is not None for _, kw_ in layers]
        for mode in PREC_MODES:
            margs = []
            for args, kw_ in layers:
                wp, kp, wl, sl = pna_layer.prepare_layer(args[3], args[5],
                                                         args[7], mode)
                a = list(args)
                a[3], a[5], a[7] = wp, kp, wl
                margs.append((a, dict(kw_, mode=mode, s_lin=sl,
                                      staged=pna_layer.stage_layer(
                                          wp, kp, wl, mode))))

            def run(save, _margs=margs):
                for a, k in _margs:
                    pna_layer.fused_pna_layer(*a, **k, save_res=save)

            for a, k in margs:   # the same bits with the stores
                o1 = pna_layer.fused_pna_layer(*a, **k)
                o2 = pna_layer.fused_pna_layer(*a, **k, save_res=True)[0]
                if not torch.equal(o1, o2):
                    raise AssertionError(f"pna_layer {mode}: out moved with "
                                         f"the residual stores")
            timing = {}
            for save in (False, True, True, False):
                timing.setdefault(save, []).append(
                    timed(lambda: run(save), 10)[0])
            entry = {}
            for save in (False, True):
                terms, nbytes = pna_mode_work(widths, n, e, w, skips, mode,
                                              save)
                b_ms, b_by = bound_mixed(terms, nbytes)
                entry["residual" if save else "no_residual"] = dict(
                    device_ms=timing[save], bound_ms=b_ms, bound_by=b_by,
                    bytes=nbytes)
            out["residuals"][f"pna_layer_{mode}"] = entry
            report[f"pna_layer_{mode}"]["residual_ms"] = min(
                entry["residual"]["device_ms"])
            report[f"pna_layer_{mode}"]["residual_bound_ms"] = (
                entry["residual"]["bound_ms"])
            log(f"pna_layer {mode}, a b{BATCH_GRAPHS} step's six: device "
                f"{entry['no_residual']['device_ms']} ms without the "
                f"residual stores, {entry['residual']['device_ms']} with "
                f"(bound {entry['no_residual']['bound_ms']:.4f} / "
                f"{entry['residual']['bound_ms']:.4f} ms by "
                f"{entry['residual']['bound_by']}) on {smi}")
        for conv in ("gin", "sage", "gcn"):
            torch.manual_seed(31)
            mmodel = canonical_model(conv, "qm9", graphs=tgraphs).to(dev)
            f32_layers = mp_args(mmodel, tb, False)
            for mode in (PREC_MODES if conv != "gcn" else ("bf16",)):
                mls = in_mode(f32_layers, "mp_layer", mode)

                def run(save, _mls=mls):
                    for a, k in _mls:
                        mp_layer.fused_mp_layer(*a, **k, save_s=save)

                for a, k in mls:
                    o1 = mp_layer.fused_mp_layer(*a, **k)
                    o2 = mp_layer.fused_mp_layer(*a, **k, save_s=True)[0]
                    if not torch.equal(o1, o2):
                        raise AssertionError(f"mp_layer {conv} {mode}: out "
                                             f"moved with the s store")
                timing = {}
                for save in (False, True, True, False):
                    timing.setdefault(save, []).append(
                        timed(lambda: run(save), 10)[0])
                terms, nbytes = mode_work("mp_layer", mls, tb, mode)
                s_bytes = sum(4 * n * a[0].shape[1] for a, _ in mls)
                entry = {}
                for save in (False, True):
                    b_ms, b_by = bound_mixed(
                        terms, nbytes + (s_bytes if save else 0))
                    entry["residual" if save else "no_residual"] = dict(
                        device_ms=timing[save], bound_ms=b_ms,
                        bound_by=b_by)
                out["residuals"][f"mp_layer_{conv}_{mode}"] = entry
                if conv == "gin":
                    report[f"mp_layer_{mode}"]["residual_ms"] = min(
                        entry["residual"]["device_ms"])
                    report[f"mp_layer_{mode}"]["residual_bound_ms"] = (
                        entry["residual"]["bound_ms"])
                log(f"mp_layer {conv} {mode}, a b{BATCH_GRAPHS} step's six: "
                    f"device {entry['no_residual']['device_ms']} ms without "
                    f"s, {entry['residual']['device_ms']} with (bound "
                    f"{entry['no_residual']['bound_ms']:.4f} / "
                    f"{entry['residual']['bound_ms']:.4f} ms) on {smi}")

    with phase("policy_grad: Program(block_size=256) forwards through the "
               "layer kernels"):
        lib = _build.load()
        for mod, fn in ((pna_block, lib.gnnb_pna_block_rows),
                        (mp_block, lib.gnnb_mp_block_rows),
                        (mp_layer, lib.gnnb_mp_layer_block_rows),
                        (gat_block, lib.gnnb_gat_block_rows)):
            if mod.BLOCK_ROWS != fn():
                raise AssertionError(f"{mod.__name__}.BLOCK_ROWS is "
                                     f"{mod.BLOCK_ROWS}, the library's "
                                     f"{fn()}")
        for conv, (kw, width) in BLOCK256_CONVS.items():
            bgraphs, (bb,) = canonical_batches(
                "qm9", n_graphs=BATCH_GRAPHS, batch_size=BATCH_GRAPHS,
                block_size=256, node_multiple=256, node_dim=width,
                device=dev)
            torch.manual_seed(32)
            bmodel = canonical_model(conv, "qm9", graphs=bgraphs,
                                     conv_kwargs=dict(kw or {}))
            prog = Program(bmodel, max_nodes=bb.num_nodes,
                           max_edges=bb.num_edges, max_graphs=bb.num_graphs,
                           block_size=256, device="cuda")
            prog.init_params()
            zero_counts()
            got = prog.forward(bb)
            torch.cuda.synchronize()
            launched = counts()
            want = only(**{policy_kernel(conv): bmodel.gnn_num_layers,
                           "readout": 1})
            if launched != want:
                raise AssertionError(f"{conv} at 256-row blocks launches "
                                     f"{launched}, expected {want}")
            dispatch.set_fused_mode("never")
            try:
                ref = prog.forward(bb)
            finally:
                dispatch.set_fused_mode("auto")
            m = bb.graph_mask
            ok, abs_err, rel = close_enough(got[m], ref[m])
            if not ok:
                raise AssertionError(f"{conv} at 256-row blocks: "
                                     f"{rel:.3e} of max off the plain path")
            out["block256"][conv] = dict(launches={k: v for k, v in
                                                   launched.items() if v},
                                         rel_err=rel, nodes=bb.num_nodes)
            log(f"{conv} Program(block_size=256) forward, N={bb.num_nodes}:"
                f" launches { {k: v for k, v in launched.items() if v} }; "
                f"{rel:.3e} of max |value| off the per-layer plain path "
                f"(tol {TOL})")
    print("policy_grad " + json.dumps(out), flush=True)
    return out


HARNESS_CONVS = ("gcn", "gin", "pna", "sage")
HARNESS_DATASETS = ("qm9", "esol")
HARNESS_BATCHES = (1, 4, 256)
REPAIR_GRAPHS = 256      # QM9 graphs in the sharded repairs' batch
REPAIR_INT8_TOL = 1e-6   # of max: the gathered int8 blocks are the product
REPAIR_ATOL, REPAIR_RTOL = 2e-5, 1e-5    # the sharded forwards' tolerance


def harness_expected(conv, block):
    """The launches of one forward of a harness arm: the readout (row 2)
    everywhere; on standard batches the layer kernel in each of the six
    layers (row 5 for PNA, row 4 for the others); on 128-row blocks the
    stack kernel (row 1 for PNA, row 3 for GCN and SAGE; GIN runs per
    layer on the plain block product)."""
    k = {"readout": 1}
    if not block:
        k["pna_layer" if conv == "pna" else "mp_layer"] = 6
    elif conv == "pna":
        k["pna_block_stack"] = 1
    elif conv != "gin":
        k["mp_block_stack"] = 1
    return k


def harness_part(name):
    """The part of a forward's device time a kernel belongs to: the
    port's kernels, or torch's."""
    ours = ("pna_", "mp_layer", "mp_block", "readout", "gnnb")
    return "port kernels" if any(k in name for k in ours) else "torch"


def harness_phases(*, zero_counts, counts, only, smi):
    """The conv x dataset grid of ``bench/harness.py`` on the card.

    First each arm as ``bench_gpu`` builds it (``harness._program_arm``
    on the card at ``bench_gpu``'s defaults: its Program and first batch
    of each size), with a latency callable that holds the forward to the
    per-layer plain path at TOL of max with its launches those of
    ``harness_expected``, splits its device busy ms a forward by
    ``harness_part`` under torch.profiler (five forwards), and times it
    as ``bench_gpu`` does.  Then ``run_grid(backends=("gpu",))`` on
    ``HARNESS_CONVS`` x ``HARNESS_DATASETS`` at batch 1, 4 and 256 into a
    temporary directory, as a user calls it, the counts set to 0 just
    before and read just after: each of rows 1-5 launched, and no other
    kernel.  Then the ``torch_cpu`` arm on (gcn, qm9), the CPU baseline,
    into the same directory.  Prints the grid: ms a forward and a graph
    at b1, b4 and b256, graphs/s, ``vs_fpga_par`` and the ratio to the
    CPU baseline of this run.  Returns the rows and the per-arm checks."""
    import inspect

    from gnnbuilder_tpu_torch.bench import harness
    from gnnbuilder_tpu_torch.bench.timing import _device_split
    from gnnbuilder_tpu_torch.ops import dispatch

    checks = []

    def checked(conv, dataset):
        def latency(prog, batch, iters):
            before = counts()
            out = prog.forward(batch)
            torch.cuda.synchronize()
            after = counts()
            launched = {k: after[k] - before[k] for k in after}
            dispatch.set_fused_mode("never")
            try:
                ref = prog.forward(batch)
            finally:
                dispatch.set_fused_mode("auto")
            m = batch.graph_mask
            ok, abs_err, rel_err = close_enough(out[m], ref[m])
            block = batch.block_adj is not None
            bs = batch.num_graphs - 1
            want = only(**harness_expected(conv, block))
            fired = {k: v for k, v in launched.items() if v}
            log(f"harness {conv} {dataset} b{bs} "
                f"({'block 128' if block else 'standard'}, "
                f"N={batch.num_nodes}): kernels vs per-layer plain max abs "
                f"{abs_err:.3e}, {rel_err:.3e} of max |value| (tol {TOL});"
                f" launches {fired}")
            checks.append(dict(conv=conv, dataset=dataset, batch_size=bs,
                               block=block, nodes=batch.num_nodes,
                               launches=fired, max_abs_err=abs_err,
                               rel_err=rel_err))
            if not ok:
                raise AssertionError(f"harness arm {conv} {dataset} b{bs} "
                                     f"disagrees with the plain path")
            if launched != want:
                raise AssertionError(
                    f"harness arm {conv} {dataset} b{bs}: launches {fired},"
                    f" want {harness_expected(conv, block)}")
            split, per_call = _device_split(lambda: prog.forward(batch),
                                            harness_part)
            # bench_gpu's timing: the median of three event windows
            dt = prog.benchmark(batch, iters=max(iters, 12),
                                repeats=3)["latency_s"]
            busy = sum(split.values())
            checks[-1].update(events_ms=dt * 1e3, busy_ms=split,
                              device_launches=sum(per_call.values()),
                              idle=1.0 - busy / (dt * 1e3))
            log(f"  events {dt * 1e3:.4f} ms a forward; device busy "
                f"{busy:.4f} ("
                + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
                + f"), {sum(per_call.values()):.0f} device launches; idle "
                f"{checks[-1]['idle']:.3f} of the events")
            return dt
        return latency

    defaults = {k: v.default for k, v in
                inspect.signature(harness.bench_gpu).parameters.items()}
    with phase(f"harness arms held to plain: {len(HARNESS_CONVS)} convs x "
               f"{len(HARNESS_DATASETS)} datasets x batch "
               f"{HARNESS_BATCHES}"):
        for conv in HARNESS_CONVS:
            for ds in HARNESS_DATASETS:
                harness._program_arm(conv, ds, HARNESS_BATCHES,
                                     defaults["n_graphs"],
                                     defaults["iters"], "cuda",
                                     checked(conv, ds))
    n_arms = len(HARNESS_CONVS) * len(HARNESS_DATASETS) * len(
        HARNESS_BATCHES)
    if len(checks) != n_arms:
        raise AssertionError(f"{len(checks)} arms checked, want {n_arms}")
    rdir = tempfile.mkdtemp(prefix="gnnb_harness_")
    with phase(f"harness grid on the card: {len(HARNESS_CONVS)} convs x "
               f"{len(HARNESS_DATASETS)} datasets x batch "
               f"{HARNESS_BATCHES}"):
        zero_counts()
        rows = harness.run_grid(
            convs=HARNESS_CONVS, datasets=HARNESS_DATASETS,
            backends=("gpu",), results_dir=rdir, verbose=False,
            batch_sizes=HARNESS_BATCHES)
        torch.cuda.synchronize()
        launches = counts()
        log(f"launches during the grid: "
            f"{ {k: v for k, v in launches.items() if v} }")
        path = ("pna_block_stack", "readout", "mp_block_stack",
                "mp_layer", "pna_layer")
        if any(not launches[k] for k in path) or any(
                launches[k] for k in launches if k not in path):
            raise AssertionError("the grid did not launch rows 1-5 alone")
    with phase("harness CPU baseline: torch_cpu on (gcn, qm9)"):
        threads = torch.get_num_threads()
        try:
            (base,) = harness.run_grid(convs=("gcn",), datasets=("qm9",),
                                       backends=("torch_cpu",),
                                       results_dir=rdir, verbose=False)
        finally:
            torch.set_num_threads(threads)
        with open(os.path.join(rdir, "results.json")) as f:
            merged = json.load(f)
        if len(merged) != len(rows) + 1:
            raise AssertionError("results.json did not merge the runs")
        files = sorted(os.listdir(rdir))
        want_files = 4 * len(rows) + 2 + 1
        if len(files) != want_files:
            raise AssertionError(f"{len(files)} results files, want "
                                 f"{want_files}")
    log(f"harness grid ({smi}; ms a forward, ms a graph, graphs/s):")
    for r in rows:
        for k, v in r.items():
            if isinstance(v, float) and not (math.isfinite(v) and v > 0):
                raise AssertionError(f"harness {r['conv']} {r['dataset']}: "
                                     f"{k} = {v}")
        cells = "; ".join(
            f"b{bs} {r[f'latency_b{bs}_s'] * 1e3:.4f} ms, "
            f"{r[f'latency_b{bs}_s'] * 1e3 / bs:.5f} ms/graph, "
            f"{r[f'graphs_per_s_b{bs}']:.1f} graphs/s"
            for bs in HARNESS_BATCHES)
        extra = (f"; vs_fpga_par {r['vs_fpga_par']:.4f}"
                 if "vs_fpga_par" in r else "")
        if (r["conv"], r["dataset"]) == ("gcn", "qm9"):
            r["vs_torch_cpu"] = base["latency_s"] / r["latency_s"]
            extra += (f"; torch_cpu b1 {base['latency_s'] * 1e3:.4f} ms/"
                      f"graph, {r['vs_torch_cpu']:.4f}x it")
        log(f"  {r['conv']:5s} {r['dataset']:6s} {cells}; best b"
            f"{r['best_batch_size']}, energy bound "
            f"{r['energy_j_per_graph_bound']:.3e} J/graph at "
            f"{r['energy_tdp_w_assumed']} W{extra}")
    return dict(rows=rows, torch_cpu=base, checks=checks,
                grid_launches={k: v for k, v in launches.items() if v})


def _gloo_repair_rank(rank, world, init_file, state0, q):
    """One rank of the two-rank gloo world of the sharded repairs on the
    one card, in the all-gather strategy: canonical GCN under int8 with
    its weights sharded over tp = 2, and canonical GAT with QM9's edge
    features on dp = 2; each beside the one-rank forward on the plain
    path (``no_fused``, as the strategy runs), and the int8 one beside
    its float32 forward."""
    del state0
    try:
        import torch.distributed as dist

        from gnnbuilder_tpu_torch import Program
        from gnnbuilder_tpu_torch.bench.canonical import (
            canonical_batches,
            canonical_model,
        )
        from gnnbuilder_tpu_torch.compile.precision import Precision
        from gnnbuilder_tpu_torch.ops.dispatch import no_fused
        from gnnbuilder_tpu_torch.parallel.mesh import make_mesh
        from gnnbuilder_tpu_torch.parallel.sharding import (
            shard_batch,
            shard_params,
        )
        from gnnbuilder_tpu_torch.parallel.train import make_sharded_forward

        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        graphs, (b,) = canonical_batches(
            "qm9", n_graphs=REPAIR_GRAPHS, batch_size=REPAIR_GRAPHS,
            node_multiple=256, device="cpu")
        res = {}
        for name, conv, kw, dp, tp, prec in (
                ("int8_tp2", "gcn", {}, 1, 2, "int8"),
                ("edge_gat_dp2", "gat", EDGE_GAT, 2, 1, None)):
            mesh = make_mesh(dp=dp, tp=tp, device_type="cuda")
            model = canonical_model(conv, "qm9", graphs=graphs, **kw)
            Program(model, max_nodes=8, max_edges=8, max_graphs=2,
                    device=mesh.device, seed=61).init_params()
            full = b.to(mesh.device)
            params = (shard_params(mesh, model.state_dict()) if tp > 1
                      else None)
            fwd = make_sharded_forward(model, mesh, full, halo=False)
            sb = shard_batch(mesh, b, halo=False)
            policy = (Precision.from_name(prec).activate() if prec
                      else contextlib.nullcontext())
            with torch.no_grad():
                with policy:
                    out = fwd(params, sb)
                    with no_fused():
                        single = model(full)
                f32 = fwd(params, sb)
            torch.cuda.synchronize()
            whole = model.state_dict()
            res[name] = dict(
                out=out.cpu().numpy(), single=single.cpu().numpy(),
                f32=f32.cpu().numpy(), mask=full.graph_mask.cpu().numpy(),
                blocks=sum(tuple(v.shape) != tuple(whole[k].shape)
                           for k, v in (params or {}).items()),
                nodes=sb.num_nodes, edges=sb.num_edges)
        dist.barrier()
        dist.destroy_process_group()
        q.put((rank, res, None))
    except BaseException:
        import traceback

        q.put((rank, None, traceback.format_exc()))


def sharded_repair_phases(*, smi):
    """The sharded configurations that the port once refused, on the card:
    a gloo world of two ranks (``_gloo_repair_rank``) runs canonical GCN's
    int8 forward with its weights sharded over tp = 2 and canonical edge
    GAT's forward on dp = 2, both in the all-gather strategy, each held
    to its one-rank forward (int8 at ``REPAIR_INT8_TOL`` of max, the edge
    GAT at the sharded forwards' atol / rtol); the int8 forward differs
    from the float32 one, and weights are tp blocks.  No kernel runs
    there (the strategy runs the plain path).  Returns the errors."""
    out = {}
    with phase(f"sharded repairs: int8 over tp = 2 and the edge GAT over "
               f"dp = 2, a gloo world of {PAR_WORLD} on the one card"):
        t = time.time()
        ranks = _gloo_world(None, _gloo_repair_rank)
        for name in ("int8_tp2", "edge_gat_dp2"):
            for rank, res in enumerate(ranks):
                r = res[name]
                m = r["mask"]
                got = torch.from_numpy(r["out"][m])
                want = torch.from_numpy(r["single"][m])
                if name == "int8_tp2":
                    ok, abs_err, rel_err = close_enough(got, want,
                                                        REPAIR_INT8_TOL)
                else:
                    _, abs_err, rel_err = close_enough(got, want)
                    ok = bool(torch.isfinite(got).all()) and bool(
                        torch.allclose(got, want, atol=REPAIR_ATOL,
                                       rtol=REPAIR_RTOL))
                f32_err = float(np.abs(r["out"][m] - r["f32"][m]).max())
                log(f"{name} rank {rank} (N={r['nodes']}, E={r['edges']} "
                    f"local; {r['blocks']} tp blocks): against the one-rank "
                    f"forward max abs {abs_err:.3e}, {rel_err:.3e} of max "
                    f"|value|" + (f"; against float32 {f32_err:.3e}"
                                  if name == "int8_tp2" else ""))
                if not ok:
                    raise AssertionError(f"{name} rank {rank} disagrees "
                                         f"with the one-rank forward")
                if name == "int8_tp2" and not (
                        r["blocks"] and f32_err > REPAIR_INT8_TOL
                        * float(np.abs(r["f32"][m]).max())):
                    raise AssertionError("int8_tp2: no tp block, or the "
                                         "int8 policy did not reach it")
                out.setdefault(name, []).append(dict(
                    max_abs_err=abs_err, rel_err=rel_err,
                    vs_f32_max_abs=f32_err, tp_blocks=int(r["blocks"])))
        log(f"world of {PAR_WORLD}: {time.time() - t:.2f}s wall ({smi})")
    return out


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
    from gnnbuilder_tpu_torch.native import build as native_build
    from gnnbuilder_tpu_torch.ops import dispatch, ell, segment
    from gnnbuilder_tpu_torch.ops.cuda import (
        _build,
        edge_block,
        ell_agg,
        ell_bwd,
        gat_block,
        gat_bwd,
        gat_layer,
        gine_layer,
        mp_block,
        mp_layer,
        pna_block,
        pna_layer,
        readout,
        scatter_bwd,
    )

    # the gather counts per mode: the reverse table's, and the reverse
    # CSR's of batches without one
    counted = {"pna_block_stack": pna_block.fused_pna_block_stack,
               "readout": readout.fused_readout,
               "pna_layer": pna_layer.fused_pna_layer,
               "pna_scatter_bwd": scatter_bwd.fused_pna_scatter_cstk,
               "ell_gather_bwd": ell_bwd.fused_gather_backward,
               "ell_gather_bwd_csr": ell_bwd.fused_gather_backward_csr,
               "mp_block_stack": mp_block.fused_mp_block_stack,
               "mp_layer": mp_layer.fused_mp_layer,
               "gat_block": gat_block.fused_gat_block_layer,
               "gat_layer": gat_layer.fused_gat_layer,
               "gat_bwd": gat_bwd.fused_gat_scatter_backward,
               "ell_agg": ell_agg.fused_ell_aggregate,
               "gine_layer": gine_layer.fused_gine_layer,
               "edge_block": edge_block.fused_edge_block_layer}

    def only(**nonzero):
        """The launch counts of a path that launches ``nonzero``."""
        return {k: nonzero.get(k, 0) for k in counted}

    def zero_counts():
        for fn in counted.values():
            fn.launches = 0
            for per_mode in ("mode_launches", "edge_launches"):
                if hasattr(fn, per_mode):
                    setattr(fn, per_mode,
                            dict.fromkeys(getattr(fn, per_mode), 0))

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
        t = time.time()
        native_lib = native_build.build()
        native_build_s = time.time() - t
        log(f"native packer built with g++ in {native_build_s:.2f}s: "
            f"{native_lib}")

    with phase("tensor-core instructions and resources of each instance of "
               "the PNA stack, the PNA layer, the GAT projection and block, "
               "the mp stack, the PNA scatter backward, the mp layer's gin "
               "/ sage, the EdgeConv and the GINE kernels; row 7's "
               "registers"):
        tc = tc_kernel_resources(lib, _build.load(), _build.nvcc())
        for kern, insts in tc.items():
            for inst, v in insts.items():
                log(f"{kern}_kernel<{inst}>: "
                    + ", ".join(f"{k} {n}" for k, n in v.items()))
                if not sum(v[op] for op in TC_OPS):
                    raise AssertionError(f"{kern}_kernel<{inst}> has no "
                                         f"tensor-core instruction")
        for kern, inst in (("gine_layer", "bf16 64 rows, ring's weights, "
                            "2 CTAs an SM"),
                           ("gine_layer", "bf16 64 rows, caller's weights, "
                            "2 CTAs an SM")):
            if not tc[kern][inst]["DMMA"]:
                raise AssertionError(f"{kern} {inst}: bf16's T W0 runs on "
                                     "no float64 tensor core")
        g7 = _build.load().gnnb_ell_gather_bwd_info
        g7.restype = ctypes.c_int
        row7_res = {}
        for csr in (0, 1):
            for ts, tname in enumerate(("run-time terms", "lin-only", "PNA",
                                        "cmp-only")):
                for vec in (1, 0):
                    regs, ctas = ctypes.c_int(), ctypes.c_int()
                    err = g7(csr, ts, vec, ctypes.byref(regs),
                             ctypes.byref(ctas))
                    if err:
                        raise RuntimeError(f"gnnb_ell_gather_bwd_info: "
                                           f"cudaError {err}")
                    key = (f"{'CSR' if csr else 'table'} {tname} "
                           f"{'float4' if vec else 'scalar'}")
                    row7_res[key] = dict(registers=regs.value,
                                         ctas_per_sm=ctas.value)
        log("ell_gather_bwd_kernel instances (registers, CTAs an SM): "
            + "; ".join(f"{k} {v['registers']}, {v['ctas_per_sm']}"
                        for k, v in row7_res.items()))

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
        report["pna_block_stack"] = dict(max_abs_err=abs_err,
                                         resources=tc["pna_block_stack"][
                                             "f32"])

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
        err_scatter = err_gather = err_csr = 0.0
        for i, ((args, _), (_, v, agg, aux, _)) in enumerate(
                zip(layers, residuals)):
            F_i, Fout_i = args[3].shape[1], args[7].shape[1]
            ks_t = pna_layer.scaler_blocks(
                args[5], args[0].shape[1], F_i).t().contiguous()
            d_mid = torch.randn(tb.num_nodes, Fout_i, generator=gen,
                                device=dev)
            # the route of a batch without a reverse table: the cstk mode,
            # the reverse CSR of the forward table and the CSR gather
            sa = (d_mid, aux, agg, tb.in_degree, tb.nbr_nodes, v, ks_t,
                  args[9])
            got = scatter_bwd.fused_pna_scatter_backward(*sa)
            again = scatter_bwd.fused_pna_scatter_backward(*sa)
            torch.cuda.synchronize()
            want = scatter_bwd.pna_scatter_backward_plain(*sa)
            ok, abs_err, rel_err = close_enough(got, want)
            err_csr = max(err_csr, abs_err)
            log(f"table-less PNA dv {i} (cstk, reverse_csr, CSR gather): "
                f"max abs {abs_err:.3e}, {rel_err:.3e} of max |value| "
                f"against the plain scatter (tol {TOL}); bitwise equal on "
                f"two calls: {torch.equal(got, again)}")
            if not ok:
                raise AssertionError(f"table-less PNA dv {i} disagrees with "
                                     f"its plain version")
            if not torch.equal(got, again):
                raise AssertionError(f"table-less PNA dv {i}: two calls "
                                     f"differ")
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
            if not torch.equal(dv1, ell_bwd.ell_gather_backward_ordered(*ga)):
                raise AssertionError(f"ell_gather_bwd {i}: not the bits of "
                                     f"the slot-ordered loop")
            ok, abs_g, rel_g = close_enough(
                dv1, ell_bwd.ell_gather_backward_plain(*ga))
            err_gather = max(err_gather, abs_g)
            ok_s, _, rel_s = close_enough(dv1, want)
            log(f"pna_scatter_bwd {i} cstk mode: {rel_c:.3e} of max |value|; "
                f"ell_gather_bwd: {rel_g:.3e} of max |value| against its "
                f"plain version, {rel_s:.3e} against the scatter route's "
                f"plain dv (tol {TOL}); bitwise equal on two launches: "
                f"{torch.equal(dv1, dv2)}; the slot-ordered loop's bits")
            if not (ok and ok_s):
                raise AssertionError(f"ell_gather_bwd {i} disagrees")
            if not torch.equal(dv1, dv2):
                raise AssertionError(f"ell_gather_bwd {i}: two launches "
                                     f"differ")
            cs_args.append(ca)
            g_args.append(ga)
        report["pna_layer"] = dict(max_abs_err=err_layer, resources=dict(
            proj=tc["pna_proj"]["f32"], agg=tc["pna_agg"]["f32"],
            v=tc["pna_v"]["f32"]))
        # ks_t changes every step: the wrapper lays it out on every call
        ks_dev = device_ms(lambda: [scatter_bwd.stage_ks_t(a[4])
                                    for a in cs_args], 10)
        rows = _build.load().gnnb_scatter_bwd_rows(cs_args[0][0].shape[1])
        log(f"pna_scatter_bwd: {rows} rows a CTA at N={tb.num_nodes}; the "
            f"six layers' ks_t staging {ks_dev:.4f} ms device a step")
        report["pna_scatter_bwd"] = dict(
            max_abs_err=err_scatter, rows_per_cta=rows,
            ks_t_staging_device_ms=ks_dev,
            resources=tc["pna_scatter_bwd"]["f32"])
        report["ell_gather_bwd"] = dict(max_abs_err=err_gather,
                                        resources=row7_res)
        report["ell_gather_bwd_csr"] = dict(max_abs_err=err_csr)

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
        for k in ("pna_layer", "pna_scatter_bwd"):
            report[k]["launches"] = launches[k]
        report["ell_gather_bwd"]["pna_mode_launches"] = launches[
            "ell_gather_bwd"]
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
        wstaged = mp_block.stage_mp_stack(wargs[3:7], "f32")
        wide_ms = time_ms(lambda: mp_block.fused_mp_block_stack(
            *wargs, **wkw, staged=wstaged), 3)
        log(f"mp_block_stack sage at hidden 384: max abs {abs_err:.3e}, "
            f"{rel_err:.3e} of max |value| (tol {TOL}); {wide_ms:.4f} ms")
        if not ok:
            raise AssertionError("mp_block_stack at hidden 384 disagrees")
        report["mp_block_stack"] = dict(
            max_abs_err=err_mp, sage_hidden_384_ms=wide_ms,
            resources=tc["mp_block_stack"]["f32 H in shared"])

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

    with phase("row 4 (mp layer) against its plain version: six convs, "
               "ELL and block modes, canonical widths"):
        gen4 = torch.Generator(device=dev).manual_seed(17)
        mp_modes = {"ell": (tb, None), "block": (b0, b0.block_adj)}
        err_l = 0.0
        for conv in MP_LAYER_CONVS:
            for mode, (g_, badj) in mp_modes.items():
                for F_, act, with_skip, save_s in (
                        (11, "relu", True, True), (128, "tanh", False, True),
                        (128, "relu", True, False)):
                    ops, Fout = mp_layer_operands(conv, F_, gen4, dev)
                    x_ = torch.randn(g_.num_nodes, F_, generator=gen4,
                                     device=dev)
                    sk = (torch.randn(g_.num_nodes, Fout, generator=gen4,
                                      device=dev) if with_skip else None)
                    kw = dict(ops, skip=sk, act=act, save_s=save_s,
                              block_adj=badj)
                    got = mp_layer.fused_mp_layer(x_, g_.nbr_nodes,
                                                  g_.in_degree, conv, **kw)
                    torch.cuda.synchronize()
                    want = mp_layer.mp_layer_plain(x_, g_.nbr_nodes,
                                                   g_.in_degree, conv, **kw)
                    if not save_s:
                        got, want = (got,), (want,)
                    real = g_.node_mask
                    for name, a, w in zip(("out", "s"), got, want):
                        ok, abs_err, rel_err = close_enough(a[real], w[real])
                        err_l = max(err_l, abs_err)
                        if not ok:
                            raise AssertionError(
                                f"mp_layer {conv} {mode} F={F_} {name}: "
                                f"{rel_err:.3e} of max |value| against its "
                                f"plain version (tol {TOL})")
                log(f"mp_layer {conv} {mode} [N={g_.num_nodes}]: out and s "
                    f"within tol at F = 11 and 128, relu + skip and tanh")
        report["mp_layer"] = dict(max_abs_err=err_l)

    with phase("row 7's CSR mode against its plain version on two batches "
               "without a reverse table"):
        star_b = one_way_star_batch(tgraphs[:255], dev)
        gen7 = torch.Generator(device=dev).manual_seed(19)
        for label, g_ in (("b1024 train batch, rev_ell_width=0",
                           tb.replace(rev_nbr_nodes=None, out_degree=None)),
                          ("one-way 70-leaf star", star_b)):
            if g_.rev_nbr_nodes is not None or g_.nbr_nodes is None:
                raise AssertionError(f"{label}: needs an ELL table and no "
                                     f"reverse table")
            ptr, idx = ell.reverse_csr(g_.nbr_nodes, g_.in_degree)
            n_ = g_.num_nodes
            vv = torch.randn(n_, 128, generator=gen7, device=dev)
            cs7 = torch.randn(n_, 7 * 128, generator=gen7, device=dev)
            hit = torch.rand(n_, 128, generator=gen7, device=dev) < 0.5
            cs7[:, 384:512] = torch.where(hit, vv, cs7[:, 384:512])
            for terms, ga in (
                    ("lin-only", (cs7[:, :128].contiguous(), ptr, idx, None,
                                  True, False, 0)),
                    ("PNA", (cs7, ptr, idx, vv, True, True, 2))):
                one = ell_bwd.fused_gather_backward_csr(*ga)
                two = ell_bwd.fused_gather_backward_csr(*ga)
                torch.cuda.synchronize()
                if not torch.equal(
                        one, ell_bwd.ell_gather_backward_csr_ordered(*ga)):
                    raise AssertionError(f"ell_gather_bwd_csr on {label} "
                                         f"({terms}): not the bits of the "
                                         f"slot-ordered loop")
                ok, abs_err, rel_err = close_enough(
                    one, ell_bwd.ell_gather_backward_csr_plain(*ga))
                report["ell_gather_bwd_csr"]["max_abs_err"] = max(
                    report["ell_gather_bwd_csr"]["max_abs_err"], abs_err)
                log(f"{label} (N={n_}, largest out-degree "
                    f"{int((ptr[1:] - ptr[:-1]).max())}), {terms} terms: "
                    f"{rel_err:.3e} of max |value| (tol {TOL}); bitwise "
                    f"equal on two launches: {torch.equal(one, two)}")
                if not ok or not torch.equal(one, two):
                    raise AssertionError(f"ell_gather_bwd_csr on {label} "
                                         f"({terms})")

    torch.set_grad_enabled(True)
    mp_models = {}
    with phase("GCN, GIN and SAGE training: gradients of one step against "
               "the plain path, and two steps from one state"):
        for conv in MP_CONVS:
            m_ = canonical_model(conv, "qm9", graphs=tgraphs)
            p_ = Program(m_, max_nodes=tb.num_nodes, max_edges=tb.num_edges,
                         max_graphs=tb.num_graphs, device="cuda", seed=21)
            st_ = {k: v.clone() for k, v in p_.init_params().items()}
            mp_models[conv] = (m_, p_, st_)
            again = []
            for _ in range(2):
                m_.load_state_dict(st_)
                fresh_step(m_)(tb, target)
                torch.cuda.synchronize()
                again.append(grads_of(m_))
            same = [k for k in again[0]
                    if torch.equal(again[0][k], again[1][k])]
            refs = {}
            for name, dt in (("float64", torch.float64),
                             ("float32", torch.float32)):
                mr = canonical_model(conv, "qm9", graphs=tgraphs).to(dev)
                mr = mr.to(dt)
                mr.load_state_dict({k: v.to(dt) for k, v in st_.items()})
                dispatch.set_fused_mode("never")
                try:
                    train.masked_mse_loss(
                        mr(tb.replace(node_feat=tb.node_feat.to(dt))),
                        target.to(dt), tm).backward()
                finally:
                    dispatch.set_fused_mode("auto")
                refs[name] = grads_of(mr)
                del mr
            # GIN's gate is the float32 plain path: relu decisions within
            # float32 rounding of 0 go the other way in float64 (three on
            # this batch in every float32 path), each moving a gradient
            # by ~1e-3 of its max
            gate = "float32" if conv == "gin" else "float64"
            for name in ("float64", "float32"):
                ok, abs_err, rel, k = worst_grad(again[0], refs[name])
                log(f"{conv}: gradients vs {name} plain path worst "
                    f"{rel:.3e} of max |value| ({k}), max abs {abs_err:.3e}"
                    + (f" (tol {TOL})" if name == gate else " (logged)"))
                if name == gate and not ok:
                    raise AssertionError(f"{conv} gradients disagree with "
                                         f"the {name} plain path")
            log(f"{conv}: bitwise-equal gradients on two steps: {len(same)} "
                f"of {len(again[0])}")
            if len(same) != len(again[0]):
                raise AssertionError(f"{conv}: two train steps from one "
                                     f"state gave different gradients")

    with phase(f"main path: {MP_TRAIN_STEPS} Adam steps each of canonical "
               f"GCN, GIN and SAGE on the train batch"):
        mp_curves, mp_train_launches, lin_launches = {}, 0, 0
        for conv in MP_CONVS:
            m_, _, st_ = mp_models[conv]
            m_.load_state_dict(st_)
            step_ = fresh_step(m_)
            zero_counts()
            mp_curves[conv] = [float(step_(tb, target))
                               for _ in range(MP_TRAIN_STEPS)]
            torch.cuda.synchronize()
            launches = counts()
            log(f"{conv}: losses {mp_curves[conv]}; launches {launches}")
            want = only(mp_layer=6 * MP_TRAIN_STEPS,
                        ell_gather_bwd=6 * MP_TRAIN_STEPS,
                        readout=MP_TRAIN_STEPS)
            if launches != want:
                raise AssertionError(f"{conv} train launches {launches}, "
                                     f"expected {want}")
            if not all(math.isfinite(x_) for x_ in mp_curves[conv]):
                raise AssertionError(f"{conv}: non-finite loss")
            mp_train_launches += launches["mp_layer"]
            lin_launches += launches["ell_gather_bwd"]
        report["mp_layer"]["launches"] = mp_train_launches
        report["ell_gather_bwd"]["launches"] = lin_launches

    with phase("PNA and GCN train steps on the train batch without its "
               "reverse table (rev_ell_width=0): two steps from one state"):
        tb_nr = tb.replace(rev_nbr_nodes=None, out_degree=None)
        csr_launches = 0
        for conv, mdl, st_, want in (
                ("pna", tmodel, state0,
                 only(pna_layer=6, pna_scatter_bwd=6, ell_gather_bwd_csr=6,
                      readout=1)),
                ("gcn", mp_models["gcn"][0], mp_models["gcn"][2],
                 only(mp_layer=6, ell_gather_bwd_csr=6, readout=1))):
            again = []
            for _ in range(2):
                mdl.load_state_dict(st_)
                step_ = fresh_step(mdl)
                zero_counts()
                step_(tb_nr, target)
                torch.cuda.synchronize()
                launches = counts()
                if launches != want:
                    raise AssertionError(f"{conv} table-less step launches "
                                         f"{launches}, expected {want}")
                csr_launches += launches["ell_gather_bwd_csr"]
                again.append(grads_of(mdl))
            same = [k for k in again[0]
                    if torch.equal(again[0][k], again[1][k])]
            log(f"{conv}: launches {launches}; bitwise-equal gradients "
                f"{len(same)} of {len(again[0])}")
            if len(same) != len(again[0]):
                raise AssertionError(f"{conv}: table-less train steps from "
                                     f"one state gave different gradients")
        report["ell_gather_bwd_csr"]["launches"] = csr_launches
    torch.set_grad_enabled(False)

    with phase("Program.forward of GCN, GIN and SAGE on the standard-packed "
               "batch and of LG, Simple-sum and Simple-mean on the block "
               "batches, against the plain path"):
        sw_graphs, sw_batches = canonical_batches(
            "qm9", n_graphs=BATCH_GRAPHS * N_BATCHES,
            batch_size=BATCH_GRAPHS, block_size=128, node_multiple=1024,
            node_dim=128, device=dev)
        fwd_cells = {}
        for conv in MP_CONVS:
            m_, p_, st_ = mp_models[conv]
            m_.load_state_dict(st_)
            fwd_cells[conv] = (p_, [tb])
        for name, conv, kw in SAME_WIDTH:
            m_ = canonical_model(conv, "qm9", graphs=sw_graphs,
                                 conv_kwargs=kw)
            p_ = Program(m_, max_nodes=sw_batches[0].num_nodes,
                         max_edges=sw_batches[0].num_edges,
                         max_graphs=sw_batches[0].num_graphs,
                         block_size=128, device="cuda", seed=23)
            p_.init_params()
            fwd_cells[name] = (p_, sw_batches)
        for name, (p_, bs_) in fwd_cells.items():
            zero_counts()
            outs_ = [p_.forward(b) for b in bs_]
            torch.cuda.synchronize()
            launches = counts()
            want = only(mp_layer=6 * len(bs_), readout=len(bs_))
            if launches != want:
                raise AssertionError(f"{name} forward launches {launches}, "
                                     f"expected {want}")
            dispatch.set_fused_mode("never")
            try:
                refs_ = [p_.forward(b) for b in bs_]
            finally:
                dispatch.set_fused_mode("auto")
            for i, (b, o_, r_) in enumerate(zip(bs_, outs_, refs_)):
                m = b.graph_mask
                ok, abs_err, rel_err = close_enough(o_[m], r_[m])
                if not ok or tuple(o_.shape) != (b.num_graphs, 1):
                    raise AssertionError(f"{name} forward {i} disagrees "
                                         f"({rel_err:.3e} of max |value|)")
            log(f"{name}: launches {launches}; outputs within tol ({TOL}) of "
                f"the per-layer plain path on {len(bs_)} batch(es) of N="
                f"{bs_[0].num_nodes}")

    gat = gat_phases(report, dev=dev, graphs=graphs, batches=batches, b0=b0,
                     tgraphs=tgraphs, tb=tb, target=target,
                     zero_counts=zero_counts, counts=counts, only=only,
                     fresh_step=fresh_step, smi=smi)
    report["gat_layer"]["resources"] = tc["gat_proj_tc"]
    report["gat_block"]["resources"] = tc["gat_block_tc"]
    edge_agg = edge_agg_phases(
        report, dev=dev, graphs=graphs, batches=batches, b0=b0,
        tgraphs=tgraphs, tb=tb, target=target, zero_counts=zero_counts,
        counts=counts, only=only, fresh_step=fresh_step, smi=smi)
    report["gine_layer"]["resources"] = tc["gine_layer"]
    precision = precision_phases(
        report, dev=dev, graphs=graphs, batches=batches, b0=b0, tb=tb,
        prog=prog, counted=counted, zero_counts=zero_counts, smi=smi,
        tc=tc["pna_block_stack"], tcl=tc)
    slice_modes = slice_phases(
        report, dev=dev, graphs=graphs, b0=b0, tb=tb, counted=counted,
        zero_counts=zero_counts, smi=smi)
    serving = serving_phases(
        report, dev=dev, graphs=graphs, batches=batches, b0=b0, tb=tb,
        counted=counted, zero_counts=zero_counts, smi=smi)
    edge_gat = edge_gat_phases(
        report, dev=dev, graphs=graphs, b0=b0, tgraphs=tgraphs, tb=tb,
        target=target, counted=counted, zero_counts=zero_counts,
        counts=counts, only=only, fresh_step=fresh_step, smi=smi)
    measurement = measurement_phases(dev=dev, graphs=graphs, batches=batches,
                                     prog=prog, mp_progs=mp_progs, smi=smi)
    trainer_verify = trainer_verify_phases(
        dev=dev, graphs=graphs, batches=batches, b0=b0, prog=prog,
        tgraphs=tgraphs, tb=tb, target=target, state0=state0,
        fresh_step=fresh_step, zero_counts=zero_counts, counts=counts,
        only=only, smi=smi, native_build_s=native_build_s)
    parallel, parallel_entry = parallel_phases(
        dev=dev, tgraphs=tgraphs, tb=tb, target=target, state0=state0,
        fresh_step=fresh_step, zero_counts=zero_counts, counts=counts,
        only=only, smi=smi)
    dse = dse_phases(dev=dev, zero_counts=zero_counts, counts=counts,
                     smi=smi)
    policy_grad = policy_grad_phases(
        report, dev=dev, tgraphs=tgraphs, tb=tb, target=target,
        counted=counted, zero_counts=zero_counts, counts=counts, only=only,
        smi=smi)
    harness_grid = harness_phases(zero_counts=zero_counts, counts=counts,
                                  only=only, smi=smi)
    sharded_repairs = sharded_repair_phases(smi=smi)

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
        s_agg = sum(5 * edges * w[1] for w in widths)
        s_pad = L * layer_flops(N, edges, 128, 128, 128, 5)
        s_bytes = 4 * (N * widths[0][0] + N * widths[-1][2] + N * W + N
                       + sum(layer_weights(*w) for w in widths))
        s_bound, s_by = bound_f32_products(s_flops - s_agg, s_agg, s_bytes)
        # the weights in the kernel's layout, as Program's model caches it
        staged = pna_block.stage_stack(sargs[3:], "f32")
        log(f"pna_block_stack: weights streamed into shared memory "
            f"{staged.numel() * 4 * (N // 128) / 1e9:.3f} GB a forward, "
            f"{staged.numel() * 4 / 1e6:.3f} MB a block (each layer's "
            f"once, f32 as TF32 halves)")
        report["pna_block_stack"].update(
            ms=time_ms(lambda: pna_block.fused_pna_block_stack(
                *sargs, **skw, staged=staged), 10),
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
        # the head packed once, as the model caches it for inference
        packed = readout.pack_head(head)
        r_fn = lambda: readout.fused_readout(h, b0.n_node, packed, **rkw)
        r_dms, r_ems = timed(r_fn, 50)
        sm_fn = lambda: segment.contiguous_segment_max(
            h, b0.graph_starts, b0.n_node, b0.max_graph_nodes_static)
        sm_dms, sm_ems = timed(sm_fn, 50)
        report["readout"].update(
            ms=r_ems, device_ms=r_dms,
            pairs_ms=time_ms(lambda: readout.fused_readout(*rargs, **rkw),
                             50),
            plain_ms=time_ms(lambda: readout.readout_plain(
                h, b0.n_node, b0.graph_starts, head, aggrs, mx,
                model.mlp_activation, model.output_activation), 20),
            bound_ms=r_bound, bound_by=r_by,
            flops=r_flops, bytes=r_bytes,
            segment_max_ms=sm_ems, segment_max_device_ms=sm_dms)
        log(f"readout f32 (packed head), device ms (event ms): {r_dms:.4f} "
            f"({r_ems:.4f}); with (w, b) pairs packed per call "
            f"{report['readout']['pairs_ms']:.4f} events; the plain max "
            f"pooling before it (contiguous_segment_max) {sm_dms:.4f} "
            f"({sm_ems:.4f})")

        # train kernels: the six launches of one step, at the shapes and on
        # the operands of the canonical model's layers; the kernel timed on
        # its weights laid out beforehand, the train step's operands (its
        # live weights padded and laid out, every call) timed apart
        l_staged = [pna_layer.stage_layer(a[3], a[5], a[7], "f32")
                    for a, _ in layers]
        live = [c._weights() for c in tmodel.gnn_convs]
        with torch.enable_grad():
            padded = [pna_layer._pad_weights(*w) for w in live]

        def stage_all():
            # the layout alone, of the padded live weights
            return pna_layer.stage_layers(
                [(w[0], w[2], w[4]) for w in padded], "f32")

        def operands_all():
            # what a train step makes: the live weights padded, laid out
            with torch.enable_grad():
                return pna_layer.layer_operands(live, "f32")

        def run_layers(fn):
            for (args, kw), st in zip(layers, l_staged):
                if fn is pna_layer.fused_pna_layer:
                    kw = dict(kw, staged=st)
                fn(*args, **kw, save_res=True)

        for key, fn, what in (
                ("train_layout", stage_all,
                 "stage_layers of the 6 layers' padded live f32 weights"),
                ("train_operands", operands_all,
                 "layer_operands of the 6 layers' live f32 weights")):
            lay_dev, lay_ev = timed(fn, 10)
            lay_host = host_ms(fn, 10)
            report["pna_layer"][key] = dict(
                device_ms=lay_dev, event_ms=lay_ev, host_ms=lay_host,
                per=what)
            log(f"pna_layer: the train step's {what}: device {lay_dev:.4f} "
                f"ms, events {lay_ev:.4f} ms, host {lay_host:.4f} ms a step "
                f"({smi})")
        am = pna_layer.agg_rows(tb.num_nodes, "f32", dev)
        log(f"pna_layer aggregate launch: {am} rows a CTA, "
            f"{-(-tb.num_nodes // am)} CTAs for N={tb.num_nodes}")

        def run_each(fn, arg_list):
            for a in arg_list:
                fn(*a)

        E = int(tb.in_degree.sum())
        Nt, Wt = tb.num_nodes, tb.ell_width
        Wr = tb.rev_nbr_nodes.shape[1]
        l_flops = l_bytes = c_flops = c_bytes = l_pad = c_pad = c_other = 0
        g_flops = g_bytes = g_pad = l_gather = 0
        for (args, kw), (Fi, Fl, Fo) in zip(layers, pna_widths(tmodel)):
            # the five products, ~5 ops per gathered value (add,
            # square-add, max, min), 2 compares per gathered value for ties
            l_flops += layer_flops(Nt, E, Fi, Fl, Fo, 7)
            l_gather += 7 * E * Fl
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
            c_other += 10 * Nt * Fl
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
            # rows 5 and 6 run their products on the tensor cores: their
            # bounds restated
            b_ms, b_by = (
                bound_f32_products(fl - l_gather, l_gather, by)
                if name == "pna_layer" else
                bound_f32_products(fl - c_other, c_other, by)
                if name == "pna_scatter_bwd" else bound(fl, by))
            ent = dict(ms=time_ms(fn, 10), plain_ms=time_ms(plain, 3),
                       bound_ms=b_ms, bound_by=b_by, flops=fl,
                       padded_flops=pads[name], bytes=by,
                       per="PNA train step (6 launches)")
            if name == "ell_gather_bwd":   # the PNA terms; the headline
                report[name]["pna_mode"] = ent   # is this slice's lin-only
            else:
                report[name].update(ent)
        pm = report["ell_gather_bwd"]["pna_mode"]
        log(f"ell_gather_bwd PNA terms: {pm['ms']:.4f} ms per PNA step "
            f"(plain {pm['plain_ms']:.4f} ms, bound {pm['bound_ms']:.4f} ms "
            f"by {pm['bound_by']})")
        mp_timed = mp_times(report, tb=tb, mp_modes=mp_modes, g_args=g_args,
                            sc_args=sc_args, mp_models=mp_models,
                            fwd_cells=fwd_cells, target=target,
                            fresh_step=fresh_step)

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
            # the products run on the tensor cores: the bound restated
            prod = mp_products(conv, Nb, widths)
            b_ms, b_by = bound_f32_products(prod, fl - prod, by)
            # on weights laid out beforehand, as the model caches them
            staged = mp_block.stage_mp_stack(margs[3:7], "f32")
            by_conv[conv] = dict(
                ms=time_ms(lambda: mp_block.fused_mp_block_stack(
                    *margs, **mkw, staged=staged), 10),
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

    with phase("GCN train step split (torch.profiler, 3 steps)"):
        m_, _, st_ = mp_models["gcn"]
        m_.load_state_dict(st_)
        step_ = fresh_step(m_)
        step_(tb, target)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            for _ in range(3):
                step_(tb, target)
            torch.cuda.synchronize()
            gcn_wall_ms = (time.time() - t) * 1e3 / 3
        gcn_split = split_device_time(prof, 3)
        gcn_busy = sum(gcn_split.values())
        split_line = ", ".join(f"{k} {v:.4f}" for k, v in gcn_split.items())
        log(f"GCN device ms per step by part: {split_line}; busy "
            f"{gcn_busy:.4f} of {gcn_wall_ms:.4f} ms wall")
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
             **report["ell_gather_bwd"]),
        dict(name="ell_gather_bwd_csr", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/ell_bwd.cu",
             replaces="gnnbuilder_tpu/ops/pallas/ell_bwd.py:259",
             **report["ell_gather_bwd_csr"]),
        dict(name="mp_layer", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/mp_layer.cu",
             replaces="gnnbuilder_tpu/ops/pallas/mp_layer.py:341",
             **report["mp_layer"]),
        dict(name="gat_block", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/gat_block.cu",
             replaces="gnnbuilder_tpu/ops/pallas/gat_block.py:164",
             **report["gat_block"]),
        dict(name="gat_layer", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/gat_layer.cu",
             replaces="gnnbuilder_tpu/ops/pallas/gat_layer.py:308",
             **report["gat_layer"]),
        dict(name="gat_bwd", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/gat_bwd.cu",
             replaces="gnnbuilder_tpu/ops/pallas/gat_bwd.py:297",
             **report["gat_bwd"]),
        dict(name="ell_agg", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/ell_agg.cu",
             replaces="gnnbuilder_tpu/ops/pallas/ell_agg.py:205",
             **report["ell_agg"]),
        dict(name="gine_layer", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/gine_layer.cu",
             replaces="gnnbuilder_tpu/ops/pallas/gine_layer.py:253",
             **report["gine_layer"]),
        dict(name="edge_block", route="cuda",
             source="gnnbuilder_tpu_torch/csrc/edge_block.cu",
             replaces="gnnbuilder_tpu/ops/pallas/edge_block.py:151",
             **report["edge_block"]),
    ] + [
        dict(name=f"{k}_{mode}", route="cuda",
             source=f"gnnbuilder_tpu_torch/csrc/{src}.cu",
             replaces=f"gnnbuilder_tpu/ops/pallas/{src}.py:{line}",
             library_ms=None, **report[f"{k}_{mode}"])
        for mode in PREC_MODES
        for k, src, line in (("pna_block_stack", "pna_block", 392),
                             ("readout", "readout", 186),
                             ("pna_layer", "pna_layer", 458))
    ] + [
        dict(name=f"{k}_{mode}", route="cuda",
             source=f"gnnbuilder_tpu_torch/csrc/{src}.cu",
             replaces=f"gnnbuilder_tpu/ops/pallas/{src}.py:{line}",
             **report[f"{k}_{mode}"])
        for k, (src, line, modes) in {**SLICE_KERNELS,
                                      **GAT_MODE_KERNELS}.items()
        for mode in modes
    ] + [
        dict(name=name + ("" if mode == "f32" else f"_{mode}"), route="cuda",
             source=f"gnnbuilder_tpu_torch/csrc/{src}.cu",
             replaces=f"gnnbuilder_tpu/ops/pallas/{src}.py:{line}",
             **report[name + ("" if mode == "f32" else f"_{mode}")])
        for name, src, line, modes in EDGE_KERNELS.values()
        for mode in modes
    ] + [parallel_entry]
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
        "mp_train": dict(batch_graphs=BATCH_GRAPHS, **mp_timed["train"],
                         loss_curves=mp_curves,
                         gcn_device_ms_per_step=gcn_split,
                         gcn_profiled_wall_ms=gcn_wall_ms),
        "mp_layer_forward": dict(batch_graphs=BATCH_GRAPHS,
                                 **mp_timed["forward"]),
        "gat": dict(batch_graphs=BATCH_GRAPHS, heads=GAT_HEADS, **gat),
        "gine_edge_agg": dict(batch_graphs=BATCH_GRAPHS, **edge_agg),
        "precision": dict(batch_graphs=BATCH_GRAPHS, **precision),
        "slice_modes": dict(batch_graphs=BATCH_GRAPHS, **slice_modes),
        "gat_modes_serving": dict(batch_graphs=BATCH_GRAPHS,
                                  heads=GAT_HEADS, **serving),
        "edge_gat": dict(batch_graphs=BATCH_GRAPHS, heads=GAT_HEADS,
                         edge_dim=4, **edge_gat),
        "measurement": measurement,
        "trainer_verify": trainer_verify,
        "parallel": parallel,
        "dse": dse,
        "policy_grad": policy_grad,
        "harness": harness_grid,
        "sharded_repairs": sharded_repairs,
    }), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

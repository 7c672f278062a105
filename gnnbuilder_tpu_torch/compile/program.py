"""Program — the run driver: owns the model's parameters, the padding
bucket and the device, packs batches and runs the forward.

The JAX package's ``Program`` compiles one XLA executable per bucket; here
PyTorch runs eagerly and the bucket only fixes the padded shapes.  The
device is explicit: ``device=None`` means the CUDA card and raises when
there is none; the CPU runs only when the caller asks for it.

``precision`` ("f32", "bf16" or "int8", ``compile.precision``) is the
forward's policy, as in the JAX package: ``params`` stays the float32
master; under bf16 the forward runs a copy of the model whose parameters
are the master rounded to bf16 (``Precision.cast_params``, held as
float32 values) on node features rounded to bf16; under int8 it runs the
master with every ``Linear`` quantized, with the static activation scales
of ``calibrate_int8`` when it has them.  The output is float32.

Serving (``serve.GNNServer``) sizes the bucket with ``from_dataset``,
warms the forward with ``compile`` and ships ``export`` /
``export_bundle``.  The JAX package's artifact is a traced StableHLO
program; the kernels here are plain-C launchers called through ctypes,
which no tracer sees, so the artifact is the Program's own description
instead: a JSON file with ``GNNModel.spec()``, the policy, the bucket,
the block size, the pinned batch widths (largest graph, ELL and reverse
ELL widths) and the frozen ``int8_scales``, from which
``load_exported`` rebuilds the Program (building the kernel library on
the card); ``export_bundle`` puts the parameters beside it as a state
dict that ``load_bundle`` reads with ``torch.load(weights_only=True)``:
no pickled code.

Measurement, on the card only: ``benchmark`` times eager forwards with
CUDA events (the host's gaps between launches included);
``benchmark_inner`` replays k chained forwards captured in one CUDA graph
and takes the slope over two k (device time per forward).
``cost_analysis`` counts FLOPs and bytes from shapes
(``compile/cost.py``), on the CPU too.

Verification: ``gen_testbench_data`` writes the reference's golden files
(``verify/golden.py``), ``run_parity_check`` replays graphs against them
on the Program's device.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
from typing import Optional, Sequence

import torch

from gnnbuilder_tpu_torch.compile.precision import Precision
from gnnbuilder_tpu_torch.core.graph import (
    GraphBatch,
    build_graph_batch,
    resolve_device,
)
from gnnbuilder_tpu_torch.nn.model import GNNModel

__all__ = ["Program", "BucketSpec", "resolve_device",
           "enable_persistent_cache", "ARTIFACT_FORMAT"]

# the ``format`` entry of an exported artifact
ARTIFACT_FORMAT = "gnnbuilder_tpu_torch.program/1"
# the file names inside an ``export_bundle`` directory
BUNDLE_ARTIFACT, BUNDLE_PARAMS = "model.json", "params.pt"


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Keep compiled kernels across processes (serving cold start).  The
    JAX package's persistent cache of compiled executables maps onto the
    hashed nvcc build directory (``ops/cuda/_build.py``): a process loads
    the library an earlier one built for the same sources, headers, flags
    and compiler, and builds only when there is none.  That directory
    persists already, under ``build/gnnbuilder_tpu_torch`` of the
    checkout; ``path`` moves it (a library this process has loaded stays
    loaded).  Returns the directory."""
    from gnnbuilder_tpu_torch.ops.cuda import _build

    if path is not None:
        _build.set_build_root(path)
    return str(_build.build_root())


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static padded sizes of every batch this Program runs."""

    max_nodes: int
    max_edges: int
    max_graphs: int

    def fits(self, n: int, e: int, g: int) -> bool:
        """Whether ``g`` graphs of ``n`` nodes and ``e`` edges in all fit,
        beside the ghost node and the ghost graph."""
        return (
            n + 1 <= self.max_nodes
            and e <= self.max_edges
            and g + 1 <= self.max_graphs
        )


class Program:
    def __init__(
        self,
        model: GNNModel,
        max_nodes: int = 500,
        max_edges: int = 500,
        max_graphs: int = 2,
        precision: Precision | str = "f32",
        seed: int = 0,
        block_size: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        if block_size:
            assert max_nodes % block_size == 0, (max_nodes, block_size)
        # block_size > 0 selects block-diagonal packing (core/graph.py),
        # which the whole-stack kernel needs
        self.block_size = int(block_size)
        self.bucket = BucketSpec(max_nodes, max_edges, max_graphs)
        self.precision = (
            precision if isinstance(precision, Precision)
            else Precision.from_name(precision)
        )
        self._seed = seed
        self._initialized = False
        self.int8_scales: Optional[dict] = None
        self._cast = None      # (master key, bf16-rounded model copy)
        self._loaded = None    # the params mapping ``_call`` loaded last
        # batch widths the exported artifact pins (``export``)
        self._pinned = dict(max_graph_nodes=None, ell_width=None,
                            rev_ell_width=None)

    # ------------------------------------------------------------ construct
    @classmethod
    def from_dataset(cls, model: GNNModel, graphs, batch_size: int = 1,
                     headroom: float = 1.0, **kw) -> "Program":
        """A Program whose bucket fits the ``batch_size`` largest graphs
        of ``graphs`` packed together (times ``headroom``), so any batch
        drawn from them fits: the JAX package's sizing, as its serving
        benchmark sizes the server's bucket.  Block packing
        (``block_size``) budgets the worst bin-pack waste, ~half a block
        per graph boundary, aligned to the block."""
        ns = sorted((g.x.shape[0] for g in graphs), reverse=True)
        es = sorted((g.edge_index.shape[1] for g in graphs), reverse=True)
        k = min(batch_size, len(ns))
        max_nodes = int((sum(ns[:k]) + 1) * headroom) + 8
        max_edges = int(max(sum(es[:k]), 1) * headroom) + 8
        blk = int(kw.get("block_size", 0) or 0)
        if blk:
            waste = blk / max(blk - (max_nodes / max(k, 1)) / 2.0, 1.0)
            max_nodes = int(-(-int(max_nodes * waste + 1) // blk) * blk)
        return cls(model, max_nodes=max_nodes, max_edges=max_edges,
                   max_graphs=batch_size + 1, **kw)

    # ------------------------------------------------------------ params
    def init_params(self, example_batch: Optional[GraphBatch] = None):
        """Seeded init, torch.nn.Linear's law U(+-1/sqrt(fan_in)) for weight
        and bias (where the Linear has one) and GAT's attention vectors
        [1, H, C] (``att_edge`` too, with edge features) glorot-uniform
        U(+-sqrt(6 / (H + C))) (the JAX package's init), drawn from one
        ``torch.Generator`` in module order; GCN's
        and GAT's separate biases stay zero, as in the JAX package.
        Returns the state dict."""
        from gnnbuilder_tpu_torch.nn.conv import GATConv

        gen = torch.Generator().manual_seed(self._seed)
        with torch.no_grad():
            for mod in self.model.modules():
                if isinstance(mod, GATConv):
                    bound = math.sqrt(6.0 / (mod.heads + mod.out_channels))
                    atts = [mod.att_src, mod.att_dst]
                    if mod.edge_dim is not None:
                        atts.append(mod.att_edge)
                    for p in atts:
                        r = torch.rand(p.shape, generator=gen)
                        p.copy_((2.0 * r - 1.0) * bound)
                if isinstance(mod, torch.nn.Linear):
                    bound = 1.0 / math.sqrt(mod.in_features)
                    for p in (mod.weight, mod.bias):
                        if p is None:
                            continue
                        r = torch.rand(p.shape, generator=gen)
                        p.copy_((2.0 * r - 1.0) * bound)
        self._initialized = True
        return self.model.state_dict()

    def set_params(self, params: dict):
        """Load a state dict (e.g. ``port.params_from_jax``'s result)."""
        self.model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in params.items()}
        )
        self._initialized = True

    @property
    def params(self) -> dict:
        return self.model.state_dict()

    # ----------------------------------------------------------- batching
    def batch(self, graphs: Sequence) -> GraphBatch:
        return build_graph_batch(
            graphs,
            node_budget=self.bucket.max_nodes,
            edge_budget=self.bucket.max_edges,
            graph_budget=self.bucket.max_graphs,
            block_size=self.block_size or None,
            device=self.device,
        )

    def _dummy_batch(self) -> GraphBatch:
        """One small random graph in this bucket, at the pinned widths
        (the JAX package's example batch when the caller gives none)."""
        from gnnbuilder_tpu_torch.data.datasets import FakeDataset

        gs = FakeDataset(num_graphs=1, avg_num_nodes=4,
                         node_dim=self.model.graph_input_feature_dim,
                         edge_dim=(self.model.graph_input_edge_dim
                                   or self.model.conv_kwargs.get("edge_dim")
                                   or 1))
        pin = self._pinned
        b = build_graph_batch(
            gs, node_budget=self.bucket.max_nodes,
            edge_budget=self.bucket.max_edges,
            graph_budget=self.bucket.max_graphs,
            ell_width=pin["ell_width"], rev_ell_width=pin["rev_ell_width"],
            block_size=self.block_size or None, device=self.device)
        if pin["max_graph_nodes"]:
            b = b.replace(max_graph_nodes_static=pin["max_graph_nodes"])
        return b

    # ------------------------------------------------------------ forward
    def _policy_model(self) -> GNNModel:
        """The model the forward runs: under bf16 a copy whose parameters
        are the master's rounded to bf16, rebuilt when a master parameter
        is replaced or changed in place; else the model itself."""
        if self.precision.name != "bf16":
            return self.model
        key = tuple((id(p), p._version) for p in self.model.parameters())
        if self._cast is None or self._cast[0] != key:
            cast = self.precision.cast_params(self.model.state_dict())
            cache, self.model._kernel_cache = self.model._kernel_cache, {}
            try:    # the copy starts with an empty kernel cache
                model = copy.deepcopy(self.model)
            finally:
                self.model._kernel_cache = cache
            model.load_state_dict({k: v.float() for k, v in cast.items()})
            self._cast = (key, model)
        return self._cast[1]

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        """[G, out] float32 predictions, ghost row included (mask with
        ``batch.graph_mask``).  Runs under inference scope and the
        precision policy, so a block-packed batch goes through the stack
        and readout kernels in the policy's mode."""
        from gnnbuilder_tpu_torch.ops.dispatch import inference_mode
        from gnnbuilder_tpu_torch.ops.quant import calibration, to_bf16

        if not self._initialized:
            self.init_params(batch)
        if batch.device != self.device:
            raise ValueError(f"batch on {batch.device}, program on "
                             f"{self.device}")
        prec = self.precision
        if prec.name == "bf16":
            batch = batch.replace(node_feat=to_bf16(batch.node_feat))
        static = (calibration(scales=self.int8_scales) if self.int8_scales
                  else contextlib.nullcontext())
        with torch.no_grad(), inference_mode(), prec.activate(), static:
            return self._policy_model()(batch).float()

    def _call(self, params, batch: GraphBatch) -> torch.Tensor:
        """``forward`` with ``params``: a state dict, loaded when it is not
        the mapping loaded last (a fresh dict reloads, bumping the kernel
        caches), or None for the parameters the Program holds."""
        if params is not None and params is not self._loaded:
            self.set_params(params)
            self._loaded = params
        return self.forward(batch)

    def compile(self, example_batch: Optional[GraphBatch] = None):
        """Warm the forward for this bucket and return ``fn(params,
        batch)`` (``params`` None = the Program's own).  PyTorch runs
        eagerly, so this compiles nothing: on the card it loads the kernel
        library (building it from the sources when no build is cached) and
        runs one forward on ``example_batch`` (a one-graph batch when
        None), which fills the model's kernel caches of the active policy
        (the bf16 copy, the mode weights), then waits for the card.  A
        server calls it before its threads start, so that only one thread
        builds."""
        if example_batch is None:
            example_batch = self._dummy_batch()
        if not self._initialized:
            self.init_params(example_batch)
        if self.device.type == "cuda":
            from gnnbuilder_tpu_torch.ops.cuda import _build

            _build.load()
        self.forward(example_batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self._call

    # ------------------------------------------------------------ export
    def export(self, path: str,
               example_batch: Optional[GraphBatch] = None) -> str:
        """Write the artifact that rebuilds this Program (module
        docstring) to ``path``: JSON with the model's constructor
        arguments, the policy, the bucket, the block size, the frozen
        ``int8_scales`` and the batch widths ``example_batch`` pins (its
        largest-graph bound and ELL widths; unpinned without one).  The
        parameters are not in it (``export_bundle`` adds them).  Returns
        ``path``."""
        pin = dict(max_graph_nodes=None, ell_width=None, rev_ell_width=None)
        if example_batch is not None:
            rev = example_batch.rev_nbr_nodes
            pin = dict(
                max_graph_nodes=example_batch.max_graph_nodes_static or None,
                ell_width=example_batch.ell_width or 0,
                rev_ell_width=0 if rev is None else int(rev.shape[1]))
        spec = dict(format=ARTIFACT_FORMAT, model=self.model.spec(),
                    precision=self.precision.name,
                    bucket=dataclasses.asdict(self.bucket),
                    block_size=self.block_size, seed=self._seed,
                    int8_scales=self.int8_scales, **pin)
        with open(path, "w") as f:
            json.dump(spec, f, indent=1)
        return path

    @staticmethod
    def read_exported(path: str) -> dict:
        """The artifact's JSON spec; raises on a file of another format."""
        with open(path) as f:
            spec = json.load(f)
        if spec.get("format") != ARTIFACT_FORMAT:
            raise ValueError(f"{path} is not a {ARTIFACT_FORMAT} artifact")
        return spec

    @staticmethod
    def load_exported(path: str, params: Optional[dict] = None,
                      device=None):
        """``fn(params, batch) -> output`` of the Program that the
        artifact at ``path`` rebuilds on ``device`` (None = the card).
        With ``params`` (a state dict), they are loaded and the forward
        warmed (``compile``) before this returns."""
        spec = Program.read_exported(path)
        model_kw = dict(spec["model"])
        model_kw["pooling_aggrs"] = tuple(model_kw["pooling_aggrs"])
        model_kw["conv_kwargs"] = {
            k: tuple(v) if isinstance(v, list) else v
            for k, v in model_kw["conv_kwargs"].items()}
        prog = Program(GNNModel(**model_kw), precision=spec["precision"],
                       block_size=spec["block_size"], seed=spec["seed"],
                       device=device, **spec["bucket"])
        prog.int8_scales = spec["int8_scales"]
        prog._pinned = {k: spec[k] for k in prog._pinned}
        if params is None:
            return prog._call
        prog.set_params(params)
        prog._loaded = params
        return prog.compile()

    def export_bundle(self, dirpath: str,
                      example_batch: Optional[GraphBatch] = None) -> str:
        """A self-contained directory a serving process needs
        (``serve.GNNServer.from_bundle``): the artifact (``export``) and
        the parameters as a state dict saved by ``torch.save``.  Returns
        ``dirpath``."""
        os.makedirs(dirpath, exist_ok=True)
        self.export(os.path.join(dirpath, BUNDLE_ARTIFACT), example_batch)
        torch.save({k: v.detach().cpu() for k, v in self.params.items()},
                   os.path.join(dirpath, BUNDLE_PARAMS))
        return dirpath

    @staticmethod
    def load_bundle(dirpath: str, device=None):
        """(fn, params) from an ``export_bundle`` directory: the state dict
        read with ``torch.load(weights_only=True)`` (tensors only, no
        code) and ``load_exported``'s warmed ``fn`` over it."""
        params = torch.load(os.path.join(dirpath, BUNDLE_PARAMS),
                            map_location="cpu", weights_only=True)
        fn = Program.load_exported(os.path.join(dirpath, BUNDLE_ARTIFACT),
                                   params, device)
        return fn, params

    # ---------------------------------------------------------------- verify
    def gen_testbench_data(self, graphs, out_dir: str, max_graphs=None,
                           output_encoding: str = "regression",
                           num_classes: Optional[int] = None) -> dict:
        """Serialize params + per-graph goldens in the reference's binary
        testbench format (code_gen.py:227-305), each golden from this
        Program's forward on its device; see ``verify/golden.py``."""
        from gnnbuilder_tpu_torch.verify import golden

        return golden.gen_testbench_data(
            self, graphs, out_dir, max_graphs=max_graphs,
            output_encoding=output_encoding, num_classes=num_classes)

    def run_parity_check(self, graphs, golden_dir: str) -> dict:
        """MAE of this Program's forwards, on its device, against
        serialized goldens: the build_and_run_testbench analog
        (code_gen.py:339-395)."""
        from gnnbuilder_tpu_torch.verify import golden

        return golden.parity_check(self, graphs, golden_dir)

    def calibrate_int8(self, batches: Sequence[GraphBatch]) -> dict:
        """Record static int8 activation scales from representative
        batches (``ops.quant.calibration``): one eager pass per batch
        through the plain path, each quantized site's max |activation|,
        then ``scale = max / 127`` for every later forward.  Returns
        {site: scale}, sites named as the model's modules."""
        from gnnbuilder_tpu_torch.ops.quant import (
            calibration,
            scales_from_record,
        )

        if self.precision.name != "int8":
            raise ValueError("calibrate_int8 requires precision='int8'")
        if not self._initialized:
            self.init_params(batches[0])
        record: dict = {}
        with torch.no_grad(), self.precision.activate(), \
                calibration(record=record):
            for b in batches:
                self.model(b)
        self.int8_scales = scales_from_record(record)
        return self.int8_scales

    def benchmark(self, batch: GraphBatch, iters: int = 25,
                  warmup: int = 3) -> dict:
        """Device time per forward, from CUDA events around ``iters``
        back-to-back forwards after ``warmup`` untimed ones.  CUDA only."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark measures the card; this Program "
                               f"runs on {self.device}")
        for _ in range(warmup):
            self.forward(batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            self.forward(batch)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
        real_graphs = int(batch.graph_mask.sum())
        real_edges = int(batch.edge_mask.sum())
        return {
            "latency_s": dt,
            "graphs_per_s": real_graphs / dt,
            "edges_per_s": real_edges / dt,
            "device": torch.cuda.get_device_name(self.device),
        }

    # ------------------------------------------------------------ diagnostics
    def cost_analysis(self, example_batch: Optional[GraphBatch] = None
                      ) -> dict:
        """FLOPs and bytes of one forward, the JAX package's compiled-HLO
        cost analysis: "flops" and "bytes accessed" counted from the
        model's widths and the batch's shapes under the Program's policy
        (``compile/cost.py`` states the rules; the same whichever route
        runs the forward), "argument_size_in_bytes" (the batch's tensors
        and the parameters), "output_size_in_bytes", and on the card
        "temp_size_in_bytes" (the most the forward allocates beyond its
        output, after one warm forward: ``max_memory_allocated`` over a
        second) and "peak_hbm_bytes" (their sum).  On the CPU the temp and
        peak keys are absent, as JAX's are where its memory analysis
        fails."""
        from gnnbuilder_tpu_torch.bench.roofline import batch_nbytes
        from gnnbuilder_tpu_torch.compile.cost import forward_cost

        if example_batch is None:
            example_batch = self._dummy_batch()
        if not self._initialized:
            self.init_params(example_batch)
        out = forward_cost(self.model, example_batch, self.precision.name)
        out["argument_size_in_bytes"] = float(
            sum(batch_nbytes(example_batch).values())
            + sum(p.numel() * p.element_size()
                  for p in self.params.values()))
        out["output_size_in_bytes"] = float(
            4 * example_batch.num_graphs * self.model.mlp_out_dim)
        if self.device.type == "cuda":
            dev = self.device
            self.forward(example_batch)
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            y = self.forward(example_batch)
            torch.cuda.synchronize(dev)
            temp = (torch.cuda.max_memory_allocated(dev) - before
                    - y.numel() * y.element_size())
            out["temp_size_in_bytes"] = float(max(temp, 0))
            out["peak_hbm_bytes"] = (out["argument_size_in_bytes"]
                                     + out["output_size_in_bytes"]
                                     + out["temp_size_in_bytes"])
        return out

    def _inner_chain(self, k: int):
        """``chain(batch, c) -> (c', out)``: ``k`` forwards, each on the
        batch's node features plus ``c * 1e-30`` (rounded to bf16 by the
        bf16 policy's forward), each feeding ``c = sum(out)`` to the next,
        so the card runs them one after another; ``out`` is the last
        forward's output (the JAX package's ``_inner_chain_fn``, whose
        scalar carry keeps a real data dependence without perturbing
        the numerics).  ``benchmark_inner`` captures it in a CUDA graph;
        on the CPU it runs as it is."""
        def chain(batch: GraphBatch, c: torch.Tensor):
            out = None
            for _ in range(k):
                x = batch.node_feat + c.to(batch.node_feat.dtype) * 1e-30
                out = self.forward(batch.with_node_feat(x))
                c = out.float().sum()
            return c, out

        return chain

    def _cache_state(self):
        """What the forward's caches hold: the model's (and the bf16
        copy's) kernel operands and the kernels' index caches; capture
        checks that it does not change (a cache filled while capturing
        would live in the graph's memory pool)."""
        from gnnbuilder_tpu_torch.ops.cuda import (
            gat_layer,
            gine_layer,
            pna_layer,
            readout,
        )

        models = {id(m): m for m in (self.model, self._policy_model())}
        return (
            tuple(sorted((i, mode, id(hit[1]))
                         for i, m in models.items()
                         for mode, hit in m._kernel_cache.items())),
            tuple(f.cache_info().misses
                  for f in (pna_layer._stage_plan, pna_layer._layers_plan,
                            gat_layer._stage_plan)),
            len(gine_layer._index_cache), len(readout._zeros))

    @contextlib.contextmanager
    def _captured_chain(self, batch: GraphBatch, k: int, carry):
        """``_inner_chain(k)`` on ``batch`` captured once in one CUDA graph
        whose replay writes the new carry into the 0-d tensor ``carry``.
        Yields ``(run, out)``: ``run(n)`` replays the graph ``n`` times
        (n k chained forwards) and returns ``carry``; ``out`` holds the
        last forward's output after a replay.  First two forwards run on
        a side stream: one fills the caches, then a warm one runs under
        ``torch.cuda.set_sync_debug_mode("error")``, which raises where
        the forward synchronizes with the host; capture raises if a cache
        changes.  The graph keeps the addresses of the batch, the
        parameters and the caches: it is freed on exit, and a Program
        whose parameters change captures again.  Nothing falls back to
        eager forwards."""
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            self._inner_chain(1)(batch, carry)
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._inner_chain(1)(batch, carry)
            except RuntimeError as e:
                raise RuntimeError(
                    f"the {self.model.gnn_conv} forward cannot be captured "
                    f"in a CUDA graph: it synchronizes with the host ({e})"
                ) from e
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        state = self._cache_state()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                c, out = self._inner_chain(k)(batch, carry)
                carry.copy_(c)
        except RuntimeError as e:
            raise RuntimeError(f"capturing {k} chained {self.model.gnn_conv} "
                               f"forwards in a CUDA graph failed: {e}") from e
        if self._cache_state() != state:
            graph.reset()
            raise RuntimeError("a kernel cache changed while the forward "
                               "was captured; its tensors would live in "
                               "the graph's memory pool")

        def run(n: int = 1):
            for _ in range(n):
                graph.replay()
            return carry

        try:
            yield run, out
        finally:
            graph.reset()

    def benchmark_inner(self, batch: GraphBatch, k_lo: int = 1,
                        k_hi: int = 5, iters: int = 20, repeats: int = 5,
                        dynamic: bool = False) -> dict:
        """Per-forward DEVICE time by the inner-chain protocol (the JAX
        package's ``benchmark_inner``): time a call of k chained forwards
        at two chain lengths, slope = (t_hi - t_lo) / (k_hi - k_lo).  A
        call replays CUDA graphs (``_captured_chain``), so the host issues
        one graph launch where an eager forward issues one launch per
        kernel; the fixed cost of a call and of the fence cancels in the
        slope, unlike ``benchmark``'s events around eager forwards, which
        include the host's gaps between launches.  Static: one graph of k
        forwards per k.  ``dynamic``: one graph of one forward replayed k
        times, so every k runs the same graph (JAX's ``fori_loop``
        chain).  Each timing is ``bench.timing.marginal_time`` with JAX's
        widened-gap retries (``_inner_marginal``), the fit JAX's
        (``_inner_fit``).

        Returns latency_s (per forward), overhead_s (per call), resolved
        (False when the fit is degenerate: then latency_s is the t_hi /
        k_hi upper bound), times_s {k: seconds per call}, graphs_per_s,
        edges_per_s and device.  CUDA only."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark measures the card; this Program "
                               f"runs on {self.device}")
        if not self._initialized:
            self.init_params(batch)
        carry = torch.zeros((), device=self.device)
        times = {}
        with contextlib.ExitStack() as stack:
            if dynamic:
                run, _ = stack.enter_context(
                    self._captured_chain(batch, 1, carry))
            for k in (k_lo, k_hi):
                if dynamic:
                    call = lambda _k=k: run(_k)
                else:
                    run_k, _ = stack.enter_context(
                        self._captured_chain(batch, k, carry))
                    call = run_k
                call()
                times[k] = _inner_marginal(call, iters, repeats)
        slope, overhead, resolved = _inner_fit(times, k_lo, k_hi)
        real_graphs = int(batch.graph_mask.sum())
        real_edges = int(batch.edge_mask.sum())
        return {
            "latency_s": float(slope),
            "overhead_s": float(overhead),
            "resolved": bool(resolved),
            "times_s": {int(k): float(v) for k, v in times.items()},
            "graphs_per_s": real_graphs / slope,
            "edges_per_s": real_edges / slope,
            "device": torch.cuda.get_device_name(self.device),
        }


def _inner_marginal(call, iters: int, repeats: int) -> float:
    """``marginal_time`` of ``call`` with the JAX package's retries: a
    window below 2 ms is widened once to a gap that clears it, and a
    clamped (~0) estimate is retried once at the widest gap."""
    from gnnbuilder_tpu_torch.bench import timing

    dt = timing.marginal_time(call, n_hi=iters, repeats=max(repeats, 3))
    if dt * (iters - 5) < 2e-3:
        gap = min(int(2e-3 / max(dt, 2e-5)) + 50, 400)
        dt = timing.marginal_time(
            call, n_lo=gap // 5, n_hi=gap, repeats=max(repeats, 3)
        )
        if dt < 1e-8:
            dt = timing.marginal_time(
                call, n_lo=80, n_hi=400, repeats=max(repeats, 3)
            )
    return dt


def _inner_fit(times: dict, k_lo: int, k_hi: int):
    """(latency per forward, overhead per call, resolved) from the seconds
    per call at two chain lengths: the slope and its intercept, or, where
    the fit is degenerate (flat in k, or a negative slope), the honest
    upper bound t_hi / k_hi with no overhead and resolved False."""
    slope = (times[k_hi] - times[k_lo]) / (k_hi - k_lo)
    overhead = times[k_lo] - slope * k_lo
    resolved = slope > 0 and times[k_hi] > 1.25 * times[k_lo]
    if not resolved:
        slope = times[k_hi] / k_hi
        overhead = 0.0
    return slope, max(overhead, 0.0), resolved

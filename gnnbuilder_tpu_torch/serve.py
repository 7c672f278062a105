"""Serving frontend: micro-batching inference over a ``Program`` or its
exported artifact (the JAX package's ``serve.py``).

* ``GNNServer`` owns the forward and a request queue.  A worker thread
  packs waiting requests into the bucket (up to ``max_batch`` graphs; it
  takes every request already queued at once and waits at most
  ``max_wait_ms`` for stragglers) and runs them as one forward; a
  resolver thread copies each result to the host and resolves the
  requests' futures, so that the worker packs the next batch while the
  card runs the last one (at most 3 batches in flight).
* Requests return futures; each request's wall latency is recorded and
  summarized as p50 / p90 / p99 (``stats()``).
* From a live ``Program`` (``from_program``), an export artifact and its
  parameters (``from_artifact``: strict shapes, over-width requests fail
  at submit) or an ``export_bundle`` directory (``from_bundle``).

Threads and the forward: the inference scope, the precision policy and
the int8 calibration are context variables, and grad mode and the current
CUDA device are per thread, none of which a new thread inherits.  So the
worker runs the forward only through ``Program.compile``'s function,
which enters them, on the device the server names, and every constructor
warms that function (building the kernel library and filling the
model's caches) before the threads start.  Every wait on a thread or a
future has a timeout.  No request falls back to another device: a
failed forward fails its requests.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from gnnbuilder_tpu_torch.core.graph import build_graph_batch, resolve_device

__all__ = ["GNNServer", "load_artifact"]

# batches dispatched and not yet resolved at most (backpressure)
IN_FLIGHT = 3


def load_artifact(path: str, params: Optional[dict] = None, device=None):
    """(fn, spec) of an exported artifact (``Program.export``): ``fn(params,
    batch)`` over the Program it rebuilds on ``device`` (None = the
    card), warmed when ``params`` is given, and the artifact's spec, whose
    ``bucket``, ``max_graph_nodes``, ``ell_width`` and ``rev_ell_width``
    are the shapes it serves."""
    from gnnbuilder_tpu_torch.compile.program import Program

    spec = Program.read_exported(path)
    return Program.load_exported(path, params, device), spec


class _Pending:
    __slots__ = ("graph", "future", "t_submit")

    def __init__(self, graph):
        self.graph = graph
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class GNNServer:
    """Micro-batching server over a GNN forward.

    From a live program::

        server = GNNServer.from_program(prog)

    or over any ``fn(batch)`` and the bucket's budgets::

        server = GNNServer(fn, None, node_budget=N, edge_budget=E,
                           graph_budget=G, device="cpu")

    then ``submit(graph) -> Future`` (streaming) or ``predict(graphs) ->
    np.ndarray`` (synchronous).  ``params`` is kept for the JAX package's
    signature; ``fn`` holds its parameters.  Close it (or use it as a
    context manager) to stop its threads.
    """

    def __init__(
        self,
        fn,
        params,
        node_budget: int,
        edge_budget: int,
        graph_budget: int,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 2.0,
        max_graph_nodes: Optional[int] = None,
        ell_width: Optional[int] = None,
        rev_ell_width: Optional[int] = None,
        strict_shapes: bool = False,
        block_size: int = 0,
        device=None,
    ):
        self._fn = fn
        self._params = params
        self._device = resolve_device(device)
        self._budgets = (node_budget, edge_budget, graph_budget)
        # widths every packed batch carries (the exported artifact's): any
        # largest-graph bound >= a batch's own is valid
        self._max_graph_nodes = max_graph_nodes
        self._ell_width = ell_width
        self._rev_ell_width = rev_ell_width
        self._block = int(block_size)
        # strict (artifact) mode rejects over-width requests at submit;
        # flexible (live Program) mode packs such a batch at its own widths
        self._strict = strict_shapes
        self._max_batch = max_batch or (graph_budget - 1)   # ghost graph
        self._max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._lat_ms: list[float] = []
        self._served = 0
        self._batches = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._resolve_q: "queue.Queue" = queue.Queue(maxsize=IN_FLIGHT)
        self._resolver = threading.Thread(target=self._resolve_loop,
                                          daemon=True)
        self._resolver.start()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ construct
    @classmethod
    def from_program(cls, prog, batch_example=None, **kw) -> "GNNServer":
        """Serve ``prog``: its ``compile`` warms the forward on
        ``batch_example`` (whose largest-graph bound and ELL widths the
        server then pins) before the threads start."""
        fwd = prog.compile(batch_example)
        b = prog.bucket
        if batch_example is not None:
            rev = batch_example.rev_nbr_nodes
            kw.setdefault("max_graph_nodes",
                          batch_example.max_graph_nodes_static)
            kw.setdefault("ell_width", batch_example.ell_width or 0)
            kw.setdefault("rev_ell_width",
                          0 if rev is None else int(rev.shape[1]))
        kw.setdefault("block_size", prog.block_size)
        kw.setdefault("device", prog.device)
        return cls(lambda batch: fwd(None, batch), None,
                   node_budget=b.max_nodes, edge_budget=b.max_edges,
                   graph_budget=b.max_graphs, **kw)

    @classmethod
    def from_bundle(cls, dirpath: str, **kw) -> "GNNServer":
        """Serve an ``export_bundle`` directory (artifact + parameters), as
        ``from_artifact`` does."""
        from gnnbuilder_tpu_torch.compile.program import (
            BUNDLE_ARTIFACT,
            Program,
        )

        fn, params = Program.load_bundle(dirpath, kw.get("device"))
        spec = Program.read_exported(os.path.join(dirpath, BUNDLE_ARTIFACT))
        return cls._serve_exported(fn, params, spec, kw)

    @classmethod
    def from_artifact(cls, path: str, params, **kw) -> "GNNServer":
        """Serve a ``Program.export`` artifact with ``params`` (a state
        dict): the Program is rebuilt and warmed on ``device`` (None = the
        card) before the threads start, and shapes are strict."""
        fn, spec = load_artifact(path, params, kw.get("device"))
        return cls._serve_exported(fn, params, spec, kw)

    @classmethod
    def _serve_exported(cls, fn, params, spec, kw) -> "GNNServer":
        b = spec["bucket"]
        kw.setdefault("max_graph_nodes", spec["max_graph_nodes"])
        kw.setdefault("ell_width", spec["ell_width"])
        kw.setdefault("rev_ell_width", spec["rev_ell_width"])
        kw.setdefault("block_size", spec["block_size"])
        kw.setdefault("strict_shapes", True)
        return cls(lambda batch: fn(params, batch), None,
                   node_budget=b["max_nodes"], edge_budget=b["max_edges"],
                   graph_budget=b["max_graphs"], **kw)

    # -------------------------------------------------------------- requests
    def submit(self, graph) -> Future:
        """Enqueue one graph; the future resolves to its [out_dim] numpy
        prediction."""
        p = _Pending(graph)
        err = self._validate(graph)
        if err is not None:
            p.future.set_exception(ValueError(err))
            return p.future
        self._q.put(p)
        return p.future

    def _validate(self, graph) -> Optional[str]:
        if not self._strict:
            return None
        n = graph.x.shape[0]
        if self._max_graph_nodes and n > self._max_graph_nodes:
            return (f"graph has {n} nodes; this artifact serves graphs of "
                    f"<= {self._max_graph_nodes} nodes")
        if graph.edge_index.shape[1]:
            send, recv = (np.asarray(graph.edge_index[i]) for i in (0, 1))
            for ids, width, what in ((recv, self._ell_width, "in-degree",),
                                     (send, self._rev_ell_width,
                                      "out-degree")):
                d = int(np.bincount(ids, minlength=n).max())
                if width and d > width:
                    return (f"graph max {what} {d} exceeds the artifact's "
                            f"table width {width}")
        return None

    def predict(self, graphs: Sequence, timeout: float = 600.0) -> np.ndarray:
        """The predictions of ``graphs``, in order; ``timeout`` bounds the
        wait for each."""
        futs = [self.submit(g) for g in graphs]
        return np.stack([f.result(timeout=timeout) for f in futs])

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            lats = np.asarray(self._lat_ms, dtype=np.float64)
            served, batches = self._served, self._batches
        out = {"served": served, "batches": batches,
               "avg_batch": served / max(batches, 1)}
        if lats.size:
            out.update(p50_ms=float(np.percentile(lats, 50)),
                       p90_ms=float(np.percentile(lats, 90)),
                       p99_ms=float(np.percentile(lats, 99)))
        return out

    def close(self, timeout: Optional[float] = 60.0):
        """Stop dispatching, resolve what is in flight and fail what was
        never dispatched.  Waits up to ``timeout`` seconds for the worker
        (it may be inside a forward); if it is still running then, it is
        left behind as a daemon without the resolver's stop sentinel, so
        that the resolver still resolves its last handoff."""
        self._stop.set()
        self._worker.join(timeout=timeout)
        if not self._worker.is_alive():
            # every batch the worker dispatched is queued ahead of this
            self._resolve_q.put(None, timeout=timeout)
            self._resolver.join(timeout=timeout)
        try:
            while True:
                p = self._q.get_nowait()
                if not p.future.done():
                    p.future.set_exception(RuntimeError(
                        "GNNServer closed before this request was "
                        "dispatched"))
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------------- worker
    def _fits(self, chunk: list, g) -> bool:
        nb, eb, gb = self._budgets
        if self._block:
            # the packer's greedy bin-pack, simulated (chunks are small)
            cur = 0
            for gg in [p.graph for p in chunk] + [g]:
                ng = gg.x.shape[0]
                if ng > self._block:
                    return False
                if (cur % self._block) + ng > self._block:
                    cur = -(-cur // self._block) * self._block
                cur += ng
            n = -(-(cur + 1) // self._block) * self._block
        else:
            n = sum(p.graph.x.shape[0] for p in chunk) + g.x.shape[0] + 8
        e = sum(p.graph.edge_index.shape[1] for p in chunk) + (
            g.edge_index.shape[1])
        return n <= nb and e + 8 <= eb and len(chunk) + 2 <= gb

    def _next_chunk(self, first) -> list:
        """``first`` and the requests behind it: every one already queued
        (``get_nowait``), then stragglers until ``max_wait``, while they
        fit the bucket and ``max_batch``."""
        chunk = [first]
        deadline = time.perf_counter() + self._max_wait
        while len(chunk) < self._max_batch:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
            if not self._fits(chunk, nxt.graph):
                self._q.put(nxt)    # bucket full: it leads the next batch
                break
            chunk.append(nxt)
        return chunk

    def _pack(self, graphs):
        """The batch of ``graphs`` on the server's device.  It is packed on
        the host and copied from pinned memory without waiting: a copy
        from pageable memory (``build_graph_batch(device=...)``) waits
        for the card to finish the batch before, which would serialize
        packing with the device."""
        nb, eb, gb = self._budgets
        kw = dict(node_budget=nb, edge_budget=eb, graph_budget=gb,
                  block_size=self._block or None, device="cpu")
        try:
            batch = build_graph_batch(graphs, ell_width=self._ell_width,
                                      rev_ell_width=self._rev_ell_width,
                                      **kw)
        except (AssertionError, ValueError):
            if self._strict:
                raise
            # a batch past the pinned widths packs at its own (flexible)
            batch = build_graph_batch(graphs, **kw)
        if (self._max_graph_nodes
                and batch.max_graph_nodes_static <= self._max_graph_nodes):
            batch = batch.replace(max_graph_nodes_static=self._max_graph_nodes)
        if self._device.type == "cpu":
            return batch
        return batch.replace(**{
            f.name: getattr(batch, f.name).pin_memory().to(
                self._device, non_blocking=True)
            for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)})

    def _run(self):
        torch.set_grad_enabled(False)
        if self._device.type == "cuda" and self._device.index is not None:
            torch.cuda.set_device(self._device)
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            chunk = self._next_chunk(first)
            try:
                # the forward returns once its launches are queued: the
                # resolver's copy to the host waits for the card, while
                # this thread packs the next batch
                dev_out = self._fn(self._pack([p.graph for p in chunk]))
            except Exception as e:  # noqa: BLE001 - fails these requests
                for p in chunk:
                    p.future.set_exception(e)
                continue
            self._resolve_q.put((chunk, dev_out))   # blocks at IN_FLIGHT

    def _resolve_loop(self):
        while True:
            item = self._resolve_q.get()
            if item is None:
                return
            self._resolve_one(*item)

    def _resolve_one(self, chunk, dev_out):
        try:
            out = dev_out.cpu().numpy()
        except Exception as e:  # noqa: BLE001 - a fault on the card
            for p in chunk:
                p.future.set_exception(e)
            return
        t_done = time.perf_counter()
        with self._lock:
            self._served += len(chunk)
            self._batches += 1
            for p in chunk:
                self._lat_ms.append((t_done - p.t_submit) * 1e3)
        for i, p in enumerate(chunk):
            p.future.set_result(out[i])

"""Batched data loader with background packing (the JAX package's
``data/loader.py``).

A producer thread packs the next batches on the host into a bounded
queue while the card runs the current one:

    loader = GraphLoader(graphs, batch_size=256, shuffle=True, seed=0)
    for batch, target in loader.epoch():
        loss = step(batch, target)

The producer does host work only: it packs each batch with numpy
(``build_graph_batch(device="cpu")``) and, for a card, pins it.  The copy
to the card is issued by the consumer, on its current stream, with
``non_blocking=True``: the train step that follows on the same stream is
ordered after it, and no host sync is added per batch (a copy from
pageable memory would wait for the card).
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from gnnbuilder_tpu_torch.core.graph import (
    GraphBatch,
    build_graph_batch,
    resolve_device,
)

__all__ = ["GraphLoader"]


def _tensors(batch: GraphBatch) -> dict:
    return {f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor)}


class GraphLoader:
    """Iterate padded GraphBatches (+ stacked targets) over a graph list,
    on ``device`` (None = the CUDA card, which raises without one; pass
    ``device="cpu"`` for the CPU).

    All batches share one padding bucket (max over the dataset at the given
    batch size), so every step sees the same shapes: the bucket of the JAX
    package's loader, budget for budget.
    """

    def __init__(
        self,
        graphs: Sequence,
        batch_size: int = 32,
        shuffle: bool = False,
        seed: int = 0,
        target_dim: int = 1,
        node_multiple: int = 8,
        edge_multiple: int = 8,
        drop_last: bool = True,
        prefetch: int = 2,
        block_size: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.target_dim = target_dim
        self.node_multiple = node_multiple
        self.edge_multiple = edge_multiple
        self.drop_last = drop_last
        self.prefetch = prefetch
        # block_size > 0 selects the block-diagonal bin-packed layout
        self.block_size = int(block_size)

        # one shared bucket across every possible batch composition: worst
        # case = the batch_size largest graphs packed together
        ns = sorted((g.x.shape[0] for g in self.graphs), reverse=True)
        es = sorted((g.edge_index.shape[1] for g in self.graphs),
                    reverse=True)
        k = min(batch_size, len(self.graphs))
        if self.block_size:
            bsz = self.block_size
            assert ns[0] <= bsz, (ns[0], bsz)
            # worst-case pack: each block holds at least
            # floor(bsz / max_graph) graphs of the largest kind
            per = max(bsz // ns[0], 1) if ns[0] else bsz
            blocks = -(-k // per) + 1
            align = math.lcm(bsz, node_multiple)
            self.node_budget = self._rup(blocks * bsz + 1, align)
        else:
            self.node_budget = self._rup(sum(ns[:k]) + 1, node_multiple)
        self.edge_budget = self._rup(max(sum(es[:k]), 1), edge_multiple)
        self.graph_budget = batch_size + 1
        self._epoch = 0
        # host seconds the producer spent packing each batch of the last
        # epoch (numpy packing, targets and pinning)
        self.pack_seconds: list[float] = []

    @staticmethod
    def _rup(x: int, m: int) -> int:
        return ((x + m - 1) // m) * m

    def __len__(self) -> int:
        n = len(self.graphs) // self.batch_size
        if not self.drop_last and len(self.graphs) % self.batch_size:
            n += 1
        return n

    def _chunks(self) -> list[list]:
        order = np.arange(len(self.graphs))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        chunks = []
        bs = self.batch_size
        for i in range(0, len(order), bs):
            idx = order[i: i + bs]
            if len(idx) < bs and self.drop_last:
                continue
            chunks.append([self.graphs[j] for j in idx])
        return chunks

    def _pack(self, chunk):
        """The host half: ``chunk`` packed on the CPU, pinned for a
        card."""
        import time

        from gnnbuilder_tpu_torch.train import stack_targets

        t0 = time.perf_counter()
        batch = build_graph_batch(
            chunk,
            node_budget=self.node_budget,
            edge_budget=self.edge_budget,
            graph_budget=self.graph_budget,
            node_multiple=self.node_multiple,
            edge_multiple=self.edge_multiple,
            block_size=self.block_size or None,
            device="cpu",
        )
        target = stack_targets(chunk, batch.num_graphs, self.target_dim,
                               device="cpu")
        if self.device.type == "cuda":
            batch = batch.replace(**{k: v.pin_memory()
                                     for k, v in _tensors(batch).items()})
            target = target.pin_memory()
        self.pack_seconds.append(time.perf_counter() - t0)
        return batch, target

    def _to_device(self, item):
        """The consumer half: the pinned batch copied to the card on the
        current stream without waiting."""
        batch, target = item
        if self.device.type == "cpu":
            return batch, target
        moved = {k: v.to(self.device, non_blocking=True)
                 for k, v in _tensors(batch).items()}
        return (batch.replace(**moved),
                target.to(self.device, non_blocking=True))

    def epoch(self) -> Iterator:
        """One epoch, background-packed with a bounded prefetch queue.
        Abandoning it (a ``break`` or an exception in the loop) stops the
        producer thread."""
        chunks = self._chunks()
        self._epoch += 1
        self.pack_seconds = []
        if self.prefetch <= 0:
            for c in chunks:
                yield self._to_device(self._pack(c))
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _END = object()
        err: list[BaseException] = []
        cancel = threading.Event()

        def producer():
            try:
                for c in chunks:
                    item = self._pack(c)
                    # a put that notices the consumer leaving: a blocking
                    # put would keep this thread and its batches forever
                    while not cancel.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if cancel.is_set():
                        return
            except BaseException as e:  # raised on the consumer side
                err.append(e)
            finally:
                while True:
                    try:
                        q.put(_END, timeout=0.1)
                        break
                    except queue.Full:
                        if cancel.is_set():
                            break

        t = threading.Thread(target=producer, daemon=True,
                             name="gnnb-loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                yield self._to_device(item)
        finally:
            cancel.set()
            # drain, so that a producer blocked mid-put sees the cancel
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)
        if err:
            raise err[0]

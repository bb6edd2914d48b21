"""Deterministic synthetic token pipeline with background prefetch.

This is the substrate `data.next_wait` measures: batches are produced by a
worker thread into a bounded queue; `next()` blocks only when the consumer
outruns the producer (a data tail).  Determinism: batch t is a pure function
of (seed, shard, t), so restart-from-checkpoint resumes the exact stream by
cursor — the fault-tolerance contract for the data layer.

A `stall(step, seconds)` hook injects producer-side delays for the E3-style
live-loop experiments (the host-visible analogue of the paper's dataloader
faults).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator

import numpy as np

__all__ = ["SyntheticTokens", "PrefetchPipeline"]


class SyntheticTokens:
    """Pure-function token batches: LCG-mixed, label = next-token shift.

    Tokens are power-law tilted (not uniform): a uniform stream has its
    cross-entropy floor at exactly log(V), leaving an untrained model zero
    headroom to improve; the tilt puts learnable unigram structure in the
    stream so short smoke trainings show a real loss decrease.
    """

    def __init__(
        self,
        vocab_size: int,
        batch: int,
        seq: int,
        *,
        seed: int = 0,
        shard: int = 0,
        num_shards: int = 1,
    ):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards

    def batch_at(self, cursor: int) -> dict[str, np.ndarray]:
        key = (
            self.seed * 0x9E3779B97F4A7C15
            + cursor * self.num_shards + self.shard + 1
        ) % (2**63)
        rng = np.random.default_rng(key)
        u = rng.random(size=(self.batch, self.seq + 1))
        tokens = np.minimum(
            (self.vocab_size * u**3).astype(np.int32), self.vocab_size - 1
        )
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class PrefetchPipeline:
    """Bounded-queue background prefetch over a batch source."""

    def __init__(
        self,
        source: SyntheticTokens,
        *,
        prefetch: int = 2,
        start_cursor: int = 0,
        stall: Callable[[int], float] | None = None,
    ):
        self.source = source
        self.cursor = start_cursor
        self._stall = stall or (lambda step: 0.0)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._produced = start_cursor
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        while not self._stop.is_set():
            step = self._produced
            delay = self._stall(step)
            if delay > 0:
                time.sleep(delay)
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._produced += 1

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.cursor = step + 1
        return batch

    def state(self) -> dict:
        """Checkpointable cursor (consumed count)."""
        return {"cursor": self.cursor, "seed": self.source.seed}

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)

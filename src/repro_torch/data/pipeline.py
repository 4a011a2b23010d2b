"""Synthetic-token data pipeline: deterministic, host-sharded, prefetched.

Port of ``repro/data/pipeline.py``, a numpy copy: the batches are the
reference's bit for bit.  Each host materialises only its shard of the
global batch (``host_id``/``num_hosts``), a batch is a pure function of
(seed, step, host), so a restarted job regenerates identical data, and a
background thread keeps a prefetch queue ahead of the step loop.  Batches
are numpy; the train step moves them to its device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # Zipf-ish marginal so the loss curve is non-trivial (pure uniform
    # tokens give a flat, uninformative loss).
    zipf_a: float = 1.2


class SyntheticLM:
    """Deterministic synthetic LM stream: repeated structured n-gram
    patterns so a model can actually reduce loss."""

    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.host_batch = cfg.global_batch // num_hosts

    def batch_at(self, step: int) -> dict:
        """Batch for ``step`` (pure function of (seed, step, host))."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id]))
        base = rng.zipf(cfg.zipf_a, size=(self.host_batch, cfg.seq_len))
        tokens = (base % (cfg.vocab - 2)).astype(np.int32) + 1
        # plant learnable structure: token[t+1] = f(token[t]) on half the
        # positions
        shifted = (tokens * 31 + 7) % (cfg.vocab - 2) + 1
        mask = rng.random((self.host_batch, cfg.seq_len)) < 0.5
        tokens[:, 1:] = np.where(mask[:, 1:], shifted[:, :-1],
                                 tokens[:, 1:])
        labels = np.concatenate([tokens[:, 1:],
                                 np.zeros((self.host_batch, 1), np.int32)],
                                axis=1)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch queue over any step-indexed source."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.source.batch_at(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)

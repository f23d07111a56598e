"""Deterministic synthetic data pipeline with background prefetch (a copy of
``repro.data.pipeline``; batches are numpy, and the train step moves them to
the device).

Design goals (mirrors what a production loader must provide):
  * **Stateless addressing** — ``batch_for_step(step)`` is a pure function of
    (seed, step, shape), so checkpoint restore replays the exact stream with
    no loader state to persist, and elastic re-sharding just changes which
    slice each host materializes.
  * **Host-side prefetch** — a double-buffered background thread keeps
    ``depth`` batches ready (the LTRF idea applied at the host->device
    boundary: fetch the next working set while the current one computes).
  * **Straggler mitigation** — ``get()`` returns a *recomputed* batch
    if the prefetch thread misses its deadline; the step never blocks on a
    slow producer.
  * **Restore safety** — ``restore(step)`` bumps a generation counter so an
    in-flight producer iteration cannot clobber the repositioned stream
    (stale-generation batches are discarded by the consumer).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from ..configs.base import ArchConfig, ShapeConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    depth: int = 2           # prefetch depth
    timeout_s: float = 5.0   # straggler deadline


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def batch_for_step(cfg: ArchConfig, shape: ShapeConfig, step: int,
                   seed: int = 1234, host_slice: slice | None = None) -> dict:
    """Pure function (seed, step) -> batch.  ``host_slice`` selects this
    host's rows for multi-host data loading."""
    rng = _rng_for(seed, step)
    B, S = shape.global_batch, shape.seq_len
    sl = host_slice or slice(None)
    if cfg.family == "audio":
        codes = rng.integers(0, cfg.vocab, (B, cfg.n_codebooks, S),
                             dtype=np.int32)
        return {"codes": codes[sl], "labels": codes[sl]}
    if cfg.family == "vlm":
        toks = rng.integers(0, cfg.vocab, (B, S - cfg.n_patches), dtype=np.int32)
        patches = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), dtype=np.float32) * 0.02
        labels = np.concatenate(
            [np.zeros((B, cfg.n_patches), np.int32), toks], axis=1)
        return {"tokens": toks[sl], "patches": patches[sl],
                "labels": labels[sl]}
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    return {"tokens": toks[sl], "labels": toks[sl]}


class PrefetchingLoader:
    """Background-threaded loader with deadline-based straggler fallback."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 data_cfg: DataConfig | None = None, start_step: int = 0):
        self.cfg, self.shape = cfg, shape
        self.dc = data_cfg or DataConfig()
        self._q: queue.Queue = queue.Queue(maxsize=self.dc.depth)
        self._lock = threading.Lock()
        self._gen = 0
        self._next_produce = start_step
        self._next_consume = start_step
        self._stop = threading.Event()
        self.straggler_fallbacks = 0
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                gen, step = self._gen, self._next_produce
            batch = batch_for_step(self.cfg, self.shape, step, self.dc.seed)
            try:
                self._q.put((gen, step, batch), timeout=0.25)
            except queue.Full:
                continue
            with self._lock:
                if gen == self._gen:   # a restore() may have intervened
                    self._next_produce = step + 1

    def get(self) -> dict:
        """Next batch; recomputes synchronously if the producer is late."""
        with self._lock:
            gen, step = self._gen, self._next_consume
        deadline_hits = 0
        batch = None
        while True:
            try:
                got_gen, got_step, got = self._q.get(timeout=self.dc.timeout_s)
            except queue.Empty:
                self.straggler_fallbacks += 1
                batch = batch_for_step(self.cfg, self.shape, step, self.dc.seed)
                break
            if got_gen == gen and got_step == step:
                batch = got
                break
            deadline_hits += 1
            if deadline_hits > 4 * self.dc.depth + 4:
                # stale stream (restore raced repeatedly): compute directly
                self.straggler_fallbacks += 1
                batch = batch_for_step(self.cfg, self.shape, step, self.dc.seed)
                break
        with self._lock:
            self._next_consume = step + 1
        return batch

    def restore(self, step: int) -> None:
        """Reposition the stream after checkpoint restore (exact replay)."""
        with self._lock:
            self._gen += 1
            self._next_consume = step
            self._next_produce = step
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)

"""Deterministic synthetic data pipeline with packing and host sharding
(copy of ``repro.data.pipeline``, numpy op for op: the batches are the
reference's, bit for bit).

Serves next-token LM batches from a seeded generator (a Zipfian token
stream with injected n-gram structure, so losses actually go down during
the end-to-end training example).  Features:

  * deterministic resume: batches are indexed by step, so a restart from a
    checkpoint at step k regenerates the exact same remaining stream;
  * sequence packing: documents of random length packed back-to-back;
  * host sharding: each host serves only its shard of the global batch
    (``host_id``/``n_hosts``);
  * background prefetch of a bounded queue.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    mean_doc_len: int = 256
    zipf_a: float = 1.3
    ngram_order: int = 3
    host_id: int = 0
    n_hosts: int = 1


class SyntheticLM:
    """Zipf tokens + deterministic trigram structure (learnable signal)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed bigram successor table: token t is followed by succ[t] with
        # probability p_det, else a fresh Zipf draw
        self.succ = rng.integers(2, v, size=v)
        self.p_det = 0.6

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        n = int(rng.exponential(cfg.mean_doc_len)) + 8
        out = np.empty(n, np.int32)
        tok = int(rng.zipf(cfg.zipf_a) % (cfg.vocab_size - 2)) + 2
        for i in range(n):
            out[i] = tok
            if rng.random() < self.p_det:
                tok = int(self.succ[tok])
            else:
                tok = int(rng.zipf(cfg.zipf_a) % (cfg.vocab_size - 2)) + 2
        out[-1] = 1  # EOS
        return out

    def batch(self, step: int) -> dict:
        """Packed (local_batch, seq_len+1) -> {'tokens', 'targets'}."""
        cfg = self.cfg
        rows = []
        for r in range(self.local_batch):
            # unique, restart-stable stream per (step, global row)
            grow = cfg.host_id * self.local_batch + r
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step) * 4096 + grow)
            buf = np.empty(0, np.int32)
            while buf.size < cfg.seq_len + 1:
                buf = np.concatenate([buf, self._doc(rng)])
            rows.append(buf[: cfg.seq_len + 1])
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "targets": arr[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Bounded background prefetch around any step-indexed source."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        s = self.step
        while not self._stop.is_set():
            b = self.source.batch(s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2.0)

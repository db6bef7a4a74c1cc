"""Seeded synthetic language-model batches: a frozen copy of the port's
``repro_torch.data.pipeline`` (``DataConfig`` and ``SyntheticLM.batch``,
numpy op for op), kept here so that a change to the program cannot change
the benchmark's inputs.

A Zipfian token stream with a fixed successor table (a learnable signal),
documents of exponential length packed back to back; batches are indexed
by step, each row from its own generator seeded by (seed, step, row), so
every row of every step differs.
"""
from __future__ import annotations

from dataclasses import dataclass

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

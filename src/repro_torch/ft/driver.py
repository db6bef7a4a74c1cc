"""Fault-tolerant training driver: checkpoint-restart, failure injection,
straggler deadlines.

Counterpart of ``repro.ft.driver``.  The recovery unit is
checkpoint-restart:

  * periodic async checkpoints (atomic publish, integrity-hashed);
  * ``FailureInjector`` kills the step loop at configured steps — tests
    restart the driver and assert exact continuation of the loss curve
    (the data pipeline is step-indexed, so the stream resumes exactly);
  * straggler deadline: a step exceeding ``deadline_factor`` x the rolling
    median is recorded.

Fresh state comes from ``torch.Generator(device).manual_seed(seed)`` on the
model's device.  On the card the resumed curve equals the uninterrupted one
bit for bit only under ``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``), which the caller sets: the
embedding's backward accumulates with atomics otherwise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as C
from repro_torch.data.pipeline import DataConfig, SyntheticLM


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic chaos: raise at the given global steps (once each)."""
    fail_at: set = field(default_factory=set)
    fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclass
class StragglerPolicy:
    deadline_factor: float = 3.0
    window: int = 16
    history: list = field(default_factory=list)
    events: list = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True if the step blew the deadline (straggler)."""
        med = float(np.median(self.history)) if self.history else None
        self.history.append(seconds)
        if len(self.history) > self.window:
            self.history.pop(0)
        if med is not None and seconds > self.deadline_factor * med:
            self.events.append({"step": step, "seconds": seconds,
                                "median": med})
            return True
        return False


@dataclass
class TrainDriver:
    model: Any                       # repro_torch.models.model.Model
    train_step: Callable             # (params, opt, batch) -> ...
    opt_init: Callable
    data_cfg: DataConfig
    ckpt_dir: str
    ckpt_every: int = 50
    injector: Optional[FailureInjector] = None
    straggler: StragglerPolicy = field(default_factory=StragglerPolicy)

    def _fresh_state(self, seed: int = 0):
        dev = self.model.device
        params = self.model.init(torch.Generator(device=dev)
                                 .manual_seed(seed))
        return params, self.opt_init(params)

    def run(self, total_steps: int, seed: int = 0) -> dict:
        """Run (or resume) to total_steps. Returns metrics history."""
        dev = self.model.device
        saver = C.AsyncSaver()
        start = C.latest_step(self.ckpt_dir)
        params, opt = self._fresh_state(seed)
        step0 = 0
        if start is not None:
            state, meta = C.restore(self.ckpt_dir, start,
                                    {"p": params, "o": opt}, device=dev)
            params.load_state_dict(state["p"])
            opt = state["o"]
            step0 = start

        source = SyntheticLM(self.data_cfg)
        sync = (lambda: torch.cuda.synchronize(dev)) \
            if dev.type == "cuda" else (lambda: None)
        losses = []
        try:
            for step in range(step0, total_steps):
                if self.injector:
                    self.injector.check(step)
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in source.batch(step).items()}
                sync()
                t0 = time.time()
                params, opt, metrics = self.train_step(params, opt, batch)
                loss = float(metrics["loss"])
                dt = time.time() - t0
                self.straggler.observe(step, dt)
                losses.append({"step": step, "loss": loss, "seconds": dt})
                if (step + 1) % self.ckpt_every == 0 \
                        or step + 1 == total_steps:
                    saver.save(self.ckpt_dir, step + 1,
                               {"p": params, "o": opt}, meta={"loss": loss})
        finally:
            saver.wait()
        return {"losses": losses, "stragglers": self.straggler.events,
                "final_step": total_steps}

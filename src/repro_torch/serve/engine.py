"""Serving engine: prefill / decode steps + a batched request scheduler.

Counterpart of ``repro.serve.engine``.  ``ServeLoop`` is a simple
continuous-batching scheduler: fixed decode batch, slots freed on
EOS/length and refilled from the queue, greedy sampling.  The reference
``jax.jit``s its decode step; the port runs it eagerly.

Pass a ``repro_torch.telemetry.DecodeEnergyMeter`` to attribute
per-request Watt*seconds: every prefill/decode window's wall time and
measured slot occupancy are booked into the meter's trace and ledger, and
the window's energy is split across the requests that shared the batch
(``Request.energy_ws``).  On the card every clock read that closes a
metered window follows ``torch.cuda.synchronize()``, so the meter bills
the device's work and not the host's enqueue time.

``park()`` stops the loop taking new work and ``drain()`` evicts its queue
and active slots as resumable requests (a resubmitted request
teacher-forces prompt+output through the new loop's cache).  The
reference's power governor hook waits for the fleet slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model
from repro_torch.telemetry.dvfs import LiveUtilization
from repro_torch.telemetry.energy import (IDLE_PHASE, INFRA_TENANT,
                                          DecodeEnergyMeter)


def make_prefill(model: Model):
    def prefill(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill


def make_decode_step(model: Model):
    def decode_step(params, batch, cache):
        return model.decode_step(params, batch, cache)
    return decode_step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new: int
    tenant: str = "default"     # billing label for the energy ledger
    out: list[int] = field(default_factory=list)
    done: bool = False
    energy_ws: float = 0.0      # attributed prefill+decode Watt*seconds
    prefill_ws: float = 0.0     # ... the prefill share of it
    decode_ws: float = 0.0      # ... the decode share of it
    enq_t: Optional[float] = None   # host meter time at submit (queue-wait)
    queue_wait_s: float = 0.0   # meter-time spent queued before each fill


class ServeLoop:
    """Continuous-batching greedy decoder over a fixed slot batch.

    Runs on ``device`` (default ``cuda``; raises without a card), which
    must be the model's device."""

    def __init__(self, model: Model, params, batch_slots: int, max_seq: int,
                 eos_id: int = 1,
                 meter: Optional[DecodeEnergyMeter] = None,
                 node: Optional[str] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"loop device {self.device} is not the "
                             f"model's {model.device}")
        self.model = model
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        self.eos = eos_id
        self.meter = meter
        # node label precedence: an explicit argument re-tags the meter; a
        # configured meter otherwise keeps (and lends the loop) its own
        if node is None:
            node = meter.node if meter is not None else "node0"
        elif meter is not None:
            meter.node = node
        self.node = node
        # injectable step timer: deterministic tests tick a virtual clock
        self.clock = clock
        self.queue: list[Request] = []
        self.active: list[Optional[Request]] = [None] * batch_slots
        self.finished: list[Request] = []
        self.steps_done = 0
        self._t_mark: Optional[float] = None    # last step's clock reading
        self.parked = False                 # a parked loop takes no new work
        # measured slot-occupancy signal: unless the meter already carries
        # a measured utilization, the loop feeds it one
        self.utilization: Optional[LiveUtilization] = None
        if meter is not None and meter.utilization is None:
            self.utilization = LiveUtilization()
            meter.utilization = self.utilization
        self.cache = model.init_cache(batch_slots, max_seq)
        self.pos = np.zeros(batch_slots, np.int32)
        self._decode = make_decode_step(model)
        self._tokens = np.zeros((batch_slots, 1), np.int32)
        # observability: open request spans by rid + the coalesced idle span
        self._req_spans: dict = {}
        self._idle_span = None

    def _sync(self) -> None:
        """Wait for the device's queued work before a clock read that
        closes a metered window."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def submit(self, req: Request):
        # stamp the enqueue on the meter's busy-time timeline (a peek,
        # not a clock() call — the virtual tick clock must not advance)
        if self.meter is not None:
            req.enq_t = self.meter.now
        self.queue.append(req)

    @property
    def occupied_slots(self) -> int:
        """Real occupancy counter: slots currently holding a request."""
        return sum(1 for r in self.active if r is not None)

    @property
    def has_work(self) -> bool:
        return self.occupied_slots > 0 or bool(self.queue
                                               and not self.parked)

    def park(self) -> None:
        """Stop taking new work (queued or resubmitted); in-flight slots
        still decode to completion.  Queued requests stay in ``queue``
        until the loop is unparked or ``drain()`` hands them on."""
        self.parked = True

    def unpark(self) -> None:
        self.parked = False
        # idle accounting restarts from re-admission
        self._t_mark = None

    def drain(self, include_queue: bool = True) -> list[Request]:
        """Evict the queue and every active slot as resumable requests
        (they keep their generated tokens)."""
        moved: list[Request] = []
        if include_queue:
            moved.extend(self.queue)
            self.queue.clear()
        for i, req in enumerate(self.active):
            if req is not None:
                self.active[i] = None
                moved.append(req)
        self._close_idle()
        if self.meter is not None:
            now = self.meter.now
            for req in moved:
                ent = self._req_spans.pop(req.rid, None)
                if ent is not None:
                    if "decode" in ent:
                        ent["decode"].finish(now)
                    ent["root"].tags["outcome"] = "migrated"
                    ent["root"].finish(now)
        return moved

    def _close_idle(self) -> None:
        if self._idle_span is not None:
            self._idle_span.finish()
            self._idle_span = None

    def _record_util(self, phase: str, seconds: float, util: float) -> None:
        """Book the window's measured occupancy on the meter timeline
        (just before the meter integrates it)."""
        if self.utilization is not None and seconds > 0:
            t0 = self.meter.now
            self.utilization.record(phase, t0, t0 + seconds, util)

    def _fill_slots(self):
        if self.parked:
            return
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                req = self.queue.pop(0)
                self.active[i] = req
                if self.meter is not None and req.enq_t is not None:
                    # the fill ends this hop's queue-wait: both edges are
                    # meter-time peeks, so the virtual clock never moves
                    qw = max(self.meter.now - req.enq_t, 0.0)
                    req.queue_wait_s += qw
                    mx = obs.METRICS
                    if mx.enabled:
                        mx.histogram(
                            "queue_wait_s",
                            "meter-time queued before a slot").observe(qw)
                    tr = obs.TRACER
                    if tr.enabled:
                        root = tr.begin("serve.request", node=self.node,
                                        t0=req.enq_t,
                                        tags={"rid": req.rid,
                                              "tenant": req.tenant})
                        tr.begin("serve.queue_wait", node=self.node,
                                 t0=req.enq_t, parent=root,
                                 tags={"rid": req.rid,
                                       "tenant": req.tenant}
                                 ).finish(self.meter.now)
                        self._req_spans[req.rid] = {"root": root}
                # teacher-forced sequential prefill through the decode path
                # (a migrated request also teacher-forces its output)
                seq = np.asarray(req.prompt, np.int32) if not req.out else \
                    np.concatenate([np.asarray(req.prompt, np.int32),
                                    np.asarray(req.out, np.int32)])
                t0 = self.clock()
                for t, tok in enumerate(seq[:-1]):
                    self._step_one(i, int(tok), t)
                if self.meter is not None:
                    self._sync()
                    dt = self.clock() - t0
                    util = 1.0 / self.slots
                    self._record_util("prefill", dt, util)
                    p0 = self.meter.now
                    ws = self.meter.observe(dt, util=util, phase="prefill",
                                            tenants=[req.tenant])
                    req.energy_ws += ws
                    req.prefill_ws += ws
                    ent = self._req_spans.get(req.rid)
                    if ent is not None:
                        tr = obs.TRACER
                        tr.begin("serve.prefill", node=self.node, t0=p0,
                                 parent=ent["root"],
                                 tags={"rid": req.rid, "tenant": req.tenant,
                                       "phase": "prefill", "ws": ws}
                                 ).finish(self.meter.now)
                        ent["decode"] = tr.begin(
                            "serve.decode", node=self.node,
                            t0=self.meter.now, parent=ent["root"],
                            tags={"rid": req.rid, "tenant": req.tenant,
                                  "phase": "decode", "ws": 0.0})
                self.pos[i] = len(seq) - 1
                self._tokens[i, 0] = int(seq[-1])

    def _batch(self, toks: np.ndarray, pos: int) -> dict:
        return {"tokens": torch.as_tensor(toks, device=self.device),
                "pos": pos}

    def _step_one(self, slot: int, token: int, pos: int):
        toks = self._tokens.copy()
        toks[slot, 0] = token
        _, self.cache = self._decode(self.params, self._batch(toks, pos),
                                     self.cache)

    def _idle_step(self) -> int:
        """A step with no work still burns the envelope floor: book the
        time since the previous step's last clock reading as ``idle``
        Watt*seconds at zero utilization, billed to the infra tenant."""
        if self.meter is not None:
            now = self.clock()
            if self._t_mark is None:        # first-ever step: no history
                dt = self.clock() - now     # one tick virtual, ~0 wall
                now += dt
            else:
                dt = max(now - self._t_mark, 0.0)
            self._t_mark = now
            self._record_util(IDLE_PHASE, dt, 0.0)
            ws = self.meter.observe(dt, util=0.0, phase=IDLE_PHASE,
                                    tenants=[INFRA_TENANT])
            tr = obs.TRACER
            if tr.enabled and dt > 0:
                # coalesce: one span per idle stretch, extended each tick
                t1 = self.meter.now
                if self._idle_span is None:
                    self._idle_span = tr.begin(
                        "serve.idle", node=self.node, t0=t1 - dt,
                        tags={"phase": IDLE_PHASE, "tenant": INFRA_TENANT,
                              "ws": 0.0})
                self._idle_span.extend(t1, ws=ws)
        self.steps_done += 1
        return 0

    def step(self) -> int:
        """One decode step across all active slots. Returns #active.

        With no active slots the step books floor-watts ``idle`` energy
        instead of nothing — see ``_idle_step``."""
        self._fill_slots()
        if all(r is None for r in self.active):
            return self._idle_step()
        self._close_idle()
        participants = [r for r in self.active if r is not None]
        t0 = self.clock()
        # one position for the whole batch: the max over the active slots
        pos = int(max(self.pos[i] for i, r in enumerate(self.active)
                      if r is not None))
        logits, self.cache = self._decode(
            self.params, self._batch(self._tokens, pos), self.cache)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        if self.meter is not None:
            # the step's Ws splits evenly across the requests in the batch
            self._sync()
            dt = self.clock() - t0
            self._t_mark = t0 + dt      # idle accounting resumes here
            util = len(participants) / self.slots
            self._record_util("decode", dt, util)
            ws = self.meter.observe(dt, util=util, phase="decode",
                                    tenants=[r.tenant for r in participants])
            share = ws / len(participants)
            now_m = self.meter.now
            mx, tr = obs.METRICS, obs.TRACER
            for r in participants:
                r.energy_ws += share
                r.decode_ws += share
                if mx.enabled:
                    mx.histogram("decode_ws_per_token",
                                 "Ws billed per generated token"
                                 ).observe(share)
                if tr.enabled:
                    ent = self._req_spans.get(r.rid)
                    if ent is not None and "decode" in ent:
                        ent["decode"].extend(now_m, ws=share)
        n_active = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt[i])
            req.out.append(tok)
            self.pos[i] += 1
            self._tokens[i, 0] = tok
            if tok == self.eos or len(req.out) >= req.max_new \
                    or self.pos[i] >= self.max_seq - 1:
                req.done = True
                self.active[i] = None
                self.finished.append(req)
                ent = self._req_spans.pop(req.rid, None)
                if ent is not None and self.meter is not None:
                    end = self.meter.now
                    if "decode" in ent:
                        ent["decode"].finish(end)
                    ent["root"].tags["tokens"] = len(req.out)
                    ent["root"].finish(end)
            else:
                n_active += 1
        self.steps_done += 1
        return n_active

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drain queue + active slots; returns requests finished this run."""
        n0 = len(self.finished)
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()
        self._close_idle()
        return self.finished[n0:]

"""Serving engine: prefill / decode steps + a batched request scheduler.

Counterpart of ``repro.serve.engine``.  ``ServeLoop`` is a simple
continuous-batching scheduler: fixed decode batch, slots freed on
EOS/length and refilled from the queue, greedy sampling.  The reference
``jax.jit``s its decode step; on ``cuda`` the port captures it once as a
CUDA graph (``DecodeGraph``) and replays it for every step, the
teacher-forced prompt steps included.  The step reads the tokens and the
position from the loop's static device buffers and writes the loop's
cache in place; on the CPU the loop runs the same step eagerly through the
same buffers.

Pass a ``repro_torch.telemetry.DecodeEnergyMeter`` to attribute
per-request Watt*seconds: every prefill/decode window's wall time and
measured slot occupancy are booked into the meter's trace and ledger, and
the window's energy is split across the requests that shared the batch
(``Request.energy_ws``).  On the card every clock read that closes a
metered window follows ``torch.cuda.synchronize()``, so the meter bills
the device's work and not the host's enqueue time.

With tracing on (``obs.enable()``) the loop counts its replays and
tokens (``serve.fill_replays``, ``serve.decode_replays``,
``serve.tokens_out``) and traces each request (``serve.request`` over
``serve.queue_wait``, ``serve.prefill``, ``serve.decode``).  A metered
loop stamps those spans on the meter's billing timeline, as the reference
does; a loop without a meter stamps them on ``obs.TRACER``'s clock and
adds the host's phases of each step: ``serve.step`` (tagged ``kind`` fill,
decode or idle, ``active``, ``pos``) over ``serve.fill`` (a filled
request's token copies and the enqueue of its forced replays),
``serve.launch`` (the decode step's input copies and replay) and
``serve.sync`` (the wait for the argmax on the host).  Those spans
``obs.to_profiler_ns`` lays on ``torch.profiler``'s timeline.

``park()`` stops the loop taking new work and ``drain()`` evicts its queue
and active slots as resumable requests (a resubmitted request
teacher-forces prompt+output through the new loop's cache).

Pass a ``repro_torch.telemetry.governor.PowerGovernor`` too and the loop
closes the paper's Step-7 circuit under serving traffic: every
``governor.policy.flush_every`` steps the meter's fresh energy rolls into
the shared fleet ledger and the node's drift monitor; at checkpoint
boundaries a drift-triggered plan migration is judged and, when applied,
recorded in ``plan_migrations`` (rebuilding the model under the new plan
is the caller's checkpointed swap, as in the reference).
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels._build import add_launches, capture_graph
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.obs.span import Span
from repro_torch.parallel.sharding import is_dtensor
from repro_torch.telemetry.dvfs import LiveUtilization
from repro_torch.telemetry.energy import (IDLE_PHASE, INFRA_TENANT,
                                          DecodeEnergyMeter)


def make_prefill(model: Model, rules=None):
    """``prefill(params, batch, cache)`` under ``rules``
    (``parallel.sharding.ShardingRules``, optional)."""
    def prefill(params, batch, cache):
        return model.prefill(params, batch, cache, rules)
    return prefill


def make_decode_step(model: Model, rules=None):
    """``decode_step(params, batch, cache)`` under ``rules`` (optional)."""
    def decode_step(params, batch, cache):
        return model.decode_step(params, batch, cache, rules)
    return decode_step


def _freeze(params, dtype: torch.dtype, cache: list,
            dev: torch.device) -> Optional[L.FrozenCasts]:
    """A memo for ``params``' casts to ``dtype`` where ``dev``'s free
    memory, the allocator's cache emptied, holds them with a decode step's
    warm-up to spare (``DecodeGraph``); else None."""
    total, largest = L.cast_bound(params, dtype)
    if total == 0:
        return None
    warm = sum(L.local_tensor(v).numel() * v.element_size()
               for c in cache for v in c.values())
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(dev)
    if free < total + warm + largest:
        return None
    return L.FrozenCasts(watch=[p for p in params.parameters()
                                if is_dtensor(p)])


class DecodeGraph:
    """``make_decode_step(model, rules)`` captured once as a CUDA graph:
    the port's counterpart of the reference's ``jax.jit`` of its decode
    step.

    The step reads ``tokens`` (slots, 1) and the 0-d ``pos`` and writes
    ``cache`` in place; ``replay()`` runs it on whatever those buffers
    then hold and returns the logits in the graph's own output tensor
    (overwritten by the next replay).  Before the capture one eager step
    runs on a side stream, on a copy of the cache so that served state
    does not move, to build and load every kernel library and set its
    attributes outside the capture.  A capture or a replay that fails
    raises.

    Under ``rules`` (``parallel.sharding.ShardingRules``; the parameters
    and the cache may be ``DTensor``s on its mesh) the warm-up's copy of
    the cache keeps each ``DTensor``'s placements, and the capture makes
    the mesh's communicators first (``kernels._build.capture_graph``).

    Serving never writes its weights, so the graph casts them once: the
    warm-up runs under a ``models.layers.FrozenCasts`` memo that records
    and keeps each weight's cast to the compute dtype, and the capture
    under the same memo serving, so that the graph's GEMMs and kernels
    read the kept copies and a replay casts nothing (``frozen``, the memo;
    ``frozen_bytes``, the device bytes its copies hold, freed with the
    graph).  It freezes only where the device's free memory, the
    allocator's cache emptied, holds the copies (at most every floating
    parameter not in the compute dtype, in it) with the warm-up's own
    peak to spare: its copy of the cache, and the largest copy again for
    the step's transient tensors.  Otherwise the graph casts at every
    replay, as an eager step does (``frozen`` None, ``frozen_bytes`` 0).
    ``stale()`` says whether a frozen weight has since been written in
    place, which a replay would not see: the graph's owner captures
    again.

    A replay makes no call to a kernel's Python launcher, so the graph
    counts the launches its capture recorded (``launches``, per
    ``CudaKernel``) and adds them to each kernel's count on every replay;
    the capture's own recorded launches ran nothing and are not counted.
    So too what the capture recorded for ``repro_torch.obs``
    (``recorded``: the counters its Python bumped, ``weights.frozen_casts``
    and ``weights.frozen_bytes`` or, unfrozen, ``weights.casts`` and
    ``weights.cast_bytes``, and, when device ranges were on, its ranges
    ``decode.step`` and those nested in it), handed on at every replay;
    None when tracing was off, and then a replay does nothing more.
    ``capture_ms`` is the capture's wall time (the warm-up apart);
    ``pool_bytes`` the device memory the graph's private pool took."""

    def __init__(self, model: Model, params, cache: list,
                 tokens: torch.Tensor, pos: torch.Tensor, rules=None):
        dev = tokens.device
        step = make_decode_step(model, rules)
        batch = {"tokens": tokens, "pos": pos}
        frozen = self.frozen = _freeze(params, L.cdtype(model.plan), cache,
                                       dev)
        # a DTensor's clone is a DTensor at the same placements
        warm = [{k: v.clone() for k, v in c.items()} for c in cache]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.no_grad(), \
                nullcontext() if frozen is None else frozen.recording():
            step(params, batch, warm)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        del warm
        self.frozen_bytes = 0 if frozen is None else frozen.nbytes

        @torch.no_grad()
        def logits():
            with nullcontext() if frozen is None else frozen.serving():
                return step(params, batch, cache)[0]
        (self.graph, self.logits, self.launches, self.capture_ms,
         self.pool_bytes, self.recorded) = capture_graph(
            logits, dev, None if rules is None else rules.mesh)

    def stale(self) -> bool:
        """Whether a weight whose cast the graph froze has been written in
        place since."""
        return self.frozen is not None and self.frozen.stale()

    def replay(self) -> torch.Tensor:
        if self.recorded is not None:
            obs.replaying(self.recorded)
        self.graph.replay()
        add_launches(self.launches)
        return self.logits


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
    enq_t: Optional[float] = None   # submit time on the span timeline
    queue_wait_s: float = 0.0   # meter-time spent queued before each fill


class ServeLoop:
    """Continuous-batching greedy decoder over a fixed slot batch.

    Runs on ``device`` (default ``cuda``; raises without a card), which
    must be the model's device."""

    def __init__(self, model: Model, params, batch_slots: int, max_seq: int,
                 eos_id: int = 1,
                 meter: Optional[DecodeEnergyMeter] = None,
                 governor: Optional[Any] = None,
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
        self.governor = governor
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
        self.plan_migrations: list = []     # (step, new_plan) from governor
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
        self._tokens = np.zeros((batch_slots, 1), np.int32)
        # the decode step's static inputs on the device, and on cuda its
        # captured graph with the (model, params) it was captured for
        self._tok_buf = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                    device=self.device)
        self._pos_buf = torch.zeros((), dtype=torch.int32,
                                    device=self.device)
        self.graph: Optional[DecodeGraph] = None
        self._graph_for: Optional[tuple] = None
        # observability: open request spans by rid + the coalesced idle span
        self._req_spans: dict = {}
        self._idle_span = None

    def _sync(self) -> None:
        """Wait for the device's queued work before a clock read that
        closes a metered window."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _host_tracer(self):
        """``obs.TRACER`` when it stamps this loop's spans on its own
        clock (tracing on, no meter), else None."""
        tr = obs.TRACER
        return tr if tr.enabled and self.meter is None else None

    def submit(self, req: Request):
        # stamp the enqueue on the meter's busy-time timeline (a peek,
        # not a clock() call — the virtual tick clock must not advance),
        # or without a meter on the tracer's clock
        if self.meter is not None:
            req.enq_t = self.meter.now
        elif obs.TRACER.enabled:
            req.enq_t = obs.TRACER.clock()
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
        if self._req_spans:
            now = self._span_clock()
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

    def _fill_slots(self) -> int:
        """Fill free slots from the queue, teacher-forcing each prompt;
        returns the number of forced replays."""
        if self.parked:
            return 0
        forced = 0
        htr = self._host_tracer()
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
                # teacher-forced sequential prefill through the decode path
                # (a migrated request also teacher-forces its output)
                seq = np.asarray(req.prompt, np.int32) if not req.out else \
                    np.concatenate([np.asarray(req.prompt, np.int32),
                                    np.asarray(req.out, np.int32)])
                prefill = self._open_request(req)
                fill = None if htr is None else htr.begin(
                    "serve.fill", node=self.node,
                    tags={"rid": req.rid, "replays": len(seq) - 1})
                t0 = self.clock()
                for t, tok in enumerate(seq[:-1]):
                    self._step_one(i, int(tok), t)
                forced += len(seq) - 1
                if fill is not None:
                    fill.finish(htr.clock())
                ws = None
                if self.meter is not None:
                    self._sync()
                    dt = self.clock() - t0
                    util = 1.0 / self.slots
                    self._record_util("prefill", dt, util)
                    ws = self.meter.observe(dt, util=util, phase="prefill",
                                            tenants=[req.tenant])
                    req.energy_ws += ws
                    req.prefill_ws += ws
                self._close_prefill(req, prefill, ws)
                self.pos[i] = len(seq) - 1
                self._tokens[i, 0] = int(seq[-1])
        mx = obs.METRICS
        if mx.enabled and forced:
            mx.counter("serve.fill_replays",
                       "teacher-forced prompt replays").add(forced)
        return forced

    def _span_clock(self) -> float:
        """Now on this loop's span timeline: the meter's billing clock (a
        peek: the virtual tick clock must not advance), else the
        tracer's."""
        return self.meter.now if self.meter is not None \
            else obs.TRACER.clock()

    def _open_request(self, req: Request) -> Optional[Span]:
        """As a request's fill begins: its ``serve.request`` from its
        submit, with ``serve.queue_wait`` closed now; returns its
        ``serve.prefill``, opened now.  None with tracing off or for a
        request submitted untraced."""
        tr = obs.TRACER
        if not tr.enabled or req.enq_t is None:
            return None
        now = self._span_clock()
        tags = {"rid": req.rid, "tenant": req.tenant}
        # the request's root nests under no step
        root = Span(name="serve.request", node=self.node, t0=req.enq_t,
                    tags=dict(tags))
        tr.add_spans([root])
        tr.begin("serve.queue_wait", node=self.node, t0=req.enq_t,
                 parent=root, tags=dict(tags)).finish(now)
        self._req_spans[req.rid] = {"root": root}
        return tr.begin("serve.prefill", node=self.node, t0=now,
                        parent=root, tags={**tags, "phase": "prefill"})

    def _close_prefill(self, req: Request, prefill: Optional[Span],
                       ws: Optional[float]) -> None:
        """Close ``prefill`` now and open the request's ``serve.decode``;
        a billing loop tags both with their Watt*seconds ``ws``."""
        if prefill is None:
            return
        now = self._span_clock()
        tags = {"rid": req.rid, "tenant": req.tenant, "phase": "decode"}
        if ws is not None:
            prefill.tags["ws"] = ws
            tags["ws"] = 0.0
        prefill.finish(now)
        ent = self._req_spans[req.rid]
        ent["decode"] = obs.TRACER.begin("serve.decode", node=self.node,
                                         t0=now, parent=ent["root"],
                                         tags=tags)

    def capture(self) -> Optional[DecodeGraph]:
        """On ``cuda``, the decode step's graph for the loop's current
        ``model`` and ``params``: captured at the first call, and again
        after a caller has swapped either one or written in place to a
        weight whose cast the graph froze (``DecodeGraph.stale``).  None
        on the CPU, where the step runs eagerly."""
        if self.device.type != "cuda":
            return None
        key = self._graph_for
        if key is None or key[0] is not self.model \
                or key[1] is not self.params or self.graph.stale():
            self.graph = self._graph_for = None   # free the old pool first
            self.graph = DecodeGraph(self.model, self.params, self.cache,
                                     self._tok_buf, self._pos_buf)
            self._graph_for = (self.model, self.params)
        return self.graph

    def decode(self, toks: np.ndarray, pos: int) -> torch.Tensor:
        """One decode step of the whole slot batch on ``toks`` (slots, 1)
        at position ``pos``, writing the loop's cache in place; returns the
        logits (slots, V).  The inputs go through the static buffers; on
        ``cuda`` the step is a replay of ``capture()``'s graph, whose
        logits tensor the next step overwrites."""
        self._tok_buf.copy_(torch.from_numpy(np.ascontiguousarray(toks)))
        self._pos_buf.fill_(pos)
        graph = self.capture()
        if graph is not None:
            return graph.replay()
        with torch.no_grad():
            return make_decode_step(self.model)(
                self.params, {"tokens": self._tok_buf, "pos": self._pos_buf},
                self.cache)[0]

    def _step_one(self, slot: int, token: int, pos: int):
        toks = self._tokens.copy()
        toks[slot, 0] = token
        self.decode(toks, pos)

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
        if self.governor is not None and self.meter is not None:
            self.governor.tick(self.meter, self.steps_done, node=self.node)
        return 0

    def step(self) -> int:
        """One decode step across all active slots. Returns #active.

        With no active slots the step books floor-watts ``idle`` energy
        instead of nothing — see ``_idle_step``.  Without a meter and
        with tracing on the step is the span ``serve.step``."""
        tr = self._host_tracer()
        if tr is None:
            return self._step(None)
        with tr.span("serve.step", node=self.node) as sp:
            return self._step(sp)

    def _step(self, sp) -> int:
        forced = self._fill_slots()
        if all(r is None for r in self.active):
            if sp is not None:
                sp.tags["kind"] = "idle"
            return self._idle_step()
        self._close_idle()
        participants = [r for r in self.active if r is not None]
        t0 = self.clock()
        # one position for the whole batch: the max over the active slots
        pos = int(max(self.pos[i] for i, r in enumerate(self.active)
                      if r is not None))
        if sp is None:
            logits = self.decode(self._tokens, pos)
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        else:
            tr = obs.TRACER
            sp.tags.update(kind="fill" if forced else "decode",
                           active=len(participants), pos=pos)
            launch = tr.begin("serve.launch", node=self.node)
            logits = self.decode(self._tokens, pos)
            t = tr.clock()
            launch.finish(t)
            sync = tr.begin("serve.sync", node=self.node, t0=t)
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            sync.finish(tr.clock())
        mx = obs.METRICS
        if mx.enabled:
            mx.counter("serve.decode_replays", "decode-step replays").inc()
            mx.counter("serve.tokens_out", "tokens generated").add(
                len(participants))
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
                if ent is not None:
                    end = self._span_clock()
                    if "decode" in ent:
                        ent["decode"].finish(end)
                    ent["root"].tags["tokens"] = len(req.out)
                    ent["root"].finish(end)
            else:
                n_active += 1
        self.steps_done += 1
        if self.governor is not None and self.meter is not None:
            new_plan = self.governor.tick(self.meter, self.steps_done,
                                          node=self.node)
            if new_plan is not None:
                # checkpointed migration: the caller rebuilds its model
                # under the new plan; the loop records that it fired
                self.plan_migrations.append((self.steps_done, new_plan))
        return n_active

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drain queue + active slots; returns requests finished this run."""
        n0 = len(self.finished)
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()
        self._close_idle()
        if self.governor is not None and self.meter is not None:
            # drain trailing un-flushed energy so the fleet ledger totals
            # match the meter at run end; govern=False keeps the partial
            # tail window out of the drift median
            self.governor.flush(self.meter, self.steps_done, node=self.node,
                                govern=False)
        return self.finished[n0:]

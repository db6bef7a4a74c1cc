"""Span tracing — nestable timed windows on named per-node timelines.

Copy of ``repro.obs.span`` (jax-free in the reference, copied so the port
imports nothing of ``repro``).  A ``Span`` is one window on one node's
timeline: a name, start/end seconds, a tag dict, and an optional parent
id.  The ``Tracer`` hands them out two ways:

  * ``begin``/``finish`` for spans whose edges the *caller* times — the
    serving instrumentation stamps spans with the node meter's
    cumulative busy-time clock (``meter.now``) so span windows line up
    exactly with the Watt*second bookings they describe;
  * the ``span()`` context manager for control-plane scopes on the
    tracer's own monotonic clock, with automatic parent nesting.

A tracer on a host clock (``time.monotonic``, the default, or
``time.perf_counter``) reads it once beside ``time.time_ns()`` when it is
made: ``to_profiler_ns`` puts a span's edges on ``torch.profiler``'s
timeline, whose host events Kineto stamps on the wall clock (ns since the
Unix epoch), so program spans and profiled device work can be laid side
by side.  A tracer on an injected clock (``TickClock``) has no such
conversion.

``extend(t1, ws=...)`` grows an open span and accumulates a ``ws`` tag —
the Watt*seconds this span's window booked, which the joule-attribution
pass (``repro_torch.obs.attribution``) uses as the exact distribution
weight.

Instrumented call sites go through the module-level
``repro_torch.obs.TRACER`` (a ``NullTracer`` by default), guarded by
``.enabled`` — the hot path pays one attribute check when tracing is off.
Dependency-free.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

FLEET_ROW = "fleet"     # default timeline for control-plane spans
#: the host clocks a tracer can place on the profiler's timeline
HOST_CLOCKS = (time.monotonic, time.perf_counter)


@dataclass
class Span:
    """One timed window on one node's timeline."""
    name: str
    t0: float
    node: str = FLEET_ROW
    t1: Optional[float] = None      # None while the span is open
    span_id: int = 0
    parent_id: Optional[int] = None
    tags: dict = field(default_factory=dict)
    attributed_ws: float = 0.0      # filled by the attribution join pass

    @property
    def open(self) -> bool:
        return self.t1 is None

    @property
    def seconds(self) -> float:
        end = self.t0 if self.t1 is None else self.t1
        return max(end - self.t0, 0.0)

    def extend(self, t1: float, ws: float = 0.0) -> "Span":
        """Grow the window to at least ``t1`` and accumulate ``ws`` into
        the span's booked-energy weight tag."""
        self.t1 = t1 if self.t1 is None else max(self.t1, t1)
        if ws:
            self.tags["ws"] = self.tags.get("ws", 0.0) + ws
        return self

    def finish(self, t1: Optional[float] = None) -> "Span":
        """Close the span: at ``t1`` when given, else where ``extend``
        left it (zero-length at ``t0`` if never extended)."""
        if t1 is not None:
            self.t1 = max(t1, self.t0)
        elif self.t1 is None:
            self.t1 = self.t0
        return self

    def contains(self, other: "Span") -> bool:
        """Whether ``other``'s window nests inside this span's."""
        end = self.t0 if self.t1 is None else self.t1
        o_end = other.t0 if other.t1 is None else other.t1
        return self.t0 <= other.t0 and o_end <= end

    def to_dict(self) -> dict:
        return {"name": self.name, "node": self.node,
                "t0": self.t0, "t1": self.t0 if self.t1 is None else self.t1,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "tags": dict(self.tags),
                "attributed_ws": self.attributed_ws}

    @classmethod
    def from_dict(cls, doc: dict) -> "Span":
        return cls(name=doc["name"], node=doc.get("node", FLEET_ROW),
                   t0=float(doc["t0"]), t1=float(doc["t1"]),
                   span_id=int(doc.get("span_id", 0)),
                   parent_id=doc.get("parent_id"),
                   tags=dict(doc.get("tags", {})),
                   attributed_ws=float(doc.get("attributed_ws", 0.0)))


class Tracer:
    """Collects spans; bounded so a runaway loop cannot eat the host."""

    enabled = True

    def __init__(self, clock=time.monotonic, maxlen: int = 200_000):
        self.clock = clock
        self.maxlen = maxlen
        self.spans: list[Span] = []
        self.dropped = 0            # spans past maxlen (counted, not kept)
        self._next_id = 1
        self._stack: list[Span] = []    # context-manager nesting
        #: (this clock, ``time.time_ns()``) read together at construction;
        #: None on an injected clock
        self.epoch = (clock(), time.time_ns()) if clock in HOST_CLOCKS \
            else None

    def to_profiler_ns(self, t: float) -> int:
        """``t`` (seconds on this tracer's clock) as nanoseconds on
        ``torch.profiler``'s timeline (``time.time_ns()``'s)."""
        if self.epoch is None:
            raise ValueError(f"a tracer on the injected clock "
                             f"{self.clock!r} has no place on the "
                             f"profiler's timeline")
        c0, ns0 = self.epoch
        return ns0 + round((t - c0) * 1e9)

    def begin(self, name: str, *, node: str = FLEET_ROW,
              t0: Optional[float] = None, parent: Optional[Span] = None,
              tags: Optional[dict] = None) -> Span:
        """Open a span; the caller closes it via ``finish``/``extend``.
        ``parent=None`` inherits the innermost context-managed span."""
        if parent is None and self._stack:
            parent = self._stack[-1]
        sp = Span(name=name, node=node,
                  t0=self.clock() if t0 is None else t0,
                  span_id=self._next_id,
                  parent_id=parent.span_id if parent is not None else None,
                  tags=dict(tags or {}))
        self._next_id += 1
        if len(self.spans) < self.maxlen:
            self.spans.append(sp)
        else:
            self.dropped += 1
        return sp

    def instant(self, name: str, *, node: str = FLEET_ROW,
                t: Optional[float] = None,
                tags: Optional[dict] = None) -> Span:
        """A zero-length marker span (lifecycle edges: route, flush...)."""
        return self.begin(name, node=node, t0=t, tags=tags).finish()

    @contextmanager
    def span(self, name: str, *, node: str = FLEET_ROW,
             tags: Optional[dict] = None):
        """Scope a span on the tracer's clock; children opened inside the
        ``with`` body nest under it automatically."""
        sp = self.begin(name, node=node, tags=tags)
        self._stack.append(sp)
        try:
            yield sp
        finally:
            self._stack.pop()
            sp.finish(self.clock())

    def add_spans(self, spans) -> int:
        """Bulk append: assign ids and store a whole batch of caller-built
        ``Span`` objects in one tracer call (the vectorized engines emit
        per-(node, phase) aggregates and sampled request trees this way
        instead of one ``begin`` per span).  Spans arriving with
        ``span_id == 0`` get fresh ids; parent links set by the caller
        are kept.  Returns how many were stored (the rest are counted in
        ``dropped``)."""
        stored = 0
        for sp in spans:
            if sp.span_id == 0:
                sp.span_id = self._next_id
                self._next_id += 1
            if len(self.spans) < self.maxlen:
                self.spans.append(sp)
                stored += 1
            else:
                self.dropped += 1
        return stored

    def to_jsonl(self, path) -> str:
        from repro_torch.obs.export import write_spans_jsonl
        return write_spans_jsonl(self.spans, path)


_NULL_SPAN = Span(name="", t0=0.0)


class NullTracer:
    """The default tracer: every call is a no-op returning a shared dummy
    span.  Call sites guard on ``.enabled`` so these methods are only the
    safety net."""

    enabled = False
    spans: tuple = ()
    dropped = 0
    epoch = None
    clock = staticmethod(time.monotonic)

    def to_profiler_ns(self, t: float) -> int:
        raise ValueError("tracing is off: no span is on the profiler's "
                         "timeline")

    def begin(self, name: str, **kw) -> Span:
        return _NULL_SPAN

    def instant(self, name: str, **kw) -> Span:
        return _NULL_SPAN

    def add_spans(self, spans) -> int:
        return 0

    @contextmanager
    def span(self, name: str, **kw):
        yield _NULL_SPAN

    def to_jsonl(self, path) -> str:
        Path(path).write_text("")
        return str(path)


def load_spans_jsonl(path) -> list[Span]:
    """Read a spans JSONL file back (inverse of ``Tracer.to_jsonl``)."""
    spans = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            spans.append(Span.from_dict(json.loads(line)))
    return spans

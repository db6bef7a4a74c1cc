"""Span tracing — nestable timed windows on named per-node timelines.

The part of ``repro.obs.span`` the serving loop uses (context-managed
scopes, bulk appends and exporters wait for the observability slice).  A
``Span`` is one window on one node's timeline: a name, start/end seconds, a
tag dict, and an optional parent id.  ``Tracer.begin`` opens spans whose
edges the *caller* times — the serving instrumentation stamps them with the
node meter's cumulative busy-time clock (``meter.now``) so span windows line
up exactly with the Watt*second bookings they describe.

``extend(t1, ws=...)`` grows an open span and accumulates a ``ws`` tag.
Instrumented call sites go through the module-level
``repro_torch.obs.TRACER`` (a ``NullTracer`` by default), guarded by
``.enabled`` — the hot path pays one attribute check when tracing is off.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

FLEET_ROW = "fleet"     # default timeline for control-plane spans


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


class Tracer:
    """Collects spans; bounded so a runaway loop cannot eat the host."""

    enabled = True

    def __init__(self, clock=time.monotonic, maxlen: int = 200_000):
        self.clock = clock
        self.maxlen = maxlen
        self.spans: list[Span] = []
        self.dropped = 0            # spans past maxlen (counted, not kept)
        self._next_id = 1

    def begin(self, name: str, *, node: str = FLEET_ROW,
              t0: Optional[float] = None, parent: Optional[Span] = None,
              tags: Optional[dict] = None) -> Span:
        """Open a span; the caller closes it via ``finish``/``extend``."""
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


_NULL_SPAN = Span(name="", t0=0.0)


class NullTracer:
    """The default tracer: every call is a no-op returning a shared dummy
    span.  Call sites guard on ``.enabled`` so these methods are only the
    safety net."""

    enabled = False
    spans: tuple = ()
    dropped = 0
    clock = staticmethod(time.monotonic)

    def begin(self, name: str, **kw) -> Span:
        return _NULL_SPAN


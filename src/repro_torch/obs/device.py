"""Device ranges — named, nestable windows of device time.

A range is a pair of ``torch.cuda.Event(enable_timing=True,
external=True)`` recorded on the current stream around a stretch of the
program's work.  Under stream capture ``external=True`` makes each record
an event-record node of the graph (a default event recorded in a capture
becomes only a cross-stream dependency), so the ranges opened while a CUDA
graph is captured time every replay of it: the graph keeps the ranges its
capture recorded (``capturing``) and hands them back as it launches each
replay (``replaying``), as it adds its kernels' launch counts.  A range opened
outside a capture times the eager work it wraps.

Once the device has run the work, ``collect`` reads every range into
per-name totals: count, device ms, and self ms (the range minus the time
its child ranges cover).  A graph's events hold its latest replay's
times, so a graph about to be replayed again before a ``collect`` first
has its previous replay read (waiting for it): no replay's numbers are
lost or read twice.

``DeviceRanges(clock=...)`` stamps a host clock instead of recording
events: for the CPU and for tests on an injected clock.

Sites go through ``repro_torch.obs.device_range(name)``, which reads the
module-level ``repro_torch.obs.RANGES`` (a ``NullRanges`` until
``enable_ranges``): with ranges off a site records nothing, and a capture
holds no event node.  A graph carries no Python, so a range is an event
pair and never an NVTX or ``record_function`` range.  The ranges of one
``DeviceRanges`` nest on one stack: the autograd engine runs a backward's
ranges on its own thread while the thread that called ``backward()``
waits, so the two never push at once.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

import torch


class _Range:
    """One open or closed range: its name, its two stamps (events or
    clock readings) and the ranges opened inside it."""

    __slots__ = ("name", "start", "end", "children")

    def __init__(self, name: str, start):
        self.name = name
        self.start = start
        self.end = None
        self.children: list = []


class DeviceRanges:
    """Collects named device ranges and their per-name totals."""

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock
        #: name -> [count, device ms, self ms], over every range read
        self.totals: dict = {}
        self._stack: list = []
        self._loose: list = []       # top-level ranges recorded eagerly
        self._sink = self._loose     # where a new top-level range goes
        self._pending: list = []     # replayed graphs' ranges, unread

    def _stamp(self):
        if self.clock is not None:
            return self.clock()
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        return ev

    @contextmanager
    def range(self, name: str):
        """A range around the ``with`` body, nested in the innermost open
        one."""
        r = _Range(name, self._stamp())
        (self._stack[-1].children if self._stack else self._sink).append(r)
        self._stack.append(r)
        try:
            yield r
        finally:
            self._stack.pop()
            r.end = self._stamp()

    @contextmanager
    def capturing(self):
        """Around a CUDA graph's capture: yields the list that, once the
        block ends, holds the top-level ranges the capture recorded (read
        only through ``replaying``)."""
        outer, self._sink = self._sink, []
        try:
            yield self._sink
        finally:
            self._sink = outer

    def replaying(self, ranges: list) -> None:
        """Just before a replay of a graph whose capture recorded
        ``ranges`` is launched: that replay's ranges are read at the next
        ``collect`` (a previous replay's still unread are read now, before
        the new one records over them)."""
        if any(p is ranges for p in self._pending):
            self.collect()
        self._pending.append(ranges)

    def _ms(self, r: _Range) -> float:
        if self.clock is not None:
            return (r.end - r.start) * 1e3
        return r.start.elapsed_time(r.end)

    def _read(self, r: _Range, top: bool = True) -> float:
        if top and self.clock is None:
            # one stream: the children's events come before their parent's
            # end, which is all the wait a range tree needs
            r.end.synchronize()
        ms = self._ms(r)
        inner = sum(self._read(c, False) for c in r.children)
        t = self.totals.setdefault(r.name, [0, 0.0, 0.0])
        t[0] += 1
        t[1] += ms
        t[2] += ms - inner
        return ms

    def collect(self) -> dict:
        """Read every closed range recorded eagerly or replayed since the
        last ``collect`` (waiting for the device to reach each one's end)
        into ``totals``; returns ``totals``."""
        groups, self._pending = self._pending, []
        loose = [r for r in self._loose if r.end is not None]
        self._loose[:] = [r for r in self._loose if r.end is None]
        for group in groups + [loose]:
            for r in group:
                self._read(r)
        return self.totals

    def reset(self) -> None:
        """Forget the totals (ranges not yet read stay pending)."""
        self.totals = {}

    def table(self) -> list:
        """``[name, count, device ms, self ms]`` a name, by self ms."""
        return sorted(([n, *t] for n, t in self.totals.items()),
                      key=lambda row: row[3], reverse=True)


class NullRanges:
    """The default: no range is recorded (sites guard on ``.enabled``)."""

    enabled = False
    totals: dict = {}

    @contextmanager
    def range(self, name: str):
        yield None

    @contextmanager
    def capturing(self):
        yield []

    def replaying(self, ranges: list) -> None:
        pass

    def collect(self) -> dict:
        return {}

    def reset(self) -> None:
        pass

    def table(self) -> list:
        return []


def format_table(rows: list) -> str:
    """``DeviceRanges.table()`` as aligned text: name, count, device ms,
    self ms."""
    lines = [f"{'range':<24} {'count':>8} {'device ms':>12} {'self ms':>12}"]
    lines += [f"{n:<24} {c:>8d} {ms:>12.3f} {own:>12.3f}"
              for n, c, ms, own in rows]
    return "\n".join(lines)

"""What the program's own instruments (``repro_torch.obs``) read in a cell,
reduced to numbers: the arithmetic of ``portbench/trace_program.py``.

- ``profile_busy(fn)`` profiles a stretch on the card and keeps its busy
  intervals in nanoseconds on ``torch.profiler``'s timeline, where
  ``obs.to_profiler_ns`` puts the program's host spans.
- ``split_idle`` books each idle nanosecond of that stretch to the
  innermost host span open at that instant, or to ``HARNESS``.
- ``serve_numbers`` and ``train_numbers`` turn a run's readings into the
  per-layer numbers the program's instruments give (PERF.md, section 3):
  ``weight_cast_range_share.serve``, ``weight_cast_gb_per_step.serve``,
  ``fill_replay_share.serve``, ``idle_in_loop_share.serve``,
  ``plain_backward_share.train`` and ``graph_capture_s.train``, each
  beside the outside reading it shadows where there is one.
"""
from __future__ import annotations

import time

from portbench.profiling import _merge as merge
from portbench.stats import rule_seconds, share

#: where ``split_idle`` books idle time during which no given span was open
HARNESS = "harness"
#: the serve loop's host phases: a step and what it does inside
LOOP = ("serve.step", "serve.fill", "serve.launch", "serve.sync")


def profile_busy(fn) -> dict:
    """Run ``fn()`` under the profiler (the card's activity only); returns
    {"start_ns", "end_ns": the stretch on the profiler's timeline,
    "busy_ns": its merged busy intervals, "busy_s", "window_s",
    "kernels": [[name, device seconds, count], ...] by time}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.time_ns()
        fn()
        torch.cuda.synchronize()
        end = time.time_ns()
    # the events' times are microseconds from the trace's start
    base = prof.profiler.kineto_results.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    sums: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != cuda:
            continue
        a = base + round(e.time_range.start * 1e3)
        b = base + round(e.time_range.end * 1e3)
        s = sums.setdefault(e.name, [0.0, 0])
        s[0] += (b - a) / 1e9
        s[1] += 1
        spans.append((a, b))
    busy = merge(spans)
    kernels = sorted(([k, v[0], v[1]] for k, v in sums.items()),
                     key=lambda r: r[1], reverse=True)
    return {"start_ns": start, "end_ns": end, "busy_ns": busy,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (end - start) / 1e9, "kernels": kernels}


def split_idle(busy, start: int, end: int, spans, to_ns) -> dict:
    """Span name -> nanoseconds of ``[start, end)`` (ns on the profiler's
    timeline) in which the device ran nothing (outside every interval of
    ``busy``, ``[[s, e], ...]`` ns, sorted and disjoint) while that span
    was the innermost open one; ``HARNESS`` takes the idle time in which
    none was.  ``spans`` are closed host spans that nest (a parent's
    window holds its children's); ``to_ns`` maps their seconds onto the
    profiler's timeline.  The values sum to the stretch's idle time."""
    idle, t = [], start
    for s, e in busy:
        if e <= t:
            continue
        if s >= end:
            break
        if s > t:
            idle.append((t, s))
        t = e
    if t < end:
        idle.append((t, end))
    edges: dict = {}
    for sp in spans:
        a, b = to_ns(sp.t0), to_ns(sp.t1)
        if b > a:
            edges.setdefault(a, ([], []))[0].append((b, sp.name))
            edges.setdefault(b, ([], []))[1].append((b, sp.name))
    for a, b in idle:
        edges.setdefault(a, ([], []))
        edges.setdefault(b, ([], []))
    out: dict = {}
    stack: list = []       # open spans as (end, name), outermost first
    xs = sorted(edges)
    j = 0
    for x0, x1 in zip(xs, xs[1:]):
        opened, closed = edges[x0]
        for c in closed:
            stack.remove(c)
        # of spans opening together the one ending last is the outer one
        stack.extend(sorted(opened, reverse=True))
        while j < len(idle) and idle[j][1] <= x0:
            j += 1
        if j < len(idle) and idle[j][0] <= x0:
            name = stack[-1][1] if stack else HARNESS
            out[name] = out.get(name, 0) + (x1 - x0)
    return out


def range_share(totals: dict, parts, whole: str):
    """Device ms of the ranges ``parts`` over the device ms of ``whole``,
    in % (``totals``: ``obs.RANGES.totals``, name -> [count, device ms,
    self ms]); None without either."""
    if whole not in totals:
        return None
    return share(sum(totals[n][1] for n in parts if n in totals),
                 totals[whole][1])


def backwards(totals: dict) -> list:
    """The plain backwards' range names (``<kernel>.backward``; the whole
    step's ``train.backward`` holds them)."""
    return sorted(n for n in totals
                  if n.endswith(".backward") and n != "train.backward")


def delta(before: dict, after: dict) -> dict:
    """Counter name -> its growth from ``before`` to ``after``."""
    return {n: v - before.get(n, 0.0) for n, v in after.items()
            if v != before.get(n, 0.0)}


def serve_numbers(r: dict) -> dict:
    """The serve cell's numbers from ``trace_program.serve``'s readings
    ``r`` (``counts``: the counters' growth over the window; ``ranges``:
    range totals over the ranged stretch; ``idle_ns``: ``split_idle`` of
    the profiled stretch; ``profile``: ``profile_busy``'s reading)."""
    c = r["counts"]
    fills = c.get("serve.fill_replays", 0.0)
    decodes = c.get("serve.decode_replays", 0.0)
    replays = fills + decodes
    out = {
        "weight_cast_range_share.serve": range_share(
            r["ranges"], ["weights.cast"], "decode.step"),
        "weight_cast_gb_per_step.serve":
            c.get("weights.cast_bytes", 0.0) / replays / 1e9
            if replays else None,
        "casts_per_step": c.get("weights.casts", 0.0) / replays
            if replays else None,
        "fill_replay_share.serve": share(fills, replays),
        "forced_step_share.serve": share(
            r["forced_steps"], r["forced_steps"] + r["decode_steps"]),
        "tokens_per_decode_replay": c.get("serve.tokens_out", 0.0)
            / decodes if decodes else None,
    }
    prof = r.get("profile")
    if prof:
        out["idle_in_loop_share.serve"] = 100.0 * sum(
            r["idle_ns"].get(n, 0) for n in LOOP) / (
            prof["end_ns"] - prof["start_ns"])
        out["weight_cast_share.serve"] = share(
            rule_seconds(prof, "weight_casts"), prof["busy_s"])
    return out


def train_numbers(r: dict) -> dict:
    """The train cell's numbers from ``trace_program.train``'s readings:
    the plain backwards' share of the ranged steps, and the first call's
    capture apart from its eager step."""
    return {
        "plain_backward_share.train": range_share(
            r["ranges"], backwards(r["ranges"]), "train.step"),
        "graph_capture_s.train": r.get("capture_s"),
        "eager_step_s": r.get("eager_step_s"),
    }

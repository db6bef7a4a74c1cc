"""A profiled stretch of a run: the card's kernels and copies under
``torch.profiler`` (CUPTI), reduced to what the per-layer readers and the
result line's ``breakdown`` read.

Only the card's activity is recorded (its kernels, copies and the CUDA
runtime calls): recording every operator on the host as well stretches
a window of CUDA-graph replays several times.  Under CUPTI a graph launch
also costs the host more, so the busy share of a profiled stretch
understates what an unprofiled window reaches; the readers take idle
shares from CUDA events in the measured window instead.
"""
from __future__ import annotations

import time

import torch

TOP = 10


def _merge(spans: list) -> list:
    spans = sorted(spans)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(fn) -> dict:
    """Run ``fn()`` under the profiler; returns {"window_s", "busy_s",
    "kernels": [[name, device seconds, count], ...] by time,
    "idle_gaps": the longest gaps between device work, each named by the
    runtime calls the host made in it}."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    sums: dict = {}
    spans, host = [], []
    for e in prof.events():
        if e.device_type == cuda:
            us = e.time_range.end - e.time_range.start
            s = sums.setdefault(e.name, [0.0, 0])
            s[0] += us / 1e6
            s[1] += 1
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith("cuda"):
            host.append((e.time_range.start, e.time_range.end, e.name))
    busy = _merge(spans)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:TOP]
    idle = []
    for length, s, e in gaps:
        calls: dict = {}
        for hs, he, name in host:
            ov = min(he, e) - max(hs, s)
            if ov > 0:
                calls[name] = calls.get(name, 0.0) + ov
        label = max(calls, key=calls.get) if calls else "no runtime call"
        idle.append([f"host in {label}", length / 1e6])
    kernels = sorted(([k, v[0], v[1]] for k, v in sums.items()),
                     key=lambda r: r[1], reverse=True)
    return {"window_s": wall,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "kernels": kernels, "idle_gaps": idle}


def breakdown(prof: dict) -> dict:
    """The result line's ``breakdown``: the ten kernels that took most
    device time and the ten longest idle gaps."""
    return {"device_ops": [[k[:120], s] for k, s, _ in prof["kernels"][:TOP]],
            "idle_gaps": prof["idle_gaps"]}

"""The serve driver: the port's ``ServeLoop`` under a closed loop of
clients, measured over a window of steps.

Set-up makes the weights from the seed, builds the model and the loop
(``batch_slots`` slots, an ``eos_id`` no token takes, so every request
runs to its drawn output length), submits one request a client and takes
the loop's first step, which fills every slot (the first requests carry
residual output lengths, ``mixes``) and captures the decode step as a CUDA
graph.  The window then steps the loop until ``seconds`` have passed;
after each step every finished request's client submits its next one.  A
token's time is the host clock after the step that made it: the step's
``.cpu()`` of the argmax waits for the card.

With ``trace`` the window also records CUDA events around every replay of
the decode step, and after it a stretch of ``profile_s`` more steps runs
under the profiler.  Once the window has closed and the peak memory is
read, the program is freed and the plain reference judges every served
token from the loop's first step on (``reference.serve``).
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from portbench import core, mixes, profiling, weights
from portbench import program as prog
from portbench.energy import Nvml, Window
from portbench.reference import serve as ref_serve


class Book:
    """The window's counts, kept from each step's served tokens."""

    def __init__(self):
        self.seen: dict = {}     # rid -> (tokens seen, time of the last)
        self.open = None         # the window's start, once open
        self.tokens = 0
        self.gaps_ms: list = []
        self.forced = 0
        self.needed = 0
        self.ctx = 0
        self.served_reqs = set()

    def step(self, inflight: list, now: float) -> list:
        """Book the tokens ``inflight`` requests gained; returns the ones
        that finished."""
        done = []
        for r in inflight:
            n = len(r.out)
            k, last = self.seen.get(r.rid, (0, None))
            if n > k:
                if self.open is not None:
                    p = len(r.prompt)
                    if k == 0:           # filled in this step
                        self.forced += p - 1
                        self.needed += p - 1
                        self.ctx += (p - 1) * p // 2
                    self.needed += n - k
                    self.ctx += sum(p + j for j in range(k, n))
                    self.tokens += n - k
                    self.served_reqs.add(r.rid)
                    if last is not None and last >= self.open:
                        self.gaps_ms.append((now - last) * 1e3)
                self.seen[r.rid] = (n, now)
            if r.done:
                done.append(r)
        return done


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        arch=None, control: bool = False) -> dict:
    from repro_torch.serve.engine import Request, ServeLoop
    config, mix = cell.config, cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ref = core.reference(config["reference"])
    arch = prog.arch_for(config, arch)
    params = weights.for_model(ref, config, seed, dev)
    model, w = prog.build(config, arch, params, dev)
    del params
    prog.kernel_modules()
    slots, max_seq = mix["slots"], mix["max_seq"]
    loop = ServeLoop(model, w, batch_slots=slots, max_seq=max_seq,
                     eos_id=-1, device=dev)
    stream = mixes.requests(mix, seed, config["vocab_size"])
    reqs, inflight = [], []

    def submit():
        prompt, n_out = next(stream)
        r = Request(rid=len(reqs), prompt=prompt, max_new=n_out)
        reqs.append(r)
        inflight.append(r)
        loop.submit(r)

    book = Book()

    def step():
        loop.step()
        now = time.perf_counter()
        for r in book.step(inflight, now):
            inflight.remove(r)
            submit()
        return now

    for _ in range(mix["clients"]):
        submit()
    step()                                   # fills every slot; captures
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    events = []
    if trace and on_card:
        # events around the graph's replay alone: the step's token copy
        # (from pageable memory, which waits for the card) comes before
        graph = loop.graph
        replay = graph.replay

        def timed():
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = replay()
            e.record()
            events.append((s, e))
            return out
        graph.replay = timed
    energy = Window(Nvml(dev).energy_j) if on_card else None
    if energy is not None:
        energy.open()
    steps0 = loop.steps_done
    t0 = time.perf_counter()
    book.open = t0
    now = t0
    while now - t0 < seconds:
        now = step()
    window_s = now - t0
    decode_steps = loop.steps_done - steps0
    book.open = None
    if energy is not None:
        energy.close()
    readings = {"setup_s": setup_s, "window_s": window_s,
                "gen_tokens": book.tokens, "gaps_ms": book.gaps_ms,
                "decode_steps": decode_steps, "forced_steps": book.forced,
                "needed_tokens": book.needed, "needed_ctx_sum": book.ctx,
                "config": config, "reference": config["reference"],
                "slots": slots}
    if energy is not None:
        readings.update(energy_j=energy.joules, energy_s=energy.seconds)
    breakdown = None
    if trace and on_card:
        graph.replay = replay
        torch.cuda.synchronize(dev)
        readings["replay_ms"] = [s.elapsed_time(e) for s, e in events]
        before = prog.launches()

        def stretch():
            t = time.perf_counter()
            while time.perf_counter() - t < mix["profile_s"]:
                step()
        readings["profile"] = profiling.profile(stretch)
        after = prog.launches()
        readings["launches"] = {k: after[k] - before.get(k, 0)
                                for k in after}
        breakdown = profiling.breakdown(readings["profile"])
    device_info = device_dict(dev)

    served = [(r.prompt, r.max_new, list(r.out)) for r in reqs]
    n_steps = loop.steps_done
    loop.graph = loop._graph_for = loop.cache = None
    del loop, w, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = judge(ref, config, cell.limits, served, mix, n_steps, seed, dev)
    out = {"readings": readings, "checks": checks, "device": device_info,
           "attempted": len(book.served_reqs), "failed": 0,
           "breakdown": breakdown}
    if control:
        out["control"] = judge(ref, config, cell.limits, served, mix,
                               n_steps, seed, dev, control=True)
    return out


def judge(ref, config: dict, limits: dict, served: list, mix: dict,
          decode_steps: int, seed: int, dev, control: bool = False) -> dict:
    """The compared numbers: the widest gap of a served token's logit
    below the reference's best (with ``control``, the float8 control's
    own choice in the program's place)."""
    steps, fault = ref_serve.schedule(served, mix["slots"], mix["max_seq"],
                                      mix["clients"], decode_steps)
    if fault:
        print(f"schedule fault: {fault}", file=sys.stderr)
        return {"schedule_faults": {"value": 1.0, "limit": 0.0}}
    params = weights.for_model(ref, config, seed, dev)
    out = ref_serve.judge(ref, params, config, steps, mix["slots"],
                          mix["max_seq"], dev, control=control)
    print(f"served tokens compared: {out['compared']}", file=sys.stderr)
    return {"widest_gap": {"value": out["widest_gap"],
                           "limit": limits["widest_gap"]}}


def device_dict(dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}

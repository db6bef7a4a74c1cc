"""Run one cell with the program's own instruments on and print what they
read.

    python3 portbench/trace_program.py --workload <cell> --seed <n> \
        --seconds <s> [--steps <n>] [--unranged]

From the root of a checkout, on the card.  ``repro_torch.obs`` is on from
the start (spans and counters; ``obs.enable()``).  Not a run of the
benchmark: ``run.py``'s drivers do not switch the instruments on, so its
result line does not carry these numbers (PERF.md, open questions).

A serve cell runs as ``drivers/serve.py`` runs it (the same weights,
loop, closed loop of clients and ``Book``): a window of ``seconds`` with
CUDA events around each replay, over which the counters' growth is read;
then ``profile_s`` of steps under the profiler, whose idle time
``spans.split_idle`` books to the loop's host spans; then the decode step
captured again with device ranges on (``obs.enable_ranges()``) and
``steps`` more steps (default: ``profile_s`` of them), each replay timed
by events outside its ranges.

A train cell builds the driver's model, optimizer state and
``TrainGraph`` with ranges on before its one capture, times the first call
(``train.eager_step``, ``train.capture``) and ``steps`` replays (default
4); with ``--unranged`` a second graph, captured with ranges off, times as
many replays beside them.

Standard error gets the range table, the counters' growth and the idle
split; the last line of standard output is one JSON object:
``{"numbers": spans.serve_numbers / train_numbers, "readings": ...}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import core, mixes, spans, weights  # noqa: E402
from portbench import program as prog  # noqa: E402
from portbench.drivers.serve import Book  # noqa: E402
from portbench.drivers.train import check_optimizer  # noqa: E402


def _median(xs):
    return statistics.median(xs) if xs else None


def _time_replays(graph, sink: list) -> None:
    """CUDA events around each later replay of ``graph``, into ``sink``
    (ms, read once the card has run them).  The device ranges of the
    replay before are read first, so that the wait for them falls
    outside the events."""
    from repro_torch import obs
    replay = graph.replay

    def timed():
        obs.RANGES.collect()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = replay()
        e.record()
        sink.append((s, e))
        return out
    graph.replay = timed


def serve(cell, seed: int, seconds: float, device, arch=None,
          steps=None) -> dict:
    from repro_torch import obs
    from repro_torch.serve.engine import Request, ServeLoop
    config, mix = cell.config, cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    tr, mx = obs.enable()
    try:
        ref = core.reference(config["reference"])
        arch = prog.arch_for(config, arch)
        params = weights.for_model(ref, config, seed, dev)
        model, w = prog.build(config, arch, params, dev)
        del params
        prog.kernel_modules()
        loop = ServeLoop(model, w, batch_slots=mix["slots"],
                         max_seq=mix["max_seq"], eos_id=-1, device=dev)
        stream = mixes.requests(mix, seed, config["vocab_size"])
        book, inflight, n = Book(), [], [0]

        def submit():
            prompt, n_out = next(stream)
            r = Request(rid=n[0], prompt=prompt, max_new=n_out)
            n[0] += 1
            inflight.append(r)
            loop.submit(r)

        def step():
            loop.step()
            now = time.perf_counter()
            for r in book.step(inflight, now):
                inflight.remove(r)
                submit()
            return now

        def sync():
            if on_card:
                torch.cuda.synchronize(dev)

        for _ in range(mix["clients"]):
            submit()
        step()                               # fills every slot; captures
        sync()

        plain = []
        if on_card:
            _time_replays(loop.graph, plain)
        c0, steps0 = mx.counter_values(), loop.steps_done
        t0 = now = time.perf_counter()
        book.open = t0
        while now - t0 < seconds:
            now = step()
        book.open = None
        sync()
        r = {"window_s": now - t0, "decode_steps": loop.steps_done - steps0,
             "forced_steps": book.forced,
             "counts": spans.delta(c0, mx.counter_values()),
             "replay_ms": _median([s.elapsed_time(e) for s, e in plain])}

        def stretch():
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < mix["profile_s"]:
                step()

        if on_card:
            first = len(tr.spans)
            prof = r["profile"] = spans.profile_busy(stretch)
            host = [s for s in tr.spans[first:] if s.name in spans.LOOP]
            r["idle_ns"] = spans.split_idle(prof["busy_ns"],
                                            prof["start_ns"], prof["end_ns"],
                                            host, tr.to_profiler_ns)

        # the decode step again, captured with ranges on; the warm-up's
        # and the capture's own ranges are dropped before the stretch
        obs.enable_ranges(clock=None if on_card else time.perf_counter)
        loop.graph = loop._graph_for = None
        gc.collect()                         # the window's graph's pool
        step()
        sync()
        obs.RANGES.collect()
        obs.RANGES.reset()
        ranged = []
        if on_card:
            _time_replays(loop.graph, ranged)
        if steps is None:
            stretch()
        else:
            for _ in range(steps):
                step()
        sync()
        r["ranges"] = obs.RANGES.collect()
        r["ranged_replay_ms"] = _median([s.elapsed_time(e)
                                         for s, e in ranged])
        r["table"] = obs.RANGES.table()
        r["weight_bytes_f32"] = sum(
            p.numel() * p.element_size() for p in w.parameters()
            if p.dtype == torch.float32)
        loop.graph = loop._graph_for = loop.cache = None
        return r
    finally:
        obs.disable()
        gc.collect()


def train(cell, seed: int, device, arch=None, steps: int = 4,
          unranged: bool = False) -> dict:
    from repro_torch import obs
    from repro_torch.train.step import TrainGraph, make_opt_init
    config, mix = cell.config, cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    tr, mx = obs.enable()
    obs.enable_ranges(clock=None if on_card else time.perf_counter)
    try:
        ref = core.reference(config["reference"])
        arch = prog.arch_for(config, arch)
        check_optimizer(arch, config["train"])
        model, w = prog.build(config, arch,
                              weights.for_model(ref, config, seed, dev), dev)
        prog.kernel_modules()
        opt_state = make_opt_init(model)(w)
        source = mixes.train_source(mix, seed, config["vocab_size"])

        def batch(k: int) -> dict:
            return {n: torch.from_numpy(v).to(dev)
                    for n, v in source.batch(k).items()}

        def sync():
            if on_card:
                torch.cuda.synchronize(dev)

        def run(graph, k0: int) -> tuple:
            """(First call s, each later call's device ms: events around
            the call, the ranges of the call before read first)."""
            t = time.perf_counter()
            graph(w, opt_state, batch(k0))
            sync()
            first = time.perf_counter() - t
            obs.RANGES.collect()
            obs.RANGES.reset()
            events = []
            for k in range(k0 + 1, k0 + 1 + steps):
                b = batch(k)
                if on_card:
                    obs.RANGES.collect()     # the step before, untimed
                    events.append([torch.cuda.Event(enable_timing=True)
                                   for _ in range(2)])
                    events[-1][0].record()
                graph(w, opt_state, b)
                if on_card:
                    events[-1][1].record()
            sync()
            return first, [s.elapsed_time(e) for s, e in events]

        def seconds(name: str, i: int = 0):
            got = [s.seconds for s in tr.spans if s.name == name]
            return got[i] if got else None

        graph = TrainGraph(model)
        first, step_ms = run(graph, 0)
        r = {"first_call_s": first,
             "eager_step_s": seconds("train.eager_step"),
             "capture_s": seconds("train.capture"),
             "step_ms": _median(step_ms), "ranges": obs.RANGES.collect(),
             "table": obs.RANGES.table(),
             "replay_host_ms": _median([s.seconds * 1e3 for s in tr.spans
                                        if s.name == "train.replay"])}
        if unranged:
            del graph
            gc.collect()
            obs.set_ranges(None)
            first, plain = run(TrainGraph(model), 1 + steps)
            r.update(unranged_first_call_s=first,
                     unranged_capture_s=seconds("train.capture", -1),
                     unranged_step_ms=_median(plain))
        return r
    finally:
        obs.disable()
        gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--unranged", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch import obs
    cell = core.load_cell(args.workload)
    if cell.traffic["driver"] == "serve":
        r = serve(cell, args.seed, args.seconds, "cuda", steps=args.steps)
        numbers = spans.serve_numbers(r)
        for name, ns in sorted(r.get("idle_ns", {}).items(),
                               key=lambda kv: -kv[1]):
            print(f"idle in {name}: {ns / 1e6:.1f} ms", file=sys.stderr)
    else:
        r = train(cell, args.seed, "cuda", steps=args.steps or 4,
                  unranged=args.unranged)
        numbers = spans.train_numbers(r)
    print(obs.format_table(r.pop("table")), file=sys.stderr)
    print("counts: " + json.dumps(r.get("counts", {})), file=sys.stderr)
    r.pop("profile", None)
    print(json.dumps({"numbers": numbers, "readings": r,
                      "card": torch.cuda.get_device_name()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

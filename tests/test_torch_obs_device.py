"""The port's own measurement inside the program (``repro_torch.obs``):
device ranges on an injected clock, the counters a captured graph records
and hands on at each replay, the weight-cast counter against the
parameter shapes, the serve loop's spans on the tracer's clock without a
meter, and the tracer's place on ``torch.profiler``'s timeline (the split
of idle time by span is the benchmark's: ``portbench/spans.py``).  CPU
only; the card's counterparts are in
``tests/test_torch_obs_cuda.py``.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.obs import DeviceRanges, Tracer
from repro_torch.serve.engine import Request, ServeLoop
from repro_torch.telemetry import TickClock
from repro_torch.train.step import TrainGraph, make_opt_init


@pytest.fixture
def traced():
    """Tracing and host-clock ranges on for one test, off afterwards."""
    try:
        yield obs.enable(clock=TickClock(1.0)), \
            obs.enable_ranges(clock=TickClock(1.0))
    finally:
        obs.disable()


# ---------------------------------------------------------------------------
# Device ranges
# ---------------------------------------------------------------------------


def test_ranges_nest_and_total_their_self_time():
    clock = TickClock(1.0)          # every stamp one second on
    rg = DeviceRanges(clock=clock)
    for _ in range(2):
        with rg.range("step"):              # t 1 .. 8
            with rg.range("a"):             # 2 .. 5
                with rg.range("cast"):      # 3 .. 4
                    pass
            with rg.range("cast"):          # 6 .. 7
                pass
    with rg.range("cast"):
        pass
    totals = rg.collect()
    ms = 1e3
    assert totals == {"step": [2, 14 * ms, 6 * ms],
                      "a": [2, 6 * ms, 4 * ms],
                      "cast": [5, 5 * ms, 5 * ms]}
    # a second collect reads nothing new; the table orders by self time
    assert rg.collect() == totals
    assert [row[0] for row in rg.table()] == ["step", "cast", "a"]
    rg.reset()
    assert rg.collect() == {}


def test_ranges_off_record_nothing():
    obs.disable()
    assert not obs.RANGES.enabled
    with obs.device_range("decode.step") as r:
        assert r is None
    with obs.recorded() as rec:
        with obs.device_range("decode.step"):
            pass
    assert rec == obs.Recorded({}, [])
    assert obs.RANGES.collect() == {}


def test_ranges_switched_off_at_the_site():
    rg = obs.enable_ranges(clock=TickClock(1.0))
    try:
        with obs.device_range("decode.mlp", False) as r:
            assert r is None
        assert rg.collect() == {}
    finally:
        obs.disable()


def test_a_capture_records_counts_and_ranges_each_replay_hands_on(traced):
    (_, mx), rg = traced
    mx.counter("weights.casts").inc(2)
    with obs.recorded() as rec:
        mx.counter("weights.casts").inc(3)
        mx.counter("weights.cast_bytes").add(40)
        with obs.device_range("decode.step"):
            with obs.device_range("weights.cast"):
                pass
    # a capture runs nothing: its counts are put back, its ranges kept
    assert mx.counter("weights.casts").value == 2
    assert mx.counter("weights.cast_bytes").value == 0
    assert rec.counts == {"weights.casts": 3, "weights.cast_bytes": 40}
    assert [r.name for r in rec.ranges] == ["decode.step"]
    assert rg.collect() == {}
    # three replays, two of them before any collect: each is read once
    obs.replaying(rec)
    obs.replaying(rec)
    obs.replaying(rec)
    totals = rg.collect()
    assert totals["decode.step"][0] == 3 and totals["weights.cast"][0] == 3
    assert mx.counter("weights.casts").value == 2 + 3 * 3
    assert mx.counter("weights.cast_bytes").value == 3 * 40


# ---------------------------------------------------------------------------
# Weight casts, counted by the program
# ---------------------------------------------------------------------------


def _cast_bytes_from_shapes(params, cfg) -> int:
    """f32 bytes of every weight a decode step casts to the compute
    dtype: all but the norms' scales and the embedding table (its rows
    are gathered, then cast), and the table too when the head is tied."""
    total = 0
    for name, p in params.named_parameters():
        if ".norm" in f".{name}" or name.startswith("final_norm"):
            continue
        if name == "embed" and not cfg.tie_embeddings:
            continue
        total += p.numel() * 4
    return total


def test_a_decode_step_counts_the_bytes_of_the_weights_it_casts(traced):
    (_, mx), _ = traced
    cfg = get_config("tiny-test")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert {p.dtype for p in params.parameters()} == {torch.float32}
    cache = model.init_cache(2, 8)
    want = _cast_bytes_from_shapes(params, cfg)
    # 2 attention layers x (wq, wk, wv, wo, wi, wg, wo) + the head
    n_casts = 2 * 7 + 1
    with torch.no_grad():
        for call in (1, 2, 3):
            model.decode_step(params, {"tokens": torch.ones(2, 1,
                                                            dtype=torch.int32),
                                       "pos": call - 1}, cache)
            assert mx.counter("weights.cast_bytes").value == call * want
            assert mx.counter("weights.casts").value == call * n_casts


def test_the_decode_step_names_its_sublayers(traced):
    _, rg = traced
    cfg = get_config("tiny-test")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.decode_step(params, {"tokens": torch.ones(2, 1,
                                                        dtype=torch.int32),
                                   "pos": 0}, model.init_cache(2, 8))
        model.prefill(params,
                      {"tokens": torch.ones(2, 4, dtype=torch.int32)},
                      model.init_cache(2, 8))
    totals = rg.collect()
    counts = {n: t[0] for n, t in totals.items()}
    # the prefill opens no decode range; its 15 casts are ranged all the
    # same, as the decode step's 15
    assert counts == {"decode.step": 1, "decode.attention": 2,
                      "decode.mlp": 2, "decode.head": 1,
                      "weights.cast": 2 * 15}
    step = totals["decode.step"]
    inner = sum(totals[n][1] for n in ("decode.attention", "decode.mlp",
                                       "decode.head"))
    assert step[1] - step[2] == pytest.approx(inner)


def test_the_train_step_names_its_phases_and_the_plain_backward(traced):
    _, rg = traced
    cfg = get_config("mamba2-1.3b", True)
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(
        ssm_impl="pallas", remat="full", microbatches=2))
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = make_opt_init(model)(params)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "targets")}
    tr = obs.TRACER
    TrainGraph(model)(params, opt, batch)
    totals = rg.collect()
    counts = {n: t[0] for n, t in totals.items()}
    n_layers = len(cfg.layer_kinds())
    assert counts["train.step"] == 1
    assert counts["train.forward"] == counts["train.backward"] == 2
    assert counts["train.optimizer"] == 1
    # one plain SSD backward a layer a microbatch, inside train.backward
    assert counts["ssd.backward"] == 2 * n_layers
    for name in ("train.step", "train.backward"):
        assert totals[name][2] >= 0
    assert [s.name for s in tr.spans] == ["train.eager_step"]


# ---------------------------------------------------------------------------
# The serve loop without a meter: spans on the tracer's clock, counters
# ---------------------------------------------------------------------------


def test_the_loop_without_a_meter_traces_on_the_tracers_clock(traced):
    (tr, mx), _ = traced
    cfg = get_config("tiny-test")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    loop = ServeLoop(model, params, batch_slots=2, max_seq=32, eos_id=-1,
                     device="cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size,
                                               int(rng.integers(3, 7))
                                               ).astype(np.int32),
                    max_new=int(rng.integers(2, 5))) for i in range(4)]
    for r in reqs:
        loop.submit(r)
    loop.run()
    assert all(r.done for r in reqs)
    by = {}
    for s in tr.spans:
        by.setdefault(s.name, []).append(s)
        assert not s.open
    # every edge a reading of the tracer's own (ticking) clock
    assert all(float(s.t0).is_integer() and float(s.t1).is_integer()
               for s in tr.spans)
    steps = by["serve.step"]
    assert len(steps) == loop.steps_done
    assert {s.tags["kind"] for s in steps} == {"fill", "decode"}
    forced = sum(len(r.prompt) - 1 for r in reqs)
    assert mx.counter("serve.fill_replays").value == forced
    assert mx.counter("serve.decode_replays").value == loop.steps_done
    assert mx.counter("serve.tokens_out").value == sum(len(r.out)
                                                       for r in reqs)
    # fill steps are those whose serve.step holds a serve.fill
    fills = by["serve.fill"]
    assert sum(f.tags["replays"] for f in fills) == forced
    ids = {s.span_id: s for s in tr.spans}
    fill_steps = {f.parent_id for f in fills}
    assert fill_steps == {s.span_id for s in steps
                          if s.tags["kind"] == "fill"}
    for name in ("serve.fill", "serve.launch", "serve.sync"):
        for s in by[name]:
            parent = ids[s.parent_id]
            assert parent.name == "serve.step" and parent.contains(s)
    assert len(by["serve.launch"]) == len(by["serve.sync"]) \
        == loop.steps_done
    # each request's tree: root from submit to its last token
    roots = {s.tags["rid"]: s for s in by["serve.request"]}
    assert sorted(roots) == [r.rid for r in reqs]
    for s in by["serve.request"]:
        assert s.parent_id is None and s.tags["tokens"] > 0
    for name in ("serve.queue_wait", "serve.prefill", "serve.decode"):
        assert len(by[name]) == len(reqs)
        for s in by[name]:
            root = roots[s.tags["rid"]]
            assert s.parent_id == root.span_id and root.contains(s)
    for rid, root in roots.items():
        kids = sorted((s for s in tr.spans if s.parent_id == root.span_id),
                      key=lambda s: s.t0)
        assert [k.name for k in kids] == ["serve.queue_wait",
                                          "serve.prefill", "serve.decode"]
        assert kids[0].t0 == root.t0 and kids[-1].t1 == root.t1
        assert kids[0].t1 == kids[1].t0 and kids[1].t1 == kids[2].t0


def test_the_loop_counts_nothing_with_tracing_off():
    obs.disable()
    cfg = get_config("tiny-test")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    loop = ServeLoop(model, params, batch_slots=2, max_seq=16, eos_id=-1,
                     device="cpu")
    r = Request(rid=0, prompt=np.array([3, 4, 5], np.int32), max_new=2)
    loop.submit(r)
    loop.run()
    assert r.enq_t is None and loop._req_spans == {}
    assert obs.TRACER.spans == () and obs.METRICS.to_json() == {}


# ---------------------------------------------------------------------------
# The tracer's place on the profiler's timeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clock", [time.monotonic, time.perf_counter])
def test_a_span_holds_the_profiled_range_it_wraps(clock):
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = Tracer(clock=clock)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("host") as sp:
            with record_function("inner"):
                torch.ones(64).sum()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner"]
    assert tr.to_profiler_ns(sp.t0) <= ev.start_ns() <= ev.end_ns() \
        <= tr.to_profiler_ns(sp.t1)


def test_a_tracer_on_an_injected_clock_has_no_profiler_timeline():
    tr = Tracer(clock=TickClock(1.0))
    assert tr.epoch is None
    with pytest.raises(ValueError, match="profiler's timeline"):
        tr.to_profiler_ns(1.0)
    assert tr.clock.now == 0.0          # making it read no tick

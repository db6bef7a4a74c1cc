"""The program's device ranges and spans on the card (``repro_torch.obs``).

Ranges captured in a ``DecodeGraph`` time every replay, their children
never sum above their parent, and ``decode.step`` agrees with CUDA events
around the replay; with ranges off the capture holds no event node; the
train step's ranges time its replays, the plain SSD backward among them;
each ``serve.launch`` span holds its replay's ``cudaGraphLaunch`` on the
profiler's timeline.  The CPU counterparts are in
``tests/test_torch_obs_device.py``.

jax-free.  Every test takes the ``cuda`` fixture, which skips (with the
reason) when no CUDA device is visible; on the H100 run them with
``python -m pytest -m cuda tests/test_torch_obs_cuda.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models.model import Model

pytestmark = pytest.mark.cuda

#: the decode step's replays timed, after one untimed
REPLAYS = 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run "
                    "python -m pytest -m cuda tests/test_torch_obs_cuda.py")
    obs.disable()
    try:
        yield torch.device("cuda")
    finally:
        obs.disable()


def _qwen2_two_layers(dev):
    """qwen2-7b at its published widths, 2 of its 28 layers, under the
    serve cell's plan (the swiglu decode kernel, bf16 compute and cache):
    a decode step of a few ms, long beside a graph launch."""
    cfg = get_config("qwen2-7b")
    cfg = dataclasses.replace(cfg, n_layers=2, plan=cfg.plan.replace(
        attn_impl="pallas", mlp_impl="pallas"))
    model = Model(cfg, device=dev)
    return model, model.init(torch.Generator(device=dev).manual_seed(0))


def _decode_graph(model, params, dev, slots=8, max_seq=256):
    from repro_torch.serve.engine import DecodeGraph
    cache = model.init_cache(slots, max_seq)
    tok = torch.randint(2, 1000, (slots, 1), dtype=torch.int32, device=dev)
    pos = torch.full((), 17, dtype=torch.int32, device=dev)
    return DecodeGraph(model, params, cache, tok, pos)


def test_decode_graph_ranges_time_every_replay(cuda):
    model, params = _qwen2_two_layers(cuda)
    rg = obs.enable_ranges()
    graph = _decode_graph(model, params, cuda)
    assert graph.recorded is not None and graph.recorded.ranges
    rg.collect()                 # the warm-up's eager step
    rg.reset()
    graph.replay()
    torch.cuda.synchronize()
    rg.collect()
    rg.reset()
    outer = []
    for _ in range(REPLAYS):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        graph.replay()
        e.record()
        outer.append((s, e))
        # read now: a replay launched with its predecessor unread would
        # first read it, host time inside the outer pair
        torch.cuda.synchronize()
        rg.collect()
    totals = rg.totals
    counts = {n: t[0] for n, t in totals.items()}
    # the weights' casts are frozen: a replay ranges none
    assert graph.frozen is not None
    assert counts == {"decode.step": REPLAYS,
                      "decode.attention": 2 * REPLAYS,
                      "decode.mlp": 2 * REPLAYS, "decode.head": REPLAYS}
    for name, (n, ms, own) in totals.items():
        assert ms > 0, name
        # children never sum above their parent (events resolve ~0.5 us)
        assert own >= -1e-3 * n, name
    step_ms = totals["decode.step"][1]
    outer_ms = sum(s.elapsed_time(e) for s, e in outer)
    assert step_ms <= outer_ms
    assert step_ms == pytest.approx(outer_ms, rel=0.03)


def test_with_ranges_off_a_capture_holds_no_event_node(cuda, monkeypatch):
    """An event-record node needs a recorded event: with ranges off the
    warm-up and the capture make none (and the graph records nothing to
    hand on); with ranges on every range is a pair of external events."""
    model, params = _qwen2_two_layers(cuda)
    made = []
    real_event = torch.cuda.Event

    class CountedEvent(real_event):
        def __new__(cls, *args, **kw):
            made.append(kw)
            return super().__new__(cls, *args, **kw)

    monkeypatch.setattr(torch.cuda, "Event", CountedEvent)
    off = _decode_graph(model, params, cuda)
    assert off.recorded is None and made == []
    del off
    obs.enable_ranges()
    on = _decode_graph(model, params, cuda)
    # the step, its head, 2 x (attention, mlp): two events each, in the
    # warm-up's eager step and in the capture; the warm-up's 21 casts
    # (2 x (wq, wk, wv, bq, bk, bv, wo, wi, wg, wo) + the head) too, which
    # the capture, its casts frozen, does not make
    assert len(made) == 2 * 2 * (2 + 2 * 2) + 2 * 21
    assert all(kw == {"enable_timing": True, "external": True}
               for kw in made)
    assert len(on.recorded.ranges) == 1


def test_train_graph_ranges_time_its_replays(cuda):
    from repro_torch.train.step import TrainGraph, make_opt_init
    cfg = get_config("mamba2-1.3b", True)
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(
        ssm_impl="pallas", remat="full", microbatches=2))
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    opt = make_opt_init(model)(params)
    rng = np.random.default_rng(0)

    def batch():
        return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                                    .astype(np.int32)).to(cuda)
                for k in ("tokens", "targets")}
    tr, _ = obs.enable()
    rg = obs.enable_ranges()
    graph = TrainGraph(model)
    graph(params, opt, batch())
    assert [s.name for s in tr.spans] == ["train.eager_step",
                                          "train.capture"]
    rg.collect()
    rg.reset()
    for _ in range(3):
        graph(params, opt, batch())
    torch.cuda.synchronize()
    totals = rg.collect()
    counts = {n: t[0] for n, t in totals.items()}
    n_layers = len(cfg.layer_kinds())
    assert counts["train.step"] == counts["train.optimizer"] == 3
    assert counts["train.forward"] == counts["train.backward"] == 6
    assert counts["ssd.backward"] == 6 * n_layers
    for name, (n, ms, own) in totals.items():
        assert ms > 0 and own >= -1e-3 * n, name
    assert totals["ssd.backward"][1] < totals["train.backward"][1] \
        < totals["train.step"][1]
    assert [s.name for s in tr.spans][2:] == ["train.replay"] * 3


def test_each_launch_span_holds_its_graph_launch(cuda):
    """The serve loop's spans on the profiler's timeline: every
    ``serve.launch`` holds exactly one ``cudaGraphLaunch`` (its replay's),
    and every graph launch of the profiled steps lies in a
    ``serve.launch`` or a ``serve.fill``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Request, ServeLoop
    cfg = get_config("tiny-test")
    model = Model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tr, _ = obs.enable()
    loop = ServeLoop(model, params, batch_slots=2, max_seq=64, eos_id=-1,
                     device=cuda)
    rng = np.random.default_rng(0)
    for i in range(6):
        loop.submit(Request(rid=i, prompt=rng.integers(
            2, cfg.vocab_size, 5).astype(np.int32), max_new=6))
    loop.step()                  # captures the decode step
    first = len(tr.spans)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop.run()
        torch.cuda.synchronize()
    start = prof.profiler.kineto_results.trace_start_ns()
    launches = [(start + round(e.time_range.start * 1e3),
                 start + round(e.time_range.end * 1e3))
                for e in prof.events() if e.name == "cudaGraphLaunch"]
    spans = [s for s in tr.spans[first:]
             if s.name in ("serve.launch", "serve.fill")]
    windows = [(s.name, obs.to_profiler_ns(s.t0), obs.to_profiler_ns(s.t1))
               for s in spans]
    assert launches and any(n == "serve.launch" for n, _, _ in windows)
    for name, a, b in windows:
        inside = [1 for s, e in launches if a <= s and e <= b]
        if name == "serve.launch":
            assert len(inside) == 1
    for s, e in launches:
        assert any(a <= s and e <= b for _, a, b in windows)

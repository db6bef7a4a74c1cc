"""The port's ``ServeLoop`` against the JAX ``ServeLoop`` on the same requests,
and its decode step through the static buffers against the step called
directly.

Both loops serve f32 tiny-test (and reduced mamba2-1.3b and
recurrentgemma-9b, whose recurrent states the teacher-forced prompt steps
advance in every slot) with the same weights (carried by
``params_from_jax``), each with its own copy of the same virtual tick clock
and a ``DecodeEnergyMeter`` at the accelerated R740 node point.  They must
emit identical tokens and bill identical Watt*seconds (1e-9): the meters'
arithmetic is copied op for op and the clock takes the same ticks.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_config as jget
from repro.core.power import R740_ARRIA10 as J_R740
from repro.models.model import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeLoop as JServeLoop
from repro.telemetry import DecodeEnergyMeter as JMeter
from repro.telemetry import TickClock
from repro.telemetry import node_envelope as j_node_envelope
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.power import R740_ARRIA10
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeLoop, make_decode_step
from repro_torch.telemetry import DecodeEnergyMeter, node_envelope

WS = dict(rel=1e-9, abs=1e-12)


def _f32(cfg):
    return dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", kv_cache_dtype="float32"))


def _pair(jcfg, cfg):
    jmodel = JModel(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    params = model.load(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jmodel, jp, model, params


@pytest.fixture(scope="module")
def pair():
    return _pair(_f32(jget("tiny-test")), _f32(get_config("tiny-test")))


def _loops(pair, slots=2, max_seq=64):
    jmodel, jp, model, params = pair
    jloop = JServeLoop(jmodel, jp, batch_slots=slots, max_seq=max_seq,
                       meter=JMeter(envelope=j_node_envelope(
                           J_R740, accelerated=True)),
                       clock=TickClock(2e-3))
    loop = ServeLoop(model, params, batch_slots=slots, max_seq=max_seq,
                     meter=DecodeEnergyMeter(envelope=node_envelope(
                         R740_ARRIA10, accelerated=True)),
                     clock=TickClock(2e-3), device="cpu")
    return jloop, loop


def _requests(vocab, n, seed=0, max_new=6):
    """launch/serve.py's recipe: prompt length 4-11 from default_rng."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(2, vocab, size=plen).astype(np.int32)
        out.append((i, prompt, "ab"[i % 2]))
    return ([JRequest(rid=i, prompt=p, max_new=max_new, tenant=t)
             for i, p, t in out],
            [Request(rid=i, prompt=p, max_new=max_new, tenant=t)
             for i, p, t in out])


def _same_bills(jreqs, reqs):
    for jr, r in zip(sorted(jreqs, key=lambda r: r.rid),
                     sorted(reqs, key=lambda r: r.rid)):
        assert r.rid == jr.rid and r.out == jr.out and r.done == jr.done
        assert r.energy_ws == pytest.approx(jr.energy_ws, **WS)
        assert r.prefill_ws == pytest.approx(jr.prefill_ws, **WS)
        assert r.decode_ws == pytest.approx(jr.decode_ws, **WS)
        assert r.queue_wait_s == pytest.approx(jr.queue_wait_s, **WS)


def _same_ledgers(jloop, loop):
    jl, tl = jloop.meter.ledger, loop.meter.ledger
    assert tl.total_ws == pytest.approx(jl.total_ws, **WS)
    assert tl.total_seconds == pytest.approx(jl.total_seconds, **WS)
    assert set(tl.cells) == set(jl.cells)
    for key, cell in jl.cells.items():
        assert tl.cells[key].ws == pytest.approx(cell.ws, **WS)
        assert tl.cells[key].count == cell.count
    for by in ("node", "tenant", "phase"):
        roll = tl.rollup(by)
        assert sum(p.ws for p in roll.values()) == \
            pytest.approx(tl.total_ws, **WS)
    assert loop.meter.trace.integrate() == \
        pytest.approx(jloop.meter.trace.integrate(), **WS)
    assert loop.meter.trace.integrate() == pytest.approx(tl.total_ws, **WS)
    assert loop.utilization.per_phase() == \
        pytest.approx(jloop.utilization.per_phase(), **WS)


def test_serve_twin_tokens_and_bills(pair):
    jloop, loop = _loops(pair)
    jreqs, reqs = _requests(pair[2].cfg.vocab_size, 5)
    for jr, r in zip(jreqs, reqs):
        jloop.submit(jr)
        loop.submit(r)
    jdone, done = jloop.run(), loop.run()
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert all(1 <= len(r.out) <= 6 for r in done)
    _same_bills(jdone, done)
    # idle steps book floor watts to the infra tenant on both sides
    for _ in range(3):
        assert jloop.step() == loop.step() == 0
    _same_ledgers(jloop, loop)
    assert sum(r.energy_ws for r in done) + \
        loop.meter.ledger.rollup("tenant")["fleet"].ws == \
        pytest.approx(loop.meter.ledger.total_ws, **WS)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_serve_twin_recurrent_archs(arch):
    """The offload plan on both sides (the kernels' plain versions here,
    the JAX kernels under jit in decode, which reaches none of them):
    identical tokens and Watt*seconds, 4 slots for 6 requests so slots
    refill while others hold state."""
    plan = dict(attn_impl="pallas", mlp_impl="pallas", ssm_impl="pallas",
                rglru_impl="pallas")
    jcfg, cfg = (dataclasses.replace(c, plan=c.plan.replace(**plan))
                 for c in (_f32(jget(arch, True)),
                           _f32(get_config(arch, True))))
    jloop, loop = _loops(_pair(jcfg, cfg), slots=4)
    jreqs, reqs = _requests(cfg.vocab_size, 6, seed=3)
    for jr, r in zip(jreqs, reqs):
        jloop.submit(jr)
        loop.submit(r)
    jdone, done = jloop.run(), loop.run()
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert all(1 <= len(r.out) <= 6 for r in done)
    _same_bills(jdone, done)
    _same_ledgers(jloop, loop)


def test_drained_requests_resume_on_another_loop(pair):
    jloop, loop = _loops(pair)
    jreqs, reqs = _requests(pair[2].cfg.vocab_size, 3, seed=1, max_new=8)
    for jr, r in zip(jreqs, reqs):
        jloop.submit(jr)
        loop.submit(r)
    for _ in range(3):
        jloop.step()
        loop.step()
    jloop.park()
    loop.park()
    jmoved, moved = jloop.drain(), loop.drain()
    assert [r.rid for r in moved] == [r.rid for r in jmoved]
    assert [r.out for r in moved] == [r.out for r in jmoved]
    assert loop.has_work is False and not loop.queue
    jdest, dest = _loops(pair)
    for jr, r in zip(jmoved, moved):
        jdest.submit(jr)
        dest.submit(r)
    _same_bills(jdest.run(), dest.run())
    _same_ledgers(jdest, dest)


def test_spans_and_metrics_match_when_tracing(pair):
    try:
        jtr, jmx = jobs.enable(clock=TickClock(1.0))
        tr, mx = obs.enable(clock=TickClock(1.0))
        jloop, loop = _loops(pair)
        jreqs, reqs = _requests(pair[2].cfg.vocab_size, 3, seed=2)
        for jr, r in zip(jreqs, reqs):
            jloop.submit(jr)
            loop.submit(r)
        jloop.run()
        loop.run()
        jloop.step()
        loop.step()
        loop._close_idle()
        jloop._close_idle()

        def rows(spans):
            return [(s.name, s.node, s.t0, s.t1, s.span_id, s.parent_id,
                     s.tags) for s in spans]
        assert len(tr.spans) > 10
        assert rows(tr.spans) == pytest.approx(rows(jtr.spans))
        for name in ("queue_wait_s", "decode_ws_per_token"):
            h, jh = mx.histogram(name), jmx.histogram(name)
            assert (h.counts, h.count) == (jh.counts, jh.count)
            assert h.sum == pytest.approx(jh.sum, **WS)
    finally:
        jobs.disable()
        obs.disable()


def test_loop_device_must_be_the_models(pair, monkeypatch):
    _, _, model, params = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="model's"):
        ServeLoop(model, params, batch_slots=1, max_seq=8, device="cuda")


# ---------------------------------------------------------------------------
# the decode step through the loop's static buffers (what a CUDA graph
# captures on the card) against the step called directly
# ---------------------------------------------------------------------------

#: one tiny config per kind of cache, under the offload plan the card
#: serves (its kernels' plain versions here): (arch, reduced, plan fields)
CACHE_KINDS = {
    "bf16_attention": ("tiny-test", False, {}),
    "int8_attention": ("tiny-test", False, {"kv_cache_dtype": "int8"}),
    "ssm": ("mamba2-1.3b", True, {}),
    "rglru": ("recurrentgemma-9b", True, {}),
    "moe": ("granite-moe-1b-a400m", True, {}),
}
OFFLOAD = dict(attn_impl="pallas", mlp_impl="pallas", ssm_impl="pallas",
               rglru_impl="pallas")


def _kind_model(kind):
    arch, reduced, fields = CACHE_KINDS[kind]
    cfg = get_config(arch, reduced)
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(**OFFLOAD,
                                                         **fields))
    model = Model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _clone(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


def _direct_step(model, params, toks, pos, cache):
    """The step as the loop called it before its static buffers: a fresh
    token tensor and an int position."""
    return make_decode_step(model)(
        params, {"tokens": torch.from_numpy(toks.copy()), "pos": int(pos)},
        cache)[0]


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_static_buffer_step_equals_the_direct_step(kind):
    """``ServeLoop.decode`` feeds the step a 0-d ``pos`` tensor and the
    static token buffer: the same logits and cache, bit for bit, as the
    step called directly with an int position on a copy of the cache."""
    model, params = _kind_model(kind)
    loop = ServeLoop(model, params, batch_slots=2, max_seq=16, device="cpu")
    assert loop._pos_buf.dim() == 0
    ref = _clone(loop.cache)
    rng = np.random.default_rng(1)
    for pos in range(6):
        toks = rng.integers(2, model.cfg.vocab_size, (2, 1)).astype(np.int32)
        got = loop.decode(toks, pos)
        assert torch.equal(got, _direct_step(model, params, toks, pos, ref))
        for c, r in zip(loop.cache, ref):
            assert c.keys() == r.keys()
            for k in c:
                assert torch.equal(c[k], r[k]), (pos, k)


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_decode_step_writes_the_cache_in_place(kind):
    """Every cache tensor keeps its storage across steps, as a captured
    graph, which reads and writes fixed addresses, requires."""
    model, params = _kind_model(kind)
    loop = ServeLoop(model, params, batch_slots=2, max_seq=16, device="cpu")
    cache = loop.cache
    ptrs = [{k: v.data_ptr() for k, v in c.items()} for c in cache]
    bufs = (loop._tok_buf.data_ptr(), loop._pos_buf.data_ptr())
    before = _clone(cache)
    for pos in range(3):
        loop.decode(np.full((2, 1), 3 + pos, np.int32), pos)
    assert loop.cache is cache
    assert [{k: v.data_ptr() for k, v in c.items()} for c in cache] == ptrs
    assert (loop._tok_buf.data_ptr(), loop._pos_buf.data_ptr()) == bufs
    assert any(not torch.equal(c[k], b[k])
               for c, b in zip(cache, before) for k in c)


class _DirectLoop(ServeLoop):
    """The loop with its decode step called directly, as before the step
    took static buffers."""

    def decode(self, toks, pos):
        return _direct_step(self.model, self.params, toks, pos, self.cache)


@pytest.mark.parametrize("kind", CACHE_KINDS)
def test_loop_serves_what_the_direct_step_served(kind):
    """A whole run, slots refilled while others hold state: the same
    tokens, finishing order and steps as the loop whose step is called
    directly."""
    model, params = _kind_model(kind)
    loops = [cls(model, params, batch_slots=2, max_seq=32, device="cpu")
             for cls in (ServeLoop, _DirectLoop)]
    for loop in loops:
        for r in _requests(model.cfg.vocab_size, 4, seed=4)[1]:
            loop.submit(r)
    done = [loop.run() for loop in loops]
    assert [(r.rid, r.out) for r in done[0]] == \
        [(r.rid, r.out) for r in done[1]]
    assert all(len(r.out) >= 1 for r in done[0]) and len(done[0]) == 4
    assert loops[0].steps_done == loops[1].steps_done

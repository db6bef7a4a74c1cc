"""The port's ``ServeLoop`` against the JAX ``ServeLoop`` on the same requests.

Both loops serve f32 tiny-test with the same weights (carried by
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
from repro_torch.serve.engine import Request, ServeLoop
from repro_torch.telemetry import DecodeEnergyMeter, node_envelope

WS = dict(rel=1e-9, abs=1e-12)


def _f32(cfg):
    return dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", kv_cache_dtype="float32"))


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = _f32(jget("tiny-test")), _f32(get_config("tiny-test"))
    jmodel = JModel(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    params = model.load(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jmodel, jp, model, params


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

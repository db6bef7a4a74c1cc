"""The port's Step-7 loop against the JAX package's governor.

Mirrors ``tests/test_governor.py`` and the ``test_reconfigurator_*``
tests of ``tests/test_adapt.py`` on the port's ``EnergyLedger``,
``Reconfigurator`` and ``PowerGovernor``, and holds the port's governor
equal to the reference's: both packages' reconfigurators get the same
verifier factory (the analytic rung, ``n_chips=256``, one ``HardwareSpec``
built from the same figures in each), see the same flush windows, and
must emit equal ``GovernorEvent``s — ``new_plan`` included, compared on
the plan fields the port has (the reference's plans also carry sharding
and training knobs the port does not).  The re-searches run at decode
shapes: the port's analytic rung refuses training shapes.  A governor
re-verifying on the measured rung runs it on the CPU here
(``MeasuredBackend(device="cpu")`` with a fixed wattage).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import power as j_power
from repro.core.adapt import ReconfigPolicy as JReconfigPolicy
from repro.core.adapt import Reconfigurator as JReconfigurator
from repro.core.ga import GAConfig as JGAConfig
from repro.core.verifier import Verifier as JVerifier
from repro.models.model import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeLoop as JServeLoop
from repro.telemetry import DecodeEnergyMeter as JMeter
from repro.telemetry import EnergyLedger as JEnergyLedger
from repro.telemetry import GovernorPolicy as JGovernorPolicy
from repro.telemetry import PowerGovernor as JPowerGovernor
from repro.telemetry import ReplaySource as JReplaySource
from repro.telemetry import envelope_for as j_envelope_for
from repro_torch.configs import CARD_SHAPES, ShapeSpec, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import backends, power
from repro_torch.core.adapt import ReconfigPolicy, Reconfigurator, adapt
from repro_torch.core.destinations import Requirement
from repro_torch.core.ga import GAConfig
from repro_torch.core.verifier import Verifier
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeLoop
from repro_torch.telemetry import (ConstantSource, DecodeEnergyMeter,
                                   EnergyLedger, GovernorPolicy,
                                   PowerGovernor, ReplaySource, TickClock,
                                   envelope_for)

TICK = 0.005
WS = dict(rel=1e-9, abs=1e-12)
#: one chip spec, built in both packages from the same numbers
SPEC = dict(name="test_chip", peak_flops=500e12, hbm_bw=2.0e12,
            hbm_bytes=64e9, ici_bw=100e9, e_flop=1.1e-12, e_hbm=1.3e-10,
            e_ici=2e-11, p_static=90.0)
SHAPE = "decode_32k"


def _env():
    return envelope_for(power.H100)


def _recon(cfg, node="node0", shape=SHAPE, **policy_kw):
    kw = dict(degrade_factor=1.5, window=8, cooldown_steps=10_000)
    kw.update(policy_kw)
    return Reconfigurator(cfg, shape, policy=ReconfigPolicy(**kw),
                          ga=GAConfig(population=4, generations=1),
                          node=node)


def _fields(describe: str) -> dict:
    return dict(kv.split("=", 1) for kv in describe.split(","))


#: the reference's plan fields the port leaves out
REF_ONLY_FIELDS = ("moe_impl", "scan_layers")


def _same_plan(port_describe: str, ref_describe: str) -> None:
    """Every field the two plans share is equal, and the port's plan has
    every field of the reference's but the two it leaves out."""
    mine, ref = _fields(port_describe), _fields(ref_describe)
    assert mine == {k: v for k, v in ref.items()
                    if k not in REF_ONLY_FIELDS}


# ---------------------------------------------------------------------------
# Ledger rollups / merge / persistence / drift
# ---------------------------------------------------------------------------

def test_rollups_all_sum_to_total():
    led = EnergyLedger()
    led.add("prefill", 10.0, 0.1, node="n0", tenant="a")
    led.add("decode", 30.0, 0.3, node="n0", tenant="b")
    led.add("decode", 20.0, 0.2, node="n1", tenant="a")
    for by in ("node", "tenant", "phase"):
        roll = led.rollup(by)
        assert sum(pe.ws for pe in roll.values()) == \
            pytest.approx(led.total_ws)
        assert sum(pe.seconds for pe in roll.values()) == \
            pytest.approx(led.total_seconds)
    assert led.rollup("node")["n0"].ws == pytest.approx(40.0)
    assert led.rollup("tenant")["a"].ws == pytest.approx(30.0)
    assert led.tenants() == ["a", "b"]
    with pytest.raises(ValueError):
        led.rollup("chip")


def test_ledger_merge_is_fleet_rollup():
    a, b = EnergyLedger(), EnergyLedger()
    a.add("decode", 10.0, 0.1, node="pod0", tenant="t0", peak_w=120.0)
    b.add("decode", 20.0, 0.2, node="pod1", tenant="t0", peak_w=150.0)
    b.add("prefill", 5.0, 0.05, node="pod1", tenant="t1")
    fleet = EnergyLedger()
    fleet.merge(a)
    fleet.merge(b)
    assert fleet.total_ws == pytest.approx(35.0)
    assert fleet.nodes == pytest.approx({"pod0": 10.0, "pod1": 25.0})
    assert fleet.rollup("tenant")["t0"].ws == pytest.approx(30.0)
    assert fleet.phases["decode"].peak_w == pytest.approx(150.0)
    assert set(fleet.cells) == set(a.cells) | set(b.cells)
    assert fleet.summary().startswith("total=35.0Ws [")


def test_ledger_json_reads_in_both_packages(tmp_path):
    """A ledger written by either package reads in the other, cell for
    cell (the persisted format is the reference's)."""
    led = EnergyLedger(window=4)
    led.add("decode", 12.5, 0.25, peak_w=180.0, node="n0", tenant="teamA")
    led.add("prefill", 2.5, 0.05, node="n1", tenant="teamB", count=3)
    jled = JEnergyLedger(window=4)
    jled.add("decode", 12.5, 0.25, peak_w=180.0, node="n0", tenant="teamA")
    jled.add("prefill", 2.5, 0.05, node="n1", tenant="teamB", count=3)
    p = led.to_json(tmp_path / "port.json")
    jp = jled.to_json(tmp_path / "ref.json")
    assert p.read_text() == jp.read_text()
    for back in (JEnergyLedger.from_json(p), EnergyLedger.from_json(jp),
                 EnergyLedger.from_json(p)):
        assert back.window == 4
        assert back.total_ws == pytest.approx(led.total_ws, rel=1e-15)
        assert set(back.cells) == set(led.cells)
        for key, cell in led.cells.items():
            got = back.cells[key]
            assert (got.ws, got.seconds, got.count, got.peak_w) == \
                (cell.ws, cell.seconds, cell.count, cell.peak_w)
        assert back.nodes == led.nodes
        assert set(back.tenants()) == {"teamA", "teamB"}


def test_ledger_absorbs_leaf_spans_of_a_trace():
    from repro_torch.telemetry import synthesize_phase_trace
    trace = synthesize_phase_trace([("compute", 1.0, 50.0),
                                    ("collective", 0.5, 5.0)],
                                   static_watts=100.0)
    led = EnergyLedger()
    led.absorb(trace, scale=2.0, node="pod", tenant="t")
    assert set(led.phases) <= {"compute", "collective"}
    assert led.total_ws == pytest.approx(2.0 * trace.integrate(), rel=1e-9)


def test_step_drift_window():
    led = EnergyLedger(window=3)
    assert led.drift_ratio(5.0) is None
    for ws in (1.0, 2.0, 3.0, 4.0):
        led.record_step(0.1, ws)
    assert [w for _, w in led.steps] == [2.0, 3.0, 4.0]
    assert led.median_step_ws() == 3.0
    assert led.median_step_seconds() == pytest.approx(0.1)
    assert led.drift_ratio(6.0) == pytest.approx(2.0)
    led.reset_steps()
    assert led.median_step_ws() is None


# ---------------------------------------------------------------------------
# Meter: tenant splitting + source override + the routing prediction
# ---------------------------------------------------------------------------

def test_meter_tenant_split_conserves_energy():
    meter = DecodeEnergyMeter(envelope=_env(), node="n0")
    ws = meter.observe(0.1, util=1.0, phase="decode",
                       tenants=["a", "a", "b"])
    assert ws == pytest.approx(meter.ledger.total_ws)
    roll = meter.ledger.rollup("tenant")
    assert roll["a"].ws == pytest.approx(2.0 * ws / 3.0)
    assert roll["b"].ws == pytest.approx(ws / 3.0)
    assert meter.ledger.phases["decode"].count == 1
    assert meter.ledger.cells[("n0", "b", "decode")].count == 1


def test_meter_source_overrides_envelope_and_prediction():
    src = ReplaySource([(0.0, 100.0), (1.0, 400.0)])
    meter = DecodeEnergyMeter(envelope=_env(), source=src)
    assert meter.observe(0.5) == pytest.approx(50.0)
    assert meter.observe(1.0) == pytest.approx(400.0)
    assert meter.trace.energy_ws() == pytest.approx(meter.ledger.total_ws)
    assert meter.predict_watts(0.0) == pytest.approx(400.0)
    plain = DecodeEnergyMeter(envelope=_env())
    assert plain.predict_watts(0.5) == pytest.approx(_env().watts(0.5))
    assert plain.predict_watts(7.0) == pytest.approx(_env().watts(1.0))


# ---------------------------------------------------------------------------
# Reconfigurator (mirrors the test_reconfigurator_* tests of test_adapt.py)
# ---------------------------------------------------------------------------

def _r(cfg, **kw):
    pol = dict(degrade_factor=1.5, window=4, cooldown_steps=0)
    pol.update(kw.pop("policy", {}))
    return Reconfigurator(cfg, SHAPE, policy=ReconfigPolicy(**pol),
                          ga=GAConfig(population=4, generations=1), **kw)


def test_reconfigurator_triggers_on_degradation():
    cfg = get_config("qwen2-7b")
    r = _r(cfg)
    for i in range(4):
        assert r.observe(i, 1.0, cfg.plan) is None
    new = r.observe(5, 3.0, cfg.plan)
    assert new is not None and r.events[0]["step"] == 5
    assert r.events[0]["new_plan"] == new.describe()


def test_reconfigurator_cooldown():
    cfg = get_config("qwen2-7b")
    r = _r(cfg, policy=dict(degrade_factor=1.2, window=2,
                            cooldown_steps=1000))
    for i in range(2):
        r.observe(i, 1.0, cfg.plan)
    assert r.observe(3, 5.0, cfg.plan) is not None
    r.observe(4, 1.0, cfg.plan)
    r.observe(5, 1.0, cfg.plan)
    assert r.observe(6, 5.0, cfg.plan) is None


def test_reconfigurator_first_step_never_triggers():
    cfg = get_config("qwen2-7b")
    r = _r(cfg, policy=dict(degrade_factor=1.1))
    assert r.observe(0, 1e6, cfg.plan, energy_ws=1e9) is None
    assert not r.events and r.ledger.steps == [(1e6, 1e9)]


def test_reconfigurator_drift_exactly_at_factor_holds():
    cfg = get_config("qwen2-7b")
    r, r2 = _r(cfg), _r(cfg)
    for i in range(4):
        r.observe(i, 1.0, cfg.plan, energy_ws=200.0)
        r2.observe(i, 1.0, cfg.plan, energy_ws=200.0)
    assert r.observe(5, 1.0, cfg.plan, energy_ws=300.0) is None
    assert r2.observe(5, 1.0, cfg.plan, energy_ws=300.1) is not None


def test_reconfigurator_cooldown_expires():
    cfg = get_config("qwen2-7b")
    r = _r(cfg, policy=dict(degrade_factor=1.2, window=2, cooldown_steps=10))
    for i in range(2):
        r.observe(i, 1.0, cfg.plan, energy_ws=100.0)
    assert r.observe(3, 1.0, cfg.plan, energy_ws=500.0) is not None
    for i in range(4, 6):
        r.observe(i, 1.0, cfg.plan, energy_ws=100.0)
    assert r.observe(7, 1.0, cfg.plan, energy_ws=500.0) is None
    for i in range(8, 12):
        r.observe(i, 1.0, cfg.plan, energy_ws=100.0)
    assert r.observe(14, 1.0, cfg.plan, energy_ws=500.0) is not None
    assert len(r.events) == 2


def test_reconfigurator_unmetered_fallback_uses_nominal_watts():
    cfg = get_config("qwen2-7b")
    r = _r(cfg, nominal_watts=200.0)
    for i in range(4):
        assert r.observe(i, 1.0, cfg.plan) is None
    assert r.ledger.steps == [(1.0, 200.0)] * 4
    assert r.observe(5, 3.0, cfg.plan) is not None
    assert r.events[0]["energy_ws"] == pytest.approx(600.0)
    assert r.events[0]["drift_ratio"] == pytest.approx(3.0)
    # the default fallback is the H100 envelope's active point
    assert _r(cfg).nominal_watts == envelope_for(power.H100).p_active


def test_reconfigurator_for_node_is_independent():
    cfg = get_config("qwen2-7b")
    r = _r(cfg)
    other = r.for_node("pod7")
    assert other.node == "pod7" and other.policy is r.policy
    assert other.ledger is not r.ledger and other.events is not r.events
    for i in range(4):
        r.observe(i, 1.0, cfg.plan, energy_ws=100.0)
    assert other.ledger.steps == []
    assert other.observe(5, 1.0, cfg.plan, energy_ws=500.0) is None


def test_reconfigurator_verifies_on_one_card_and_card_shapes():
    cfg = get_config("qwen2-7b")
    v = Reconfigurator(cfg, "decode_32k_b8").make_verifier()
    assert (v.n_chips, v.mode, v.shape_name) == (1, "analytic",
                                                 "decode_32k_b8")
    assert v.power.hw is power.H100
    r = _r(cfg)
    r.shape_name = "decode_32k_b8"
    for i in range(4):
        r.observe(i, 1.0, cfg.plan, energy_ws=100.0)
    assert r.observe(5, 1.0, cfg.plan, energy_ws=500.0) is not None


def test_adapt_hands_back_a_reconfigurator_on_its_ladder(monkeypatch):
    monkeypatch.setitem(CARD_SHAPES, "cpu_decode",
                        ShapeSpec("cpu_decode", 48, 2, "decode"))
    cfg = get_config("tiny-lm")
    rung = backends.MeasuredBackend(device="cpu",
                                    source=ConstantSource(250.0),
                                    window_s=0.05, decode_steps=4)
    rep = adapt(cfg, "cpu_decode", requirement=Requirement(max_seconds=1e-9),
                ga=GAConfig(population=4, generations=1),
                backends={"measured": rung})
    recon = rep.reconfigurator
    assert isinstance(recon, Reconfigurator)
    assert (recon.cfg, recon.shape_name) == (cfg, "cpu_decode")
    v = recon.make_verifier()
    assert v.mode == "analytic" and v.rungs.finalist == "analytic"
    assert v.backend("measured") is rung       # the same loaded backend


# ---------------------------------------------------------------------------
# Governor mechanics (mirrors tests/test_governor.py)
# ---------------------------------------------------------------------------

def test_governor_policy_validates():
    with pytest.raises(ValueError):
        GovernorPolicy(flush_every=0)
    with pytest.raises(ValueError):
        GovernorPolicy(checkpoint_every=0)


def test_governor_defers_migration_to_checkpoint():
    cfg = get_config("tiny-test")
    gov = PowerGovernor(_recon(cfg), plan=cfg.plan,
                        policy=GovernorPolicy(flush_every=1,
                                              checkpoint_every=100))
    meter = DecodeEnergyMeter(envelope=_env(), node="n0")
    for step in range(1, 5):
        meter.observe(0.01, util=1.0)
        gov.flush(meter, step, node="n0")
    assert gov.pending is None
    meter.observe(0.05, util=1.0)
    gov.flush(meter, 5, node="n0")
    assert gov.pending is not None and not gov.events
    old = gov.plan
    new = gov.checkpoint(100)
    assert new is not None and gov.plan is new
    (ev,) = gov.events
    assert (ev.step, ev.detected_step, ev.node) == (100, 5, "n0")
    assert ev.drift_ratio > 1.5 and ev.old_plan == old.describe()
    assert gov.pending is None and gov.checkpoint(200) is None
    assert gov.summary()["events"] == [ev.to_dict()]


def test_governor_keeps_per_node_monitors():
    cfg = get_config("tiny-test")
    recon = _recon(cfg, node="podA")
    gov = PowerGovernor(recon, plan=cfg.plan)
    ma = DecodeEnergyMeter(envelope=_env(), node="podA")
    mb = DecodeEnergyMeter(envelope=_env(), node="podB")
    assert gov.monitor("podA") is recon
    assert gov.monitor("podB") is not recon
    assert gov.monitor("podB").node == "podB"
    assert not gov.monitor("podA").derive_requirement
    assert not gov.monitor("podB").derive_requirement
    for step in range(1, 5):
        ma.observe(0.01)
        mb.observe(0.01)
        gov.flush(ma, step, node="podA")
        gov.flush(mb, step, node="podB")
    mb.observe(0.05)
    ma.observe(0.01)
    gov.flush(ma, 5, node="podA")
    gov.flush(mb, 5, node="podB")
    assert gov.pending is not None and gov.pending.node == "podB"
    assert gov.ledger.nodes["podA"] == pytest.approx(ma.ledger.total_ws)
    assert gov.ledger.nodes["podB"] == pytest.approx(mb.ledger.total_ws)


def test_checkpoint_applies_every_pending_node():
    cfg = get_config("tiny-test")
    gov = PowerGovernor(_recon(cfg), plan=cfg.plan)
    ma = DecodeEnergyMeter(envelope=_env(), node="podA")
    mb = DecodeEnergyMeter(envelope=_env(), node="podB")
    for step in range(1, 5):
        ma.observe(0.01)
        mb.observe(0.01)
        gov.flush(ma, step, node="podA")
        gov.flush(mb, step, node="podB")
    ma.observe(0.05)
    mb.observe(0.06)
    gov.flush(ma, 5, node="podA")
    gov.flush(mb, 5, node="podB")
    assert gov.checkpoint(8) is not None
    assert sorted(e.node for e in gov.events) == ["podA", "podB"]
    assert gov.pending is None


def test_drain_flush_books_energy_without_governing():
    cfg = get_config("tiny-test")
    gov = PowerGovernor(_recon(cfg), plan=cfg.plan)
    meter = DecodeEnergyMeter(envelope=_env(), node="n0")
    meter.observe(0.05)
    gov.flush(meter, 1, node="n0", govern=False)
    assert gov.ledger.total_ws == pytest.approx(meter.ledger.total_ws)
    assert gov.monitor("n0").ledger.steps == []
    assert gov.pending is None


def test_governor_flush_is_incremental():
    cfg = get_config("tiny-test")
    gov = PowerGovernor(_recon(cfg), plan=cfg.plan)
    meter = DecodeEnergyMeter(envelope=_env(), node="n0")
    meter.observe(0.01)
    gov.flush(meter, 1, node="n0")
    total = gov.ledger.total_ws
    gov.flush(meter, 2, node="n0")
    gov.flush(meter, 3, node="n0")
    assert gov.ledger.total_ws == pytest.approx(total)
    assert len(gov.monitor("n0").ledger.steps) == 1


# ---------------------------------------------------------------------------
# Re-verification on a higher rung
# ---------------------------------------------------------------------------

class _StubMeasuredRung:
    """Measured-rung stand-in on the CPU with a scripted verdict."""

    name = "measured"
    device = "cpu"

    def __init__(self, veto_new: bool):
        self.veto_new = veto_new
        self.measured: list = []

    def measure(self, ctx, plan):
        self.measured.append(plan.describe())
        if self.veto_new and len(self.measured) == 1:
            return backends.penalty_measurement("stub: trial failed",
                                                ctx.power)
        return backends.Measurement(seconds=1.0, watts=100.0,
                                    energy_j=100.0, source="measured")


def _governed(rung, shape=SHAPE, verify_rung="measured"):
    cfg = get_config("tiny-test")
    recon = _recon(cfg, shape=shape)
    recon.verifier_factory = lambda: Verifier(
        cfg, shape, backends={"measured": rung})
    gov = PowerGovernor(recon, plan=cfg.plan,
                        policy=GovernorPolicy(flush_every=1,
                                              checkpoint_every=100),
                        verify_rung=verify_rung)
    meter = DecodeEnergyMeter(envelope=_env(), node="n0")
    for step in range(1, 5):
        meter.observe(0.01, util=1.0)
        gov.flush(meter, step, node="n0")
    meter.observe(0.05, util=1.0)
    gov.flush(meter, 5, node="n0")
    assert gov.pending is not None
    return gov


def test_governor_rejects_migration_when_measured_rung_disagrees():
    stub = _StubMeasuredRung(veto_new=True)
    gov = _governed(stub)
    old_plan = gov.plan
    assert gov.checkpoint(100) is None
    assert gov.plan is old_plan and gov.pending is None
    assert len(stub.measured) == 2
    (ev,) = gov.events
    assert ev.applied is False and ev.verify_rung == "measured"
    assert "penalized" in ev.reject_reason
    assert (ev.step, ev.node) == (100, "n0")


def test_governor_applies_migration_when_measured_rung_confirms():
    stub = _StubMeasuredRung(veto_new=False)
    gov = _governed(stub)
    new = gov.checkpoint(100)
    assert new is not None and gov.plan is new
    assert len(stub.measured) == 2
    (ev,) = gov.events
    assert ev.applied is True and ev.verify_rung == "measured"
    assert ev.reject_reason == ""


def test_governor_reverifies_with_real_trials_on_the_cpu(monkeypatch):
    """The real measured rung (a model, its weights, a fixed wattage):
    both plans run their decode trial and the event says why it was
    applied or rejected."""
    monkeypatch.setitem(CARD_SHAPES, "cpu_decode",
                        ShapeSpec("cpu_decode", 48, 2, "decode"))
    rung = backends.MeasuredBackend(device="cpu",
                                    source=ConstantSource(250.0),
                                    window_s=0.05, decode_steps=4)
    cfg = get_config("tiny-test")
    gov = _governed(rung, shape="cpu_decode")
    gov.plan = cfg.plan.replace(mlp_impl="pallas")   # the kernel plan serves
    gov.checkpoint(100)
    (ev,) = gov.events
    assert ev.verify_rung == "measured"
    assert ev.new_plan != ev.old_plan
    assert len(rung.outputs) == 2                    # two real trials
    m_new, m_old = (gov._verifier.cache[k] for k in gov._verifier.cache)
    assert m_new.ok and m_old.ok
    assert ev.applied == backends.confirms_preference(m_new, m_old)


def test_measured_governor_needs_a_card_unless_told(monkeypatch):
    cfg = get_config("tiny-test")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PowerGovernor(_recon(cfg), plan=cfg.plan, verify_rung="measured")
    with pytest.raises(ValueError, match="unknown verify rung"):
        PowerGovernor(_recon(cfg), plan=cfg.plan, verify_rung="hlo")
    # the compiled rung (the pod dry run) runs on the host: no card
    PowerGovernor(_recon(cfg), plan=cfg.plan, verify_rung="compiled")
    recon = _recon(cfg)
    recon.verifier_factory = lambda: Verifier(
        cfg, SHAPE, backends={"measured": backends.MeasuredBackend(
            device="cpu", source=ConstantSource(1.0))})
    gov = PowerGovernor(recon, plan=cfg.plan, verify_rung="measured")
    assert gov._verifier.backend("measured").device == "cpu"
    # the replay rung reads recordings: no device to resolve
    PowerGovernor(_recon(cfg), plan=cfg.plan, verify_rung="replay")


# ---------------------------------------------------------------------------
# Twins: the same windows through both packages' governors
# ---------------------------------------------------------------------------

def _twin_recons(arch, shape, node="n0"):
    cfg = get_config(arch)
    jcfg = jget(arch)
    pol = dict(degrade_factor=1.5, window=8, cooldown_steps=10_000)
    r = Reconfigurator(
        cfg, shape, policy=ReconfigPolicy(**pol),
        ga=GAConfig(population=4, generations=1), node=node,
        verifier_factory=lambda: Verifier(
            cfg, shape, n_chips=256, mode="analytic",
            power=power.PowerModel(power.HardwareSpec(**SPEC))))
    jr = JReconfigurator(
        jcfg, shape, policy=JReconfigPolicy(**pol),
        ga=JGAConfig(population=4, generations=1), node=node,
        verifier_factory=lambda: JVerifier(
            jcfg, shape, n_chips=256, tp=1, mode="analytic",
            power=j_power.PowerModel(j_power.HardwareSpec(**SPEC))))
    return cfg, jcfg, r, jr


def _same_events(events, jevents):
    assert len(events) == len(jevents) > 0
    for ev, jev in zip(events, jevents):
        d, jd = ev.to_dict(), jev.to_dict()
        _same_plan(d.pop("new_plan"), jd.pop("new_plan"))
        _same_plan(d.pop("old_plan"), jd.pop("old_plan"))
        assert d == pytest.approx(jd, **WS)


@pytest.mark.parametrize("arch", ["tiny-test", "qwen2-7b"])
def test_governor_twin_events(arch):
    cfg, jcfg, r, jr = _twin_recons(arch, SHAPE)
    pol = dict(flush_every=1, checkpoint_every=100)
    gov = PowerGovernor(r, plan=cfg.plan, policy=GovernorPolicy(**pol))
    jgov = JPowerGovernor(jr, plan=jcfg.plan, policy=JGovernorPolicy(**pol))
    env = envelope_for(power.HardwareSpec(**SPEC))
    jenv = j_envelope_for(j_power.HardwareSpec(**SPEC))
    for g, m in ((gov, DecodeEnergyMeter(envelope=env, node="n0")),
                 (jgov, JMeter(envelope=jenv, node="n0"))):
        for step, dt in enumerate((0.01, 0.01, 0.012, 0.01, 0.05, 0.01), 1):
            m.observe(dt, util=1.0, tenants=["a", "b"])
            g.flush(m, step, node="n0")
        g.checkpoint(100)
    _same_events(gov.events, jgov.events)
    assert r.events[0]["stage"] == jr.events[0]["stage"]
    cells, jcells = gov.ledger.cells, jgov.ledger.cells
    assert set(cells) == set(jcells)
    for key, cell in jcells.items():
        assert cells[key].ws == pytest.approx(cell.ws, **WS)


def _f32(cfg):
    return dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", kv_cache_dtype="float32"))


def test_governed_serving_twin_end_to_end():
    """Tiny-test serving with an injected drift tail through both
    packages: identical tokens, bills, fleet ledgers, one checkpointed
    migration each, and equal events under the shared spec."""
    jcfg, cfg = _f32(jget("tiny-test")), _f32(get_config("tiny-test"))
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = Model(cfg, device="cpu")
    params = model.load(params_from_jax(cfg,
                                        jax.tree.map(np.asarray, jparams)))
    _, _, r, jr = _twin_recons("tiny-test", SHAPE)
    r.cfg, jr.cfg = cfg, jcfg
    drift = [(0.0, 150.0), (0.06, 450.0)]
    pol = dict(flush_every=2, checkpoint_every=4)
    gov = PowerGovernor(r, plan=cfg.plan, policy=GovernorPolicy(**pol))
    jgov = JPowerGovernor(jr, plan=jcfg.plan, policy=JGovernorPolicy(**pol))
    loop = ServeLoop(model, params, batch_slots=4, max_seq=64, eos_id=-1,
                     meter=DecodeEnergyMeter(
                         envelope=envelope_for(power.HardwareSpec(**SPEC)),
                         source=ReplaySource(drift)),
                     governor=gov, node="n0", clock=TickClock(TICK),
                     device="cpu")
    jloop = JServeLoop(jmodel, jparams, batch_slots=4, max_seq=64, eos_id=-1,
                       meter=JMeter(envelope=j_envelope_for(
                           j_power.HardwareSpec(**SPEC)),
                           source=JReplaySource(drift)),
                       governor=jgov, node="n0", clock=TickClock(TICK))
    rng = np.random.default_rng(0)
    reqs, jreqs = [], []
    for i in range(4):
        prompt = rng.integers(2, cfg.vocab_size, size=4).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=12,
                            tenant=f"tenant{i % 2}"))
        jreqs.append(JRequest(rid=i, prompt=prompt, max_new=12,
                              tenant=f"tenant{i % 2}"))
        loop.submit(reqs[-1])
        jloop.submit(jreqs[-1])
    done, jdone = loop.run(), jloop.run()
    assert [r.out for r in done] == [r.out for r in jdone]
    assert loop.steps_done == jloop.steps_done == 12
    for req, jreq in zip(reqs, jreqs):
        assert req.energy_ws == pytest.approx(jreq.energy_ws, **WS)
        assert req.energy_ws == pytest.approx(req.prefill_ws + req.decode_ws)
    assert sum(req.energy_ws for req in reqs) == \
        pytest.approx(loop.meter.ledger.total_ws, rel=1e-9)
    assert gov.ledger.total_ws == pytest.approx(loop.meter.ledger.total_ws,
                                                rel=1e-9)
    by_tenant = gov.ledger.rollup("tenant")
    assert set(by_tenant) == {"tenant0", "tenant1"}
    for t in ("tenant0", "tenant1"):
        want = sum(req.energy_ws for req in reqs if req.tenant == t)
        assert by_tenant[t].ws == pytest.approx(want, rel=1e-9)
    assert set(gov.ledger.cells) == set(jgov.ledger.cells)
    for key, cell in jgov.ledger.cells.items():
        assert gov.ledger.cells[key].ws == pytest.approx(cell.ws, **WS)
    (ev,) = gov.events
    assert ev.step % gov.policy.checkpoint_every == 0
    assert ev.detected_step <= ev.step and ev.drift_ratio > 1.5
    assert loop.plan_migrations == [(ev.step, gov.plan)]
    assert [s for s, _ in loop.plan_migrations] == \
        [s for s, _ in jloop.plan_migrations]
    assert gov.plan.describe() == ev.new_plan
    _same_events(gov.events, jgov.events)

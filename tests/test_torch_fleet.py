"""The port's object fleet against the JAX package's ``repro.fleet``.

Mirrors ``tests/test_fleet.py``, ``tests/test_fleet_power.py`` and
``tests/test_fleet_power_invariants.py`` on the port's classes, and holds
the port's fleet equal to the reference's on the same arrival scripts two
ways: with stub serving loops (``SimLoop`` below, the port's counterpart of
``tests/fleet_sim.py``, which imports ``repro``) and with real tiny-test
models whose weights ``convert.params_from_jax`` carries across.  Held
equal: the fleet ledger cell by cell (rel 1e-9), the node each request was
routed to, the tokens, the ``FleetEvent``s and ``PlacementEvent``s, and
the admission rejections.  Both packages meter at one envelope, built from
the same figures in each (the port keeps no TPU constant), on a virtual
``TickClock``; models run in f32 on the CPU.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from fleet_sim import sim_envelope_node as j_sim_envelope_node
from fleet_sim import sim_node as j_sim_node
from repro import fleet as jfleet
from repro.configs import get_config as jget
from repro.core import power as j_power
from repro.models.model import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.telemetry import ConstantSource as JConstantSource
from repro.telemetry import ReplaySource as JReplaySource
from repro.telemetry import WsBudget as JWsBudget
from repro.telemetry import envelope_for as j_envelope_for
from repro_torch import fleet as pfleet
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import power
from repro_torch.fleet import (AdmissionController, ArrivalForecaster,
                               FleetPolicy, FleetPowerPlanner,
                               FleetScheduler, Node, PowerPlanPolicy,
                               PowerStatePolicy)
from repro_torch.fleet.power import NodePowerState
from repro_torch.fleet.power.states import ACTIVE, GATED, PROBATION
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request
from repro_torch.telemetry import (INFRA_TENANT, IDLE_PHASE, ConstantSource,
                                   DecodeEnergyMeter, EnergyLedger,
                                   LiveUtilization, ReplaySource, TickClock,
                                   TRANSITION_PHASE, WsBudget, drain_delta,
                                   envelope_for)

TICK = 0.005
PTICK = 0.01                # the power-planner tests' step
WS = dict(rel=1e-9, abs=1e-12)
#: one chip spec, built in both packages from the same numbers
SPEC = dict(name="test_chip", peak_flops=500e12, hbm_bw=2.0e12,
            hbm_bytes=64e9, ici_bw=100e9, e_flop=1.1e-12, e_hbm=1.3e-10,
            e_ici=2e-11, p_static=90.0)


def _env():
    return envelope_for(power.HardwareSpec(**SPEC))


def _j_env():
    return j_envelope_for(j_power.HardwareSpec(**SPEC))


# ---------------------------------------------------------------------------
# The port's stub serving loop (counterpart of tests/fleet_sim.py)
# ---------------------------------------------------------------------------

class SimLoop:
    """Fixed-step decode simulator over the ServeLoop scheduling surface,
    op for op the reference's ``fleet_sim.SimLoop`` on the port's meter
    and tracer."""

    def __init__(self, slots: int, meter: DecodeEnergyMeter,
                 step_s: float = 0.01):
        self.slots = slots
        self.meter = meter
        self.step_s = step_s
        self.queue = []
        self.active = [None] * slots
        self.finished = []
        self.parked = False
        self.steps_done = 0

    @property
    def occupied_slots(self) -> int:
        return sum(1 for r in self.active if r is not None)

    @property
    def has_work(self) -> bool:
        return self.occupied_slots > 0 or bool(self.queue
                                               and not self.parked)

    def submit(self, req) -> None:
        req.enq_t = self.meter.now
        self.queue.append(req)

    def park(self) -> None:
        self.parked = True

    def unpark(self) -> None:
        self.parked = False

    def drain(self, include_queue: bool = True):
        moved = []
        if include_queue:
            moved.extend(self.queue)
            self.queue.clear()
        for i, req in enumerate(self.active):
            if req is not None:
                self.active[i] = None
                moved.append(req)
        return moved

    def step(self) -> int:
        if not self.parked:
            for i in range(self.slots):
                if self.active[i] is None and self.queue:
                    req = self.queue.pop(0)
                    self.active[i] = req
                    if getattr(req, "enq_t", None) is not None:
                        qw = max(self.meter.now - req.enq_t, 0.0)
                        req.queue_wait_s += qw
                        mx = obs.METRICS
                        if mx.enabled:
                            mx.histogram(
                                "queue_wait_s",
                                "meter-time queued before a slot"
                            ).observe(qw)
        participants = [r for r in self.active if r is not None]
        tr = obs.TRACER
        node = getattr(self.meter, "node", "sim")
        if not participants:
            ws = self.meter.observe(self.step_s, util=0.0, phase="idle",
                                    tenants=[INFRA_TENANT])
            if tr.enabled:
                tr.begin("sim.idle", node=node,
                         t0=self.meter.now - self.step_s,
                         tags={"phase": "idle", "tenant": INFRA_TENANT,
                               "ws": 0.0}).extend(self.meter.now, ws=ws)
            self.steps_done += 1
            return 0
        ws = self.meter.observe(self.step_s,
                                util=len(participants) / self.slots,
                                phase="decode",
                                tenants=[r.tenant for r in participants])
        if tr.enabled:
            share = ws / len(participants)
            for req in participants:
                tr.begin("sim.decode", node=node,
                         t0=self.meter.now - self.step_s,
                         tags={"phase": "decode", "tenant": req.tenant,
                               "rid": req.rid, "ws": 0.0}
                         ).extend(self.meter.now, ws=share)
        n_active = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(0)
            req.energy_ws += ws / len(participants)
            req.decode_ws += ws / len(participants)
            if len(req.out) >= req.max_new:
                req.done = True
                self.active[i] = None
                self.finished.append(req)
            else:
                n_active += 1
        self.steps_done += 1
        return n_active


def sim_node(name: str, watts: float, slots: int = 2,
             step_s: float = 0.01) -> Node:
    """A fleet node whose meter replays a constant ``watts`` draw."""
    meter = DecodeEnergyMeter(envelope=_env(),
                              source=ConstantSource(watts), node=name)
    return Node(name=name, loop=SimLoop(slots, meter, step_s=step_s),
                meter=meter, nominal_step_s=step_s)


def sim_envelope_node(name: str, slots: int = 2,
                      step_s: float = 0.01) -> Node:
    """A fleet node metered by the envelope (no source override): idle
    steps book its gated floor."""
    meter = DecodeEnergyMeter(envelope=_env(), node=name)
    return Node(name=name, loop=SimLoop(slots, meter, step_s=step_s),
                meter=meter, nominal_step_s=step_s)


def _req(rid, tenant="default", max_new=4, prompt_len=4):
    return Request(rid=rid, prompt=np.full(prompt_len, 2, np.int32),
                   max_new=max_new, tenant=tenant)


def _jreq(rid, tenant="default", max_new=4, prompt_len=4):
    return JRequest(rid=rid, prompt=np.full(prompt_len, 2, np.int32),
                    max_new=max_new, tenant=tenant)


# ---------------------------------------------------------------------------
# Budget windows + the shared flush primitive
# ---------------------------------------------------------------------------

def test_ws_budget_windows_roll_and_forgive():
    led = EnergyLedger()
    budget = WsBudget(budget_ws=5.0, window_steps=10)
    assert not budget.exhausted(led, "t")
    led.add("decode", 6.0, 0.1, tenant="t")
    assert budget.spent_ws(led, "t") == pytest.approx(6.0)
    assert budget.exhausted(led, "t")
    budget.roll(9, led, "t")
    assert budget.exhausted(led, "t")
    budget.roll(10, led, "t")
    assert budget.spent_ws(led, "t") == pytest.approx(0.0)
    assert not budget.exhausted(led, "t")
    assert budget.remaining_ws(led, "t") == pytest.approx(5.0)
    run_budget = WsBudget(budget_ws=5.0)
    run_budget.roll(10_000, led, "t")
    assert run_budget.exhausted(led, "t")


def test_drain_delta_is_incremental_and_phase_filtered():
    src, dst, snap = EnergyLedger(), EnergyLedger(), {}
    src.add("decode", 10.0, 0.1, node="meter", tenant="a")
    src.add("prefill", 4.0, 0.05, node="meter", tenant="b")
    ws, s = drain_delta(src, dst, snap, "podX", phases=("decode",))
    assert ws == pytest.approx(10.0) and s == pytest.approx(0.1)
    assert dst.total_ws == pytest.approx(14.0)
    assert dst.rollup("node").keys() == {"podX"}
    assert dst.rollup("tenant")["b"].ws == pytest.approx(4.0)
    assert drain_delta(src, dst, snap, "podX") == (0.0, 0.0)
    src.add("decode", 1.0, 0.01, node="meter", tenant="a")
    ws, _ = drain_delta(src, dst, snap, "podX", phases=("decode",))
    assert ws == pytest.approx(1.0)
    assert dst.total_ws == pytest.approx(15.0)


# ---------------------------------------------------------------------------
# Routing, admission and drift drains on stub nodes
# ---------------------------------------------------------------------------

def test_energy_router_prefers_cheapest_marginal_ws_per_token():
    cool, hot = sim_node("cool", 100.0), sim_node("hot", 300.0)
    sched = FleetScheduler([cool, hot])
    assert cool.marginal_ws_per_token() < hot.marginal_ws_per_token()
    assert sched.route(_req(0)) is cool
    cool.submit(_req(0))
    assert sched.route(_req(1)) is cool
    cool.loop.park()
    assert cool.marginal_ws_per_token() == float("inf")
    assert sched.route(_req(2)) is hot
    hot.loop.park()
    with pytest.raises(RuntimeError):
        sched.route(_req(3))


def test_round_robin_router_is_energy_blind():
    cool, hot = sim_node("cool", 100.0), sim_node("hot", 300.0)
    sched = FleetScheduler([cool, hot],
                           policy=FleetPolicy(router="round_robin"))
    assert [sched.route(_req(i)).name for i in range(4)] == \
        ["cool", "hot", "cool", "hot"]
    with pytest.raises(ValueError):
        FleetPolicy(router="cheapest")
    with pytest.raises(ValueError):
        FleetPolicy(flush_every=0)
    with pytest.raises(ValueError, match="unique"):
        FleetScheduler([sim_node("a", 1.0), sim_node("a", 1.0)])


def test_router_books_no_energy_on_unrouted_nodes():
    cool, hot = sim_node("cool", 100.0, slots=4), sim_node("hot", 300.0)
    sched = FleetScheduler([cool, hot])
    for i in range(4):
        assert sched.submit(_req(i)) is cool
    sched.run()
    assert not hot.served and hot.meter.ledger.total_ws == 0.0
    assert "hot" not in sched.ledger.rollup("node")
    assert sched.ledger.rollup("node")["cool"].ws == \
        pytest.approx(cool.meter.ledger.total_ws)


def test_admission_throttles_exhausted_tenant_with_zero_ws():
    node = sim_node("n0", 100.0, slots=2)
    admission = AdmissionController({"burst": WsBudget(budget_ws=0.5)})
    sched = FleetScheduler([node], admission=admission)
    assert sched.submit(_req(0, tenant="burst")) is node
    sched.run()
    spent = WsBudget.tenant_ws(sched.ledger, "burst")
    assert spent > 0.5
    assert sched.submit(_req(1, tenant="burst")) is None
    assert sched.submit(_req(2, tenant="steady")) is node
    sched.run()
    assert [r.rid for r in admission.rejections] == [1]
    assert "0.50Ws" in admission.rejections[0].reason
    assert WsBudget.tenant_ws(sched.ledger, "burst") == pytest.approx(spent)
    assert admission.summary(sched.ledger)["burst"]["rejected"] == 1


def test_admission_window_readmits_after_roll():
    node = sim_node("n0", 100.0, slots=2)
    admission = AdmissionController(
        {"t": WsBudget(budget_ws=0.5, window_steps=8)})
    sched = FleetScheduler([node], admission=admission)
    assert sched.submit(_req(0, tenant="t")) is node
    sched.run()
    assert sched.submit(_req(1, tenant="t")) is None
    sched.steps += 8
    assert sched.submit(_req(2, tenant="t")) is node
    assert [r.rid for r in admission.rejections] == [1]


def test_admission_reads_unflushed_spend():
    node = sim_node("n0", 100.0, slots=2)
    admission = AdmissionController({"t": WsBudget(budget_ws=0.5)})
    sched = FleetScheduler([node], admission=admission,
                           policy=FleetPolicy(flush_every=10_000,
                                              checkpoint_every=10_000))
    assert sched.submit(_req(0, tenant="t", max_new=8)) is node
    while node.has_work:
        sched.step()
    assert sched.ledger.total_ws == 0.0
    assert sched.submit(_req(1, tenant="t")) is None
    assert sched.ledger.total_ws == pytest.approx(
        node.meter.ledger.total_ws)
    assert [r.rid for r in admission.rejections] == [1]


def test_admission_default_budget_covers_unknown_tenants():
    admission = AdmissionController(default=WsBudget(budget_ws=1.0))
    led = EnergyLedger()
    led.add("decode", 2.0, 0.1, tenant="anyone")
    assert not admission.admit(_req(0, tenant="anyone"), 0, led)
    assert admission.admit(_req(1, tenant="fresh"), 0, led)
    assert admission.budgets["anyone"] is not admission.budgets["fresh"]


def test_drained_node_never_receives_its_own_load():
    sick = sim_node("a-sick", 100.0, slots=2)
    sick.meter.source = ReplaySource([(0.0, 100.0), (0.2, 300.0)])
    ok = sim_node("b-ok", 100.0, slots=2)
    sched = FleetScheduler(
        [sick, ok], policy=FleetPolicy(flush_every=2, checkpoint_every=4,
                                       degrade_factor=1.5,
                                       park_drained=False,
                                       router="round_robin"))
    sick.submit(_req(0, max_new=40))
    sick.submit(_req(1, max_new=40))
    sched.run()
    assert len(sched.events) == 1
    assert sched.events[0].targets == ("b-ok",)
    assert not sick.parked
    assert sched.route(_req(9)) in (sick, ok)


def test_drift_drain_parks_at_checkpoint_and_migrates_load():
    sick = sim_node("a-sick", 100.0, slots=2)
    sick.meter.source = ReplaySource([(0.0, 100.0), (0.2, 300.0)])
    ok = sim_node("b-ok", 100.0, slots=2)
    sched = FleetScheduler(
        [sick, ok], policy=FleetPolicy(flush_every=2, checkpoint_every=4,
                                       degrade_factor=1.5))
    for i in range(2):
        assert sched.submit(_req(i, max_new=40)) is sick
    finished = sched.run()
    assert len(sched.events) == 1
    ev = sched.events[0]
    assert ev.node == "a-sick" and ev.targets == ("b-ok",)
    assert ev.step % sched.policy.checkpoint_every == 0
    assert ev.detected_step <= ev.step and ev.drift_ratio > 1.5
    assert sorted(ev.moved_rids) == [0, 1]
    assert sick.parked and not ok.parked
    assert sorted(r.rid for r in finished) == [0, 1]
    assert all(len(r.out) == 40 for r in finished)
    assert sched.ledger.total_ws == pytest.approx(
        sick.meter.ledger.total_ws + ok.meter.ledger.total_ws, rel=1e-12)


def test_no_drain_without_a_healthy_target():
    solo = sim_node("solo", 100.0, slots=2)
    solo.meter.source = ReplaySource([(0.0, 100.0), (0.1, 400.0)])
    sched = FleetScheduler(
        [solo], policy=FleetPolicy(flush_every=2, checkpoint_every=4,
                                   degrade_factor=1.5))
    sched.submit(_req(0, max_new=60))
    finished = sched.run()
    assert sched.events == [] and not solo.parked
    assert [r.rid for r in finished] == [0]


def test_normalized_arrivals_refuse_mixed_scripts():
    with pytest.raises(ValueError, match="mixed"):
        FleetScheduler([sim_node("n", 1.0)]).run(
            arrivals=[_req(0), (3, _req(1))])


# ---------------------------------------------------------------------------
# Twins on stub nodes: the same script through both packages
# ---------------------------------------------------------------------------

def _stub_fleets(planner: bool):
    """Three nodes per package: two constant draws and one drifting, or
    (with ``planner``) three envelope nodes under consolidate-and-gate."""
    def pol(mod):
        return mod.FleetPolicy(flush_every=2, checkpoint_every=4,
                               degrade_factor=1.5,
                               migrate_on_drift=not planner)

    def plan_pol(mod):
        return mod.PowerPlanPolicy(
            mode="gate", slo_queue_depth=4.0, plan_every=4, min_active=1,
            min_active_steps=20, horizon_steps=32.0,
            states=mod.PowerStatePolicy(gate_watts=2.0, boot_energy_ws=1.0,
                                        warmup_steps=4, cooldown_steps=8))
    if planner:
        jn = [j_sim_envelope_node(f"n{i}", envelope=_j_env(), slots=2,
                                  step_s=PTICK) for i in range(3)]
        pn = [sim_envelope_node(f"n{i}", slots=2, step_s=PTICK)
              for i in range(3)]
    else:
        jn = [j_sim_node(n, w, slots=2) for n, w in
              (("a", 100.0), ("b", 150.0), ("c", 200.0))]
        pn = [sim_node(n, w, slots=2) for n, w in
              (("a", 100.0), ("b", 150.0), ("c", 200.0))]
        jn[0].meter.source = JReplaySource([(0.0, 100.0), (0.15, 350.0)])
        pn[0].meter.source = ReplaySource([(0.0, 100.0), (0.15, 350.0)])
    jadm = jfleet.AdmissionController(
        {"t1": JWsBudget(budget_ws=0.8, window_steps=32)})
    adm = AdmissionController({"t1": WsBudget(budget_ws=0.8,
                                              window_steps=32)})
    jsched = jfleet.FleetScheduler(
        jn, policy=pol(jfleet), admission=jadm,
        planner=jfleet.FleetPowerPlanner(policy=plan_pol(jfleet))
        if planner else None)
    sched = FleetScheduler(
        pn, policy=pol(pfleet), admission=adm,
        planner=FleetPowerPlanner(policy=plan_pol(pfleet))
        if planner else None)
    return jsched, sched


def _script(make, planner: bool):
    if planner:
        dues = list(range(1, 9)) + list(range(160, 196, 3))
    else:
        dues = [i for i in range(0, 40, 2)]
    return [(due, make(i, tenant=f"t{i % 2}", max_new=8 if planner else 12))
            for i, due in enumerate(dues)]


def _same_ledger(jl, tl):
    assert set(tl.cells) == set(jl.cells)
    for key, cell in jl.cells.items():
        got = tl.cells[key]
        assert got.ws == pytest.approx(cell.ws, **WS), key
        assert got.seconds == pytest.approx(cell.seconds, **WS), key
        assert (got.count, got.peak_w) == (cell.count, cell.peak_w), key
    assert tl.total_ws == pytest.approx(jl.total_ws, **WS)


def _routes(sched):
    return {n.name: [r.rid for r in n.served] for n in sched.nodes}


def _events(evs):
    return [e.to_dict() for e in evs]


@pytest.mark.parametrize("planner", [False, True],
                         ids=["drift_drain", "gate_planner"])
def test_stub_fleet_twin(planner):
    jsched, sched = _stub_fleets(planner)
    jdone = jsched.run(arrivals=_script(_jreq, planner), max_steps=2000)
    done = sched.run(arrivals=_script(_req, planner), max_steps=2000)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert [r.out for r in done] == [r.out for r in jdone]
    for jr, r in zip(jdone, done):
        assert r.energy_ws == pytest.approx(jr.energy_ws, **WS)
        assert r.queue_wait_s == pytest.approx(jr.queue_wait_s, **WS)
    assert _routes(sched) == _routes(jsched)
    _same_ledger(jsched.ledger, sched.ledger)
    assert _events(sched.events) == pytest.approx(_events(jsched.events))
    assert [r.to_dict() for r in sched.admission.rejections] == \
        pytest.approx([r.to_dict() for r in jsched.admission.rejections])
    assert sched.admission.rejections, "the script must throttle t1"
    if planner:
        assert _events(sched.planner.events) == \
            pytest.approx(_events(jsched.planner.events))
        assert {e.action for e in sched.planner.events} >= \
            {"gate", "wake", "probe", "admit"}
        assert sched.planner.states == jsched.planner.states
        s, js = sched.summary(), jsched.summary()
        assert s["placement"]["max_queue_depth"] == \
            js["placement"]["max_queue_depth"]
    else:
        assert len(sched.events) == 1 and sched.events[0].node == "a"


# ---------------------------------------------------------------------------
# Power states, forecaster and planner (mirrors tests/test_fleet_power.py)
# ---------------------------------------------------------------------------

def _planner(mode="gate", **kw):
    states = kw.pop("states", PowerStatePolicy(
        gate_watts=2.0, boot_energy_ws=1.0, warmup_steps=4,
        cooldown_steps=8))
    return FleetPowerPlanner(policy=PowerPlanPolicy(
        mode=mode, slo_queue_depth=4.0, plan_every=4, min_active=1,
        min_active_steps=20, horizon_steps=32.0, states=states, **kw))


def _fleet(n=3, mode="gate", **kw):
    nodes = [sim_envelope_node(f"n{i}", slots=2, step_s=PTICK)
             for i in range(n)]
    sched = FleetScheduler(
        nodes, policy=FleetPolicy(flush_every=4, checkpoint_every=8,
                                  migrate_on_drift=False),
        planner=_planner(mode=mode, **kw))
    return nodes, sched


def _diurnal(n_a=8, trough=150, n_b=12, spacing_b=3, max_new=8):
    arrivals, rid = [], 0
    for due in range(1, n_a + 1):
        arrivals.append((due, _req(rid, tenant=f"t{rid % 2}",
                                   max_new=max_new, prompt_len=3)))
        rid += 1
    start_b = n_a + 2 + trough
    for i in range(n_b):
        arrivals.append((start_b + i * spacing_b,
                         _req(rid, tenant=f"t{rid % 2}", max_new=max_new,
                              prompt_len=3)))
        rid += 1
    return arrivals


def test_planner_refuses_every_backend_but_numpy():
    """numpy, and the torch sweep on a named device, are the only
    backends (the port has no jax; tests/test_torch_fleet_backend.py holds
    the torch sweep)."""
    assert FleetPowerPlanner(backend="numpy").backend == "numpy"
    assert FleetPowerPlanner(backend="torch", device="cpu").backend == \
        "torch"
    with pytest.raises(ValueError, match="'numpy' or 'torch'"):
        FleetPowerPlanner(backend="jax")
    with pytest.raises(ValueError):
        FleetPowerPlanner(backend="cuda")
    with pytest.raises(ValueError):
        PowerPlanPolicy(mode="sometimes")


def test_forecaster_rate_rises_on_bursts_and_decays_in_troughs():
    f = ArrivalForecaster(alpha=0.5, prior_gap=32.0)
    assert f.rate() == pytest.approx(1.0 / 32.0)
    for t in range(0, 10):
        f.observe(t)
    burst_rate = f.rate(now=10)
    assert burst_rate > 0.3
    assert f.rate(now=200) < 0.01
    assert f.rate(now=200) < f.rate(now=50) < burst_rate
    f.observe(200), f.observe(201), f.observe(202)
    assert f.rate(now=202) > 0.05


def test_forecaster_queue_depth_scales_with_servers():
    f = ArrivalForecaster(alpha=0.5)
    for t in range(0, 40):
        f.observe(t)
    lq1 = f.expected_queue_depth(2, 6.0, now=40)
    lq2 = f.expected_queue_depth(16, 6.0, now=40)
    assert lq1 > f.utilization(2, 6.0, now=40) > 1.0
    assert lq2 < 1.0 < lq1


def test_forecaster_sweep_equals_the_scalar_and_the_reference():
    f, jf = ArrivalForecaster(alpha=0.4), jfleet.ArrivalForecaster(alpha=0.4)
    for t in (0, 1, 1, 3, 7, 8, 30):
        f.observe(t)
        jf.observe(t)
    servers = np.arange(1, 40)
    got = f.expected_queue_depth_many(servers, 5.0, now=31, horizon=48.0)
    want = jf.expected_queue_depth_many(servers, 5.0, now=31, horizon=48.0)
    assert got.tolist() == want.tolist()
    assert got.tolist() == [f.expected_queue_depth(int(c), 5.0, now=31,
                                                   horizon=48.0)
                            for c in servers]
    assert f.summary() == jf.summary()


def test_gate_and_wake_book_idle_and_transition_phases():
    node = sim_envelope_node("g0", slots=2, step_s=PTICK)
    machine = _planner().policy.states
    m = NodePowerState(node, policy=machine)
    floor = node.meter.envelope.gated_idle
    node.loop.park()
    m.gate(step=0)
    m.tick(step=1)
    pe = node.meter.ledger.phases[IDLE_PHASE]
    assert pe.ws == pytest.approx(m.parked_watts * PTICK, rel=1e-9)
    assert m.parked_watts <= floor
    ws0 = node.meter.ledger.total_ws
    booked = m.wake(step=2)
    tr = node.meter.ledger.phases[TRANSITION_PHASE]
    assert booked == pytest.approx(machine.boot_energy_ws, rel=1e-9)
    assert tr.ws == pytest.approx(machine.boot_energy_ws, rel=1e-9)
    assert node.meter.ledger.total_ws == pytest.approx(ws0 + booked,
                                                       rel=1e-9)
    assert m.tick(step=2 + machine.warmup_steps) == "probe"
    assert m.state == PROBATION and not node.parked
    canary = _req(99)
    m.assign_canary(canary, step=10)
    canary.done = True
    assert m.tick(step=11) == "admit"
    assert m.state == ACTIVE
    assert set(node.meter.ledger.rollup("tenant")) == {INFRA_TENANT}


def test_probation_canary_timeout_regates_and_moves_the_load():
    states = PowerStatePolicy(gate_watts=2.0, boot_energy_ws=1.0,
                              warmup_steps=0, cooldown_steps=4,
                              canary_timeout_steps=5)
    nodes, sched = _fleet(n=2, mode="gate", states=states)
    m = sched.planner.machine(nodes[1])
    nodes[1].loop.park()
    m.gate(0)
    m.wake(1)
    sched.step()
    assert m.state == PROBATION
    req = _req(0, max_new=50)
    assert sched.submit(req) is nodes[1]
    for _ in range(10):
        sched.step()
    assert m.state == GATED and nodes[1].parked
    assert any(e.action == "regate" for e in sched.planner.events)
    while sched.has_work:
        sched.step()
    assert req.done and len(req.out) == 50
    assert req in nodes[0].loop.finished


def test_consolidate_and_gate_end_to_end():
    nodes, sched = _fleet(n=3, mode="gate")
    planner = sched.planner
    finished = sched.run(arrivals=_diurnal(), max_steps=2000)
    assert sorted(r.rid for r in finished) == list(range(20))
    assert all(len(r.out) == 8 for r in finished)
    gates = [e for e in planner.events if e.action == "gate"]
    assert gates and all(e.step % sched.policy.checkpoint_every == 0
                         for e in gates)
    actions = [e.action for e in planner.events]
    for needed in ("wake", "probe", "admit"):
        assert needed in actions, actions
    wake = next(e for e in planner.events if e.action == "wake")
    admit = next(e for e in planner.events if e.action == "admit")
    assert wake.step % sched.policy.checkpoint_every == 0
    assert admit.step > wake.step
    assert planner.max_queue_depth <= planner.policy.slo_queue_depth
    assert {IDLE_PHASE, TRANSITION_PHASE, "decode"} <= \
        set(sched.ledger.rollup("phase"))
    total = sum(n.meter.ledger.total_ws for n in nodes)
    assert sched.ledger.total_ws == pytest.approx(total, rel=1e-12)
    for by in ("node", "tenant", "phase"):
        assert sum(pe.ws for pe in sched.ledger.rollup(by).values()) == \
            pytest.approx(total, rel=1e-12)
    infra = sched.ledger.rollup("tenant")[INFRA_TENANT].ws
    idle_tr = sum(sched.ledger.rollup("phase")[p].ws
                  for p in (IDLE_PHASE, TRANSITION_PHASE))
    assert infra == pytest.approx(idle_tr, rel=1e-9)


def test_gate_beats_always_on_on_total_ws():
    arrivals = _diurnal()
    _, sched_on = _fleet(n=3, mode="always_on")
    fin_on = sched_on.run(arrivals=[(s, _req(r.rid, r.tenant, r.max_new, 3))
                                    for s, r in arrivals], max_steps=2000)
    _, sched_gate = _fleet(n=3, mode="gate")
    fin_gate = sched_gate.run(arrivals=arrivals, max_steps=2000)
    assert len(fin_on) == len(fin_gate) == 20
    assert sched_gate.ledger.total_ws < sched_on.ledger.total_ws
    assert all(e.action not in ("gate", "wake")
               for e in sched_on.planner.events)
    assert set(sched_on.planner.states.values()) == {ACTIVE}
    assert sched_on.ledger.rollup("phase")[IDLE_PHASE].ws > \
        sched_gate.ledger.rollup("phase")[IDLE_PHASE].ws


def test_drained_node_reenters_via_probation():
    nodes, sched = _fleet(n=2, mode="gate")
    nodes[0].loop.park()
    for _ in range(40):
        sched.step()
    assert [e for e in sched.planner.events
            if e.node == "n0" and e.action == "probe"]
    assert sched.planner.machine(nodes[0]).state == PROBATION
    req = _req(0, max_new=2)
    assert sched.submit(req) is nodes[0]
    while sched.has_work:
        sched.step()
    sched.planner.tick(sched.steps + 1)
    assert sched.planner.machine(nodes[0]).state == ACTIVE


def test_route_skips_non_active_nodes():
    nodes, sched = _fleet(n=2, mode="gate")
    m = sched.planner.machine(nodes[1])
    nodes[1].loop.park()
    m.gate(0)
    assert sched.route(_req(0)) is nodes[0]
    sched.planner._park_pending(1, nodes[0], "gate", 0.0, 0.0, 1)
    assert sched.planner.checkpoint(8) == []
    assert not nodes[0].parked


# ---------------------------------------------------------------------------
# Property tests (mirrors tests/test_fleet_power_invariants.py)
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

_TIMES = st.lists(st.floats(min_value=-1e9, max_value=1e9,
                            allow_nan=False, allow_infinity=False),
                  min_size=0, max_size=40)


@settings(max_examples=60, deadline=None)
@given(times=_TIMES, servers=st.integers(min_value=1, max_value=64),
       service=st.floats(min_value=0.0, max_value=1e4, allow_nan=False,
                         allow_infinity=False),
       now=st.floats(min_value=-1e9, max_value=1e9, allow_nan=False,
                     allow_infinity=False))
def test_forecaster_outputs_finite_nonnegative(times, servers, service, now):
    f = ArrivalForecaster()
    for t in times:
        f.observe(t)
    for value in (f.rate(), f.rate(now=now), f.gap(now=now),
                  f.utilization(servers, service, now=now),
                  f.expected_queue_depth(servers, service, now=now),
                  f.expected_queue_depth(servers, service, now=now,
                                         horizon=0.0)):
        assert math.isfinite(value) and value >= 0.0


@settings(max_examples=40, deadline=None)
@given(gate_watts=st.floats(min_value=0.0, max_value=1e4, allow_nan=False,
                            allow_infinity=False),
       ticks=st.integers(min_value=1, max_value=20))
def test_gated_node_books_at_most_floor_ws(gate_watts, ticks):
    node = sim_envelope_node("h0", slots=2, step_s=PTICK)
    m = NodePowerState(node, policy=PowerStatePolicy(
        gate_watts=gate_watts, cooldown_steps=10_000))
    node.loop.park()
    m.gate(0)
    for k in range(ticks):
        m.tick(k + 1)
    floor = node.meter.envelope.gated_idle
    assert 0.0 <= node.meter.ledger.total_ws <= \
        floor * PTICK * ticks * (1 + 1e-9)


@settings(max_examples=25, deadline=None)
@given(bursts=st.lists(st.tuples(st.integers(min_value=0, max_value=200),
                                 st.integers(min_value=1, max_value=6)),
                       min_size=1, max_size=4))
def test_planner_ledger_conserves_joules_under_any_script(bursts):
    nodes = [sim_envelope_node(f"n{i}", slots=2, step_s=PTICK)
             for i in range(2)]
    sched = FleetScheduler(
        nodes, policy=FleetPolicy(flush_every=4, checkpoint_every=8,
                                  migrate_on_drift=False),
        planner=FleetPowerPlanner(policy=PowerPlanPolicy(
            mode="gate", plan_every=4, min_active_steps=8,
            states=PowerStatePolicy(gate_watts=2.0, boot_energy_ws=1.0,
                                    warmup_steps=2, cooldown_steps=8))))
    arrivals, rid = [], 0
    for start, size in sorted(bursts):
        for i in range(size):
            arrivals.append((start + i, _req(rid, max_new=3, prompt_len=3)))
            rid += 1
    sched.run(arrivals=arrivals, max_steps=600)
    total = sum(n.meter.ledger.total_ws for n in nodes)
    assert sched.ledger.total_ws == pytest.approx(total, rel=1e-9)
    for by in ("node", "tenant", "phase"):
        assert sum(pe.ws for pe in sched.ledger.rollup(by).values()) == \
            pytest.approx(total, rel=1e-9)


# ---------------------------------------------------------------------------
# Real tiny-test models: ServeLoop fleet surface and the model twins
# ---------------------------------------------------------------------------

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


def _serve_node(name, model, params, source=None, slots=2):
    return Node.build(name, model, params, slots=slots, max_seq=64,
                      eos_id=-1, source=source, clock=TickClock(TICK),
                      nominal_step_s=TICK, envelope=_env(), device="cpu")


def _j_serve_node(name, model, params, source=None, slots=2):
    return jfleet.Node.build(name, model, params, slots=slots, max_seq=64,
                             eos_id=-1, source=source, clock=TickClock(TICK),
                             nominal_step_s=TICK, envelope=_j_env())


def test_node_build_needs_a_card_unless_told(pair, monkeypatch):
    _, _, model, params = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Node.build("n", model, params)
    node = Node.build("n", model, params, device="cpu")
    # the port meters at the H100 envelope unless told otherwise
    assert node.meter.envelope == envelope_for(power.H100)
    assert node.loop.device.type == "cpu"


def test_serve_loop_drain_resumes_on_another_loop(pair):
    _, _, model, params = pair
    a = _serve_node("a", model, params)
    b = _serve_node("b", model, params)
    req = _req(0, max_new=9, prompt_len=4)
    a.submit(req)
    for _ in range(5):
        a.loop.step()
    assert len(req.out) == 5 and not req.done
    a.loop.park()
    assert a.drain() == [req]
    assert a.loop.occupied_slots == 0 and not a.loop.has_work
    mid_ws = req.energy_ws
    b.submit(req)
    while b.loop.has_work:
        b.loop.step()
    assert b.loop.finished == [req] and req.done and len(req.out) == 9
    assert b.meter.ledger.phases["prefill"].count == 1
    assert req.energy_ws > mid_ws
    a.submit(_req(1))
    assert not a.loop.has_work
    assert a.loop.step() == 0
    assert a.loop.queue and a.loop.occupied_slots == 0


def test_serve_loop_books_measured_slot_occupancy(pair):
    _, _, model, params = pair
    node = _serve_node("m", model, params, slots=2)
    loop = node.loop
    assert isinstance(loop.utilization, LiveUtilization)
    assert node.meter.utilization is loop.utilization
    node.submit(_req(0, max_new=6))
    while loop.has_work:
        loop.step()
    per_phase = loop.utilization.per_phase()
    assert per_phase["decode"] == pytest.approx(0.5)
    assert per_phase["prefill"] == pytest.approx(0.5)
    want = node.meter.envelope.watts(0.5) * (loop.steps_done + 1) * TICK
    assert node.meter.ledger.total_ws == pytest.approx(want, rel=1e-9)


def test_serve_loop_idle_step_books_floor_watts(pair):
    _, _, model, params = pair
    node = Node.build("idle0", model, params, slots=2, max_seq=32,
                      clock=TickClock(PTICK), device="cpu")
    assert node.loop.step() == 0
    pe = node.meter.ledger.phases[IDLE_PHASE]
    assert pe.ws == pytest.approx(node.meter.envelope.gated_idle * PTICK,
                                  rel=1e-9)
    assert pe.seconds == pytest.approx(PTICK)
    assert node.meter.ledger.rollup("tenant")[INFRA_TENANT].ws == \
        pytest.approx(pe.ws, rel=1e-12)
    assert node.loop.utilization.per_phase()[IDLE_PHASE] == 0.0
    assert node.loop.steps_done == 1


def test_unpark_does_not_backbook_the_parked_span(pair):
    _, _, model, params = pair
    t = [0.0]
    node = Node.build("w0", model, params, slots=2, max_seq=32,
                      clock=lambda: t[0], device="cpu")
    node.loop.step()
    ws0 = node.meter.ledger.total_ws
    node.loop.park()
    t[0] += 100.0
    node.loop.unpark()
    node.loop.step()
    assert node.meter.ledger.total_ws - ws0 < \
        node.meter.envelope.gated_idle * 1.0


def test_request_behind_full_node_reports_queue_wait(pair):
    _, _, model, params = pair
    node = _serve_node("q", model, params, slots=1)
    tracer, metrics = obs.enable()
    try:
        r0, r1 = _req(0, max_new=4), _req(1, max_new=4)
        node.submit(r0)
        node.submit(r1)
        node.loop.run()
        assert r0.done and r1.done
        assert r0.queue_wait_s == pytest.approx(0.0)
        assert r1.queue_wait_s > 0.0
        waits = {sp.tags["rid"]: sp for sp in tracer.spans
                 if sp.name == "serve.queue_wait"}
        assert waits[1].seconds == pytest.approx(r1.queue_wait_s)
        roots = {sp.tags["rid"]: sp for sp in tracer.spans
                 if sp.name == "serve.request"}
        assert roots[1].contains(waits[1])
        assert waits[1].parent_id == roots[1].span_id
        h = metrics.histogram("queue_wait_s")
        assert h.count == 2 and h.quantile(0.99) > 0.0
        assert 'queue_wait_s{quantile="0.99"}' in metrics.to_prometheus()
    finally:
        obs.disable()


def _model_fleets(pair, planner: bool):
    jmodel, jp, model, params = pair
    drift = [(0.0, 150.0), (0.06, 450.0)]
    if planner:
        jn = [_j_serve_node(f"n{i}", jmodel, jp) for i in range(3)]
        pn = [_serve_node(f"n{i}", model, params) for i in range(3)]
    else:
        jn = [_j_serve_node("n0", jmodel, jp, slots=4,
                            source=JReplaySource(drift)),
              _j_serve_node("n1", jmodel, jp, slots=4,
                            source=JConstantSource(150.0))]
        pn = [_serve_node("n0", model, params, slots=4,
                          source=ReplaySource(drift)),
              _serve_node("n1", model, params, slots=4,
                          source=ConstantSource(150.0))]

    def build(mod, nodes, budget):
        plan = mod.FleetPowerPlanner(policy=mod.PowerPlanPolicy(
            mode="gate", plan_every=4, min_active_steps=8,
            horizon_steps=32.0,
            states=mod.PowerStatePolicy(gate_watts=2.0, boot_energy_ws=0.1,
                                        warmup_steps=2, cooldown_steps=8))) \
            if planner else None
        return mod.FleetScheduler(
            nodes, policy=mod.FleetPolicy(flush_every=2, checkpoint_every=4,
                                          degrade_factor=1.5,
                                          migrate_on_drift=not planner),
            admission=mod.AdmissionController({"t1": budget}),
            planner=plan)
    return (build(jfleet, jn, JWsBudget(budget_ws=0.05)),
            build(pfleet, pn, WsBudget(budget_ws=0.05)))


def _model_script(make, vocab, planner: bool):
    rng = np.random.default_rng(0)
    dues = [1, 2, 3, 60, 62, 64] if planner else [0, 0, 0, 0, 6, 9]
    out = []
    for i, due in enumerate(dues):
        plen = int(rng.integers(4, 8))
        prompt = rng.integers(2, vocab, size=plen).astype(np.int32)
        out.append((due, make(rid=i, prompt=prompt, max_new=10,
                              tenant=f"t{i % 2}")))
    return out


@pytest.mark.parametrize("planner", [False, True],
                         ids=["drift_drain", "gate_planner"])
def test_model_fleet_twin(pair, planner):
    vocab = pair[2].cfg.vocab_size
    jsched, sched = _model_fleets(pair, planner)
    jdone = jsched.run(arrivals=_model_script(JRequest, vocab, planner),
                       max_steps=400)
    done = sched.run(arrivals=_model_script(Request, vocab, planner),
                     max_steps=400)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert [r.out for r in done] == [r.out for r in jdone]
    assert all(len(r.out) == 10 for r in done)
    for jr, r in zip(jdone, done):
        assert r.energy_ws == pytest.approx(jr.energy_ws, **WS)
    assert _routes(sched) == _routes(jsched)
    _same_ledger(jsched.ledger, sched.ledger)
    assert _events(sched.events) == pytest.approx(_events(jsched.events))
    assert [r.to_dict() for r in sched.admission.rejections] == \
        pytest.approx([r.to_dict() for r in jsched.admission.rejections])
    assert sched.admission.rejections
    total = sum(n.meter.ledger.total_ws for n in sched.nodes)
    assert sched.ledger.total_ws == pytest.approx(total, rel=1e-12)
    if planner:
        assert _events(sched.planner.events) == \
            pytest.approx(_events(jsched.planner.events))
        assert any(e.action == "gate" for e in sched.planner.events)
    else:
        assert len(sched.events) == 1 and sched.events[0].node == "n0"
        assert sched.node("n0").parked

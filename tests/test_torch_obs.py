"""The port's observability stack against the JAX package's ``repro.obs``.

Mirrors ``tests/test_obs.py`` and ``tests/test_obs_invariants.py`` (the
compiled-rung stage spans and the flight recorder belong to slices not
ported yet), and holds the port equal to the reference: the same
observations render byte-identical Prometheus text, the same spans export
byte-identical JSONL and Chrome traces, and a traced consolidate-and-gate
fleet run of stub nodes (``SimLoop`` of ``tests/test_torch_fleet.py``)
yields the reference's spans, attribution and metrics on the same arrival
script.  The port's files render through the reference's jax-free
``scripts/trace_report.py``.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fleet_sim import sim_envelope_node as j_sim_envelope_node
from repro import fleet as jfleet
from repro import obs as jobs
from repro.serve.engine import Request as JRequest
from repro.telemetry import EnergyLedger as JEnergyLedger
from repro_torch import fleet as pfleet
from repro_torch import obs
from repro_torch.fleet import (FleetPolicy, FleetPowerPlanner,
                               FleetScheduler, PowerPlanPolicy,
                               PowerStatePolicy)
from repro_torch.obs import (Histogram, MetricsRegistry, Span, Tracer,
                             attribute_joules, attribute_joules_sampled,
                             read_chrome_trace, read_spans_jsonl,
                             write_chrome_trace, write_spans_jsonl)
from repro_torch.serve.engine import Request
from repro_torch.telemetry import EnergyLedger
from test_torch_fleet import _j_env, sim_envelope_node

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "trace_report.py"
TICK = 0.01


def _req(rid, tenant="default", max_new=6):
    return Request(rid=rid, prompt=np.full(3, 2, np.int32),
                   max_new=max_new, tenant=tenant)


def _jreq(rid, tenant="default", max_new=6):
    return JRequest(rid=rid, prompt=np.full(3, 2, np.int32),
                    max_new=max_new, tenant=tenant)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


# ---------------------------------------------------------------------------
# Tracer / Span
# ---------------------------------------------------------------------------

def test_span_context_manager_nests_and_times():
    tr = Tracer(clock=FakeClock())
    with tr.span("outer") as outer:
        with tr.span("inner") as inner:
            pass
        sibling = tr.begin("sibling", t0=outer.t0 + 0.5)
        sibling.finish(outer.t0 + 0.7)
    assert inner.parent_id == outer.span_id
    assert sibling.parent_id == outer.span_id
    assert not outer.open and not inner.open
    assert outer.contains(inner) and outer.contains(sibling)
    assert outer.seconds >= inner.seconds


def test_span_extend_accumulates_ws_and_finish_keeps_extent():
    sp = Span(name="w", t0=1.0)
    sp.extend(2.0, ws=0.25).extend(3.0, ws=0.25)
    assert sp.tags["ws"] == pytest.approx(0.5)
    sp.finish()
    assert sp.t1 == 3.0 and sp.seconds == pytest.approx(2.0)
    assert Span(name="z", t0=4.0).finish().seconds == 0.0


def test_tracer_caps_spans_and_counts_drops():
    tr = Tracer(clock=FakeClock(), maxlen=3)
    for i in range(5):
        tr.instant(f"e{i}")
    assert len(tr.spans) == 3 and tr.dropped == 2
    more = [Span(name="x", t0=0.0), Span(name="y", t0=0.0, span_id=77)]
    assert tr.add_spans(more) == 0 and tr.dropped == 4
    assert more[0].span_id == 6          # an id even when dropped
    fresh = [Span(name="x", t0=0.0), Span(name="y", t0=0.0, span_id=77)]
    assert Tracer(clock=FakeClock()).add_spans(fresh) == 2
    assert [sp.span_id for sp in fresh] == [1, 77]


def test_null_instruments_are_safe_and_disabled(tmp_path):
    obs.disable()
    assert not obs.TRACER.enabled and not obs.METRICS.enabled
    with obs.TRACER.span("x") as sp:
        obs.TRACER.instant("y")
    assert sp.name == ""
    obs.METRICS.counter("c").inc()
    obs.METRICS.counter("c").add(3)
    obs.METRICS.histogram("h").observe(1.0)
    obs.METRICS.histogram("h").observe_many([1.0, 2.0])
    assert obs.METRICS.to_prometheus() == ""
    assert obs.TRACER.add_spans([Span(name="a", t0=0.0)]) == 0
    assert Path(obs.TRACER.to_jsonl(tmp_path / "s.jsonl")).read_text() == ""


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def test_histogram_quantiles_interpolate_and_bound():
    h = Histogram("lat", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 3.0, 100.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(105.0)
    assert h.quantile(0.0) <= h.quantile(0.5) <= h.quantile(1.0)
    assert h.quantile(1.0) == 4.0


def test_histogram_merge_is_exact_and_bounds_checked():
    a, b = Histogram("x"), Histogram("x")
    for v in (0.01, 0.2):
        a.observe(v)
    b.observe(5.0)
    m = Histogram.merged(a, b)
    assert m.count == 3 and m.sum == pytest.approx(5.21)
    assert m.counts == [ca + cb for ca, cb in zip(a.counts, b.counts)]
    with pytest.raises(ValueError):
        a.merge(Histogram("y", buckets=(1.0, 2.0)))


def test_observe_many_is_bitwise_the_loop():
    vals = np.random.default_rng(0).exponential(0.3, 200)
    a, b = Histogram("x"), Histogram("x")
    for v in vals:
        a.observe(float(v))
    b.observe_many(vals)
    b.observe_many([])
    assert (a.counts, a.count, a.sum) == (b.counts, b.count, b.sum)


def test_registry_prometheus_text_has_buckets_and_quantiles(tmp_path):
    mx = MetricsRegistry()
    mx.counter("arrivals_total", "submits seen").inc(3)
    mx.gauge("active_nodes").set(2)
    h = mx.histogram("queue_wait_s", "queued seconds")
    for v in (0.001, 0.02, 0.3):
        h.observe(v)
    text = mx.to_prometheus()
    assert "# TYPE queue_wait_s histogram" in text
    assert 'queue_wait_s_bucket{le="+Inf"} 3' in text
    assert 'queue_wait_s{quantile="0.99"}' in text
    assert "arrivals_total 3" in text and "active_nodes 2" in text
    assert mx.to_json()["queue_wait_s"]["count"] == 3
    with pytest.raises(TypeError):
        mx.counter("queue_wait_s")
    assert Path(mx.write_prometheus(tmp_path / "m.prom")).read_text() == text


def test_prometheus_text_is_the_references_byte_for_byte():
    rng = np.random.default_rng(1)
    vals = rng.exponential(0.05, 64).tolist()
    texts = []
    for mod in (obs, jobs):
        mx = mod.MetricsRegistry()
        mx.counter("fleet_steps_total", "fleet scheduler steps").inc(17)
        mx.counter("admission_rejections_total", "admission verdicts").add(
            np.int64(2))
        mx.gauge("active_nodes", "routable (ACTIVE) nodes").set(3)
        h = mx.histogram("queue_wait_s", "meter-time queued before a slot")
        for v in vals[:40]:
            h.observe(v)
        h.observe_many(np.asarray(vals[40:]))
        other = mod.Histogram("routing_candidates",
                              buckets=(1.0, 2.0, 4.0, 8.0))
        other.observe_many([1, 1, 2, 3, 9])
        mx.histogram("routing_candidates", "nodes eligible per route",
                     buckets=(1.0, 2.0, 4.0, 8.0)).merge(other)
        texts.append(mx.to_prometheus())
        assert mx.to_json()["queue_wait_s"]["count"] == 64
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# Joule attribution
# ---------------------------------------------------------------------------

def test_attribution_distributes_by_ws_weight_and_conserves():
    ledger = EnergyLedger()
    ledger.add("decode", ws=3.0, seconds=1.0, node="n0", tenant="a")
    spans = [Span(name="d1", node="n0", t0=0.0, t1=0.5,
                  tags={"phase": "decode", "tenant": "a", "ws": 1.0}),
             Span(name="d2", node="n0", t0=0.5, t1=1.0,
                  tags={"phase": "decode", "tenant": "a", "ws": 2.0})]
    result = attribute_joules(spans, ledger)
    assert spans[0].attributed_ws == pytest.approx(1.0)
    assert spans[1].attributed_ws == pytest.approx(2.0)
    assert not result.synthesized
    assert all(r["ok"] for r in result.conservation(ledger).values())


def test_attribution_synthesizes_unattributed_cells():
    ledger = EnergyLedger()
    ledger.add("idle", ws=2.0, seconds=4.0, node="n1", tenant="fleet")
    result = attribute_joules([], ledger)
    (syn,) = result.synthesized
    assert syn.name == "unattributed:idle" and syn.node == "n1"
    assert syn.attributed_ws == pytest.approx(2.0)
    assert syn.tags["synthesized"] is True
    assert all(r["ok"] for r in result.conservation(ledger).values())


def test_attribution_is_idempotent():
    ledger = EnergyLedger()
    ledger.add("decode", ws=1.5, seconds=1.0, node="n0", tenant="a")
    spans = [Span(name="d", node="n0", t0=0.0, t1=1.0,
                  tags={"phase": "decode", "tenant": "a"})]
    attribute_joules(spans, ledger)
    attribute_joules(spans, ledger)
    assert spans[0].attributed_ws == pytest.approx(1.5)


def test_sampled_attribution_equals_the_reference():
    def spans(mod):
        return [mod.Span(name="serve.decode", node="n0", t0=0.0, t1=1.0,
                         tags={"phase": "decode", "tenant": "a", "ws": 1.0,
                               "sampled": True, "rid": 1}),
                mod.Span(name="serve.prefill", node="n0", t0=1.0, t1=1.5,
                         tags={"phase": "prefill", "tenant": "a",
                               "ws": 0.5, "sampled": True, "rid": 2})]
    out = []
    for mod, Led in ((obs, EnergyLedger), (jobs, JEnergyLedger)):
        led = Led()
        led.add("decode", 4.0, 2.0, node="n0", tenant="a")
        led.add("prefill", 1.0, 0.5, node="n0", tenant="a")
        sa = mod.attribute_joules_sampled(
            spans(mod), led, 0.5,
            population={"count": 4, "min_ws": 0.4, "max_ws": 1.5})
        out.append(sa.to_dict())
    assert out[0] == pytest.approx(out[1])
    assert out[0]["ok"] is True and out[0]["sampled_requests"] == 2
    assert attribute_joules_sampled([], EnergyLedger(), 1.0).ok is True


# ---------------------------------------------------------------------------
# Exporters + the reference's offline report CLI
# ---------------------------------------------------------------------------

def _sample_spans(mod=obs):
    return [mod.Span(name="serve.decode", node="n0", t0=0.0, t1=1.0,
                     span_id=1,
                     tags={"phase": "decode", "tenant": "a", "ws": 1.0},
                     attributed_ws=1.25),
            mod.Span(name="serve.queue_wait", node="n0", t0=0.0, t1=0.25,
                     span_id=2, parent_id=1, tags={"rid": 7}),
            mod.Span(name="power.gated", node="n1", t0=0.5, t1=2.0,
                     span_id=3, tags={"phase": "idle", "tenant": "fleet"},
                     attributed_ws=0.5)]


def test_chrome_trace_roundtrip(tmp_path):
    path = tmp_path / "trace.json"
    write_chrome_trace(_sample_spans(), path)
    doc = json.loads(path.read_text())
    assert {e["args"]["name"] for e in doc["traceEvents"]
            if e["ph"] == "M"} == {"n0", "n1"}
    back = {sp.span_id: sp for sp in read_chrome_trace(path)}
    assert len(back) == 3
    assert back[1].node == "n0" and back[1].seconds == pytest.approx(1.0)
    assert back[1].attributed_ws == pytest.approx(1.25)
    assert back[2].parent_id == 1
    assert back[3].tags["phase"] == "idle"


def test_exports_are_the_references_byte_for_byte(tmp_path):
    for kind, write in (("jsonl", "write_spans_jsonl"),
                        ("json", "write_chrome_trace")):
        mine, ref = tmp_path / f"p.{kind}", tmp_path / f"r.{kind}"
        getattr(obs, write)(_sample_spans(obs), mine)
        getattr(jobs, write)(_sample_spans(jobs), ref)
        assert mine.read_bytes() == ref.read_bytes()
    back = read_spans_jsonl(tmp_path / "r.jsonl")
    assert [s.to_dict() for s in back] == \
        [s.to_dict() for s in _sample_spans(obs)]
    tr = Tracer(clock=FakeClock())
    tr.add_spans(_sample_spans(obs))
    assert Path(tr.to_jsonl(tmp_path / "t.jsonl")).read_bytes() == \
        (tmp_path / "p.jsonl").read_bytes()


def _report(*argv):
    return subprocess.run([sys.executable, str(SCRIPT)] + list(argv),
                          capture_output=True, text=True)


def test_trace_report_renders_the_ports_files(tmp_path):
    chrome = tmp_path / "trace.json"
    jsonl = tmp_path / "trace.spans.jsonl"
    write_chrome_trace(_sample_spans(), chrome)
    write_spans_jsonl(_sample_spans(), jsonl)
    for path in (chrome, jsonl):
        r = _report("--trace", str(path))
        assert r.returncode == 0, r.stderr
        assert "3 spans on 2 rows" in r.stdout
        assert "attributed Ws by phase" in r.stdout
    r = _report("--trace", str(jsonl), "--json")
    assert r.returncode == 0
    doc = json.loads(r.stdout)
    assert doc["spans"] == 3 and doc["nodes"] == ["n0", "n1"]
    assert doc["attributed_ws"] == pytest.approx(1.75)


# ---------------------------------------------------------------------------
# The traced consolidate-and-gate fleet run, and its twin
# ---------------------------------------------------------------------------

def _gate_fleet(mod, nodes):
    planner = mod.FleetPowerPlanner(policy=mod.PowerPlanPolicy(
        mode="gate", slo_queue_depth=4.0, plan_every=4, min_active=1,
        min_active_steps=20, horizon_steps=32.0,
        states=mod.PowerStatePolicy(gate_watts=2.0, boot_energy_ws=1.0,
                                    warmup_steps=4, cooldown_steps=8)))
    return mod.FleetScheduler(
        nodes, policy=mod.FleetPolicy(flush_every=4, checkpoint_every=8,
                                      migrate_on_drift=False),
        planner=planner)


def _diurnal(make):
    dues = list(range(1, 9)) + list(range(160, 196, 3))
    return [(due, make(rid, tenant=f"t{rid % 2}", max_new=8))
            for rid, due in enumerate(dues)]


def test_traced_gate_run_covers_lifecycle_and_conserves_joules(tmp_path):
    tracer, metrics = obs.enable()
    try:
        nodes = [sim_envelope_node(f"n{i}", slots=2, step_s=TICK)
                 for i in range(3)]
        sched = _gate_fleet(pfleet, nodes)
        assert len(sched.run(arrivals=_diurnal(_req), max_steps=2000)) == 20
        names = {sp.name for sp in tracer.spans}
        for needed in ("fleet.submit", "fleet.route", "fleet.step",
                       "fleet.flush", "sim.decode", "sim.idle",
                       "power.plan", "power.gated", "power.wake",
                       "power.probation", "power.canary"):
            assert needed in names, sorted(names)
        by_id = {sp.span_id: sp for sp in tracer.spans}
        canaries = [sp for sp in tracer.spans if sp.name == "power.canary"]
        assert canaries
        for c in canaries:
            parent = by_id[c.parent_id]
            assert parent.name == "power.probation" and parent.node == c.node
        result = attribute_joules(list(tracer.spans), sched.ledger)
        rows = result.conservation(sched.ledger, tol=1e-6)
        assert set(rows) == {n.name for n in nodes}
        assert all(r["ok"] for r in rows.values()), rows
        assert not result.synthesized
        text = metrics.to_prometheus()
        for needed in ('queue_wait_s{quantile="0.99"}',
                       "routing_candidates_bucket", "placement_events_total",
                       "fleet_steps_total"):
            assert needed in text
        trace, prom = tmp_path / "gate.json", tmp_path / "gate.prom"
        write_chrome_trace(result.all_spans(), trace)
        metrics.write_prometheus(prom)
        r = _report("--trace", str(trace), "--metrics", str(prom))
        assert r.returncode == 0, r.stderr
        assert "attributed Ws by phase" in r.stdout
        assert 'queue_wait_s{quantile="0.99"}' in r.stdout
    finally:
        obs.disable()


def test_traced_gate_run_twin(tmp_path):
    """The same traced run through both packages: identical spans (every
    field, attributed Ws included, on a shared fake clock), identical
    exported files and identical Prometheus text."""
    runs = []
    for mod_obs, mod_fleet, node, make in (
            (obs, pfleet,
             lambda i: sim_envelope_node(f"n{i}", slots=2, step_s=TICK),
             _req),
            (jobs, jfleet,
             lambda i: j_sim_envelope_node(f"n{i}", envelope=_j_env(),
                                           slots=2, step_s=TICK),
             _jreq)):
        tracer, metrics = mod_obs.enable(clock=FakeClock())
        try:
            sched = _gate_fleet(mod_fleet, [node(i) for i in range(3)])
            sched.run(arrivals=_diurnal(make), max_steps=2000)
            result = mod_obs.attribute_joules(list(tracer.spans),
                                              sched.ledger)
            runs.append(([sp.to_dict() for sp in result.all_spans()],
                         metrics.to_prometheus(), result, mod_obs))
        finally:
            mod_obs.disable()
    (spans, text, result, _), (jspans, jtext, jresult, _) = runs
    assert len(spans) > 100
    assert spans == pytest.approx(jspans, rel=1e-9, abs=1e-12)
    assert [s["name"] for s in spans] == [s["name"] for s in jspans]
    assert text == jtext
    obs.write_spans_jsonl(result.all_spans(), tmp_path / "p.jsonl")
    jobs.write_spans_jsonl(jresult.all_spans(), tmp_path / "r.jsonl")
    got = [json.loads(x) for x in (tmp_path / "p.jsonl").read_text()
           .splitlines()]
    want = [json.loads(x) for x in (tmp_path / "r.jsonl").read_text()
            .splitlines()]
    assert got == pytest.approx(want, rel=1e-9, abs=1e-12)


# ---------------------------------------------------------------------------
# Property tests (mirrors tests/test_obs_invariants.py)
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

_TREES = st.recursive(st.just([]), lambda kids: st.lists(kids, max_size=3),
                      max_leaves=12)
_STEPS = st.floats(min_value=0.0, max_value=10.0, allow_nan=False,
                   allow_infinity=False)
_VALUES = st.lists(st.floats(min_value=0.0, max_value=1e3, allow_nan=False,
                             allow_infinity=False), min_size=0, max_size=30)


@settings(max_examples=60, deadline=None)
@given(tree=_TREES, step=_STEPS)
def test_context_managed_children_nest_inside_parents(tree, step):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]

    tr = Tracer(clock=clock)

    def walk(children):
        for kids in children:
            with tr.span("n"):
                walk(kids)

    with tr.span("root"):
        walk(tree)
    by_id = {sp.span_id: sp for sp in tr.spans}
    assert all(not sp.open for sp in tr.spans)
    for sp in tr.spans:
        if sp.parent_id is not None:
            assert by_id[sp.parent_id].contains(sp)


def _hist(values):
    h = Histogram("h")
    for v in values:
        h.observe(v)
    return h


@settings(max_examples=60, deadline=None)
@given(a=_VALUES, b=_VALUES, c=_VALUES)
def test_histogram_merge_associative_commutative_exact(a, b, c):
    whole = _hist(a + b + c)
    left = Histogram.merged(Histogram.merged(_hist(a), _hist(b)), _hist(c))
    right = Histogram.merged(_hist(a), Histogram.merged(_hist(b), _hist(c)))
    for m in (left, right):
        assert m.counts == whole.counts and m.count == whole.count
        assert m.sum == pytest.approx(whole.sum, rel=1e-9, abs=1e-9)
    assert Histogram.merged(_hist(b), _hist(a)).counts == \
        Histogram.merged(_hist(a), _hist(b)).counts


@settings(max_examples=60, deadline=None)
@given(values=_VALUES,
       qs=st.lists(st.floats(min_value=0.0, max_value=1.0, allow_nan=False),
                   min_size=2, max_size=8))
def test_histogram_quantiles_monotone_in_q(values, qs):
    h = _hist(values)
    estimates = [h.quantile(q) for q in sorted(qs)]
    assert all(lo <= hi for lo, hi in zip(estimates, estimates[1:]))
    assert all(e >= 0.0 for e in estimates)


@settings(max_examples=20, deadline=None)
@given(bursts=st.lists(st.tuples(st.integers(min_value=0, max_value=200),
                                 st.integers(min_value=1, max_value=6)),
                       min_size=1, max_size=4))
def test_attribution_conserves_total_ws_under_any_script(bursts):
    tracer, _ = obs.enable()
    try:
        nodes = [sim_envelope_node(f"n{i}", slots=2, step_s=TICK)
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
                arrivals.append((start + i, _req(rid, tenant=f"t{rid % 2}",
                                                 max_new=3)))
                rid += 1
        sched.run(arrivals=arrivals, max_steps=600)
        result = attribute_joules(list(tracer.spans), sched.ledger)
        rows = result.conservation(sched.ledger, tol=1e-6)
        assert rows and all(r["ok"] for r in rows.values()), rows
        assert not result.synthesized
        assert result.attributed_by_node().get("fleet", 0.0) == 0.0
    finally:
        obs.disable()

"""The port's vectorized fleet engines against the JAX package's.

Mirrors ``tests/test_fleet_vector.py``, ``tests/test_fleet_vector_invariants.py``,
``tests/test_fleet_segment.py`` and ``tests/test_fleet_shard.py`` on the
port's classes, and holds each port engine equal to its reference twin on
the same ``VectorArrivals`` script: the stepped ``VectorFleet`` (serve and
sim loop models), the numpy ``SegmentFleet`` and the ``ShardedSegmentFleet``
must give the reference's placement events, finished sets and tokens, and
ledgers equal bit for bit (each engine is a numpy copy, op for op).  The
torch booking plane on the CPU is held to the numpy one within rtol 1e-12
(a sum over a chunk reorders additions; ``test_torch_fleet_backend.py``
holds it to the reference's jax plane).  Both packages meter at one
envelope, the R740 node point built in each.
"""
import numpy as np
import pytest

from repro import fleet as jfleet
from repro.core.power import R740_ARRIA10 as J_R740
from repro.telemetry import WsBudget as JWsBudget
from repro.telemetry import node_envelope as j_node_envelope
from repro_torch import fleet as pfleet
from repro_torch import obs
from repro_torch.core.power import R740_ARRIA10
from repro_torch.fleet import (AdmissionController, FleetPolicy,
                               PowerPlanPolicy, PowerStatePolicy,
                               SegmentFleet, ShardedSegmentFleet,
                               VectorArrivals, VectorFleet, VectorNodeSpec)
from repro_torch.telemetry import WsBudget, node_envelope

TICK = 0.004
MAX_STEPS = 400


def _dues():
    """Two bursts around a long trough, then a dense re-admission burst:
    long quiet stretches, gates during the trough, boot + canary wakes in
    the second burst (the reference's segment and shard script)."""
    return (list(range(1, 7)) + list(range(120, 138, 3))
            + [200 + k // 3 for k in range(18)])


def _arrivals(pkg, dues=None, plen=5):
    dues = _dues() if dues is None else dues
    n = len(dues)
    return pkg.VectorArrivals(
        due=dues, tenant_idx=[i % 2 for i in range(n)],
        prompt_len=[plen] * n, max_new=[3 + i % 4 for i in range(n)],
        tenant_names=["team0", "team1"])


def _build(pkg, cls, n_nodes=3, slots=2, planned=True, admitted=True,
           loop_model="serve", heterogeneous=False, accelerated=False,
           **kw):
    """One engine of ``pkg`` (the port's or the reference's fleet module)
    over the shared test config."""
    ported = pkg is pfleet
    env = (node_envelope(R740_ARRIA10, accelerated=accelerated) if ported
           else j_node_envelope(J_R740, accelerated=accelerated))
    budget = WsBudget if ported else JWsBudget
    policy = pkg.FleetPolicy(flush_every=4, checkpoint_every=8,
                             router="energy", migrate_on_drift=False)
    ppol = pkg.PowerPlanPolicy(
        mode="gate", slo_queue_depth=4.0, plan_every=4, min_active=1,
        min_active_steps=20, horizon_steps=32.0,
        states=pkg.PowerStatePolicy(gate_watts=3.0, boot_energy_ws=2.0,
                                    warmup_steps=4, cooldown_steps=8)) \
        if planned else None
    specs = [pkg.VectorNodeSpec(
                 f"n{i}", env, slots=(1 + i % 3) if heterogeneous else slots,
                 step_s=TICK)
             for i in range(n_nodes)]
    adm = pkg.AdmissionController(
        {"team0": budget(budget_ws=12.0, window_steps=0)}) \
        if admitted else None
    return getattr(pkg, cls)(specs, policy=policy, plan=ppol, admission=adm,
                             loop_model=loop_model, **kw)


def _events(fleet):
    return [(e.step, e.detected_step, e.node, e.action, e.reason,
             tuple(e.moved_rids), e.active_target) for e in fleet.events]


def _tokens(fleet):
    return {r["rid"]: r["tokens"] for r in fleet.results() if r["finished"]}


def _cells(led):
    return {k: (v.ws, v.seconds, v.count, v.peak_w)
            for k, v in led.cells.items()}


def assert_bitwise(a, b, fin_a, fin_b):
    """Events, finished set, tokens, steps and every ledger number equal."""
    assert fin_b == fin_a
    assert b.steps == a.steps
    assert _events(b) == _events(a)
    assert _tokens(b) == _tokens(a)
    assert b.ledger.total_ws == a.ledger.total_ws
    assert _cells(b.ledger) == _cells(a.ledger)
    assert {k: (v.ws, v.seconds, v.count, v.peak_w)
            for k, v in b.ledger.phases.items()} == \
        {k: (v.ws, v.seconds, v.count, v.peak_w)
         for k, v in a.ledger.phases.items()}
    assert b.ledger.nodes == a.ledger.nodes


def assert_close(a, b, fin_a, fin_b, rtol):
    """Events, finished set and tokens equal; integer counts exact; every
    float of the ledger within ``rtol``."""
    assert fin_b == fin_a
    assert b.steps == a.steps
    assert _events(b) == _events(a)
    assert _tokens(b) == _tokens(a)
    assert b.ledger.total_ws == pytest.approx(a.ledger.total_ws, rel=rtol)
    assert set(b.ledger.cells) == set(a.ledger.cells)
    for key, ca in a.ledger.cells.items():
        cb = b.ledger.cells[key]
        assert cb.count == ca.count, key
        for x, y in ((cb.ws, ca.ws), (cb.seconds, ca.seconds),
                     (cb.peak_w, ca.peak_w)):
            assert x == pytest.approx(y, rel=rtol, abs=1e-300), key
    for ph, pa in a.ledger.phases.items():
        pb = b.ledger.phases[ph]
        assert pb.count == pa.count
        assert pb.ws == pytest.approx(pa.ws, rel=rtol)
        assert pb.peak_w == pa.peak_w
    for node, ws in a.ledger.nodes.items():
        assert b.ledger.nodes[node] == pytest.approx(ws, rel=rtol)


def _run(fleet, arrivals, max_steps=MAX_STEPS):
    return fleet.run(arrivals, max_steps=max_steps)


# ---------------------------------------------------------------------------
# Each port engine against its reference twin
# ---------------------------------------------------------------------------

TWINS = {
    "vector-serve": ("VectorFleet", dict(loop_model="serve")),
    "vector-sim": ("VectorFleet", dict(loop_model="sim", admitted=False)),
    "seg-serve": ("SegmentFleet", dict(backend="numpy")),
    "seg-sim": ("SegmentFleet", dict(loop_model="sim", admitted=False,
                                     backend="numpy")),
    "shard-1": ("ShardedSegmentFleet", dict(shards=1, parallel="inline")),
    "shard-2": ("ShardedSegmentFleet", dict(shards=2, parallel="inline")),
    "shard-3-hetero": ("ShardedSegmentFleet",
                       dict(shards=3, parallel="inline", heterogeneous=True,
                            n_nodes=5)),
}


@pytest.mark.parametrize("twin", sorted(TWINS))
def test_port_engine_twins_the_reference_bit_for_bit(twin):
    cls, kw = TWINS[twin]
    ref = _build(jfleet, cls, **kw)
    fin_ref = _run(ref, _arrivals(jfleet))
    got = _build(pfleet, cls, **kw)
    fin = _run(got, _arrivals(pfleet))
    if kw.get("loop_model", "serve") == "serve" and kw.get("admitted", True):
        assert any(e.action == "gate" for e in ref.events)
        assert any(e.action == "wake" for e in ref.events)
        assert ref.admission.rejections
        assert [r.rid for r in got.admission.rejections] == \
            [r.rid for r in ref.admission.rejections]
    assert_bitwise(ref, got, fin_ref, fin)
    want, have = ref.results(), got.results()
    assert have == want


def test_torch_booking_plane_twins_the_numpy_plane():
    """The port's segment engine with its booking plane folded by torch
    on the CPU against the same engine booking eagerly in numpy: the same
    control flow, the ledger within rtol 1e-12 (the reference's jax plane
    is held the same way in tests/test_torch_fleet_backend.py)."""
    ref = _build(pfleet, "SegmentFleet", backend="numpy")
    fin_ref = _run(ref, _arrivals(pfleet))
    got = _build(pfleet, "SegmentFleet", backend="torch", device="cpu")
    fin = _run(got, _arrivals(pfleet))
    assert (got.summary()["engine"], got.summary()["device"]) == \
        ("vector-torch", "cpu")
    assert_close(ref, got, fin_ref, fin, rtol=1e-12)


def test_diurnal_stream_twins_at_scale():
    """A denser seeded diurnal stream over 16 nodes: the port's segment,
    shard and torch engines against the reference's segment engine."""
    arr = dict(n=3000, tenants=3, hours=24, steps_per_hour=40, max_new=6,
               seed=5)
    ref = _build(jfleet, "SegmentFleet", n_nodes=16, admitted=False)
    fin_ref = ref.run(jfleet.VectorArrivals.diurnal(**arr), max_steps=3000)
    seg = _build(pfleet, "SegmentFleet", n_nodes=16, admitted=False)
    fin_seg = seg.run(VectorArrivals.diurnal(**arr), max_steps=3000)
    assert_bitwise(ref, seg, fin_ref, fin_seg)
    shd = _build(pfleet, "ShardedSegmentFleet", n_nodes=16, admitted=False,
                 shards=4, parallel="inline")
    assert_bitwise(ref, shd, fin_ref,
                   shd.run(VectorArrivals.diurnal(**arr), max_steps=3000))
    tch = _build(pfleet, "SegmentFleet", n_nodes=16, admitted=False,
                 backend="torch", device="cpu")
    assert_close(ref, tch, fin_ref,
                 tch.run(VectorArrivals.diurnal(**arr), max_steps=3000),
                 rtol=1e-12)


# ---------------------------------------------------------------------------
# The port's engines against each other (the reference's own contracts)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("loop_model", ["serve", "sim"])
def test_segment_twins_the_stepped_engine(backend, loop_model):
    admitted = loop_model == "serve"
    dev = dict(device="cpu") if backend == "torch" else {}
    ref = _build(pfleet, "VectorFleet", loop_model=loop_model,
                 admitted=admitted)
    fin_ref = _run(ref, _arrivals(pfleet))
    seg = _build(pfleet, "SegmentFleet", loop_model=loop_model,
                 admitted=admitted, backend=backend, **dev)
    assert_close(ref, seg, fin_ref, _run(seg, _arrivals(pfleet)), rtol=1e-9)


def test_max_steps_caps_mid_stretch():
    dues = [0, 1000]
    ref = _build(pfleet, "VectorFleet", planned=False, admitted=False)
    fin_ref = ref.run(_arrivals(pfleet, dues), max_steps=100)
    seg = _build(pfleet, "SegmentFleet", planned=False, admitted=False)
    fin_seg = seg.run(_arrivals(pfleet, dues), max_steps=100)
    assert seg.steps == ref.steps == 100
    assert_close(ref, seg, fin_ref, fin_seg, rtol=1e-9)


def test_queue_ring_grows_past_initial_capacity():
    dues = [0] * 20
    ref = _build(pfleet, "VectorFleet", n_nodes=1, slots=1, planned=False,
                 admitted=False)
    fin_ref = ref.run(_arrivals(pfleet, dues), max_steps=300)
    seg = _build(pfleet, "SegmentFleet", n_nodes=1, slots=1, planned=False,
                 admitted=False)
    fin_seg = seg.run(_arrivals(pfleet, dues), max_steps=300)
    assert len(fin_seg) == 20
    assert_close(ref, seg, fin_ref, fin_seg, rtol=1e-9)


def test_process_mode_matches_inline_bitwise():
    a = _build(pfleet, "ShardedSegmentFleet", shards=2, parallel="inline")
    fin_a = _run(a, _arrivals(pfleet))
    b = _build(pfleet, "ShardedSegmentFleet", shards=2, parallel="process")
    assert_bitwise(a, b, fin_a, _run(b, _arrivals(pfleet)))


def test_shared_memory_lifecycle_cleanup(monkeypatch):
    shd = _build(pfleet, "ShardedSegmentFleet", shards=2, parallel="process")
    captured = []
    orig = ShardedSegmentFleet._make_accumulator

    def spy(self):
        acc = orig(self)
        captured.append(acc)
        return acc

    monkeypatch.setattr(ShardedSegmentFleet, "_make_accumulator", spy)
    _run(shd, _arrivals(pfleet))
    (acc,) = captured
    assert acc._closed
    assert acc._shms == [] and acc._parts == []
    for p in acc._procs:
        p.join(timeout=5.0)
        assert not p.is_alive()
    acc.close()                         # idempotent


def test_more_shards_than_nodes_clamps():
    shd = _build(pfleet, "ShardedSegmentFleet", n_nodes=3, shards=8,
                 parallel="inline")
    assert shd._shards == 3
    seg = _build(pfleet, "SegmentFleet", n_nodes=3)
    assert_bitwise(seg, shd, _run(seg, _arrivals(pfleet)),
                   _run(shd, _arrivals(pfleet)))


def test_summaries_name_the_engine():
    shd = _build(pfleet, "ShardedSegmentFleet", shards=2, parallel="inline")
    _run(shd, _arrivals(pfleet))
    doc = shd.summary()
    assert (doc["engine"], doc["shards"], doc["parallel"]) == \
        ("vector-shard", 2, "inline")
    assert doc["dispatch_s"] >= doc["route_s"] >= 0.0
    seg = _build(pfleet, "SegmentFleet")
    _run(seg, _arrivals(pfleet))
    assert (seg.summary()["engine"], seg.summary()["backend_effective"]) \
        == ("vector-seg", "numpy")
    vec = _build(pfleet, "VectorFleet")
    _run(vec, _arrivals(pfleet))
    assert vec.summary()["engine"] == "vector"


# ---------------------------------------------------------------------------
# Guardrails and the arrival streams
# ---------------------------------------------------------------------------

def test_constructors_refuse_what_the_engines_do_not_run():
    spec = VectorNodeSpec("n0", node_envelope(R740_ARRIA10))
    with pytest.raises(ValueError, match="drift migration"):
        VectorFleet([spec], policy=FleetPolicy(migrate_on_drift=True))
    with pytest.raises(ValueError, match="loop_model"):
        VectorFleet([spec], loop_model="warp")
    with pytest.raises(ValueError, match="unique"):
        VectorFleet([spec, spec])
    with pytest.raises(ValueError, match="backend"):
        SegmentFleet([spec], backend="jax")
    with pytest.raises(ValueError, match="shards"):
        ShardedSegmentFleet([spec], shards=0)
    with pytest.raises(ValueError, match="parallel"):
        ShardedSegmentFleet([spec], parallel="threads")


def test_vector_run_is_single_shot():
    vec = _build(pfleet, "VectorFleet", planned=False, admitted=False)
    _run(vec, _arrivals(pfleet, [0]))
    with pytest.raises(RuntimeError, match="single-shot"):
        _run(vec, _arrivals(pfleet, [0]))


def test_arrivals_must_be_sorted_and_non_negative():
    kw = dict(tenant_idx=[0, 0], prompt_len=[3, 3], max_new=[2, 2],
              tenant_names=["t"])
    with pytest.raises(ValueError, match="non-decreasing"):
        VectorArrivals(due=[5, 1], **kw)
    with pytest.raises(ValueError, match=">= 0"):
        VectorArrivals(due=[-1, 1], **kw)


@pytest.mark.parametrize("stream", ["synth", "diurnal"])
def test_synthetic_streams_equal_the_references(stream):
    kw = dict(tenants=3, seed=3, max_new=6)
    a = getattr(VectorArrivals, stream)(5000, **kw)
    b = getattr(jfleet.VectorArrivals, stream)(5000, **kw)
    for f in ("due", "tenant_idx", "prompt_len", "max_new", "rid",
              "tokens_done"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.tenant_names == b.tenant_names
    assert np.all(a.due[:-1] <= a.due[1:])
    if stream == "diurnal":
        counts = np.bincount((a.due // 2000).astype(np.int64), minlength=24)
        assert counts[2] < counts[10] and counts[2] < counts[18]
        with pytest.raises(ValueError, match="hour weights"):
            VectorArrivals.diurnal(100, profile=(1, 2, 3))


def test_from_requests_equals_the_references():
    from repro.serve.engine import Request as JRequest
    from repro_torch.serve.engine import Request
    dues = [4, 0, 9, 4]

    def script(req_cls):
        return [(d, req_cls(rid=10 + i, prompt=np.full(2 + i, 2, np.int32),
                            max_new=3 + i, tenant=f"t{i % 2}"))
                for i, d in enumerate(dues)]
    a = VectorArrivals.from_requests(script(Request))
    b = jfleet.VectorArrivals.from_requests(script(JRequest))
    for f in ("due", "tenant_idx", "prompt_len", "max_new", "rid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.tenant_names == b.tenant_names
    with pytest.raises(ValueError, match="mixed arrival semantics"):
        VectorArrivals.from_requests([Request(rid=0, prompt=np.ones(2),
                                              max_new=2),
                                      (2, Request(rid=1, prompt=np.ones(2),
                                                  max_new=2))])


def test_route_clamps_nonfinite_marginal():
    """A NaN power draw loses ties deterministically (the router's
    non-finite clamp), as in the reference."""
    env = node_envelope(R740_ARRIA10)
    vec = VectorFleet([VectorNodeSpec("broken", env, slots=2, step_s=TICK,
                                      source_watts=float("nan")),
                       VectorNodeSpec("ok", env, slots=2, step_s=TICK,
                                      source_watts=40.0)],
                      policy=FleetPolicy(migrate_on_drift=False),
                      loop_model="sim")
    assert vec.run(_arrivals(pfleet, [0]), max_steps=50) == [0]
    assert vec.results()[0]["node"] == "ok"


def test_fleet_scale_smoke():
    """A scaled-down fleet_scale: the synthetic stream drains, every
    request finishes, the planner acts, and the rollups sum to the total."""
    env = node_envelope(R740_ARRIA10, accelerated=True)
    specs = [VectorNodeSpec(f"pod{i:02d}", env, slots=4, step_s=0.004,
                            max_seq=64) for i in range(16)]
    ppol = PowerPlanPolicy(
        mode="gate", slo_queue_depth=4.0, plan_every=16, min_active=2,
        min_active_steps=32, horizon_steps=64.0,
        states=PowerStatePolicy(gate_watts=3.0, boot_energy_ws=2.0,
                                warmup_steps=4, cooldown_steps=8))
    arr = VectorArrivals.synth(2000, tenants=4, mean_gap_steps=0.5,
                               max_new=8, seed=7)
    vec = SegmentFleet(specs, policy=FleetPolicy(flush_every=8,
                                                 checkpoint_every=16,
                                                 migrate_on_drift=False),
                       plan=ppol, loop_model="serve")
    fin = vec.run(arr, max_steps=20_000)
    assert len(fin) == 2000
    assert vec.steps < 20_000
    assert vec.events
    roll = vec.ledger.rollup("phase")
    assert sum(pe.ws for pe in roll.values()) == \
        pytest.approx(vec.total_ws, rel=1e-9)
    bills = sum(r["prefill_ws"] + r["decode_ws"] for r in vec.results())
    infra = vec.ledger.rollup("tenant")["fleet"].ws
    assert bills + infra == pytest.approx(vec.total_ws, rel=1e-9)


def test_vector_obs_edges_aggregate_and_conserve():
    obs.enable()
    try:
        vec = _build(pfleet, "VectorFleet", loop_model="sim",
                     admitted=False, planned=False, n_nodes=2)
        fin = _run(vec, _arrivals(pfleet))
        assert fin
        result = obs.attribute_joules(list(obs.TRACER.spans), vec.ledger)
        for row in result.conservation(vec.ledger).values():
            assert row["ok"], row
        assert obs.METRICS.counter("arrivals_total").value == len(_dues())
        assert obs.METRICS.counter("fleet_steps_total").value == vec.steps
        assert obs.METRICS.histogram("queue_wait_s").count > 0
    finally:
        obs.disable()


def test_admission_twins_the_reference():
    """A tight budget throttles the same submits in both packages, with
    zero Ws booked for them."""
    ref = _build(jfleet, "SegmentFleet")
    ref.admission = jfleet.AdmissionController(
        {"team0": JWsBudget(budget_ws=5.0, window_steps=0)})
    got = _build(pfleet, "SegmentFleet")
    got.admission = AdmissionController(
        {"team0": WsBudget(budget_ws=5.0, window_steps=0)})
    fin_ref = _run(ref, _arrivals(jfleet))
    fin = _run(got, _arrivals(pfleet))
    rej = [r.rid for r in got.admission.rejections]
    assert rej and rej == [r.rid for r in ref.admission.rejections]
    assert all(r["prefill_ws"] == r["decode_ws"] == 0.0
               for r in got.results() if r["rid"] in rej)
    assert_bitwise(ref, got, fin_ref, fin)

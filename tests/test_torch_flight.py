"""The port's flight recorder against the JAX package's ``repro.obs.flight``.

Mirrors ``tests/test_obs_flight.py``: the head sampler picks the same rids
as the reference's (splitmix64, no RNG state), the self-profiler and the
JSONL flight log match it, turning the recorder on moves no ledger bit in
the port's engines, and on one arrival script the port's engines record
the reference's snapshot rows and sampled request trees and write the same
flight log, which the reference's ``scripts/trace_report.py --flight``
renders.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro import fleet as jfleet
from repro import obs as jobs
from repro.obs.flight import _hash64 as j_hash64
from repro_torch import fleet as pfleet
from repro_torch import obs
from repro_torch.obs import (SNAPSHOT_FIELDS, FlightRecorder, NullFlight,
                             PhaseProfiler, Tracer, read_flight_jsonl)
from repro_torch.obs.flight import _hash64
from test_torch_fleet_vector import _arrivals, _build

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


# ---------------------------------------------------------------------------
# Head sampler
# ---------------------------------------------------------------------------

def test_sampler_rate_edges_and_validation():
    none = FlightRecorder(sample_rate=0.0)
    every = FlightRecorder(sample_rate=1.0)
    rids = np.arange(512, dtype=np.int64)
    assert not any(none.sampled(r) for r in range(512))
    assert all(every.sampled(r) for r in range(512))
    assert not none.sample_mask(rids).any()
    assert every.sample_mask(rids).all()
    assert none.sampling and not every.sampling
    with pytest.raises(ValueError):
        FlightRecorder(sample_rate=1.5)
    with pytest.raises(ValueError):
        FlightRecorder(sample_rate=-0.1)


@pytest.mark.parametrize("rate", [1e-3, 0.01, 0.1, 0.5, 0.9])
def test_sampler_picks_the_references_rids(rate):
    rng = np.random.default_rng(11)
    rids = np.concatenate([np.arange(4000),
                           rng.integers(0, 2**62, size=2000)])
    fl, jfl = FlightRecorder(sample_rate=rate), \
        jobs.FlightRecorder(sample_rate=rate)
    mask = fl.sample_mask(rids)
    np.testing.assert_array_equal(mask, jfl.sample_mask(rids))
    assert mask.tolist() == [fl.sampled(int(r)) for r in rids]
    assert [fl.sampled(int(r)) for r in rids[:500]] == \
        [jfl.sampled(int(r)) for r in rids[:500]]


def test_sampler_is_deterministic_and_monotone_in_rate():
    rids = range(4000)
    lo = {r for r in rids if FlightRecorder(sample_rate=0.05).sampled(r)}
    hi = {r for r in rids if FlightRecorder(sample_rate=0.5).sampled(r)}
    assert lo and lo < hi
    assert lo == {r for r in rids
                  if FlightRecorder(sample_rate=0.05).sampled(r)}
    assert _hash64(0) == j_hash64(0) == 0xE220A8397B1DCDAF
    assert _hash64(1) == j_hash64(1) == 0x910A2DEC89025CC1
    assert all(_hash64(x) == j_hash64(x) for x in (2**63, 2**64 - 1, 12345))


# ---------------------------------------------------------------------------
# PhaseProfiler, the null recorder and the flight log
# ---------------------------------------------------------------------------

def test_phase_profiler_matches_the_reference():
    a, b = PhaseProfiler(), PhaseProfiler()
    ja, jb = jobs.PhaseProfiler(), jobs.PhaseProfiler()
    for prof, other in ((a, b), (ja, jb)):
        prof.add("dispatch", 0.5, 10)
        prof.add("dispatch", 0.25, 5)
        other.add("dispatch", 1.0, 1)
        other.add("route", 0.125, 7)
        prof.merge(other)
    assert a.to_dict() == ja.to_dict()
    assert a.to_dict()["phases"]["dispatch"] == {"seconds": 1.75,
                                                 "count": 16}


def test_null_flight_and_set_flight():
    assert isinstance(obs.FLIGHT, NullFlight) and not obs.FLIGHT.enabled
    assert obs.FLIGHT.sample_mask(np.arange(3)).all()
    fl = obs.set_flight(FlightRecorder(sample_rate=0.5, snapshot_every=4))
    assert obs.FLIGHT is fl and fl.enabled and fl.sampling
    obs.disable()
    assert isinstance(obs.FLIGHT, NullFlight)
    assert SNAPSHOT_FIELDS == jobs.SNAPSHOT_FIELDS


def test_flight_log_roundtrip_matches_the_reference(tmp_path):
    rows = [{"t": 5, "aggregate_watts": 12.0, "active_nodes": 3},
            {"t": 10, "aggregate_watts": 9.0, "active_nodes": 2}]
    fl, jfl = FlightRecorder(snapshot_every=5), \
        jobs.FlightRecorder(snapshot_every=5)
    for row in rows:
        fl.record(dict(row))
        jfl.record(dict(row))
    path = fl.write_jsonl(tmp_path / "flight.jsonl")
    jpath = jfl.write_jsonl(tmp_path / "jflight.jsonl")
    assert Path(path).read_bytes() == Path(jpath).read_bytes()
    assert read_flight_jsonl(path) == rows
    Path(path).write_text(json.dumps(rows[0]) + '\n{"t": 10, "ag')
    assert read_flight_jsonl(path) == [rows[0]]
    assert read_flight_jsonl(tmp_path / "never-written.jsonl") == []
    null = NullFlight().write_jsonl(tmp_path / "null.jsonl")
    assert Path(null).read_text() == ""


# ---------------------------------------------------------------------------
# The engines: flight on moves nothing; rows and trees equal the reference's
# ---------------------------------------------------------------------------

ENGINES = {"seg": ("SegmentFleet", dict(backend="numpy")),
           "torch": ("SegmentFleet", dict(backend="torch", device="cpu")),
           "shard": ("ShardedSegmentFleet", dict(shards=2,
                                                 parallel="inline")),
           "vector": ("VectorFleet", {})}


def _state(fleet, finished):
    cells = {k: (v.ws, v.seconds, v.count)
             for k, v in fleet.ledger.cells.items()}
    events = [(e.step, e.node, e.action, tuple(e.moved_rids))
              for e in fleet.events]
    return cells, events, finished, fleet.total_ws


@pytest.mark.parametrize("engine", ["seg", "torch", "shard"])
def test_flight_recorder_does_not_move_the_ledger(engine):
    cls, kw = ENGINES[engine]
    off = _build(pfleet, cls, admitted=False, **kw)
    base = _state(off, off.run(_arrivals(pfleet), max_steps=3000))
    obs.set_tracer(Tracer())
    fl = obs.set_flight(FlightRecorder(sample_rate=0.3, snapshot_every=10))
    on = _build(pfleet, cls, admitted=False, **kw)
    assert _state(on, on.run(_arrivals(pfleet), max_steps=3000)) == base
    rows = fl.snapshots
    assert rows and all(set(SNAPSHOT_FIELDS) <= set(r) for r in rows)
    ts = [r["t"] for r in rows]
    assert ts == sorted(ts) and len(set(ts)) == len(ts)
    cum = [r["cumulative_ws"] for r in rows]
    assert all(b >= a for a, b in zip(cum, cum[1:]))
    assert 0.0 < cum[-1] <= on.total_ws * (1 + 1e-9)
    assert rows[-1]["t"] == on.steps
    prof = on.summary()["profile"]["phases"]
    assert {"dispatch", "book", "flush"} <= set(prof)


def _flight_run(pkg, o, engine, rate, tmp_path):
    """One engine of ``pkg`` under a live recorder of the ``o`` package:
    returns the rows, the sampled spans' (name, node, rid, t0, t1, ws)
    and the flight log's bytes."""
    cls, kw = ENGINES[engine]
    if pkg is jfleet:
        kw = {k: v for k, v in kw.items() if k != "device"}
        if kw.get("backend") == "torch":
            kw["backend"] = "numpy"
    o.set_tracer(o.Tracer())
    fl = o.set_flight(o.FlightRecorder(sample_rate=rate, snapshot_every=10,
                                       log_path=tmp_path / f"{id(o)}.jsonl"))
    try:
        fleet = _build(pkg, cls, **kw)
        fleet.run(_arrivals(pkg), max_steps=3000)
        spans = sorted((sp.name, sp.node, sp.tags.get("rid"), sp.t0, sp.t1,
                        sp.tags.get("ws")) for sp in o.TRACER.spans
                       if sp.tags.get("sampled"))
        path = fl.write_jsonl()
        return fl.snapshots, spans, Path(path).read_bytes(), fl.population
    finally:
        o.disable()


@pytest.mark.parametrize("engine", ["seg", "shard", "vector"])
def test_flight_rows_and_sampled_trees_equal_the_references(engine,
                                                            tmp_path):
    got = _flight_run(pfleet, obs, engine, 0.4, tmp_path)
    want = _flight_run(jfleet, jobs, engine, 0.4, tmp_path)
    assert got[0] == want[0]                    # snapshot rows
    assert got[1] == want[1] and got[1]         # sampled request trees
    assert got[2] == want[2]                    # the JSONL bytes
    assert got[3] == want[3]                    # the energy envelope


def test_sampled_tracing_emits_trees_and_scale_up_is_bounded():
    obs.set_tracer(Tracer())
    fl = obs.set_flight(FlightRecorder(sample_rate=0.5))
    fleet = _build(pfleet, "SegmentFleet", admitted=False, backend="numpy")
    fleet.run(_arrivals(pfleet), max_steps=3000)
    spans = list(obs.TRACER.spans)
    assert fl.sampled_spans > 0
    sampled = [sp for sp in spans if sp.tags.get("sampled")]
    assert {sp.name for sp in sampled} >= {"serve.request"}
    assert fl.population["count"] == len(_arrivals(pfleet))
    sa = obs.attribute_joules_sampled(spans, fleet.ledger, 0.5,
                                      population=fl.population)
    assert sa.ok is True
    assert abs(sa.error_ws) <= sa.error_bound_ws + 1e-9
    assert all(r["ok"] for r in sa.result.conservation(fleet.ledger).values())


def test_trace_report_renders_the_ports_flight_log(tmp_path):
    obs.set_flight(FlightRecorder(snapshot_every=10))
    fleet = _build(pfleet, "SegmentFleet", backend="torch", device="cpu")
    fleet.run(_arrivals(pfleet), max_steps=3000)
    path = obs.FLIGHT.write_jsonl(tmp_path / "flight.jsonl")
    r = subprocess.run([sys.executable, str(SCRIPTS / "trace_report.py"),
                        "--flight", path, "--steps-per-hour", "50"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "flight log:" in r.stdout and "mean_W" in r.stdout

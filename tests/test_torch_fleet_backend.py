"""The port's torch fleet backend against the JAX package's jax backend.

Mirrors ``tests/test_fleet_jax_kernels.py``: the routing argmin and the
Erlang-C queue-depth sweep (``repro_torch.fleet.torch_backend``, stock
torch ops in place of the reference's ``jax.jit`` of stock ops) against
their numpy references and the reference's jax twins, route winners
exactly and queue depths within rtol 1e-9, atol 1e-12; the booking plane
(``TorchAccumulator`` on the CPU) against the reference's
``JaxAccumulator`` on the same records, within rtol 1e-12, NaN watt points
included; the segment engine on either plane; the planner on
``backend="torch"`` making the reference's decisions; and no fallback: a
torch backend with no device and no card raises, without a warning.

The reference reaches for ``jax.experimental.enable_x64``, which this
jax no longer has, so its own jax tests skip here; the ``jax_plane``
fixture hands the reference module jax's ``enable_x64`` context manager
under the old name, and the reference's code then runs unchanged.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fleet as jfleet
from repro.fleet import jax_backend as jb
from repro_torch import fleet as pfleet
from repro_torch.fleet import (ArrivalForecaster, FleetPowerPlanner,
                               PowerPlanPolicy, SegmentFleet,
                               VectorNodeSpec)
from repro_torch.fleet import torch_backend as tb
from repro_torch.fleet.torch_backend import (TorchAccumulator,
                                             expected_queue_depth_many_torch,
                                             route_argmin_np,
                                             route_argmin_torch)
from fleet_sim import sim_envelope_node as j_sim_envelope_node
from test_torch_fleet import _j_env, _jreq, _req, sim_envelope_node
from test_torch_fleet_vector import (_arrivals, _build, assert_bitwise,
                                     assert_close)


@pytest.fixture
def jax_plane(monkeypatch):
    """The reference's jax backend, runnable on this jax."""
    import repro.fleet.segment as jseg
    monkeypatch.setattr(jb, "HAVE_JAX", True)
    monkeypatch.setattr(jb, "jax", jax)
    monkeypatch.setattr(jb, "jnp", jnp)
    monkeypatch.setattr(jb, "enable_x64", lambda: jax.enable_x64(True))
    monkeypatch.setattr(jseg, "HAVE_JAX", True)
    monkeypatch.setattr(jb, "_route_kernel", None)
    monkeypatch.setattr(jb, "_lq_kernels", {})
    return jb


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# ---------------------------------------------------------------------------
# The routing argmin
# ---------------------------------------------------------------------------

def test_route_argmin_np_tie_break_order():
    marg = np.array([3.0, 1.0, 1.0, 1.0])
    load = np.array([0.0, 0.5, 0.25, 0.25])
    rank = np.array([0, 1, 2, 3])
    active = np.ones(4, bool)
    for fn in (route_argmin_np, jb.route_argmin_np):
        assert fn(marg, load, rank, active) == 2
    active[2] = False
    assert route_argmin_np(marg, load, rank, active) == 3
    assert route_argmin_torch(marg, load, rank, active, device="cpu") == 3
    assert route_argmin_np(marg, load, rank, np.zeros(4, bool)) == -1
    assert route_argmin_torch(marg, load, rank, np.zeros(4, bool),
                              device="cpu") == -1
    assert route_argmin_np(np.full(2, np.inf), load[:2], rank[:2],
                           np.ones(2, bool)) == 0
    assert route_argmin_torch(np.full(2, np.inf), load[:2], rank[:2],
                              np.ones(2, bool), device="cpu") == 0


def _route_cases(seed: int, trials: int, n_max: int = 33):
    """Quantized marginals and loads force real tie sets (float-equal
    marginal ties, then load ties); some lanes are +inf, some trials have
    almost nothing active."""
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        n = int(rng.integers(1, n_max))
        marg = rng.integers(0, 4, n) * 0.125
        marg[rng.random(n) < 0.15] = np.inf
        load = rng.integers(0, 3, n) / 2.0
        rank = rng.permutation(n).astype(np.int64)
        active = rng.random(n) < (0.7 if trial % 3 else 0.05)
        yield marg, load, rank, active


def test_route_argmin_torch_matches_np_and_the_references_jax(jax_plane):
    for marg, load, rank, active in _route_cases(7, 60):
        want = jb.route_argmin_np(marg, load, rank, active)
        assert route_argmin_np(marg, load, rank, active) == want
        assert jb.route_argmin_jax(marg, load, rank, active) == want
        assert route_argmin_torch(marg, load, rank, active,
                                  device="cpu") == want


# ---------------------------------------------------------------------------
# The Erlang-C sweep
# ---------------------------------------------------------------------------

def _forecaster(pkg):
    fc = pkg.ArrivalForecaster()
    for t in np.linspace(0.0, 3.0, 40):
        fc.observe(float(t))
    return fc


def test_lq_sweep_torch_matches_numpy_and_the_references_jax(jax_plane):
    fc, jfc = _forecaster(pfleet), _forecaster(jfleet)
    lam = fc.rate(now=3.0)
    assert lam == jfc.rate(now=3.0)
    servers = np.arange(1, 65, dtype=np.int64)
    for service_time in (0.01, 0.2, 2.0, 50.0):
        ref = jfc.expected_queue_depth_many(servers, service_time, now=3.0,
                                            horizon=64.0)
        assert fc.expected_queue_depth_many(
            servers, service_time, now=3.0, horizon=64.0).tolist() == \
            ref.tolist()
        got = expected_queue_depth_many_torch(servers, service_time, lam,
                                              horizon=64.0, device="cpu")
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
        jx = jb.expected_queue_depth_many_jax(servers, service_time, lam,
                                              horizon=64.0)
        np.testing.assert_allclose(got, jx, rtol=1e-9, atol=1e-12)
    assert expected_queue_depth_many_torch(np.zeros(0, np.int64), 0.2, lam,
                                           device="cpu").size == 0


def test_lq_sweep_torch_at_a_fleets_cumulative_slots():
    """The planner's call shape: the candidates are the cumulative slots of
    the ranked nodes (c_max = the fleet's total), over rates from a trough
    to saturation."""
    rng = np.random.default_rng(3)
    slots = np.cumsum(rng.integers(1, 5, 96))
    fc = ArrivalForecaster()
    for lam in (1e-3, 0.5, 5.0, 40.0, 400.0):
        for service in (4.0, 16.0, 64.0):
            got = expected_queue_depth_many_torch(slots, service, lam,
                                                  horizon=64.0,
                                                  device="cpu")
            fc._n, fc._gap_ewma, fc._last_t = 1, 1.0 / lam, 0.0
            want = fc.expected_queue_depth_many(slots, service, now=0.0,
                                                horizon=64.0)
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# The booking plane
# ---------------------------------------------------------------------------

class _Ledger:
    """The slice of a fleet an accumulator folds into."""

    def __init__(self, n: int, t: int):
        self.n = n
        self.tenant_names = [f"t{i}" for i in range(t)]
        self._infra = t - 1
        self._cell_ws = np.zeros((n, t, 4))
        self._cell_s = np.zeros((n, t, 4))
        self._cell_n = np.zeros((n, t, 4), np.int64)
        self._cell_peak = np.zeros((n, t, 4))
        self._phase_ws = np.zeros(4)
        self._phase_s = np.zeros(4)
        self._phase_n = np.zeros(4, np.int64)
        self._phase_peak = np.zeros(4)
        self._node_ws = np.zeros(n)


def _records(seed: int, n: int, t: int, count: int, nan_every: int):
    """Seeded decode/idle records as the segment engine books them: a
    node subset, per-tenant counts, the k of a quiet stretch, a watt point
    per node (now and then NaN)."""
    rng = np.random.default_rng(seed)
    for r in range(count):
        k = int(rng.integers(1, 5))
        bi = np.sort(rng.choice(n, size=int(rng.integers(1, n + 1)),
                                replace=False))
        w = rng.uniform(50.0, 700.0, bi.size)
        if nan_every and r % nan_every == 3:
            w[rng.integers(0, bi.size)] = np.nan
        dt = rng.uniform(1e-3, 5e-3, bi.size) * k
        ws = w * dt
        if r % 2:
            cnt = rng.integers(0, 3, (bi.size, t))
            parts = np.maximum(cnt.sum(1), 1)
            share = ws / parts
            yield ("dec", bi, cnt, cnt * share[:, None],
                   cnt * (dt / parts)[:, None], w, dt, ws, k,
                   float(w.max()))
        else:
            yield ("idle", bi, w, dt, ws, k, float(w.max()))


def _fold(acc_cls, ledger, records):
    acc = acc_cls(ledger)
    for rec in records:
        if rec[0] == "dec":
            acc.book_dec(*rec[1:])
        else:
            acc.book_idle(*rec[1:])
    acc.finalize()
    return ledger


@pytest.mark.parametrize("count,nan_every", [(150, 0), (150, 17), (40, 5)])
def test_torch_accumulator_matches_the_references_jax_accumulator(
        jax_plane, count, nan_every):
    """Three chunks and a tail (150 records), one part chunk (40), with
    and without NaN watt points: cell peaks take the NaN of a record that
    books the cell, phase peaks never do."""
    n, t = 12, 3
    recs = list(_records(11, n, t, count, nan_every))
    want = _fold(jb.JaxAccumulator, _Ledger(n, t), recs)
    got = _fold(lambda f: TorchAccumulator(f, device="cpu"), _Ledger(n, t),
                recs)
    from repro.fleet.segment import NumpyAccumulator as JNumpyAccumulator
    eager = _fold(JNumpyAccumulator, _Ledger(n, t), recs)
    for name in ("_cell_n", "_phase_n"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    for name in ("_cell_peak", "_phase_peak"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(eager, name))
    for name in ("_cell_ws", "_cell_s", "_phase_ws", "_phase_s",
                 "_node_ws"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(getattr(got, name), getattr(eager, name),
                                   rtol=1e-12, atol=0)
    assert np.isnan(got._cell_peak).any() == bool(nan_every)
    assert not np.isnan(got._phase_peak).any()


def test_torch_accumulator_stages_chunks_and_keeps_carries_on_its_device():
    n, t = 5, 2
    ledger = _Ledger(n, t)
    acc = TorchAccumulator(ledger, device="cpu")
    recs = list(_records(2, n, t, 2 * tb.CHUNK + 3, 0))
    for rec in recs:
        (acc.book_dec if rec[0] == "dec" else acc.book_idle)(*rec[1:])
    # 66 idle and 65 decode records: one full chunk of each folded so far
    assert acc.records == 2 * tb.CHUNK
    assert all(c.device.type == "cpu" for c in acc._dec_carry)
    acc.finalize()
    assert acc.records == len(recs)
    assert acc.timings() == []                  # events are the card's


def test_segment_engine_on_the_torch_plane_twins_the_references_jax_plane(
        jax_plane):
    ref = _build(jfleet, "SegmentFleet", backend="jax")
    fin_ref = ref.run(_arrivals(jfleet), max_steps=400)
    assert ref.summary()["backend_effective"] == "jax"
    got = _build(pfleet, "SegmentFleet", backend="torch", device="cpu")
    fin = got.run(_arrivals(pfleet), max_steps=400)
    assert_close(ref, got, fin_ref, fin, rtol=1e-12)
    ref_np = _build(jfleet, "SegmentFleet", backend="numpy")
    got_np = _build(pfleet, "SegmentFleet", backend="numpy")
    assert_bitwise(ref_np, got_np, ref_np.run(_arrivals(jfleet),
                                              max_steps=400),
                   got_np.run(_arrivals(pfleet), max_steps=400))


# ---------------------------------------------------------------------------
# The planner on either backend
# ---------------------------------------------------------------------------

def _run_planned(pkg, backend: str, **kw):
    """The reference's planner script (tests/test_fleet_jax_kernels.py) on
    four stub nodes of ``pkg`` at one envelope."""
    ported = pkg is pfleet
    ppol = pkg.PowerPlanPolicy(
        mode="gate", slo_queue_depth=2.0, plan_every=4, min_active=1,
        min_active_steps=8, horizon_steps=32.0,
        states=pkg.PowerStatePolicy(gate_watts=3.0, boot_energy_ws=2.0,
                                    warmup_steps=4, cooldown_steps=8))
    nodes = [sim_envelope_node(f"n{i}", slots=2, step_s=0.01) if ported
             else j_sim_envelope_node(f"n{i}", envelope=_j_env(), slots=2,
                                      step_s=0.01) for i in range(4)]
    sched = pkg.FleetScheduler(
        nodes, policy=pkg.FleetPolicy(flush_every=4, checkpoint_every=8,
                                      migrate_on_drift=False),
        planner=pkg.FleetPowerPlanner(policy=ppol, backend=backend, **kw))
    make = _req if ported else _jreq
    dues = list(range(1, 9)) + list(range(120, 150, 3))
    script = [(due, make(rid, tenant=f"team{rid % 2}", max_new=4,
                         prompt_len=3)) for rid, due in enumerate(dues)]
    return sched, sched.run(arrivals=script, max_steps=2000)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_planner_backends_make_the_references_decisions(jax_plane, backend):
    dev = dict(device="cpu") if backend == "torch" else {}
    ref, fin_ref = _run_planned(jfleet, "jax")
    got, fin = _run_planned(pfleet, backend, **dev)
    assert ref.planner.backend == "jax"
    assert got.planner.backend == backend
    assert any(e.action == "gate" for e in ref.planner.events)
    assert sorted(r.rid for r in fin) == sorted(r.rid for r in fin_ref)
    assert [(e.step, e.node, e.action, tuple(e.moved_rids))
            for e in got.planner.events] == \
        [(e.step, e.node, e.action, tuple(e.moved_rids))
         for e in ref.planner.events]
    assert got.ledger.total_ws == pytest.approx(ref.ledger.total_ws,
                                                rel=1e-9)
    doc = got.planner.summary()
    assert doc["backend_requested"] == doc["backend_effective"] == backend


def test_planner_refuses_unknown_backends():
    for bad in ("jax", "cuda", "numpy "):
        with pytest.raises(ValueError, match="backend"):
            FleetPowerPlanner(policy=PowerPlanPolicy(), backend=bad)


# ---------------------------------------------------------------------------
# No fallback
# ---------------------------------------------------------------------------

def test_torch_backends_need_a_card_unless_told_and_never_degrade(no_card):
    from repro_torch.core.power import R740_ARRIA10
    from repro_torch.telemetry import node_envelope
    specs = [VectorNodeSpec("n0", node_envelope(R740_ARRIA10))]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SegmentFleet(specs, backend="torch")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FleetPowerPlanner(policy=PowerPlanPolicy(), backend="torch")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            route_argmin_torch([1.0], [0.0], [0], [True])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            expected_queue_depth_many_torch([1, 2], 4.0, 0.5)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchAccumulator(_Ledger(1, 1))
        seg = SegmentFleet(specs, backend="torch", device="cpu")
        assert seg.device.type == "cpu"
        planner = FleetPowerPlanner(policy=PowerPlanPolicy(),
                                    backend="torch", device="cpu")
        assert planner.device.type == "cpu"
        assert SegmentFleet(specs).device is None

"""The port's Fig. 5 harness against the JAX package's: sampler, A/B
comparison, reports and JSONL traces, plus the port's NVML power source.

The reference's ``repro.telemetry`` modules are jax-free, so both packages
run on the same inputs here.  The sampler, the synthesized and stage
traces and the reports are copied op for op: their samples are held equal
at rel 1e-12 and their renderings equal as text.  ``sample_during`` reads
the wall clock, so it is held to its own invariant (a constant source
integrates to W x the trace's duration, rel 1e-9).  The NVML source is
held against a stub library object with NVML's functions.
"""
import ctypes
import importlib
import json
import time

import pytest

from repro.core.power import R740_ARRIA10 as J_R740
from repro_torch.core.power import R740_ARRIA10

# the modules (each package's ``telemetry`` re-exports a function named
# ``compare`` over the module's name)
(j_compare, j_dvfs, j_energy, j_report, j_sampler, j_trace) = (
    importlib.import_module(f"repro.telemetry.{m}") for m in
    ("compare", "dvfs", "energy", "report", "sampler", "trace"))
(compare, dvfs, energy, nvml, report, sampler, trace_mod) = (
    importlib.import_module(f"repro_torch.telemetry.{m}") for m in
    ("compare", "dvfs", "energy", "nvml", "report", "sampler", "trace"))

REL = 1e-12
PHASES = [("prefill", 0.25, 30.0), ("decode", 1.5, 90.0),
          ("overlapped", 0.0, 4.0), ("idle", 0.75, 0.0)]
STAGES = [{"name": "build", "t0": 10.0, "t1": 10.4, "util": 0.3},
          {"name": "execute", "t0": 10.4, "t1": 11.9, "util": 0.9},
          {"name": "analyze", "t0": 11.9, "t1": 12.0, "util": 0.1}]


def _same_trace(a, b):
    assert len(a.samples) == len(b.samples)
    for (ta, wa), (tb, wb) in zip(a.samples, b.samples):
        assert ta == pytest.approx(tb, rel=REL, abs=1e-15)
        assert wa == pytest.approx(wb, rel=REL)
    assert [(s.name, s.t0, s.t1, s.depth) for s in a.spans] == \
        [(s.name, s.t0, s.t1, s.depth) for s in b.spans]
    assert a.energy_ws() == pytest.approx(b.energy_ws(), rel=REL)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("static,per_phase", [(20.0, 16), (111.0, 4)])
def test_synthesize_phase_trace_equals_the_reference(static, per_phase):
    got = sampler.synthesize_phase_trace(PHASES, static, per_phase,
                                         meta={"source": "analytic"})
    want = j_sampler.synthesize_phase_trace(PHASES, static, per_phase,
                                            meta={"source": "analytic"})
    _same_trace(got, want)
    assert got.meta == want.meta


@pytest.mark.parametrize("accelerated", [False, True])
def test_sample_stage_trace_equals_the_reference(accelerated):
    env = dvfs.node_envelope(R740_ARRIA10, accelerated=accelerated)
    j_env = j_dvfs.node_envelope(J_R740, accelerated=accelerated)
    got = sampler.sample_stage_trace(
        STAGES, env, chips=2, interval=0.05,
        stage_envelopes={"execute": dvfs.node_envelope(R740_ARRIA10, True)})
    want = j_sampler.sample_stage_trace(
        STAGES, j_env, chips=2, interval=0.05,
        stage_envelopes={"execute": j_dvfs.node_envelope(J_R740, True)})
    _same_trace(got, want)
    assert got.meta == want.meta


@pytest.mark.parametrize("duration,interval,t0", [(2.0, 0.05, 0.0),
                                                  (0.33, 0.1, 5.0)])
def test_power_sampler_run_constant_source_equals_the_reference(
        duration, interval, t0):
    got = sampler.PowerSampler(sampler.ConstantSource(121.0), interval) \
        .run(duration, t0=t0)
    want = j_sampler.PowerSampler(j_sampler.ConstantSource(121.0),
                                  interval).run(duration, t0=t0)
    _same_trace(got, want)


def test_power_sampler_run_replay_source_equals_the_reference():
    samples = [(0.0, 100.0), (0.3, 250.0), (0.31, 90.0), (1.2, 400.0)]
    got = sampler.PowerSampler(sampler.ReplaySource(samples), 0.07) \
        .run(1.5)
    want = j_sampler.PowerSampler(j_sampler.ReplaySource(samples), 0.07) \
        .run(1.5)
    _same_trace(got, want)
    src = sampler.ReplaySource(samples)
    assert [src.watts(t) for t in (-1.0, 0.3, 0.305, 5.0)] == \
        [100.0, 250.0, 250.0, 400.0]


def test_modeled_source_sampling_equals_the_reference():
    env = dvfs.node_envelope(R740_ARRIA10)
    j_env = j_dvfs.node_envelope(J_R740)
    util = dvfs.PhaseUtilization(STAGES)
    j_util = j_dvfs.PhaseUtilization(STAGES)
    got = sampler.PowerSampler(sampler.ModeledSource(env, util, 3), 0.02) \
        .run(2.0, t0=10.0)
    want = j_sampler.PowerSampler(j_sampler.ModeledSource(j_env, j_util, 3),
                                  0.02).run(2.0, t0=10.0)
    _same_trace(got, want)


def test_sample_during_integrates_a_constant_source_to_w_times_wall():
    for w in (111.0, 700.0):
        out, tr = sampler.PowerSampler(sampler.ConstantSource(w), 0.002) \
            .sample_during(lambda: time.sleep(0.03) or "done")
        assert out == "done"
        assert tr.duration >= 0.03
        assert tr.energy_ws() == pytest.approx(w * tr.duration, rel=1e-9)


def test_tick_clock_equals_the_reference():
    a, b = sampler.TickClock(0.125), j_sampler.TickClock(0.125)
    assert [a() for _ in range(9)] == [b() for _ in range(9)]


# ---------------------------------------------------------------------------
# JSONL traces read in either package
# ---------------------------------------------------------------------------

def _trace_pair():
    return (sampler.synthesize_phase_trace(PHASES, 50.0,
                                           meta={"arch": "qwen2-7b"}),
            j_sampler.synthesize_phase_trace(PHASES, 50.0,
                                             meta={"arch": "qwen2-7b"}))


def test_port_jsonl_reads_in_the_reference(tmp_path):
    got, _ = _trace_pair()
    got.evicted_ws, got.evicted_seconds = 3.5, 0.25
    path = got.to_jsonl(tmp_path / "port.trace.jsonl")
    back = j_trace.PowerTrace.from_jsonl(path)
    _same_trace(back, got)
    assert back.meta == got.meta and back.maxlen == got.maxlen
    assert (back.evicted_ws, back.evicted_seconds) == (3.5, 0.25)


def test_reference_jsonl_reads_in_the_port(tmp_path):
    _, want = _trace_pair()
    path = want.to_jsonl(tmp_path / "ref.trace.jsonl")
    back = trace_mod.PowerTrace.from_jsonl(path)
    _same_trace(back, want)
    assert back.meta == want.meta
    assert path.read_text() == back.to_jsonl(
        tmp_path / "again.jsonl").read_text()


def test_replay_source_reads_a_jsonl_trace(tmp_path):
    got, _ = _trace_pair()
    path = got.to_jsonl(tmp_path / "t.jsonl")
    src = sampler.ReplaySource.from_jsonl(path)
    assert src.samples == sorted(got.samples)


# ---------------------------------------------------------------------------
# Ws comparison and reports
# ---------------------------------------------------------------------------

def _comparisons():
    base = sampler.synthesize_phase_trace([("cpu", 14.0, 0.0)], 121.0)
    off = sampler.synthesize_phase_trace(
        [("h2d", 0.3, 6.0), ("kernel", 1.5, 30.0), ("d2h", 0.2, 1.0)],
        111.0)
    j_base = j_sampler.synthesize_phase_trace([("cpu", 14.0, 0.0)], 121.0)
    j_off = j_sampler.synthesize_phase_trace(
        [("h2d", 0.3, 6.0), ("kernel", 1.5, 30.0), ("d2h", 0.2, 1.0)],
        111.0)
    got = compare.compare(compare.RunEnergy.from_trace("cpu_only", base),
                          compare.RunEnergy.from_trace("offloaded", off),
                          workload="mriq_fig5")
    want = j_compare.compare(j_compare.RunEnergy.from_trace("cpu_only",
                                                            j_base),
                             j_compare.RunEnergy.from_trace("offloaded",
                                                            j_off),
                             workload="mriq_fig5")
    return got, want


def test_ws_comparison_to_dict_equals_the_reference():
    got, want = _comparisons()
    assert json.dumps(got.to_dict(), sort_keys=True) == \
        json.dumps(want.to_dict(), sort_keys=True)
    assert got.energy_cut == pytest.approx(want.energy_cut, rel=REL)


@pytest.mark.parametrize("render", ["render_comparison_text",
                                    "render_comparison_csv",
                                    "render_comparison_json"])
def test_comparison_renderings_equal_the_reference(render):
    got, want = _comparisons()
    assert getattr(report, render)(got) == getattr(j_report, render)(want)


def test_trace_summary_rendering_equals_the_reference():
    got, want = _trace_pair()
    got.meta["source"] = want.meta["source"] = "measured"
    assert report.render_trace_summary(got, "trial") == \
        j_report.render_trace_summary(want, "trial")


def _ledgers():
    out = []
    for mod in (energy, j_energy):
        led = mod.EnergyLedger()
        led.add("prefill", 12.5, 0.2, peak_w=130.0, tenant="a")
        led.add("decode", 40.0, 1.1, peak_w=121.0, node="node1",
                tenant="b")
        led.add_split("decode", 9.0, 0.3, ["a", "b", "c"], peak_w=115.0)
        led.add("idle", 5.0, 0.5, tenant="fleet")
        out.append(led)
    return out


@pytest.mark.parametrize("render", ["render_ledger", "render_rollups"])
def test_ledger_renderings_equal_the_reference(render):
    got, want = _ledgers()
    assert got.per_phase() == want.per_phase()
    assert getattr(report, render)(got, "fleet") == \
        getattr(j_report, render)(want, "fleet")


def test_serving_run_energy_equals_the_reference():
    from repro_torch.serve.engine import Request
    from repro.serve.engine import Request as JRequest
    runs = []
    for mod, dv, req in ((energy, dvfs, Request),
                         (j_energy, j_dvfs, JRequest)):
        env = dv.node_envelope(R740_ARRIA10 if mod is energy else J_R740,
                               accelerated=True)
        meter = mod.DecodeEnergyMeter(envelope=env)
        meter.observe(0.2, util=0.5, phase="prefill", tenants=["a"])
        meter.observe(0.7, util=1.0, phase="decode", tenants=["a", "b"])
        reqs = [req(rid=i, prompt=None, max_new=4, tenant=t,
                    out=[1] * (i + 1), prefill_ws=2.0 * i, decode_ws=3.0)
                for i, t in enumerate(("a", "b"))]
        cls = compare.RunEnergy if mod is energy else j_compare.RunEnergy
        runs.append(cls.from_serving("offloaded", meter, reqs))
    got, want = runs
    assert [q.to_dict() for q in got.requests] == \
        [q.to_dict() for q in want.requests]
    assert got.ws == pytest.approx(want.ws, rel=REL)
    assert got.phases == want.phases


def test_ab_sample_bills_each_leg_at_its_source():
    cmp_ = compare.ab_sample("sleep", "cpu", lambda: time.sleep(0.02),
                             "card", lambda: time.sleep(0.01),
                             sampler.ConstantSource(121.0),
                             sampler.ConstantSource(111.0), interval=0.002)
    assert cmp_.baseline.ws == pytest.approx(
        121.0 * cmp_.baseline.seconds, rel=1e-9)
    assert cmp_.candidate.ws == pytest.approx(
        111.0 * cmp_.candidate.seconds, rel=1e-9)
    assert cmp_.baseline.seconds >= 0.02 and cmp_.candidate.seconds >= 0.01


# ---------------------------------------------------------------------------
# The NVML power source, against a stub of the library
# ---------------------------------------------------------------------------

class StubNvml:
    """NVML's functions as the port calls them: out-parameters by
    ``ctypes.byref``, 0 for success.  The energy counter is ``energy_mj``
    read in turn, or ``energy_fn()`` when given."""

    def __init__(self, energy_mj=(), fail=None, energy_fn=None):
        self.energy_mj = list(energy_mj)
        self.energy_fn = energy_fn
        self.fail = fail or {}
        self.bus_ids = []

    def _rc(self, fn):
        return self.fail.get(fn, 0)

    def nvmlInit_v2(self):
        return self._rc("nvmlInit_v2")

    def nvmlDeviceGetHandleByPciBusId_v2(self, bus, handle):
        self.bus_ids.append(bus)
        handle._obj.value = 7
        return self._rc("nvmlDeviceGetHandleByPciBusId_v2")

    def nvmlDeviceGetName(self, handle, buf, size):
        buf.value = b"NVIDIA H100 80GB HBM3"
        return self._rc("nvmlDeviceGetName")

    def nvmlDeviceGetPowerManagementLimit(self, handle, mw):
        mw._obj.value = 700000
        return self._rc("nvmlDeviceGetPowerManagementLimit")

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, mj):
        rc = self._rc("nvmlDeviceGetTotalEnergyConsumption")
        if rc == 0:
            mj._obj.value = self.energy_fn() if self.energy_fn \
                else self.energy_mj.pop(0)
        return rc

    def nvmlErrorString(self, rc):
        return b"Not Supported" if rc == 3 else b"Unknown Error"


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _source(energy_mj, period=0.1, **kw):
    clock = FakeClock()
    src = nvml.NvmlSource(bus_id="00000000:3B:00.0", period=period,
                          nvml=nvml.Nvml(lib=StubNvml(energy_mj, **kw)),
                          clock=clock)
    return src, clock


def _linear_source(watts, period=0.01):
    """A stub card drawing ``watts`` steadily: its counter is watts x the
    host clock, in whole millijoules."""
    lib = StubNvml(energy_fn=lambda: int(time.perf_counter() * watts * 1e3))
    return nvml.NvmlSource(bus_id="00000000:3B:00.0", period=period,
                           nvml=nvml.Nvml(lib=lib))


def test_nvml_source_reads_name_limit_and_bus():
    src, _ = _source([5_000_000])
    assert src.name == "NVIDIA H100 80GB HBM3"
    assert src.power_limit_w == 700.0
    assert src.nvml.lib.bus_ids == [b"00000000:3B:00.0"]
    assert "700.00 W" in src.describe()


def test_nvml_source_turns_millijoules_into_watts_and_holds_between_reads():
    # construction reads 1000.000 J; then +50 J over 0.125 s, +30.5 J over
    # 0.25 s (periods of 0.1 s; clock steps exact in binary)
    src, clock = _source([1_000_000, 1_050_000, 1_080_500])
    clock.now += 0.125
    assert src.watts(0.0) == pytest.approx(400.0, rel=1e-12)
    clock.now += 0.0625                        # under one period: held
    assert src.watts(0.05) == pytest.approx(400.0, rel=1e-12)
    clock.now += 0.1875
    assert src.watts(0.2) == pytest.approx(30.5 / 0.25, rel=1e-12)


def test_counter_window_is_a_step_trace_of_the_readings():
    src = _linear_source(500.0, period=0.01)
    out, tr, counter_j = nvml.sample_counter_during(
        src, lambda: time.sleep(0.08) or "ran")
    assert out == "ran"
    t = [t for t, _ in tr.samples]
    w = [w for _, w in tr.samples]
    # two samples a reading: each interval's mean draw held across it
    assert len(tr) % 2 == 0 and len(tr) >= 4
    assert t[0] == 0.0 and t == sorted(t)
    assert all(w[i] == w[i + 1] for i in range(0, len(w), 2))
    assert all(t[i] == t[i + 1] for i in range(1, len(t) - 1, 2))
    # readings inside the span never closer than one period
    assert min(t[i + 1] - t[i] for i in range(2, len(t) - 2, 2)) >= 0.01
    # the trace spans the call only; the counter ran on for a period more,
    # whose draw the window leaves unbilled
    assert tr.duration >= 0.08
    assert counter_j - tr.integrate() >= 500.0 * 0.01 * 0.98
    assert tr.avg_watts() == pytest.approx(500.0, rel=0.05)


def test_counter_window_reads_once_after_a_short_call():
    src = _linear_source(300.0, period=0.05)
    _, tr, counter_j = nvml.sample_counter_during(src, lambda: None)
    # one interval, a period long, of which the call's instant is billed
    assert len(tr) == 2 and tr.duration < 0.05
    assert counter_j >= 300.0 * 0.05 * 0.98
    assert tr.integrate() == pytest.approx(
        tr.samples[0][1] * tr.duration, rel=1e-9)


def test_counter_window_lets_the_calls_failure_through():
    src = _linear_source(300.0, period=0.01)

    class Boom(Exception):
        pass

    def boom():
        raise Boom
    with pytest.raises(Boom):
        nvml.sample_counter_during(src, boom)


def test_sample_window_on_an_nvml_source_keeps_the_counter():
    src = _linear_source(650.0, period=0.05)
    win = nvml.sample_window(src, lambda: time.sleep(0.004), seconds=0.3,
                             min_calls=3, phase="trial")
    c = win.counter
    assert win.calls >= 3
    # billed over the calls' span (the calls' own time and the loop's),
    # not the period the last reading waits after them
    assert sum(win.call_seconds) <= win.seconds < sum(win.call_seconds) \
        + 0.025
    assert c["trace_j"] == pytest.approx(win.joules, rel=1e-12)
    assert c["rel"] == pytest.approx(1.0 - win.joules / c["counter_j"],
                                     rel=1e-9)
    # at least that period's draw is left unbilled
    assert 0.9 * 0.05 / (win.seconds + 0.05) <= c["rel"] \
        < 0.25 / (win.seconds + 0.25)
    assert c["ends"] == pytest.approx(0.1 / win.seconds, rel=1e-12)
    assert win.watts == pytest.approx(650.0, rel=0.05)
    assert win.trace.phase_names() == ["trial"]


def test_window_agreement_compares_counter_and_trace():
    tr = trace_mod.PowerTrace()
    for t, w in ((0.0, 100.0), (1.0, 100.0), (1.0, 300.0), (2.0, 300.0)):
        tr.add(t, w)
    got = nvml.window_agreement(tr, 400.0, 0.1)
    assert got["trace_j"] == pytest.approx(400.0)
    assert got["rel"] == pytest.approx(0.0, abs=1e-12)
    assert got["ends"] == pytest.approx(0.1, rel=1e-12)
    assert (got["period_s"], got["span_s"]) == (0.1, 2.0)
    assert nvml.window_agreement(tr, 440.0, 0.1)["rel"] == \
        pytest.approx(40.0 / 440.0)


@pytest.mark.parametrize("seconds, passes", [(0.03, False), (1.5, True)])
def test_check_window_refuses_a_window_short_of_the_counter(seconds,
                                                            passes):
    # a 10-ms counter: 0.03 s of calls puts two of its steps at 0.67 of the
    # span and leaves ~25 % of the counter unbilled; 1.5 s puts them at
    # 0.013 and leaves ~1 %
    src = _linear_source(400.0, period=0.01)
    win = nvml.sample_window(src, lambda: time.sleep(0.002), seconds=seconds)
    if passes:
        nvml.check_window("long", win.counter)
        assert win.counter["rel"] < nvml.WINDOW_TOL
    else:
        assert win.counter["ends"] > nvml.WINDOW_TOL
        with pytest.raises(nvml.NvmlError, match=r"> 0\.05"):
            nvml.check_window("short", win.counter)


def test_check_window_refuses_an_unbilled_share_and_no_counter():
    counter = {"counter_j": 100.0, "trace_j": 90.0, "rel": 0.1,
               "ends": 0.01, "period_s": 0.1, "span_s": 20.0}
    with pytest.raises(nvml.NvmlError, match="counter's difference unbilled"):
        nvml.check_window("w", counter)
    with pytest.raises(nvml.NvmlError, match="not read from the card"):
        nvml.check_window("w", None)
    assert nvml.describe_window(None) == ""
    assert "unbilled 0.1000" in nvml.describe_window(counter)


def test_sample_window_on_a_constant_source():
    win = nvml.sample_window(sampler.ConstantSource(250.0),
                             lambda: time.sleep(0.005), seconds=0.05,
                             min_calls=3, phase="trial")
    assert win.calls >= 3 and win.counter is None
    assert win.joules == pytest.approx(250.0 * win.seconds, rel=1e-9)
    assert win.joules_per_call == pytest.approx(win.joules / win.calls)
    assert win.trace.phase_names() == ["trial"]
    assert win.median_call_s() >= 0.005


def test_sample_window_check_can_stop_the_window():
    class Stop(Exception):
        pass

    def check(elapsed):
        raise Stop
    with pytest.raises(Stop):
        nvml.sample_window(sampler.ConstantSource(1.0), lambda: None,
                           seconds=10.0, check=check)


@pytest.mark.parametrize("fn", ["nvmlInit_v2",
                                "nvmlDeviceGetHandleByPciBusId_v2",
                                "nvmlDeviceGetPowerManagementLimit",
                                "nvmlDeviceGetTotalEnergyConsumption"])
def test_nvml_raises_on_a_failing_return_code(fn):
    with pytest.raises(nvml.NvmlError, match=f"{fn} returned 3 "
                                             r"\(Not Supported\)"):
        _source([0, 1, 2], fail={fn: 3})


def test_nvml_raises_on_a_failing_read_after_construction():
    src, _ = _source([0])
    src.nvml.lib.fail["nvmlDeviceGetTotalEnergyConsumption"] = 999
    with pytest.raises(nvml.NvmlError, match="Unknown Error"):
        src.energy_j()


def test_nvml_raises_when_the_library_is_missing():
    with pytest.raises(nvml.NvmlError, match="cannot load"):
        nvml.Nvml(library="libnvidia-ml-not-here.so.1")


def test_update_period_is_the_median_gap_between_counter_changes():
    now = [0.0]
    values = iter(range(10_000))

    def read():
        return next(values) // 25               # changes every 25 polls

    def sleep(dt):
        now[0] += dt
    period = nvml.update_period(read, seconds=1.0, poll=0.004,
                                clock=lambda: now[0], sleep=sleep)
    assert period == pytest.approx(0.1, rel=1e-9)
    with pytest.raises(nvml.NvmlError, match="changed 0 times"):
        nvml.update_period(lambda: 5, seconds=0.1, poll=0.01,
                           clock=lambda: now[0], sleep=sleep)


def test_nvml_binding_declares_pointer_arguments():
    class Lib:
        pass
    lib = Lib()
    for fn in ("nvmlInit_v2", "nvmlDeviceGetHandleByPciBusId_v2",
               "nvmlDeviceGetName", "nvmlDeviceGetPowerManagementLimit",
               "nvmlDeviceGetTotalEnergyConsumption", "nvmlErrorString"):
        setattr(lib, fn, type("F", (), {})())
    nvml._declare(lib)
    assert lib.nvmlDeviceGetTotalEnergyConsumption.argtypes[1] is \
        ctypes.POINTER(ctypes.c_ulonglong)
    assert lib.nvmlErrorString.restype is ctypes.c_char_p

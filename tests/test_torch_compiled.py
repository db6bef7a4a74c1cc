"""The compiled rung, the roofline and ``adapt`` Steps 4-5 against the
reference's.

``CompiledBackend`` (``repro_torch.core.backends``) spawns the port's pod
dry run; here its subprocess is stubbed (an injected ``runner`` drops the
record and the sidecar where the child would) and its assembly of a
record and a sidecar into a measurement is held to the reference's
``measurement_from_trial`` on the same stages: the same envelope at the
same measured utilization, so the same trace, to rtol 1e-12.  The port
applies no trip-count correction (the dry run unrolls every layer), so the
collective bytes ride along as recorded.

``analyze_record`` is held to the reference's on the same record, with the
port's ``HardwareSpec`` built from ``repro.core.power.V5E``'s fields inside
the test: the analytic terms, the dominant term, the watts and the energy
equal to rtol 1e-12.  Steps 4-5 mirror ``tests/test_adapt.py:27-62``, with
the reference's ``adjust_resources`` ranking equal to the port's on the
analytic rung, the reference's v5e cost rates passed to both explicitly.
"""
import dataclasses
import json

import pytest

from repro_torch.configs import get_config
from repro_torch.core.backends import (CompiledBackend, MeasureContext,
                                       ReplayBackend, load_record,
                                       load_stage_sidecar, make_backend,
                                       plan_tag)
from repro_torch.core.fitness import TIMEOUT_PENALTY_S
from repro_torch.core.power import H100, HardwareSpec, PowerModel

#: the reference's CostModel defaults (a v5e price), passed explicitly
REF_RATES = dict(hw_rate=2.0 / 3600.0, energy_rate=0.12 / 3.6e6)
RTOL = 1e-12


def _ctx(arch="tiny-test", shape="decode_32k", **kw):
    return MeasureContext(cfg=get_config(arch), shape_name=shape, **kw)


def _stages(*specs):
    """Sequential (name, dt, util) -> sidecar stage dicts."""
    t, out = 0.0, []
    for name, dt, util in specs:
        out.append({"name": name, "t0": t, "t1": t + dt, "util": util})
        t += dt
    return out


_OK_REC = {"status": "OK", "collectives": {"total_bytes": 1e6},
           "memory": {"argument_size_in_bytes": 2**20},
           "flops": 1e9, "mesh": "pod16x16"}


def _v5e_spec() -> HardwareSpec:
    """The port's spec built from the reference's V5E fields."""
    from repro.core.power import V5E
    return HardwareSpec(**{f.name: getattr(V5E, f.name)
                           for f in dataclasses.fields(V5E)})


# ---------------------------------------------------------------------------
# The compiled rung
# ---------------------------------------------------------------------------

def test_registry_builds_the_compiled_rung():
    assert isinstance(make_backend("compiled"), CompiledBackend)
    assert CompiledBackend().mesh_name == "pod16x16"
    assert CompiledBackend(multi_pod=True).mesh_name == "pod2x16x16"


def test_compiled_measurement_samples_wall_clock_stages():
    backend = CompiledBackend(record_trace=False, interval=0.01)
    stages = _stages(("build", 0.5, 0.9), ("trace", 3.0, 1.0),
                     ("analyze", 0.1, 0.2))
    m = backend.measurement_from_trial(_ctx(), dict(_OK_REC), stages)
    assert m.ok and m.source == "compiled"
    assert m.seconds == pytest.approx(3.6, rel=1e-6)
    assert set(m.trace.phase_names()) == {"build", "trace", "analyze",
                                          "trial"}
    assert m.trace.phase_seconds("trace") == pytest.approx(3.0)
    assert len(m.trace) >= 3.6 / 0.01
    assert m.energy_j == pytest.approx(m.trace.integrate(), rel=RTOL)
    assert m.watts == pytest.approx(m.energy_j / m.seconds, rel=RTOL)
    assert m.utilization["trace"] == pytest.approx(1.0)
    assert m.utilization["build"] == pytest.approx(0.9)
    # the record's counters as recorded: no trip-count correction
    assert m.flops == 1e9 and m.coll_bytes == 1e6
    assert m.peak_mem_per_chip == 2**20


@pytest.mark.parametrize("stages", [
    (("build", 0.5, 0.9), ("lower", 1.0, 0.7), ("compile", 2.0, 1.0),
     ("analyze", 0.1, 0.2)),
    (("build", 1.7, 0.98), ("trace", 11.4, 1.0), ("analyze", 0.01, 0.5)),
    (("compile", 1.0, 1.0), ("execute", 2.0, 1.0)),
], ids=["reference-stages", "port-stages", "execute"])
def test_compiled_measurement_equals_the_references(stages):
    """The same record and sidecar: the port's trace, seconds, watts and
    joules equal the reference's (the R740 envelopes, one per stage)."""
    from repro.configs import get_config as ref_config
    from repro.core.backends import CompiledBackend as RefCompiled
    from repro.core.backends import MeasureContext as RefContext
    st = _stages(*stages)
    rec = dict(_OK_REC, hlo_flops=1e9, hlo_bytes=1e7)
    got = CompiledBackend(record_trace=False).measurement_from_trial(
        _ctx(), rec, st)
    want = RefCompiled(record_trace=False).measurement_from_trial(
        RefContext(cfg=ref_config("tiny-test"), shape_name="decode_32k"),
        rec, st)
    assert got.ok and want.ok
    for k in ("seconds", "watts", "energy_j"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=RTOL)
    assert got.utilization == pytest.approx(want.utilization, rel=RTOL)
    assert [s for s in got.trace.samples] == \
        pytest.approx([s for s in want.trace.samples], rel=RTOL)
    assert got.trace.meta["envelopes"] == want.trace.meta["envelopes"]


def test_compiled_rung_via_stubbed_subprocess(tmp_path):
    """Full measure() path with the subprocess stubbed out: the runner
    drops the record + sidecar exactly where the child would."""
    cfg = get_config("tiny-test")
    ctx = _ctx()
    backend = CompiledBackend(art_dir=tmp_path)
    key = f"{cfg.name}__decode_32k__pod16x16_p{plan_tag(cfg.plan)}"
    seen = []

    def fake_runner(cmd, **kw):
        seen.append(cmd)
        (tmp_path / f"{key}.json").write_text(json.dumps(_OK_REC))
        (tmp_path / f"{key}.stages.json").write_text(json.dumps(
            {"wall_s": 1.5, "stages": _stages(("build", 0.5, 1.0),
                                              ("trace", 1.0, 0.8))}))

    backend.runner = fake_runner
    m = backend.measure(ctx, cfg.plan)
    assert m.ok
    assert m.seconds == pytest.approx(1.5, rel=1e-6)
    cmd = seen[0]
    assert cmd[1:3] == ["-m", "repro_torch.launch.dryrun"]
    assert "--plan-json" in cmd and "--multi-pod" not in cmd
    assert json.loads(cmd[cmd.index("--plan-json") + 1]) == \
        dataclasses.asdict(cfg.plan)
    rec_path = tmp_path / f"{key}.trace.jsonl"
    assert rec_path.is_file()
    replay = ReplayBackend(root=tmp_path, mesh_name="pod16x16")
    mr = replay.measure(ctx, cfg.plan)
    assert mr.ok and mr.source == "replay"
    assert mr.energy_j == pytest.approx(m.energy_j, rel=1e-9)


@pytest.mark.parametrize("record,sidecar", [
    (None, None),                                # nothing produced
    ("{not json", None),                         # malformed record
    (json.dumps({"no": "status"}), None),        # stale/foreign record
    (json.dumps({"status": "FAIL", "error": "boom"}), None),
    (json.dumps(_OK_REC), None),                 # OK but no sidecar
    (json.dumps(_OK_REC), "{not json"),          # OK but bad sidecar
    (json.dumps(_OK_REC), json.dumps({"stages": []})),
])
def test_compiled_rung_bad_artifacts_penalize_not_crash(tmp_path, record,
                                                        sidecar):
    cfg = get_config("tiny-test")
    backend = CompiledBackend(art_dir=tmp_path, multi_pod=True)
    key = f"{cfg.name}__decode_32k__pod2x16x16_p{plan_tag(cfg.plan)}"

    def fake_runner(cmd, **kw):
        assert "--multi-pod" in cmd
        if record is not None:
            (tmp_path / f"{key}.json").write_text(record)
        if sidecar is not None:
            (tmp_path / f"{key}.stages.json").write_text(sidecar)

    backend.runner = fake_runner
    m = backend.measure(_ctx(), cfg.plan)
    assert not m.ok and m.source == "penalty"
    assert m.seconds == TIMEOUT_PENALTY_S


def test_compiled_rung_timeout_is_a_penalty(tmp_path):
    import subprocess

    def slow(cmd, timeout, **kw):
        raise subprocess.TimeoutExpired(cmd, timeout)
    backend = CompiledBackend(art_dir=tmp_path, runner=slow)
    m = backend.measure(_ctx(timeout_s=5.0), get_config("tiny-test").plan)
    assert not m.ok and "timeout after 5s" in m.error


def test_compiled_rung_oom_against_the_cards_memory():
    """A record whose per-rank argument bytes exceed the H100's 80 GB is a
    penalty; below it is measured."""
    backend = CompiledBackend(record_trace=False)
    rec = dict(_OK_REC)
    rec["memory"] = {"argument_size_in_bytes": int(H100.hbm_bytes) + 1}
    m = backend.measurement_from_trial(_ctx(), rec,
                                       _stages(("trace", 1.0, 1.0)))
    assert not m.ok and "OOM" in m.error
    rec["memory"] = {"argument_size_in_bytes": int(H100.hbm_bytes)}
    assert backend.measurement_from_trial(
        _ctx(), rec, _stages(("trace", 1.0, 1.0))).ok


def test_compiled_rung_samples_per_stage_envelopes():
    from repro_torch.core.power import R740_ARRIA10
    from repro_torch.telemetry.dvfs import node_envelope
    backend = CompiledBackend(record_trace=False, interval=0.01)
    cpu = node_envelope(R740_ARRIA10, accelerated=False)
    accel = node_envelope(R740_ARRIA10, accelerated=True)
    assert backend.envelope.name == cpu.name
    assert backend.stage_envelopes["execute"].name == accel.name
    m = backend.measurement_from_trial(
        _ctx(), _OK_REC, _stages(("trace", 1.0, 1.0),
                                 ("execute", 2.0, 1.0)))
    tr = m.trace
    assert tr.phase_stats("trace")["avg_w"] == \
        pytest.approx(cpu.watts(1.0), rel=1e-9)
    assert tr.phase_stats("execute")["avg_w"] == \
        pytest.approx(accel.watts(1.0), rel=1e-9)
    assert m.energy_j == pytest.approx(tr.integrate(), rel=RTOL)


def test_load_record_rejects_malformed_and_stale(tmp_path):
    p = tmp_path / "rec.json"
    assert load_record(p) is None                      # missing
    p.write_text("{truncated")
    assert load_record(p) is None                      # malformed
    p.write_text(json.dumps([1, 2, 3]))
    assert load_record(p) is None                      # wrong shape
    p.write_text(json.dumps({"arch": "x"}))
    assert load_record(p) is None                      # stale (no status)
    p.write_text(json.dumps({"status": "OK"}))
    assert load_record(p) == {"status": "OK"}


def test_load_stage_sidecar_rejects_malformed(tmp_path):
    p = tmp_path / "s.json"
    assert load_stage_sidecar(p) is None
    p.write_text("{truncated")
    assert load_stage_sidecar(p) is None
    p.write_text(json.dumps({"stages": [{"name": "x"}]}))   # no t0/t1
    assert load_stage_sidecar(p) is None
    p.write_text(json.dumps({"stages": [
        {"name": "x", "t0": "oops", "t1": 2.0, "util": 1.0}]}))
    assert load_stage_sidecar(p) is None
    p.write_text(json.dumps({"stages": [
        {"name": "a", "t0": 0.0, "t1": 2.0, "util": 1.0},
        {"name": "b", "t0": 0.5, "t1": 1.5, "util": 1.0}]}))  # overlap
    assert load_stage_sidecar(p) is None
    p.write_text(json.dumps({"stages": [
        {"name": "a", "t0": 1.0, "t1": 0.5, "util": 1.0}]}))  # t1 < t0
    assert load_stage_sidecar(p) is None
    good = {"stages": _stages(("trace", 1.0, 0.5))}
    p.write_text(json.dumps(good))
    assert load_stage_sidecar(p) == good["stages"]


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

_ROOF_CELLS = [("qwen2-7b", "decode_32k", 256, 1e6),
               ("qwen2-7b", "train_4k", 256, 4.4e11),
               ("llama3-405b", "prefill_32k", 512, 2.0e9),
               ("mamba2-1.3b", "decode_32k", 256, 0.0),
               ("granite-moe-1b-a400m", "train_4k", 512, 3.0e10)]


@pytest.mark.parametrize("arch,shape,chips,coll", _ROOF_CELLS)
def test_roofline_equals_the_references(arch, shape, chips, coll):
    from repro.core.power import PowerModel as RefPower
    from repro.core.power import V5E
    from repro.core.roofline import analyze_record as ref_analyze
    from repro_torch.core.roofline import analyze_record
    rec = {"arch": arch, "shape": shape, "mesh": "pod16x16",
           "status": "OK", "n_chips": chips,
           "collectives": {"total_bytes": coll},
           "hlo_flops": 1.0, "hlo_bytes": 1.0, "flops": 3.0e15,
           "model_flops": 1.5e15}
    got = analyze_record(rec, PowerModel(_v5e_spec()))
    want = ref_analyze(rec, RefPower(V5E))
    for k in ("t_compute", "t_memory", "t_collective", "watts_per_chip",
              "energy_j", "roofline_fraction", "model_flops"):
        assert getattr(got, k) == pytest.approx(getattr(want, k),
                                                rel=RTOL), k
    assert got.dominant == want.dominant
    for k in ("analytic_flops", "analytic_hbm", "analytic_coll",
              "coll_bytes_raw_per_chip"):
        assert got.raw[k] == pytest.approx(want.raw[k], rel=RTOL), k
    # the traced count is global and whole: no trip correction
    assert got.traced_flops == 3.0e15
    assert got.useful_ratio == pytest.approx(0.5, rel=RTOL)


def test_roofline_defaults_to_the_h100_and_speaks_of_it():
    from repro_torch.core.roofline import _SUGGEST, analyze_record
    rec = {"arch": "qwen2-7b", "shape": "decode_32k", "mesh": "pod16x16",
           "status": "OK", "n_chips": 256, "collectives": {"total_bytes": 0},
           "flops": 1.0}
    row = analyze_record(rec)
    assert row.t_compute == pytest.approx(
        row.raw["analytic_flops"] / (256 * H100.reached_flops), rel=RTOL)
    text = " ".join(_SUGGEST.values())
    assert "tensor cores" in text and "NVLink" in text \
        and "shared memory" in text
    for word in ("MXU", "VMEM", "ICI"):
        assert word not in text
    fail = analyze_record({"arch": "qwen2-7b", "shape": "train_4k",
                           "mesh": "pod16x16", "status": "FAIL",
                           "error": "NotImplementedError: aten.x"})
    assert fail.status == "FAIL" and "aten.x" in fail.note


def test_roofline_rows_and_table(tmp_path):
    from repro_torch.core.roofline import load_rows, table
    for arch, status in (("qwen2-7b", "OK"), ("mamba2-1.3b", "FAIL")):
        rec = {"arch": arch, "shape": "decode_32k", "mesh": "pod16x16",
               "status": status, "n_chips": 256, "error": "boom",
               "collectives": {"total_bytes": 1e6}, "flops": 2e12,
               "model_flops": 1e12}
        (tmp_path / f"{arch}__decode_32k__pod16x16.json").write_text(
            json.dumps(rec))
    (tmp_path / "x__decode_32k__pod2x16x16.json").write_text("{}")
    rows = load_rows("pod16x16", art=tmp_path)
    assert [(r.arch, r.status) for r in rows] == [("mamba2-1.3b", "FAIL"),
                                                  ("qwen2-7b", "OK")]
    text = table(rows)
    assert "mamba2-1.3b" in text and "FAIL: boom" in text
    assert "50.0%" in text                      # useful: 1e12 / 2e12


# ---------------------------------------------------------------------------
# adapt Steps 4-5 (mirrors tests/test_adapt.py:27-62)
# ---------------------------------------------------------------------------

def _ranking(choices) -> list:
    return [(c.chips, c.measurement.ok) for c in choices]


@pytest.mark.parametrize("arch,shape", [("mamba2-1.3b", "train_4k"),
                                        ("mamba2-1.3b", "decode_32k"),
                                        ("qwen2-7b", "train_4k"),
                                        ("qwen2-7b", "prefill_32k")])
def test_adjust_resources_equals_the_references(arch, shape):
    """On the reference's chip spec (the port's ``HardwareSpec`` from
    V5E's fields) and its 16-way model axis: the same ranking, costs and
    seconds."""
    from repro.configs import get_config as ref_config
    from repro.core.adapt import CostModel as RefCost
    from repro.core.adapt import adjust_resources as ref_adjust
    from repro_torch.core.adapt import CostModel, adjust_resources
    from repro_torch.core.verifier import Verifier
    slices = (64, 128, 256, 512)
    cfg = get_config(arch)
    power = PowerModel(_v5e_spec())         # the reference's chip
    got = adjust_resources(
        cfg, shape, cfg.plan, slices, CostModel(**REF_RATES),
        verifier_factory=lambda chips: Verifier(
            cfg, shape, n_chips=chips, tp=16, mode="analytic", power=power))
    want = ref_adjust(ref_config(arch), shape, ref_config(arch).plan,
                      slices, RefCost(**REF_RATES))
    assert _ranking(got) == _ranking(want)
    for g, w in zip(got, want):
        assert g.cost == pytest.approx(w.cost, rel=1e-9)
        assert g.measurement.seconds == pytest.approx(w.measurement.seconds,
                                                      rel=1e-9)
        assert g.tokens_per_cost == pytest.approx(w.tokens_per_cost,
                                                  rel=1e-9)


def test_resource_adjustment_cost_tradeoff():
    from repro_torch.core.adapt import CostModel, adjust_resources
    cfg = get_config("mamba2-1.3b")
    cost = CostModel(**REF_RATES)
    choices = adjust_resources(cfg, "train_4k", cfg.plan,
                               (64, 128, 256, 512), cost)
    assert len(choices) == 4
    by_chips = {c.chips: c for c in choices}
    assert by_chips[512].measurement.seconds \
        <= by_chips[64].measurement.seconds * 1.05
    assert choices[0].measurement.ok
    dec = adjust_resources(cfg, "decode_32k", cfg.plan,
                           (64, 128, 256, 512), cost)
    assert dec[0].chips < 512


def test_resource_adjustment_respects_requirement():
    from repro_torch.core.adapt import CostModel, adjust_resources
    from repro_torch.core.destinations import Requirement
    cfg = get_config("qwen2-7b")
    fast = adjust_resources(cfg, "train_4k", cfg.plan, (64, 512),
                            CostModel(**REF_RATES),
                            requirement=Requirement(max_seconds=2.0))
    assert fast[0].measurement.ok
    assert fast[0].measurement.seconds <= 2.0 or all(
        c.measurement.seconds > 2.0 for c in fast)


def test_cost_model_has_no_default_rates():
    from repro_torch.core.adapt import CostModel
    with pytest.raises(TypeError):
        CostModel()


def test_placement_multi_pod_threshold():
    from repro.core.adapt import adjust_placement as ref_place
    from repro_torch.core.adapt import adjust_placement
    assert adjust_placement(256)["multi_pod"] is False
    p = adjust_placement(512)
    assert p["multi_pod"] is True and p["pods"] == 2
    for chips in (1, 64, 255, 256, 257, 512, 700):
        got, want = adjust_placement(chips), ref_place(chips)
        assert {k: got[k] for k in ("pods", "mesh", "multi_pod")} == \
            {k: want[k] for k in ("pods", "mesh", "multi_pod")}


def test_adapt_with_slices_runs_steps_4_and_5():
    from repro_torch.core.adapt import CostModel, adapt
    from repro_torch.core.destinations import Requirement
    from repro_torch.core.ga import GAConfig
    cfg = get_config("qwen2-7b")
    rep = adapt(cfg, "train_4k", requirement=Requirement(max_seconds=1e9),
                ga=GAConfig(population=4, generations=2), slices=(64, 256),
                cost=CostModel(**REF_RATES))
    assert len(rep.census) >= 3 and "attn_impl" in rep.genes
    assert rep.selection.chosen is not None and rep.plan is not None
    assert [s.chips for s in rep.slices] and rep.chips in (64, 256)
    assert rep.placement["pods"] == 1
    assert rep.reconfigurator is not None
    assert rep.reconfigurator.make_verifier().n_chips == 256
    with pytest.raises(ValueError, match="CostModel"):
        adapt(cfg, "train_4k", ga=GAConfig(population=4, generations=1),
              slices=(64,))


def test_adapt_slice_smoke_runs_on_the_compiled_rung(tmp_path):
    """Step 6 on a slice: the compiled rung on the Step-5 mesh (stubbed
    child), whatever the policy's one-card smoke rung says."""
    from repro_torch.core.adapt import CostModel, adapt
    from repro_torch.core.ga import GAConfig
    cfg = get_config("qwen2-7b")
    calls = []

    def runner(cmd, **kw):
        calls.append(cmd)
        tag = cmd[cmd.index("--tag") + 1]
        key = f"qwen2-7b__train_4k__pod2x16x16{tag}"
        (tmp_path / f"{key}.json").write_text(json.dumps(_OK_REC))
        (tmp_path / f"{key}.stages.json").write_text(json.dumps(
            {"stages": _stages(("build", 0.2, 1.0), ("trace", 0.5, 1.0))}))
    rep = adapt(cfg, "train_4k", ga=GAConfig(population=4, generations=1),
                slices=(512,), cost=CostModel(**REF_RATES), verify=True,
                backends={"compiled": CompiledBackend(
                    art_dir=tmp_path, multi_pod=True, runner=runner)})
    assert rep.chips == 512 and rep.placement["multi_pod"]
    assert "--multi-pod" in calls[0]
    assert rep.verified["status"] == "OK"
    assert rep.verified["rung"] == "compiled"
    assert rep.verified["seconds"] == pytest.approx(0.7, rel=1e-6)


def test_one_card_adapt_keeps_one_chip():
    from repro_torch.core.adapt import adapt
    from repro_torch.core.ga import GAConfig
    rep = adapt(get_config("qwen2-7b"), "train_4k",
                ga=GAConfig(population=4, generations=1))
    assert rep.chips == 1 and rep.slices == []
    assert rep.placement == {"pods": 1, "multi_pod": False,
                             "note": "one card: no slice or pod placement"}

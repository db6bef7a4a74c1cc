"""The port's scripts (``repro_torch.scripts``) against the repo's
``scripts/``.

``power_report`` and ``trace_report`` print the reference's bytes, on
stdout and stderr, and exit with its codes, on the same files: the port's
serving CLI's ledger, spans (Chrome JSON and JSONL), metrics and power
trace (tiny-test on the CPU), a second ledger to merge, synthesized power
traces (one carrying a compiled rung's meta) with a baseline, a
vectorized fleet's flight log (also truncated, empty and missing),
profiler docs, and the inputs each script refuses.  Both scripts run in
this process (the reference's imports no jax).

``optimize_all``'s and ``hillclimb``'s term arithmetic equals the
reference's on one recorded dry-run record (the port's, tiny-test
decode_32k) under the reference's chip spec: the reference scripts set
``XLA_FLAGS`` when imported, so they run in a subprocess, their
``run_cell`` handing back the record.  Both sweeps then run once over
tiny-test decode_32k on the fake 256-rank group.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import obs
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.optimized import optimized_plan
from repro_torch.core.power import HardwareSpec, PowerModel
from repro_torch.launch import dryrun, serve
from repro_torch.scripts import (hillclimb, optimize_all, power_report,
                                 trace_report)
from repro_torch.telemetry import EnergyLedger, synthesize_phase_trace

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12
SERVE_ARGV = ["--arch", "tiny-test", "--fleet", "2", "--slots", "2",
              "--requests", "8", "--max-new", "6", "--tenants", "teamA,teamB",
              "--admission", "teamB=0.5", "--admission-window", "64",
              "--arrival-every", "2", "--placement", "gate", "--govern",
              "--flush-every", "2", "--checkpoint-every", "4",
              "--device", "cpu"]
VECTOR_ARGV = ["--engine", "vector-seg", "--fleet", "4", "--slots", "2",
               "--max-new", "6", "--placement", "gate",
               "--tenants", "teamA,teamB",
               "--diurnal", "1:8:1,160:12:3,300:10:1",
               "--admission", "teamB=60", "--tick", "0.004",
               "--trace-sample", "0.5", "--snapshot-every", "20"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every input the report cases read, made once."""
    d = tmp_path_factory.mktemp("reports")
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            serve.main(SERVE_ARGV + [
                "--ledger-out", str(d / "fleet.json"),
                "--trace-spans", str(d / "trace.json"),
                "--metrics-out", str(d / "metrics.prom"),
                "--trace-out", str(d / "node0.jsonl")])
        finally:
            obs.disable()
        try:
            out = serve.main(VECTOR_ARGV + ["--flight-log",
                                            str(d / "flight.jsonl")])
        finally:
            obs.disable()
    second = EnergyLedger()
    second.add("prefill", 12.5, 0.25, peak_w=60.0, node="node7",
               tenant="teamC")
    second.add("decode", 40.0, 1.5, peak_w=45.0, node="node7",
               tenant="teamA")
    second.to_json(d / "node7.json")
    synthesize_phase_trace([("prefill", 0.4, 30.0), ("decode", 1.2, 55.0)],
                           static_watts=90.0).to_jsonl(d / "run.jsonl")
    synthesize_phase_trace([("cpu", 3.0, 120.0)],
                           static_watts=105.0).to_jsonl(d / "base.jsonl")
    synthesize_phase_trace(
        [("build", 0.2, 1.0), ("trace", 0.5, 4.0)], static_watts=124.0,
        meta={"rung": "compiled", "utilization": {"build": 1.0,
                                                  "trace": 0.75}}
    ).to_jsonl(d / "compiled.jsonl")
    flight = (d / "flight.jsonl").read_text()
    (d / "truncated.jsonl").write_text(flight[: len(flight) * 2 // 3])
    (d / "empty.jsonl").write_text("")
    (d / "nospans.jsonl").write_text("\n")
    summary = out["fleet"].summary()
    (d / "summary.json").write_text(json.dumps(summary, default=str))
    phases = {"dispatch": {"seconds": 1.25, "count": 40},
              "plan": {"seconds": 0.5, "count": 4},
              "book": {"seconds": 0.0, "count": 0}}
    (d / "profile.json").write_text(json.dumps({"phases": phases}))
    (d / "arms.json").write_text(json.dumps({"arms": [
        {"label": "inline", "profile": {"phases": phases}},
        {"shards": 4, "profile": {"phases": {"step": {"seconds": 2.0,
                                                       "count": 7}}}},
        {"engine": "vector-seg", "profile": None}]}))
    (d / "bad.json").write_text("{not json")
    return d


POWER_CASES = {
    "trace": ["--trace", "node0.jsonl"],
    "trace_json": ["--trace", "node0.jsonl", "--json"],
    "compiled_meta": ["--trace", "compiled.jsonl"],
    "compiled_meta_json": ["--trace", "compiled.jsonl", "--json",
                           "--label", "rung"],
    "baseline": ["--trace", "run.jsonl", "--baseline", "base.jsonl",
                 "--workload", "w1", "--label", "gpu",
                 "--baseline-label", "cpu"],
    "baseline_json": ["--trace", "run.jsonl", "--baseline", "base.jsonl",
                      "--json"],
    "ledger": ["--ledger", "fleet.json"],
    "ledger_json": ["--ledger", "fleet.json", "--json"],
    "ledgers_merged": ["--ledger", "fleet.json", "--ledger", "node7.json"],
    "ledgers_merged_json": ["--ledger", "fleet.json", "--ledger",
                            "node7.json", "--json"],
    "ledger_and_trace_json": ["--ledger", "fleet.json", "--trace",
                              "node0.jsonl", "--json"],
    "missing": ["--trace", "nothere.jsonl"],
    "empty": ["--trace", "empty.jsonl"],
    "empty_ledger": ["--ledger", "empty.jsonl"],
    "nothing": [],
    "baseline_alone": ["--baseline", "base.jsonl"],
}
TRACE_CASES = {
    "chrome": ["--trace", "trace.json", "--metrics", "metrics.prom"],
    "spans_jsonl": ["--trace", "trace.spans.jsonl", "--slowest", "3"],
    "chrome_json": ["--trace", "trace.json", "--json"],
    "spans_no_slowest": ["--trace", "trace.spans.jsonl", "--slowest", "0",
                         "--metrics", "metrics.prom"],
    "missing": ["--trace", "nothere.json"],
    "empty": ["--trace", "empty.jsonl"],
    "no_spans": ["--trace", "nospans.jsonl"],
    "missing_metrics": ["--trace", "trace.json", "--metrics", "no.prom"],
    "flight": ["--flight", "flight.jsonl", "--steps-per-hour", "50"],
    "flight_default_hours": ["--flight", "flight.jsonl"],
    "flight_truncated": ["--flight", "truncated.jsonl",
                         "--steps-per-hour", "50"],
    "flight_empty": ["--flight", "empty.jsonl"],
    "flight_missing": ["--flight", "nothere.jsonl"],
    "profile": ["--profile", "profile.json"],
    "profile_arms": ["--profile", "arms.json"],
    "profile_summary": ["--profile", "summary.json"],
    "profile_unreadable": ["--profile", "bad.json"],
    "flight_and_profile": ["--flight", "flight.jsonl", "--profile",
                           "profile.json", "--steps-per-hour", "40"],
    "nothing": [],
}


def _load_reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"ref_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call(main, name: str, argv: list, cwd: Path, monkeypatch) -> tuple:
    """``main`` on ``argv`` from ``cwd`` as the script ``name``: (stdout,
    stderr, exit code)."""
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            main()
        except SystemExit as e:
            if isinstance(e.code, str):
                print(e.code, file=sys.stderr)
                code = 1
            else:
                code = e.code or 0
    return out.getvalue(), err.getvalue(), code


def _both(name: str, argv: list, files, monkeypatch) -> tuple:
    port = {"power_report": power_report,
            "trace_report": trace_report}[name]
    want = _call(_load_reference(name).main, name, argv, files, monkeypatch)
    got = _call(port.main, name, argv, files, monkeypatch)
    return got, want


@pytest.mark.parametrize("case", list(POWER_CASES))
def test_power_report_prints_the_references_bytes(files, monkeypatch, case):
    got, want = _both("power_report", POWER_CASES[case], files, monkeypatch)
    assert got == want
    assert (got[2] == 0) == (case not in ("missing", "empty", "empty_ledger",
                                          "nothing", "baseline_alone"))


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_trace_report_prints_the_references_bytes(files, monkeypatch, case):
    got, want = _both("trace_report", TRACE_CASES[case], files, monkeypatch)
    assert got == want
    assert (got[2] == 0) == (case not in ("missing", "empty", "no_spans",
                                          "missing_metrics", "nothing"))


def test_report_cases_render_something(files, monkeypatch):
    """The fixtures are not vacuous: the port's renders hold the rows the
    cases are about."""
    text = _call(trace_report.main, "trace_report", TRACE_CASES["chrome"],
                 files, monkeypatch)[0]
    assert "attributed Ws by phase" in text and "quantile=" in text
    text = _call(trace_report.main, "trace_report", TRACE_CASES["flight"],
                 files, monkeypatch)[0]
    assert "flight log:" in text and "mean_W" in text
    text = _call(trace_report.main, "trace_report",
                 TRACE_CASES["flight_truncated"], files, monkeypatch)[0]
    assert "flight log:" in text
    text = _call(trace_report.main, "trace_report",
                 TRACE_CASES["profile_arms"], files, monkeypatch)[0]
    assert "[inline]" in text and "[shards=4]" in text
    text = _call(power_report.main, "power_report",
                 POWER_CASES["ledgers_merged"], files, monkeypatch)[0]
    assert "fleet(2 ledgers)" in text and "teamC" in text
    text = _call(power_report.main, "power_report",
                 POWER_CASES["compiled_meta"], files, monkeypatch)[0]
    assert "compiled" in text


def test_reports_run_as_modules(files):
    """``python -m repro_torch.scripts.<name>``, as a user runs them."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    for mod, argv in (("power_report", ["--ledger", "fleet.json"]),
                      ("trace_report", ["--flight", "flight.jsonl"])):
        r = subprocess.run([sys.executable, "-m",
                            f"repro_torch.scripts.{mod}", *argv],
                           cwd=files, env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        assert r.stdout


# ---------------------------------------------------------------------------
# the sweeps
# ---------------------------------------------------------------------------

#: the reference's side: its scripts loaded by path, ``run_cell`` handing
#: back the recorded record, their arithmetic dumped as JSON
REF_SWEEP = r"""
import dataclasses, importlib.util, json, sys
root, rec_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, root + "/src")

def load(name):
    spec = importlib.util.spec_from_file_location(
        name, f"{root}/scripts/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

opt, hc = load("optimize_all"), load("hillclimb")
from repro.configs import SHAPES, get_config
from repro.configs.optimized import optimized_plan
rec = json.loads(open(rec_path).read())
rec["compile_s"] = rec["trace_s"]
hc.run_cell = lambda *a, **kw: rec
out = {}
for arch, shape in json.loads(sys.argv[3]):
    cfg, shp = get_config(arch), SHAPES[shape]
    plans = [cfg.plan, optimized_plan(arch, shp.kind),
             cfg.plan.replace(use_tp=False, overlap_collectives=True)]
    terms = [opt.terms(rec, cfg, shp, p) for p in plans]
    ms = [hc.measure(arch, shape, p, f"_t{i}") for i, p in enumerate(plans)]
    logs = [hc.log_iter(f"{arch}/{shape}", "it", "h", ms[0], m)
            for m in ms[1:]]
    out[f"{arch}/{shape}"] = {"terms": terms, "measure": ms,
                              "verdicts": [r["verdict"] for r in logs]}
print("JSON" + json.dumps(out))
"""
SWEEP_CELLS = [("tiny-test", "decode_32k"), ("qwen2-7b", "train_4k"),
               ("llama3-405b", "decode_32k")]
#: the reference's names for the port's measure keys
KEY_MAP = {"coll_bytes_census": "coll_bytes_hlo",
           "coll_count_census": "coll_count_hlo", "trace_s": "compile_s"}


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    art = tmp_path_factory.mktemp("dryrun")
    rec = dryrun.run_cell("tiny-test", "decode_32k", False, art=art)
    assert rec["status"] == "OK"
    path = art / "record.json"
    path.write_text(json.dumps(rec))
    return rec, path


def _ref_power() -> PowerModel:
    from repro.core.power import V5E
    return PowerModel(HardwareSpec(**{f.name: getattr(V5E, f.name)
                                      for f in dataclasses.fields(V5E)}))


def test_sweep_arithmetic_equals_the_references(record):
    rec, path = record
    r = subprocess.run([sys.executable, "-c", REF_SWEEP, str(ROOT),
                        str(path), json.dumps(SWEEP_CELLS)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.split("JSON", 1)[1])
    power = _ref_power()
    for arch, shape in SWEEP_CELLS:
        cfg, shp = get_config(arch), SHAPES[shape]
        plans = [cfg.plan, optimized_plan(arch, shp.kind),
                 cfg.plan.replace(use_tp=False, overlap_collectives=True)]
        w = want[f"{arch}/{shape}"]
        for p, wt in zip(plans, w["terms"]):
            got = optimize_all.terms(rec, cfg, shp, p, power)
            assert got.keys() == wt.keys()
            for k in got:
                assert got[k] == pytest.approx(wt[k], rel=REL), k
        ms = [hillclimb.metrics(rec, cfg, shp, p, power, f"_t{i}")
              for i, p in enumerate(plans)]
        for m, wm in zip(ms, w["measure"]):
            assert {KEY_MAP.get(k, k) for k in m} == set(wm)
            for k, v in m.items():
                if isinstance(v, float):
                    assert v == pytest.approx(wm[KEY_MAP.get(k, k)],
                                              rel=REL), k
                else:
                    assert v == wm[KEY_MAP.get(k, k)], k
        verdicts = [hillclimb.log_iter(f"{arch}/{shape}", "it", "h", ms[0],
                                       m, log=lambda s: None)["verdict"]
                    for m in ms[1:]]
        assert verdicts == w["verdicts"]


def test_sweeps_run_over_a_tiny_cell_on_the_fake_group(tmp_path):
    lines: list = []
    rows = optimize_all.run([("tiny-test", "decode_32k")], art=tmp_path,
                            out=tmp_path, log=lines.append)
    assert [r["status"] for r in rows] == ["OK"]
    assert rows[0]["opt"]["t"] <= rows[0]["base"]["t"]
    assert json.loads((tmp_path / "fleet_optimized.json").read_text()) == \
        json.loads(json.dumps(rows))
    assert "1 cells optimized" in lines[-1]
    cell = dataclasses.replace(hillclimb.select(arch="llama3-405b")[0],
                               arch="tiny-test")
    log = hillclimb.run([cell], hillclimb.Sweep(art=tmp_path,
                                                log=lines.append),
                        out=tmp_path)
    assert [r["iteration"][:2] for r in log] == ["B1", "B2", "B3"]
    assert all(r["after"]["status"] == "OK" for r in log)
    assert log[0]["before"]["coll_count_census"] >= 0
    assert (tmp_path / "hillclimb_log.json").is_file()


def test_sweep_cells_keep_the_references():
    assert [(c.key, c.arch, c.shape) for c in hillclimb.select()] == [
        ("A", "mamba2-1.3b", "train_4k"), ("B", "llama3-405b", "decode_32k"),
        ("C", "qwen2-7b", "train_4k")]
    assert [c.key for c in hillclimb.select(shape="train_4k",
                                            extra=True)] == \
        ["A", "C", "A+", "C+"]
    cells = optimize_all.cells()
    assert ("qwen2-7b", "decode_32k") in cells
    assert all(not a.startswith("tiny") for a, _ in cells)
    assert all(s not in get_config(a).skip_shapes for a, s in cells)
    assert optimize_all.cells("mamba2-1.3b", "long_500k") == \
        [("mamba2-1.3b", "long_500k")]

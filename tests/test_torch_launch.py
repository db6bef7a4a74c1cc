"""The port's serving CLI (``python -m repro_torch.launch.serve``).

Runs the object engine on the CPU at tiny-test (``--device cpu``) with
two nodes, governors, consolidate-and-gate placement and per-tenant
admission, and renders what it persisted through the reference's jax-free
``scripts/power_report.py --ledger`` and ``scripts/trace_report.py``.
Object-engine flags on the vectorized engines (and the reverse) are
refused, and without ``--device`` the CLI needs a card.  On reduced
granite-moe-1b-a400m it serves the tokens and bills of the reference CLI
on the same weights.  Each vectorized engine (``--engine vector |
vector-seg | vector-torch | vector-shard``) prints the reference CLI's
lines for the same arrival script at the same envelope, and its flight
log renders through ``scripts/trace_report.py --flight``.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import power as j_power
from repro.telemetry import EnergyLedger as JEnergyLedger
from repro.telemetry import TickClock as JTickClock
from repro.telemetry import envelope_for as j_envelope_for
from repro_torch.configs import CARD_SHAPES, ShapeSpec, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import power
from repro_torch.core.backends import MeasuredBackend
from repro_torch.fleet import Node
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.obs import read_spans_jsonl
from repro_torch.telemetry import (ConstantSource, EnergyLedger, TickClock,
                                   envelope_for)

ROOT = Path(__file__).resolve().parents[1]


def _argv(tmp_path, *extra):
    return ["--arch", "tiny-test", "--fleet", "2", "--slots", "2",
            "--requests", "8", "--max-new", "6", "--tenants", "teamA,teamB",
            "--admission", "teamB=0.5", "--admission-window", "64",
            "--arrival-every", "2", "--placement", "gate", "--govern",
            "--flush-every", "2", "--checkpoint-every", "4",
            "--ledger-out", str(tmp_path / "fleet.json"),
            "--trace-spans", str(tmp_path / "trace.json"),
            "--metrics-out", str(tmp_path / "metrics.prom"),
            "--trace-out", str(tmp_path / "node0.jsonl"),
            "--device", "cpu", *extra]


@pytest.fixture
def cli_run(tmp_path, capsys):
    from repro_torch import obs
    try:
        out = serve.main(_argv(tmp_path))
    finally:
        obs.disable()
    return out, capsys.readouterr().out, tmp_path


def test_cli_serves_a_governed_gated_fleet_on_the_cpu(cli_run):
    out, text, tmp_path = cli_run
    sched, finished = out["sched"], out["finished"]
    assert out["admission"].rejections, "teamB's budget must throttle"
    rejected = {r.rid for r in out["admission"].rejections}
    assert {r.rid for r in finished} | rejected == set(range(8))
    assert all(1 <= len(r.out) <= 6 for r in finished)
    vocab = get_config("tiny-test").vocab_size
    assert all(0 <= t < vocab for r in finished for t in r.out)
    # the bills: requests + the infra tenant's idle floors = the ledger
    infra = sched.ledger.rollup("tenant").get("fleet")
    billed = sum(r.energy_ws for r in finished) + (infra.ws if infra else 0)
    assert billed == pytest.approx(sched.ledger.total_ws, rel=1e-9)
    for by in ("node", "tenant", "phase"):
        assert sum(pe.ws for pe in sched.ledger.rollup(by).values()) == \
            pytest.approx(sched.ledger.total_ws, rel=1e-9)
    assert all(n.governor is not None for n in out["nodes"])
    assert out["planner"] is not None
    rows = out["attribution"].conservation(sched.ledger)
    assert rows and all(r["ok"] for r in rows.values())
    for line in ("req 0: tenant=teamA", "THROTTLED", "\nserved ",
                 "fleet: total=", "node node0: served=", "admission teamB:",
                 "placement[gate]: states=", "ledger -> ", "trace  -> ",
                 "attribution node0:", "spans  -> ", "metrics -> ",
                 "queue_wait_s p50="):
        assert line in text, line
    assert "DRIFT" not in text


def test_cli_files_render_through_the_references_scripts(cli_run):
    out, _, tmp_path = cli_run
    ledger = tmp_path / "fleet.json"
    total = out["sched"].ledger.total_ws
    assert EnergyLedger.from_json(ledger).total_ws == \
        pytest.approx(total, rel=1e-12)
    assert JEnergyLedger.from_json(ledger).total_ws == \
        pytest.approx(total, rel=1e-12)
    r = subprocess.run([sys.executable,
                        str(ROOT / "scripts" / "power_report.py"),
                        "--ledger", str(ledger)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    assert "by tenant:" in r.stdout and "teamA" in r.stdout
    spans = tmp_path / "trace.spans.jsonl"
    assert len(read_spans_jsonl(spans)) > 20
    for path in (tmp_path / "trace.json", spans):
        r = subprocess.run([sys.executable,
                            str(ROOT / "scripts" / "trace_report.py"),
                            "--trace", str(path), "--metrics",
                            str(tmp_path / "metrics.prom")],
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        assert "attributed Ws by phase" in r.stdout
        assert 'queue_wait_s{quantile="0.99"}' in r.stdout


@pytest.mark.parametrize("flag", [["--engine", "vector"],
                                  ["--engine", "vector-seg"],
                                  ["--verify-rung", "compiled"],
                                  ["--trace-sample", "0.5"],
                                  ["--flight-log", "f.jsonl"]])
def test_cli_refuses_what_is_not_ported(tmp_path, flag):
    """Refused before anything is built: the vectorized engines with the
    object engine's --govern and --trace-out (in ``_argv``), the compiled
    rung, and the flight flags on the object engine; also the reference's
    jax engine, which the port names vector-torch."""
    with pytest.raises(SystemExit):
        serve.main(_argv(tmp_path, *flag))
    with pytest.raises(SystemExit):
        serve.parser().parse_args(["--engine", "vector-jax"])


def test_cli_needs_a_card_without_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(argv)


def test_parsers_match_the_references():
    from repro.launch import serve as jserve
    assert serve.parse_diurnal("1:3:1,10:2:4") == \
        jserve.parse_diurnal("1:3:1,10:2:4") == [1, 2, 3, 10, 14]
    with pytest.raises(ValueError):
        serve.parse_diurnal("1:0:1")
    got = serve.parse_budgets("teamA=2.5, teamB=0.8", 16)
    want = jserve.parse_budgets("teamA=2.5, teamB=0.8", 16)
    assert {k: (b.budget_ws, b.window_steps) for k, b in got.items()} == \
        {k: (b.budget_ws, b.window_steps) for k, b in want.items()}
    with pytest.raises(ValueError):
        serve.parse_budgets("teamA", 0)
    args = serve.parser().parse_args([])
    assert (args.recon_shape, args.engine, args.device) == \
        ("decode_32k_b8", "object", None)


def test_run_serves_on_the_callers_weights_with_a_measured_governor(
        monkeypatch, tmp_path, capsys):
    """The library entry on weights the caller holds: every node's
    governor re-verifies through one verifier on the measured backend it
    is given.  The nodes meter on a virtual clock at the H100 envelope:
    on the wall clock a loaded host's jitter reads as drift, and a
    migration then rests on a 0.05-s trial window.  The next test plants
    drift, so that the trials run, at the recon shape."""
    monkeypatch.setitem(CARD_SHAPES, "cpu_decode",
                        ShapeSpec("cpu_decode", 48, 2, "decode"))
    monkeypatch.setattr(serve, "Node", _ticking(
        Node, lambda: envelope_for(power.H100), TickClock))
    cfg = get_config("tiny-test")
    model = Model(cfg, cfg.plan.replace(mlp_impl="pallas"), device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    args = serve.parser().parse_args(
        ["--fleet", "2", "--slots", "2", "--requests", "4", "--max-new",
         "4", "--govern", "--verify-rung", "measured", "--recon-shape",
         "cpu_decode", "--flush-every", "1", "--checkpoint-every", "2"])
    measured = MeasuredBackend(device="cpu", source=ConstantSource(200.0),
                               params={cfg.name: params}, window_s=0.05,
                               decode_steps=4)
    out = serve.run(args, model=model, params=params, measured=measured)
    assert len(out["finished"]) == 4
    for node in out["nodes"]:
        gov = node.governor
        assert gov.plan == model.plan and gov.verify_rung == "measured"
        assert gov._verifier.backend("measured") is measured
        for ev in gov.events:
            assert ev.verify_rung == "measured"
    # one card: the governors share one verifier and its trial cache
    assert len({id(n.governor._verifier) for n in out["nodes"]}) == 1
    assert "served 4 requests" in capsys.readouterr().out


class _Drifting(TickClock):
    """A virtual clock whose tick grows ``factor``-fold after ``calls``
    readings: every metered window from then on books that much more
    energy than the rolling median, which is planted drift."""

    def __init__(self, dt: float, calls: int = 24, factor: float = 4.0):
        super().__init__(dt)
        self.left, self.factor = calls, factor

    def __call__(self) -> float:
        self.left -= 1
        if self.left == 0:
            self.dt *= self.factor
        return super().__call__()


def test_run_migrates_through_the_measured_rung_when_drift_trips(
        monkeypatch, capsys):
    """As above, with drift planted on each node's virtual clock: every
    governor re-verifies its migration with real trials on the measured
    backend it is given, at the recon shape, and says so in its events."""
    monkeypatch.setitem(CARD_SHAPES, "cpu_decode",
                        ShapeSpec("cpu_decode", 48, 2, "decode"))
    monkeypatch.setattr(serve, "Node", _ticking(
        Node, lambda: envelope_for(power.H100), _Drifting))
    cfg = get_config("tiny-test")
    model = Model(cfg, cfg.plan.replace(mlp_impl="pallas"), device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    args = serve.parser().parse_args(
        ["--fleet", "2", "--slots", "2", "--requests", "8", "--max-new",
         "8", "--govern", "--verify-rung", "measured", "--recon-shape",
         "cpu_decode", "--flush-every", "1", "--checkpoint-every", "2"])
    measured = MeasuredBackend(device="cpu", source=ConstantSource(200.0),
                               params={cfg.name: params}, window_s=0.05,
                               decode_steps=4)
    out = serve.run(args, model=model, params=params, measured=measured)
    assert len(out["finished"]) == 8
    events = [ev for node in out["nodes"] for ev in node.governor.events]
    assert events
    for ev in events:
        assert ev.verify_rung == "measured" and ev.drift_ratio > 1.5
    cache = out["nodes"][0].governor._verifier.cache
    trials = [m for m in cache.values() if m.source == "measured"]
    # both sides of a migration ran their real trial, at the recon shape
    assert len(trials) >= 2 and len(measured.outputs) >= 2
    for m in trials:
        assert m.ok and m.trace.meta["shape"] == "cpu_decode"
    assert "served 8 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The CLI on a MoE arch, against the reference CLI on the same weights
# ---------------------------------------------------------------------------

MOE_ARGV = ["--arch", "granite-moe-1b-a400m", "--reduced", "--fleet", "2",
            "--slots", "2", "--requests", "6", "--max-new", "6",
            "--arrival-every", "1", "--tenants", "teamA,teamB"]
#: one chip spec, built in both packages from the same numbers
SPEC = dict(name="test_chip", peak_flops=500e12, hbm_bw=2.0e12,
            hbm_bytes=64e9, ici_bw=100e9, e_flop=1.1e-12, e_hbm=1.3e-10,
            e_ici=2e-11, p_static=90.0)
TICK = 0.005


def _f32(cfg):
    return dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", kv_cache_dtype="float32"))


def _ticking(node_cls, envelope, clock):
    """``node_cls`` whose nodes meter at ``envelope()`` on a virtual
    ``clock`` (the CLIs' nodes read the wall clock, and each package's
    default envelope is its own chip's)."""
    class Ticking(node_cls):
        @classmethod
        def build(cls, *args, **kw):
            kw.update(clock=clock(TICK), envelope=envelope())
            return super().build(*args, **kw)
    return Ticking


def test_cli_serves_a_moe_arch_as_the_reference_cli(tmp_path, monkeypatch,
                                                    capsys):
    """``--arch granite-moe-1b-a400m --reduced``: both CLIs serve the
    reference's seeded weights (carried by ``params_from_jax``) in f32 on
    one virtual clock and envelope; the same requests finish with the same
    tokens, and the persisted fleet ledgers agree cell by cell (rel
    1e-9).  Then the port's CLI itself, ``--device cpu``, serves the arch
    at its own plan (bf16) and seeded weights."""
    from repro.fleet import Node as JNode
    from repro.launch import serve as jserve
    from repro.models.model import Model as JModel
    jcfg = _f32(jget("granite-moe-1b-a400m", reduced=True))
    cfg = _f32(get_config("granite-moe-1b-a400m", reduced=True))
    monkeypatch.setattr(jserve, "get_config", lambda name, reduced: jcfg)
    monkeypatch.setattr(jserve, "Node", _ticking(
        JNode, lambda: j_envelope_for(j_power.HardwareSpec(**SPEC)),
        JTickClock))
    monkeypatch.setattr(serve, "Node", _ticking(
        Node, lambda: envelope_for(power.HardwareSpec(**SPEC)), TickClock))
    jledger, ledger = tmp_path / "ref.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["serve", *MOE_ARGV, "--ledger-out",
                                      str(jledger)])
    jserve.main()
    ref_text = capsys.readouterr().out
    jp = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0)))
    model = Model(cfg, device="cpu")
    out = serve.run(serve.parser().parse_args(
        [*MOE_ARGV, "--ledger-out", str(ledger)]), model=model,
        params=model.load(params_from_jax(cfg, jp)))
    text = capsys.readouterr().out
    assert len(out["finished"]) == 6

    def served(txt):
        return sorted(line.split(" (")[0] for line in txt.splitlines()
                      if line.startswith("req "))
    assert served(text) == served(ref_text)
    assert len(served(text)) == 6
    got, want = EnergyLedger.from_json(ledger), \
        JEnergyLedger.from_json(jledger)
    assert got.total_ws == pytest.approx(want.total_ws, rel=1e-9)
    assert set(got.cells) == set(want.cells)
    for key, cell in want.cells.items():
        assert got.cells[key].ws == pytest.approx(cell.ws, rel=1e-9)
        assert got.cells[key].count == cell.count
    # the CLI as a user runs it, on the CPU at the arch's own plan
    monkeypatch.setattr(serve, "Node", Node)
    own = serve.main([*MOE_ARGV, "--device", "cpu"])
    vocab = cfg.vocab_size
    assert len(own["finished"]) == 6
    assert all(1 <= len(r.out) <= 6 and all(0 <= t < vocab for t in r.out)
               for r in own["finished"])


# ---------------------------------------------------------------------------
# The vectorized engines
# ---------------------------------------------------------------------------

VECTOR_ARGV = ["--fleet", "4", "--slots", "2", "--max-new", "6",
               "--placement", "gate", "--tenants", "teamA,teamB",
               "--diurnal", "1:8:1,160:12:3,300:10:1",
               "--admission", "teamB=60", "--tick", "0.004",
               "--flush-every", "4", "--checkpoint-every", "8"]
#: the port's engine and the reference's twin of it
VECTOR_TWINS = {"vector": "vector", "vector-seg": "vector-seg",
                "vector-torch": "vector-seg", "vector-shard": "vector-shard"}


def _report_lines(text: str) -> list:
    """The CLI's report without what the host's clock moves (the wall
    time, the self-profiler's rows)."""
    import re
    return [re.sub(r"in \d+\.\d+s simulated", "in _s simulated", line)
            for line in text.splitlines()
            if line and not line.startswith("profile ")]


@pytest.mark.parametrize("engine", sorted(VECTOR_TWINS))
def test_vector_cli_prints_the_reference_clis_report(engine, monkeypatch,
                                                     capsys, tmp_path):
    """The same arrival script on both CLIs, the reference's nodes at the
    port's H100 envelope: the same throttles, request lines (node, tokens,
    Ws), rollups, node lines and placement events."""
    import repro.telemetry as jtelemetry
    from repro.launch import serve as jserve
    from repro.telemetry.dvfs import PowerEnvelope as JPowerEnvelope
    env = envelope_for(power.H100)
    monkeypatch.setattr(jtelemetry, "envelope_for",
                        lambda hw: JPowerEnvelope(**dataclasses.asdict(env)))
    extra = ["--shard-workers", "2", "--shard-parallel", "inline"] \
        if engine == "vector-shard" else []
    dev = ["--device", "cpu"] if engine == "vector-torch" else []
    monkeypatch.setattr(sys, "argv", ["serve", "--engine",
                                      VECTOR_TWINS[engine], *VECTOR_ARGV,
                                      *extra])
    try:
        jserve.main()
    finally:
        from repro import obs as jobs
        jobs.disable()
    want = _report_lines(capsys.readouterr().out)
    from repro_torch import obs
    try:
        out = serve.main(["--engine", engine, *VECTOR_ARGV, *extra, *dev])
    finally:
        obs.disable()
    got = _report_lines(capsys.readouterr().out)
    got = [line.replace(f"engine={engine}",
                        f"engine={VECTOR_TWINS[engine]}") for line in got]
    assert got == want
    assert any(line.startswith("placement gate") for line in got)
    assert any("THROTTLED" in line for line in got)
    assert out["fleet"].summary()["engine"] == engine
    rows = out["fleet"].results()
    assert {r["rid"] for r in rows if r["finished"]} == set(out["finished"])


def test_vector_cli_flight_log_renders(tmp_path, capsys):
    """``--engine vector-torch --device cpu`` with the flight recorder:
    sampled request trees, snapshot rows persisted, rendered by the
    reference's ``scripts/trace_report.py --flight``."""
    from repro_torch import obs
    log = tmp_path / "flight.jsonl"
    try:
        out = serve.main(["--engine", "vector-torch", "--device", "cpu",
                          *VECTOR_ARGV, "--trace-sample", "0.5",
                          "--snapshot-every", "20", "--flight-log",
                          str(log)])
    finally:
        obs.disable()
    text = capsys.readouterr().out
    assert f"flight -> {log}" in text
    assert "flight sampled" in text and "ok" in text
    assert out["sampled"] is not None and out["sampled"].ok
    r = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                            "trace_report.py"),
                        "--flight", str(log), "--steps-per-hour", "50"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "flight log:" in r.stdout


def test_vector_torch_cli_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--engine", "vector-torch", *VECTOR_ARGV])


def test_run_vector_serves_a_callers_arrivals(capsys):
    """The library entry on the caller's ``VectorArrivals`` (the chip
    script's day of traffic, here a small one)."""
    from repro_torch.fleet import VectorArrivals
    arr = VectorArrivals.diurnal(600, tenants=2, hours=24,
                                 steps_per_hour=20, max_new=4, seed=1)
    args = serve.parser().parse_args(["--engine", "vector-torch",
                                      "--device", "cpu", "--fleet", "8",
                                      "--slots", "4", "--placement",
                                      "gate"])
    out = serve.run_vector(args, arrivals=arr)
    capsys.readouterr()
    assert out["arrivals"] is arr
    assert len(out["finished"]) == 600
    fleet = out["fleet"]
    bills = sum(r["prefill_ws"] + r["decode_ws"] for r in fleet.results())
    infra = fleet.ledger.rollup("tenant")["fleet"].ws
    assert bills + infra == pytest.approx(fleet.total_ws, rel=1e-9)

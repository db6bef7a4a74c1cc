"""The port's examples (``repro_torch.examples``) against the repo's
``examples/``.

``mriq_offload``: the reference's file is loaded by path and run at 4096
voxels x 256 k-points (its ``N_VOX``/``N_K`` patched here, in the test),
its CPU time fixed (its clock patched) and each pattern's (seconds, watts)
recorded where it calls ``fitness``; the port's census, narrowing line and
``model_patterns`` rows, given the same CPU time and the reference's model
constants, equal them at rel 1e-12.  The port's measured patterns run on
the CPU at that size, each (Qr, Qi) within ``bench_mriq.TOL`` of the
CPU-only leg's.

``quickstart`` and ``mixed_destination`` print what the reference's print,
byte for byte, and ``adapt_flow`` chooses the reference's slice and plan
at its seconds, watts and cost (rel 1e-12), with the reference's chip
spec injected where the port's verifier reads ``H100``, the reference's
VMEM pre-check in place of the card's shared-memory one, and the
reference's ``CostModel`` rates passed explicitly.  ``train_lm --smoke``
runs, checkpoints and resumes bit for bit.
"""
import contextlib
import dataclasses
import importlib.util
import io
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import bench_mriq
from repro_torch.core import adapt as p_adapt
from repro_torch.core import narrowing as p_narrowing
from repro_torch.core import verifier as p_verifier
from repro_torch.core.power import R740_ARRIA10, HardwareSpec
from repro_torch.examples import (adapt_flow, mixed_destination, mriq_offload,
                                  quickstart, train_lm)
from repro_torch.ft.driver import InjectedFailure
from repro_torch.kernels import ops
from repro_torch.telemetry.sampler import ConstantSource

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12
#: the test's MRI-Q size, and the CPU time both packages are given
SMALL = (4096, 256)
T_CPU = 1.2345
#: the reference's CostModel defaults (a v5e price), passed explicitly
REF_RATES = dict(hw_rate=2.0 / 3600.0, energy_rate=0.12 / 3.6e6)
#: the reference's plan fields the port leaves out
REF_ONLY_FIELDS = ("moe_impl", "scan_layers")


def _load_reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(mod, argv=()) -> str:
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [mod.__name__] + list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = old
    return buf.getvalue()


def _lines(fn, *args, **kw) -> tuple:
    out: list = []
    result = fn(*args, log=lambda m: out.append(str(m)), **kw)
    return "\n".join(out) + "\n", result


def _same_plan(p, jp):
    ref = {k: v for k, v in dataclasses.asdict(jp).items()
           if k not in REF_ONLY_FIELDS}
    assert dataclasses.asdict(p) == ref


@pytest.fixture(scope="module")
def ref_mriq():
    """The reference's example at SMALL with its CPU time fixed at T_CPU:
    its census (at both sizes), its printed lines and each pattern's
    (seconds, watts) as it calls ``fitness``."""
    mod = _load_reference("mriq_offload")
    paper = mod.loop_census()
    calls = []
    ticks = iter((0.0, T_CPU))
    fit = mod.fitness
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "N_VOX", SMALL[0])
        mp.setattr(mod, "N_K", SMALL[1])
        mp.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda: next(ticks)))
        mp.setattr(mod, "fitness",
                   lambda t, w: calls.append((t, w)) or fit(t, w))
        text = _run_main(mod)
        small = mod.loop_census()
    return {"mod": mod, "paper": paper, "small": small, "calls": calls,
            "lines": text.splitlines()}


def _sites(sites) -> list:
    return [(s.name, s.flops_per_elem, s.elems, s.bytes_moved,
             s.offloadable, s.flops, s.intensity) for s in sites]


def test_mriq_census_equals_the_references(ref_mriq):
    assert _sites(mriq_offload.loop_census()) == _sites(ref_mriq["paper"])
    assert _sites(mriq_offload.loop_census(*SMALL)) == \
        _sites(ref_mriq["small"])
    assert len(ref_mriq["paper"]) == 16


@pytest.mark.parametrize("size", [(mriq_offload.N_VOX, mriq_offload.N_K),
                                  SMALL])
def test_mriq_narrowing_keeps_the_references_four_patterns(size):
    rejects = mriq_offload.narrow(mriq_offload.loop_census(*size))
    names = [n for n, _ in rejects]
    assert names[:3] == ["phiMag", "init_Q", "load_kvalues"]
    assert len(names) == 16 - 3        # Q_nest, Q_inner_k, Q_sincos stay
    assert dict(rejects)["aux_loop_0"] == "IO/control, not offloadable"


def test_mriq_model_patterns_equal_the_references(ref_mriq):
    ref = ref_mriq["mod"]
    got = mriq_offload.model_patterns(T_CPU, ref.DEV_FLOPS, ref.LAUNCH_S,
                                      ref.XFER_BW, R740_ARRIA10, *SMALL)
    assert list(got) == list(mriq_offload.NOTES)
    assert len(ref_mriq["calls"]) == len(got)
    for (t, w, _), (jt, jw) in zip(got.values(), ref_mriq["calls"]):
        assert t == pytest.approx(jt, rel=REL)
        assert w == pytest.approx(jw, rel=REL)


def test_mriq_model_defaults_are_the_h100s():
    assert mriq_offload.DEV_FLOPS == 67e12 / 16
    rows = mriq_offload.model_patterns(8.0)
    assert rows["cpu_only"] == (8.0, 121.0, "paper's baseline")
    assert all(w == 111.0 for name, (_, w, _) in rows.items()
               if name != "cpu_only")


@pytest.fixture(scope="module")
def port_mriq():
    return _lines(mriq_offload.run, "cpu", ConstantSource(111.0), *SMALL,
                  naive_voxels=256, window_s=0.01)


def test_mriq_offload_patterns_hold_to_the_cpu_only_leg(port_mriq):
    """Every pattern on the CPU, at SMALL: (Qr, Qi) within TOL of the
    CPU-only leg (``run`` raises otherwise), the naive one on its voxels,
    scaled."""
    text, out = port_mriq
    rows = {r["name"]: r for r in out["rows"]}
    assert list(rows) == list(mriq_offload.NOTES)
    scale = max(float(q.abs().max()) for q in
                ops.mriq(*mriq_offload.fig5_inputs(0, *SMALL)))
    for r in rows.values():
        assert r["max_abs_err"] <= bench_mriq.TOL[0] + bench_mriq.TOL[1] * \
            scale, r["name"]
        assert r["lo"] <= r["seconds"] <= r["hi"]
        assert r["node_ws"] == pytest.approx(r["seconds"] * r["node_w"])
    naive = rows["naive_per_voxel"]
    assert naive["scaled"] and naive["scale"] == SMALL[0] / 256
    assert naive["seconds"] == pytest.approx(naive["subset_s"] * 16)
    assert rows["cpu_only"]["card_w"] is None
    assert rows["device_trig_host_sum"]["bus_bytes"] == 8 * SMALL[0] * \
        SMALL[1]
    assert out["selected"] in mriq_offload.NOTES
    assert "step 4  selected: " + out["selected"] in text


def test_mriq_offload_prints_the_references_first_steps(ref_mriq,
                                                        port_mriq):
    text, _ = port_mriq
    assert text.splitlines()[:2] == ref_mriq["lines"][:2]


def test_mriq_trig_pattern_sums_equal_the_plain_version():
    """The trig pattern's chunked sums on the host, at a chunk that does
    not divide the voxels, equal the plain version's."""
    args = mriq_offload.fig5_inputs(3, 300, 64)
    trig = mriq_offload.TrigPass(args, torch.device("cpu"), 128)
    trig()
    want = ops.mriq(*args)
    for g, w in zip(trig.out, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-5)


def test_mriq_naive_pattern_hands_the_kernel_aligned_voxels():
    """The kernel takes 16-byte aligned operands: each voxel's x, y and z
    lie 16 bytes apart in the buffer the naive pattern copies, and each
    k-space row starts at a multiple of 16 bytes, also where M is not a
    multiple of 4."""
    args = mriq_offload.fig5_inputs(0, 9, 97)
    naive = mriq_offload.NaivePass(args, torch.device("cpu"), 5)
    for i in range(5):
        got = naive.operands(naive.k, naive.v[i])
        assert all(t.data_ptr() % 16 == 0 and t.is_contiguous()
                   for t in got)
        assert [float(t) for t in got[4:]] == \
            [float(a[i]) for a in args[4:]]
        for g, w in zip(got[:4], args[:4]):
            assert torch.equal(g, w)


def test_mriq_offload_ties():
    rows = [{"name": "a", "seconds": 1.0, "lo": 0.9, "hi": 1.2},
            {"name": "b", "seconds": 1.1, "lo": 0.95, "hi": 1.3},
            {"name": "c", "seconds": 1.15, "lo": 1.1, "hi": 1.2}]
    assert mriq_offload.ties(rows, rows[0]) == ["b"]


def test_mriq_offload_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mriq_offload.run(n_vox=64, n_k=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mriq_offload.main([])


def test_mriq_offload_refuses_another_sizes_fig5():
    fig5 = {"n_vox": 8, "n_k": 8}
    with pytest.raises(ValueError, match="Fig. 5"):
        mriq_offload.run("cpu", ConstantSource(111.0), 64, 16, fig5=fig5,
                         log=lambda m: None)


# ---------------------------------------------------------------------------
# the analytic examples, on the reference's spec
# ---------------------------------------------------------------------------

@pytest.fixture
def ref_spec(monkeypatch):
    """The reference's chip where the port's verifier and monitor read
    ``H100``, and the reference's VMEM rule as the narrowing pre-check."""
    from repro.core import narrowing as j_narrowing
    from repro.core.power import V5E
    spec = HardwareSpec(**{f.name: getattr(V5E, f.name)
                           for f in dataclasses.fields(V5E)})
    monkeypatch.setattr(p_verifier, "H100", spec)
    monkeypatch.setattr(p_adapt, "H100", spec)

    def vmem_rule(site, cfg, shape, p):
        if site.vmem_working_set <= j_narrowing.VMEM_BYTES:
            return None
        return (f"VMEM working set {site.vmem_working_set/2**20:.1f} "
                f"MiB > {j_narrowing.VMEM_BYTES/2**20:.0f} MiB "
                f"(resource pre-check)")
    monkeypatch.setattr(p_narrowing.SharedMemoryFit, "for_device",
                        classmethod(lambda cls, device=None: vmem_rule))
    return spec


@pytest.mark.parametrize("name", ["quickstart", "mixed_destination"])
def test_analytic_example_prints_the_references_bytes(ref_spec, name):
    want = _run_main(_load_reference(name))
    got, _ = _lines({"quickstart": quickstart.run,
                     "mixed_destination": mixed_destination.run}[name])
    assert got == want


def test_quickstart_on_the_h100_spec_beats_the_incumbent():
    _, out = _lines(quickstart.run)
    assert out["best"].fitness() >= out["incumbent"].fitness()
    assert out["result"].n_trials >= 1


def test_adapt_flow_chooses_the_references_slice_and_plan(ref_spec,
                                                          monkeypatch):
    mod = _load_reference("adapt_flow")
    box: dict = {}
    ref_adapt, ref_recon = mod.adapt, mod.Reconfigurator

    def adapt_rec(*a, **kw):
        box["rep"] = ref_adapt(*a, **kw)
        return box["rep"]

    def recon_rec(*a, **kw):
        r = box["recon"] = ref_recon(*a, **kw)
        observe = r.observe

        def observe_rec(*oa, **okw):
            plan = observe(*oa, **okw)
            if plan is not None:
                box["new_plan"] = plan
            return plan
        r.observe = observe_rec
        return r
    monkeypatch.setattr(mod, "adapt", adapt_rec)
    monkeypatch.setattr(mod, "Reconfigurator", recon_rec)
    want_text = _run_main(mod)
    got_text, got = _lines(adapt_flow.run, "qwen2-7b", "train_4k",
                           p_adapt.CostModel(**REF_RATES))
    rep, want = got["report"], box["rep"]
    assert rep.chips == want.chips
    assert [s.chips for s in rep.slices] == [s.chips for s in want.slices]
    for g, w in zip(rep.slices, want.slices):
        for k in ("seconds", "watts", "energy_j"):
            assert getattr(g.measurement, k) == pytest.approx(
                getattr(w.measurement, k), rel=REL)
        assert g.cost == pytest.approx(w.cost, rel=REL)
        assert g.tokens_per_cost == pytest.approx(w.tokens_per_cost, rel=REL)
    _same_plan(rep.plan, want.plan)
    for k in ("pods", "mesh", "multi_pod"):
        assert rep.placement[k] == want.placement[k]
    assert [e["stage"] for e in got["events"]] == \
        [e["stage"] for e in box["recon"].events]
    assert (got["new_plan"] is None) == ("new_plan" not in box)
    if got["new_plan"] is not None:
        _same_plan(got["new_plan"], box["new_plan"])
    # the lines that name no plan and no placement note are the
    # reference's, byte for byte
    named = ("step 5: placement", "chosen:", "  new plan", "  (swap")
    assert [ln for ln in got_text.splitlines()
            if not ln.startswith(named)] == \
        [ln for ln in want_text.splitlines() if not ln.startswith(named)]


def test_adapt_flow_needs_the_operators_rates():
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            adapt_flow.main(["--arch", "qwen2-7b"])


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

def test_train_lm_smoke_checkpoints_and_resumes_bit_for_bit(tmp_path):
    smoke = ["--smoke", "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        ref = train_lm.main(smoke + ["--ckpt-dir", str(tmp_path / "ref")])
        assert [r["step"] for r in ref["losses"]] == list(range(8))
        assert (tmp_path / "ref" / "train_log.json").is_file()
        with pytest.raises(InjectedFailure):
            train_lm.main(smoke + ["--ckpt-dir", str(tmp_path / "ck"),
                                   "--fail-at", "6"])
        out = train_lm.main(smoke + ["--ckpt-dir", str(tmp_path / "ck"),
                                     "--resume"])
    want = {r["step"]: r["loss"] for r in ref["losses"]}
    assert [r["step"] for r in out["losses"]] == [4, 5, 6, 7]
    for r in out["losses"]:
        assert r["loss"] == want[r["step"]]


def test_train_lm_fills_in_tiny_lm_defaults():
    assert train_lm.train_argv(["--steps", "3"]) == [
        "--steps", "3", "--arch", "tiny-lm", "--batch", "4", "--seq", "256"]
    assert train_lm.train_argv(["--smoke", "--device", "cpu"])[:2] == \
        ["--device", "cpu"]

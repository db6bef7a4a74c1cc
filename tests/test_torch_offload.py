"""The port's offload search against the JAX package's ``repro.core``.

``fitness``, ``site_census``, ``estimate_program`` (prefill and decode, the
reference with ``use_tp=False``), ``PowerModel`` and the analytic rung are
copied op for op: held equal at rel 1e-12 under one ``HardwareSpec`` built
here with the same numbers in both packages (so the port carries no TPU
constant).  Narrowing is held equal with the reference's VMEM pre-check
injected in place of the card's shared-memory one.  The GA, the verifier
and the destination ladder are held to the reference's properties
(``tests/test_core_offload.py``, ``tests/test_backends.py``): the GA's
gene set is smaller, so its random draws differ.  The measured rung runs
on the CPU here (``device="cpu"``, a ``ConstantSource``) on ``tiny-lm`` at
a small shape added to ``CARD_SHAPES`` for the test.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget
from repro.core import backends as j_backends
from repro.core import intensity as j_intensity
from repro.core import narrowing as j_narrowing
from repro.core import plan as j_plan
from repro.core import power as j_power
from repro.core.verifier import Verifier as JVerifier
from repro_torch.configs import CARD_SHAPES, SHAPES, ShapeSpec, get_config
from repro_torch.configs.base import get_shape
from repro_torch.core import backends, fitness, intensity, narrowing, plan
from repro_torch.core import power
from repro_torch.core.adapt import adapt
from repro_torch.core.destinations import (Requirement, _pallas_off,
                                           select_destination)
from repro_torch.core.ga import GAConfig, run_ga
from repro_torch.core.verifier import PenaltyPolicy, RungPolicy, Verifier
from repro_torch.kernels import flash_attention, rglru, ssd, swiglu
from repro_torch.models.model import Model
from repro_torch.telemetry.sampler import ConstantSource

# the module (``repro.core`` re-exports a function named ``fitness``)
j_fitness = importlib.import_module("repro.core.fitness")

REL = 1e-12
ARCHS = ["qwen2-7b", "mamba2-1.3b", "recurrentgemma-9b"]
SHAPE_NAMES = ["prefill_32k", "decode_32k"]
#: one spec, built in both packages from the same numbers
SPEC = dict(name="test_chip", peak_flops=500e12, hbm_bw=2.0e12,
            hbm_bytes=64e9, ici_bw=100e9, e_flop=1.1e-12, e_hbm=1.3e-10,
            e_ici=2e-11, p_static=90.0)


def _ref_plan(cfg):
    """The reference's plan with the genes the port lacks at the values the
    port's plans imply: no tensor parallelism, no overlap."""
    return dataclasses.replace(cfg.plan, use_tp=False,
                               overlap_collectives=False)


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=1e-300)


# ---------------------------------------------------------------------------
# fitness, genes, power model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seconds,watts,alpha,beta", [
    (2.0, 111.0, 0.5, 0.5), (14.0, 121.0, 0.5, 0.5), (0.03, 680.0, 1.0, 0.0),
    (None, 111.0, 0.5, 0.5), (2.0, None, 0.5, 0.5), (None, None, 0.3, 0.7),
    (0.0, 0.0, 0.5, 0.5)])
def test_fitness_equals_the_reference(seconds, watts, alpha, beta):
    _close(fitness.fitness(seconds, watts, alpha, beta),
           j_fitness.fitness(seconds, watts, alpha, beta))
    _close(fitness.fitness_time_only(seconds or 1.0, watts),
           j_fitness.fitness_time_only(seconds or 1.0, watts))
    assert (fitness.TIMEOUT_SECONDS, fitness.TIMEOUT_PENALTY_S,
            fitness.PENALTY_WATTS) == (180.0, 1000.0, 1000.0)


def test_genes_are_a_subset_of_the_reference_with_identical_alleles():
    assert set(plan.GENES) <= set(j_plan.GENES)
    assert set(plan.GENES) == {"attn_impl", "mlp_impl", "ssm_impl",
                               "rglru_impl", "attn_chunk", "kv_cache_dtype"}
    for g, (alleles, _) in plan.GENES.items():
        assert alleles == j_plan.GENES[g][0]
        assert getattr(get_config("qwen2-7b").plan, g) is not None


@pytest.mark.parametrize("arch", ARCHS + ["tiny-lm"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_gene_applicability_equals_the_reference(arch, kind):
    cfg, jcfg = get_config(arch), jget(arch)
    for g, (_, pred) in plan.GENES.items():
        assert pred(cfg, kind) == j_plan.GENES[g][1](jcfg, kind)


def test_genome_roundtrip_and_ops():
    cfg = get_config("qwen2-7b")
    rng = np.random.default_rng(0)
    g = plan.PlanGenome.random(cfg, "prefill", rng)
    g2 = plan.PlanGenome.from_plan(cfg, "prefill", g.to_plan())
    assert g.key() == g2.key()
    child = g.crossover(g2.mutate(rng, 1.0), rng)
    assert set(child.alleles) == set(g.alleles)
    off = _pallas_off(plan.PlanGenome.from_plan(
        cfg, "prefill", cfg.plan.replace(attn_impl="pallas",
                                         mlp_impl="pallas")))
    assert (off.to_plan().attn_impl, off.to_plan().mlp_impl) == \
        ("xla_chunked", "xla")


def test_power_model_equals_the_reference():
    pm = power.PowerModel(power.HardwareSpec(**SPEC))
    jpm = j_power.PowerModel(j_power.HardwareSpec(**SPEC))
    for args in ((3e14, 2e11, 1e9, 0.7, 4), (0.0, 0.0, 0.0, 1.0, 1),
                 (1e12, 5e10, 0.0, 0.0, 2)):
        _close(pm.energy(*args), jpm.energy(*args))
        _close(pm.watts(*args), jpm.watts(*args))
    for chips in (1, 256):
        _close(pm.step_time(1e15, 3e12, 2e10, chips, 0.5),
               jpm.step_time(1e15, 3e12, 2e10, chips, 0.5))


def test_h100_spec_is_the_cards_own():
    h = power.H100
    assert (h.peak_flops, h.hbm_bw) == (989e12, 3.35e12)
    assert 80e9 <= h.hbm_bytes <= 86e9
    assert 0 < h.p_static < 700 and h.e_flop > 0 and h.e_hbm > 0
    assert 0 < h.reached_flops < h.peak_flops
    assert 0 < h.reached_bw < h.hbm_bw
    assert h.power_limit == 700.0
    assert not hasattr(power, "V5E")
    assert power.PowerModel().hw is h


def test_power_model_times_at_the_reached_rates_under_the_cap():
    pm = power.PowerModel()
    h = pm.hw
    # a window at the reached rate draws what the fit says it does
    flops = h.reached_flops * 2.0
    assert pm.step_time(flops, 0.0, 0.0, 1) == pytest.approx(2.0)
    assert pm.watts(flops, 0.0, 0.0, 2.0) == pytest.approx(
        h.p_static + h.reached_flops * h.e_flop)
    # bytes that fit under the 2 s of operations, with more joules than
    # the limit allows in 2 s: stretched to the time at the limit
    nbytes = h.reached_bw * 1.9
    assert pm.watts(flops, nbytes, 0.0, 2.0) > h.power_limit
    t = pm.step_time(flops, nbytes, 0.0, 1)
    assert t > 2.0
    assert pm.watts(flops, nbytes, 0.0, t) == pytest.approx(h.power_limit)
    # without the fields the model is the reference's (data-sheet peaks)
    plain = power.PowerModel(dataclasses.replace(
        h, reached_flops=0.0, reached_bw=0.0, power_limit=0.0))
    assert plain.step_time(flops, 0.0, 0.0, 1) == pytest.approx(
        flops / h.peak_flops)


def test_calibration_solves_the_constants_the_model_reproduces():
    from repro_torch.benchmarks import calibrate_power as cal
    h = power.H100
    # two windows drawn by the committed constants at the reached rates:
    # one bound by operations, one by bytes
    wins = []
    for flops, nbytes in ((h.reached_flops * 5.0, 1.8e12),
                          (3.0e13, h.reached_bw * 5.0)):
        t = max(flops / h.reached_flops, nbytes / h.reached_bw)
        wins.append({"flops": flops, "bytes": nbytes, "seconds": t,
                     "joules": h.p_static * t + flops * h.e_flop
                     + nbytes * h.e_hbm})
    e_flop, e_hbm = cal.solve(h.p_static, wins)
    _close(e_flop, h.e_flop)
    _close(e_hbm, h.e_hbm)
    # and the model gives each window back: its time and its watts
    pm = power.PowerModel()
    for w in wins:
        t = pm.step_time(w["flops"], w["bytes"], 0.0, 1)
        _close(t, w["seconds"])
        _close(pm.watts(w["flops"], w["bytes"], 0.0, t),
               w["joules"] / w["seconds"])
    with pytest.raises(ValueError, match="do not separate"):
        cal.solve(h.p_static, [wins[0], wins[0]])


def test_calibration_takes_each_constants_median():
    from repro_torch.benchmarks import calibrate_power as cal
    runs = [dict.fromkeys(cal.CONSTANTS, v) for v in (3.0, 1.0, 2.0)]
    runs[0]["p_static"] = 0.5
    med = cal.median_constants(runs)
    assert med == {**dict.fromkeys(cal.CONSTANTS, 2.0), "p_static": 1.0}
    assert set(cal.CONSTANTS) <= {f.name for f in
                                  dataclasses.fields(power.HardwareSpec)}


def test_analytic_32k_plans_stay_under_the_cards_limit_and_differ():
    cfg = get_config("qwen2-7b")
    v = Verifier(cfg, "prefill_32k_b1")
    got = {}
    for attn in plan.GENES["attn_impl"][0]:
        for mlp in plan.GENES["mlp_impl"][0]:
            m = v.measure_plan(cfg.plan.replace(attn_impl=attn,
                                                mlp_impl=mlp))
            assert m.ok
            assert power.H100.p_static < m.watts <= power.H100.power_limit \
                * (1 + 1e-12)
            assert m.trace.peak_watts() <= power.H100.power_limit \
                * (1 + 1e-12)
            _close(m.trace.integrate(), m.energy_j)
            got[attn, mlp] = (m.seconds, m.watts)
    assert len(set(got.values())) > 1
    # the fused MLP keeps its intermediate on chip: fewer bytes, fewer W
    assert got["pallas", "pallas"][1] < got["pallas", "xla"][1]
    # the naive attention's S^2 scores cost time at the limit
    assert got["xla", "xla"][0] > got["xla_chunked", "xla"][0]


# ---------------------------------------------------------------------------
# census and estimate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_site_census_equals_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    for p, jp in ((cfg.plan, _ref_plan(jcfg)),
                  (cfg.plan.replace(attn_impl="xla", mlp_impl="pallas",
                                    attn_chunk=256),
                   dataclasses.replace(_ref_plan(jcfg), attn_impl="xla",
                                       mlp_impl="pallas", attn_chunk=256))):
        got = intensity.site_census(cfg, SHAPES[shape], p)
        want = j_intensity.site_census(jcfg, J_SHAPES[shape], jp)
        assert [s.name for s in got] == [s.name for s in want]
        for a, b in zip(got, want):
            _close(a.flops, b.flops)
            _close(a.hbm_bytes, b.hbm_bytes)
            assert (a.count, a.vmem_working_set) == \
                (b.count, b.vmem_working_set)
            _close(a.intensity, b.intensity)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("n_chips", [1, 256])
def test_estimate_program_equals_the_reference(arch, shape, n_chips):
    cfg, jcfg = get_config(arch), jget(arch)
    got = intensity.estimate_program(cfg, SHAPES[shape], cfg.plan, n_chips)
    want = j_intensity.estimate_program(jcfg, J_SHAPES[shape],
                                        _ref_plan(jcfg), n_chips)
    for f in ("flops", "hbm_bytes", "coll_bytes", "peak_mem_per_chip"):
        _close(getattr(got, f), getattr(want, f))
    assert got.coll_ops == want.coll_ops == 0
    assert got.breakdown == want.breakdown


def test_moe_capacity_equals_the_reference():
    from repro.models.layers import moe_capacity as j_moe_capacity
    jcfg = jget("granite-moe-1b-a400m")
    for n in (1, 7, 4096, 131072):
        assert intensity.moe_capacity(jcfg, n) == j_moe_capacity(jcfg, n)


def test_estimate_program_refuses_train_shapes():
    cfg = get_config("qwen2-7b")
    with pytest.raises(NotImplementedError, match="section A item 5"):
        intensity.estimate_program(cfg, SHAPES["train_4k"], cfg.plan, 256)


def test_card_shapes_cut_only_the_batch_and_stay_out_of_shapes():
    assert set(SHAPES) == set(J_SHAPES)
    assert not set(CARD_SHAPES) & set(SHAPES)
    for name, ref in (("prefill_32k_b1", "prefill_32k"),
                      ("decode_32k_b8", "decode_32k")):
        s, r = get_shape(name), SHAPES[ref]
        assert (s.seq_len, s.kind) == (r.seq_len, r.kind)
        assert s.global_batch < r.global_batch
    assert get_config("qwen2-7b").applicable_shapes() == \
        jget("qwen2-7b").applicable_shapes()
    with pytest.raises(KeyError):
        get_shape("prefill_1m")


# ---------------------------------------------------------------------------
# narrowing
# ---------------------------------------------------------------------------

def _vmem_rule(site, cfg, shape, p):
    """The reference's resource pre-check, injected."""
    if site.vmem_working_set <= j_narrowing.VMEM_BYTES:
        return None
    return (f"VMEM working set {site.vmem_working_set/2**20:.1f} "
            f"MiB > {j_narrowing.VMEM_BYTES/2**20:.0f} MiB "
            f"(resource pre-check)")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("chunk", [256, 2048])
def test_narrowing_equals_the_reference_under_its_vmem_rule(arch, shape,
                                                            chunk):
    cfg, jcfg = get_config(arch), jget(arch)
    p = cfg.plan.replace(attn_chunk=chunk)
    jp = dataclasses.replace(_ref_plan(jcfg), attn_chunk=chunk)
    got = narrowing.narrow_candidates(cfg, SHAPES[shape], p,
                                      fits=_vmem_rule)
    want = j_narrowing.narrow_candidates(jcfg, J_SHAPES[shape], jp)
    assert got.considered == want.considered
    assert got.rejected == want.rejected
    assert [(c.name, c.overrides, c.rationale) for c in got.candidates] == \
        [(c.name, c.overrides, c.rationale) for c in want.candidates]
    assert got.funnel() == want.funnel()


def test_card_precheck_keeps_the_kernels_the_vmem_rule_would_drop():
    cfg = get_config("qwen2-7b")
    shape = get_shape("prefill_32k_b1")
    p = cfg.plan.replace(attn_chunk=2048)
    card = narrowing.narrow_candidates(cfg, shape, p)
    vmem = narrowing.narrow_candidates(cfg, shape, p, fits=_vmem_rule)
    assert {c.name for c in card.candidates} == {"attn", "mlp", "attn+mlp"}
    assert "attn" in dict(vmem.rejected)
    # the census' attention working set is far above a block's 227 KB,
    # the kernel's own request is not
    ws = [s for s in card.considered if s["site"] == "attn"][0]["vmem_ws"]
    assert ws > narrowing.SMEM_OPTIN_BYTES
    assert narrowing.site_smem_bytes("attn", cfg, shape, p) <= \
        narrowing.SMEM_OPTIN_BYTES


def test_card_precheck_rejects_a_kernel_over_the_limit():
    cfg = get_config("qwen2-7b")
    rep = narrowing.narrow_candidates(
        cfg, get_shape("prefill_32k_b1"),
        fits=narrowing.SharedMemoryFit(limit=100_000))
    rejected = dict(rep.rejected)
    assert "resource pre-check" in rejected["mlp"]      # 197,632 B
    assert [c.name for c in rep.candidates] == ["attn"]  # 87,040 B


def test_shared_memory_fit_without_a_card_is_the_h100s():
    assert narrowing.SharedMemoryFit.for_device("cpu").limit == 232448
    assert narrowing.SMEM_OPTIN_BYTES == 232448


@pytest.mark.parametrize("kernel,args,want", [
    # the launcher's requests, by the formulas of each .cu (card tests hold
    # the wrappers to what the launcher records)
    ("flash", (128, torch.bfloat16), (64 + 4 * 64) * 136 * 2),
    ("flash", (256, torch.bfloat16), (128 + 4 * 64) * 264 * 2),
    ("flash", (128, torch.float32), (2 * 128 * 64 + 64 * 128 + 64 * 64) * 4),
    ("swiglu", (32768, 3584, 18944, torch.bfloat16),
     4 * (128 * 64 * 2 * 3) + 1024),
    ("swiglu", (8, 3584, 18944, torch.bfloat16), 4 * (32 * 72 + 128 * 72) * 2),
    ("swiglu", (8, 64, 128, torch.float32), (128 * 8 + 32 * 8 + 8192) * 4),
    ("swiglu", (40, 64, 128, torch.float32),
     (128 * 64 + 32 * 64 + 8192) * 4),
    ("ssd", (64, 128, 256, torch.bfloat16), 256 * 208 * 2 + 520 * 4),
    ("rglru", (), 0),
])
def test_kernel_smem_figures(kernel, args, want):
    fn = {"flash": flash_attention.smem_bytes, "swiglu": swiglu.smem_bytes,
          "ssd": ssd.smem_bytes, "rglru": rglru.smem_bytes}[kernel]
    assert fn(*args) == want


def test_ssd_smem_figure_follows_dtype_and_chunk():
    assert ssd.smem_bytes(64, 128, 256, torch.float32) != \
        ssd.smem_bytes(64, 128, 256, torch.bfloat16)
    assert ssd.smem_bytes(64, 128, 130, torch.bfloat16) < \
        ssd.smem_bytes(64, 128, 256, torch.bfloat16)
    with pytest.raises(TypeError):
        ssd.smem_bytes(64, 128, 256, torch.float16)


def test_site_smem_uses_the_sites_shape():
    cfg = get_config("qwen2-7b")
    p = cfg.plan
    assert narrowing.site_smem_bytes("mlp", cfg, get_shape("decode_32k_b8"),
                                     p) == swiglu.smem_bytes(8, 3584, 18944,
                                                             torch.bfloat16)
    assert narrowing.site_smem_bytes("mlp", cfg, get_shape("prefill_32k_b1"),
                                     p) == swiglu.smem_bytes(
        32768, 3584, 18944, torch.bfloat16)
    m = get_config("mamba2-1.3b")
    assert narrowing.site_smem_bytes("ssm", m, SHAPES["prefill_32k"],
                                     m.plan) == ssd.smem_bytes(
        64, 128, 256, torch.bfloat16)
    with pytest.raises(KeyError):
        narrowing.site_smem_bytes("head", cfg, SHAPES["prefill_32k"], p)


# ---------------------------------------------------------------------------
# analytic rung and verifier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPE_NAMES)
def test_analytic_measurement_equals_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jget(arch)
    v = Verifier(cfg, shape, n_chips=256,
                 power=power.PowerModel(power.HardwareSpec(**SPEC)))
    jv = JVerifier(jcfg, shape, n_chips=256,
                   power=j_power.PowerModel(j_power.HardwareSpec(**SPEC)))
    got = v.measure_plan(cfg.plan)
    want = jv.measure_plan(_ref_plan(jcfg))
    assert got.ok == want.ok
    for f in ("seconds", "watts", "energy_j", "flops", "hbm_bytes",
              "peak_mem_per_chip"):
        _close(getattr(got, f), getattr(want, f))
    _close(got.trace.integrate(), got.energy_j)
    _close(got.trace.integrate(), want.trace.integrate())


def test_analytic_oom_is_a_penalty():
    cfg = get_config("qwen2-7b")
    small = power.PowerModel(dataclasses.replace(power.H100, hbm_bytes=1e9))
    m = Verifier(cfg, "prefill_32k_b1", power=small).measure_plan(cfg.plan)
    assert not m.ok and m.error.startswith("OOM")
    assert m.seconds == fitness.TIMEOUT_PENALTY_S
    _close(m.trace.integrate(), m.energy_j)


def test_registry_builds_every_rung_by_name():
    assert set(backends.BACKENDS) == {"analytic", "measured", "replay"}
    for name in backends.BACKENDS:
        assert backends.make_backend(name).name == name
    with pytest.raises(KeyError):
        backends.make_backend("compiled")


def test_verifier_defaults_are_one_card():
    v = Verifier(get_config("qwen2-7b"), "prefill_32k_b1")
    assert (v.n_chips, v.tp, v.power.hw) == (1, 1, power.H100)
    assert (v.rungs.search, v.rungs.finalist, v.rungs.smoke,
            v.rungs.governor) == ("analytic", "analytic", "measured",
                                  "measured")
    assert v.context.shape == get_shape("prefill_32k_b1")
    assert v.penalties.rungs == ("measured", "replay")


def test_confirms_preference_equals_the_reference():
    pm, jpm = power.PowerModel(), j_power.PowerModel()
    cases = [(1.0, 100.0), (4.0, 100.0), (1.0, 99.0), (None, None)]

    def make(mod, m, c):
        if c == (None, None):
            return mod.penalty_measurement("boom", m)
        return mod.Measurement(seconds=c[0], watts=c[1],
                               energy_j=c[0] * c[1])
    for a in cases:
        for b in cases:
            assert backends.confirms_preference(
                make(backends, pm, a), make(backends, pm, b)) == \
                j_backends.confirms_preference(make(j_backends, jpm, a),
                                               make(j_backends, jpm, b))


class _FlakyRung:
    """Fails the first ``fail_n`` trials, then succeeds."""
    name = "measured"

    def __init__(self, fail_n):
        self.fail_n, self.calls = fail_n, 0

    def measure(self, ctx, p):
        self.calls += 1
        if self.calls <= self.fail_n:
            return backends.penalty_measurement("stub: OOM", ctx.power)
        return backends.Measurement(seconds=1.0, watts=100.0,
                                    energy_j=100.0, source="measured")


def test_measured_penalties_get_a_retry_and_heal():
    cfg = get_config("tiny-test")
    flaky = _FlakyRung(fail_n=1)
    v = Verifier(cfg, "decode_32k", backends={"measured": flaky})
    assert not v.measure_plan(cfg.plan, rung="measured").ok
    m2 = v.measure_plan(cfg.plan, rung="measured")
    assert m2.ok and flaky.calls == 2
    assert v.measure_plan(cfg.plan, rung="measured") is m2


def test_measured_penalty_retry_budget_and_ttl():
    cfg = get_config("tiny-test")
    flaky = _FlakyRung(fail_n=2)
    now = [0.0]
    v = Verifier(cfg, "decode_32k", backends={"measured": flaky},
                 penalties=PenaltyPolicy(retries=1, ttl_s=60.0),
                 clock=lambda: now[0])
    for _ in range(3):
        assert not v.measure_plan(cfg.plan, rung="measured").ok
    assert flaky.calls == 2
    now[0] = 61.0
    assert v.measure_plan(cfg.plan, rung="measured").ok


# ---------------------------------------------------------------------------
# GA and the destination ladder (properties of the reference's tests)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("qwen2-7b", "prefill_32k_b1"),
                                        ("mamba2-1.3b", "prefill_32k"),
                                        ("recurrentgemma-9b", "decode_32k")])
def test_ga_measures_only_new_patterns_and_keeps_its_elites(arch, shape):
    cfg = get_config(arch)
    kind = get_shape(shape).kind
    v = Verifier(cfg, shape)
    base = v.measure(plan.PlanGenome.from_plan(cfg, kind, cfg.plan))
    res = run_ga(cfg, kind, v, GAConfig(population=6, generations=5,
                                        seed=1))
    assert v.n_trials == len(v.cache)
    assert res.n_trials <= 6 * 6 + 1
    best = [h["best_fitness"] for h in res.history]
    assert best == sorted(best)              # elitism: never worse
    assert res.best_measurement.fitness() >= base.fitness()
    assert len(res.history) == 5


def test_ga_power_fitness_uses_less_energy_than_time_only():
    cfg = get_config("qwen2-7b")
    v = Verifier(cfg, "decode_32k_b8")
    r_time = run_ga(cfg, "decode", v, GAConfig(population=8, generations=5,
                                               seed=3, alpha=1.0, beta=0.0))
    r_power = run_ga(cfg, "decode", v, GAConfig(population=8, generations=5,
                                                seed=3))
    assert r_power.best_measurement.energy_j <= \
        r_time.best_measurement.energy_j * 1.05


def test_destination_early_exit_and_full_ladder():
    cfg = get_config("qwen2-7b")
    v = Verifier(cfg, "prefill_32k_b1")
    sel = select_destination(cfg, "prefill", v, Requirement(max_seconds=1e9),
                             GAConfig(population=4, generations=2))
    assert sel.early_exit and len(sel.stages) == 1
    sel = select_destination(cfg, "prefill", Verifier(cfg, "prefill_32k_b1"),
                             Requirement(max_seconds=1e-9),
                             GAConfig(population=6, generations=3, seed=2))
    assert [s["stage"] for s in sel.stages] == ["xla_default", "xla_tuned",
                                                "pallas"]
    assert sel.chosen.measurement.fitness() >= sel.stages[0]["fitness"]


def test_finalists_promoted_to_the_measured_rung():
    tags = []

    class Rung:
        """Penalizes the kernel-offload plans, confirms the rest."""
        name = "measured"

        def measure(self, ctx, p):
            tags.append(backends.plan_tag(p))
            if "pallas" in (p.attn_impl, p.mlp_impl):
                return backends.penalty_measurement("stub: OOM", ctx.power)
            return backends.Measurement(seconds=2.0, watts=300.0,
                                        energy_j=600.0, source="measured")
    cfg = get_config("qwen2-7b")
    v = Verifier(cfg, "prefill_32k_b1", rungs=RungPolicy(finalist="measured"),
                 backends={"measured": Rung()})
    sel = select_destination(cfg, "prefill", v, Requirement(max_seconds=1e-9),
                             GAConfig(population=4, generations=1))
    assert tags and sel.stages[-1]["stage"] == "finalist[measured]"
    assert sel.stages[-1]["confirmed"]
    assert sel.chosen.measurement.source == "measured"
    assert "pallas" not in (sel.chosen.genome.to_plan().attn_impl,
                            sel.chosen.genome.to_plan().mlp_impl)


# ---------------------------------------------------------------------------
# the measured rung and adapt, on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def small_shapes(monkeypatch):
    monkeypatch.setitem(CARD_SHAPES, "cpu_prefill",
                        ShapeSpec("cpu_prefill", 64, 1, "prefill"))
    monkeypatch.setitem(CARD_SHAPES, "cpu_decode",
                        ShapeSpec("cpu_decode", 48, 2, "decode"))


def _measured(**kw):
    kw.setdefault("window_s", 0.05)
    kw.setdefault("decode_steps", 4)
    return backends.MeasuredBackend(device="cpu",
                                    source=ConstantSource(250.0), **kw)


@pytest.mark.parametrize("shape", ["cpu_prefill", "cpu_decode"])
def test_measured_rung_on_the_cpu(small_shapes, shape):
    cfg = get_config("tiny-test")
    rung = _measured()
    ctx = backends.MeasureContext(cfg, shape)
    m = rung.measure(ctx, cfg.plan)
    assert m.ok and m.source == "measured"
    meta = m.trace.meta
    assert meta["calls"] >= 3 and meta["counter"] is None
    assert meta["launches"] == {"flash_attention": 0, "swiglu": 0, "ssd": 0,
                                "rglru": 0}
    assert m.energy_j == pytest.approx(m.trace.integrate(), rel=1e-12)
    assert m.energy_j == pytest.approx(meta["window_j"] / meta["calls"],
                                       rel=1e-12)
    assert m.watts == pytest.approx(250.0, rel=1e-9)
    assert m.seconds == sorted(meta["call_seconds"])[meta["calls"] // 2]
    assert m.trace.phase_names() == ["trial"]
    # the weights are made once and shared by every plan
    params = rung.params["tiny-test"]
    rung.measure(ctx, cfg.plan.replace(attn_impl="pallas"))
    assert rung.params["tiny-test"] is params


def test_measured_rung_uses_the_plans_kv_cache(small_shapes, monkeypatch):
    seen = []
    orig = Model.init_cache

    def spy(self, b, s):
        cache = orig(self, b, s)
        seen.append(cache[0]["k"].dtype)
        return cache
    monkeypatch.setattr(Model, "init_cache", spy)
    cfg = get_config("tiny-test")
    _measured().measure(backends.MeasureContext(cfg, "cpu_decode"),
                        cfg.plan.replace(kv_cache_dtype="int8"))
    assert seen == [torch.int8]


def test_measured_rung_turns_an_oom_into_a_penalty(small_shapes,
                                                   monkeypatch):
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 120.00 GiB")
    monkeypatch.setattr(Model, "prefill", oom)
    cfg = get_config("tiny-test")
    m = _measured().measure(backends.MeasureContext(cfg, "cpu_prefill"),
                            cfg.plan)
    assert not m.ok and m.error.startswith("OOM: CUDA out of memory")
    assert m.seconds == fitness.TIMEOUT_PENALTY_S


def test_measured_rung_turns_the_timeout_into_a_penalty(small_shapes):
    cfg = get_config("tiny-test")
    m = _measured().measure(backends.MeasureContext(
        cfg, "cpu_prefill", timeout_s=0.0), cfg.plan)
    assert not m.ok and "verification timeout" in m.error


def test_measured_rung_lets_every_other_failure_through(small_shapes,
                                                        monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("swiglu kernel launch failed: CUDA error 700")
    monkeypatch.setattr(Model, "prefill", broken)
    cfg = get_config("tiny-test")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _measured().measure(backends.MeasureContext(cfg, "cpu_prefill"),
                            cfg.plan)


def test_measured_rung_refuses_train_shapes():
    cfg = get_config("tiny-test")
    with pytest.raises(NotImplementedError, match="section A item 5"):
        _measured().measure(backends.MeasureContext(cfg, "train_4k"),
                            cfg.plan)


def test_measured_rung_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("tiny-test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backends.MeasuredBackend().measure(
            backends.MeasureContext(cfg, "prefill_32k_b1"), cfg.plan)


def test_replay_rung_serves_what_the_measured_rung_recorded(small_shapes,
                                                            tmp_path):
    cfg = get_config("tiny-test")
    ctx = backends.MeasureContext(cfg, "cpu_prefill")
    m = _measured(record_dir=tmp_path).measure(ctx, cfg.plan)
    r = backends.ReplayBackend(root=tmp_path).measure(ctx, cfg.plan)
    assert r.ok and r.source == "replay"
    assert r.energy_j == pytest.approx(m.energy_j, rel=1e-12)
    missing = backends.ReplayBackend(root=tmp_path).measure(
        ctx, cfg.plan.replace(attn_chunk=512))
    assert not missing.ok and "no recorded trace" in missing.error


def test_plan_kernels_names_the_pallas_genes():
    cfg = get_config("recurrentgemma-9b")
    genes = plan.PlanGenome.gene_names(cfg, "prefill")
    p = cfg.plan.replace(attn_impl="pallas", rglru_impl="pallas",
                         ssm_impl="pallas")
    assert backends.plan_kernels(p, genes) == ["flash_attention", "rglru"]
    assert backends.plan_kernels(cfg.plan.replace(attn_impl="xla"),
                                 genes) == []


def test_adapt_steps_1_to_3_and_6_on_the_cpu(small_shapes):
    cfg = get_config("tiny-lm")
    lines = []
    rung = _measured()
    rep = adapt(cfg, "cpu_prefill", requirement=Requirement(max_seconds=1e-9),
                rungs=RungPolicy(finalist="measured", smoke="measured"),
                verify=True, backends={"measured": rung},
                ga=GAConfig(population=4, generations=2), log=lines.append)
    assert len(rep.census) == 4 and "attn_impl" in rep.genes
    stages = [s["stage"] for s in rep.selection.stages]
    assert stages == ["xla_default", "xla_tuned", "pallas",
                      "finalist[measured]"]
    assert rep.selection.stages[-1]["confirmed"]
    assert rep.selection.chosen.measurement.source == "measured"
    assert (rep.chips, rep.placement["multi_pod"]) == (1, False)
    assert rep.verified["status"] == "OK" and rep.verified["rung"] == \
        "measured"
    assert rep.verified["launches"] == {"flash_attention": 0, "swiglu": 0,
                                        "ssd": 0, "rglru": 0}
    assert rep.reconfigurator is None and rep.slices == []
    assert rep.plan == rep.selection.chosen.genome.to_plan()
    assert any(line.startswith("step 6 [measured]: OK") for line in lines)
    assert "[measured]" in rep.summary()


class Counting:
    """A rung that counts the trials it runs."""

    def __init__(self, backend):
        self.backend, self.name, self.plans = backend, backend.name, []

    def measure(self, ctx, plan):
        self.plans.append(backends.plan_tag(plan))
        return self.backend.measure(ctx, plan)


def test_adapt_step_6_reuses_the_finalist_trial_on_one_card(small_shapes):
    cfg = get_config("tiny-lm")
    rung = Counting(_measured())
    rep = adapt(cfg, "cpu_prefill", requirement=Requirement(max_seconds=1e-9),
                rungs=RungPolicy(finalist="measured", smoke="measured"),
                verify=True, backends={"measured": rung},
                ga=GAConfig(population=4, generations=2))
    chosen = backends.plan_tag(rep.plan)
    # the chosen plan was a finalist: one trial of it, in the search
    assert rung.plans.count(chosen) == 1
    assert len(rung.plans) == len(set(rung.plans))
    m = rep.selection.chosen.measurement
    assert (rep.verified["seconds"], rep.verified["energy_ws"]) == \
        (m.seconds, m.energy_j)


def test_adapt_step_6_runs_a_trial_when_no_finalist_ran_on_its_rung(
        small_shapes):
    cfg = get_config("tiny-lm")
    rung = Counting(_measured())
    rep = adapt(cfg, "cpu_prefill", requirement=Requirement(max_seconds=1e-9),
                rungs=RungPolicy(finalist="analytic", smoke="measured"),
                verify=True, backends={"measured": rung},
                ga=GAConfig(population=4, generations=2))
    assert rung.plans == [backends.plan_tag(rep.plan)]
    assert rep.verified["status"] == "OK" and \
        rep.selection.chosen.measurement.source == "analytic"


def test_measured_rung_keeps_each_plans_last_logits(small_shapes):
    cfg = get_config("tiny-test")
    rung = _measured()
    ctx = backends.MeasureContext(cfg, "cpu_prefill")
    rung.measure(ctx, cfg.plan)
    rung.measure(ctx, cfg.plan.replace(attn_impl="xla"))
    a, b = rung.outputs.values()
    assert a.shape == (1, cfg.vocab_size) and a.dtype == torch.float32
    # a copy of the last row, not a view holding every position's logits
    assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
    # chunked and naive attention in bf16: the same function, to 0.045 of
    # the largest logit (the share two plans' prefills are held to on the
    # card; here 0.011)
    assert float((a - b).abs().max()) <= 0.045 * float(a.abs().max())


def test_measured_rung_refuses_non_finite_logits(small_shapes, monkeypatch):
    orig = Model.prefill

    def nan(self, params, batch, cache):
        logits, cache = orig(self, params, batch, cache)
        return logits * float("nan"), cache
    monkeypatch.setattr(Model, "prefill", nan)
    cfg = get_config("tiny-test")
    with pytest.raises(RuntimeError, match="non-finite logits"):
        _measured().measure(backends.MeasureContext(cfg, "cpu_prefill"),
                            cfg.plan)


def test_adapt_books_an_oom_finalist_as_a_penalty(small_shapes, monkeypatch):
    orig = Model.prefill

    def prefill(self, params, batch, cache):
        if self.plan.mlp_impl == "pallas":
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return orig(self, params, batch, cache)
    monkeypatch.setattr(Model, "prefill", prefill)
    cfg = get_config("tiny-lm")
    rep = adapt(cfg, "cpu_prefill", requirement=Requirement(max_seconds=1e-9),
                rungs=RungPolicy(finalist="measured", smoke="measured"),
                verify=True, backends={"measured": _measured()},
                ga=GAConfig(population=4, generations=2))
    assert rep.selection.stages[-1]["confirmed"]
    assert rep.plan.mlp_impl != "pallas"
    assert rep.verified["status"] == "OK"


def test_adapt_lets_a_broken_kernel_stop_the_search(small_shapes,
                                                    monkeypatch):
    def prefill(self, params, batch, cache):
        raise RuntimeError("flash_attention kernel launch failed")
    monkeypatch.setattr(Model, "prefill", prefill)
    cfg = get_config("tiny-lm")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        adapt(cfg, "cpu_prefill", requirement=Requirement(max_seconds=1e-9),
              rungs=RungPolicy(finalist="measured"),
              backends={"measured": _measured()},
              ga=GAConfig(population=4, generations=2))

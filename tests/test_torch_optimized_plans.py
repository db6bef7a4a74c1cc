"""The plan's sharding fields, ``configs.optimized`` and ``estimate_program``
with tensor parallelism, against the reference.

``PlanConfig`` has the reference's fields, defaults and order but
``moe_impl`` and ``scan_layers``; ``GENES`` are equal in order;
``optimized_plan`` equals the reference's field for field.
``estimate_program`` is held equal at rel 1e-12 for every arch × shape at
``(n_chips, tp)`` of ``(256, 16)``, ``(512, 16)`` and ``(1, 1)``, under the
arch's plan, the three optimized plans and the plans with one sharding
gene flipped; the analytic verifier mirrors ``tests/test_optimized_plans.py``
at 256 chips, and equals the reference's under one ``HardwareSpec`` built
here in both packages.
"""
import dataclasses

import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget
from repro.configs.base import PlanConfig as JPlanConfig
from repro.configs.optimized import optimized_plan as j_optimized_plan
from repro.core import intensity as j_intensity
from repro.core import plan as j_plan
from repro.core import power as j_power
from repro.core.verifier import Verifier as JVerifier
from repro_torch.configs import SHAPES, PlanConfig, get_config, list_archs
from repro_torch.configs.optimized import _PURE_DP, optimized_plan
from repro_torch.core import intensity, plan, power
from repro_torch.core.verifier import Verifier

REL = 1e-12
ALL = list_archs()
ARCHS = [a for a in ALL if not a.startswith("tiny")]
KINDS = ("train", "prefill", "decode")
#: the reference's plan fields the port leaves out
REF_ONLY_FIELDS = ("moe_impl", "scan_layers")
SHARDING_GENES = ("fsdp", "seq_shard", "shard_moe_experts", "use_tp",
                  "overlap_collectives")
MESHES = ((256, 16), (512, 16), (1, 1))
#: one spec, built in both packages from the same numbers
SPEC = dict(name="test_chip", peak_flops=500e12, hbm_bw=2.0e12,
            hbm_bytes=64e9, ici_bw=100e9, e_flop=1.1e-12, e_hbm=1.3e-10,
            e_ici=2e-11, p_static=90.0)


def _shared(jp) -> dict:
    return {k: v for k, v in dataclasses.asdict(jp).items()
            if k not in REF_ONLY_FIELDS}


def _ref(p, jcfg):
    """The reference plan equal to the port's ``p`` in every shared field
    (the left-out fields at the arch's own values)."""
    return dataclasses.replace(jcfg.plan, **dataclasses.asdict(p))


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=1e-300)


# ---------------------------------------------------------------------------
# (a) plans
# ---------------------------------------------------------------------------

def test_plan_fields_defaults_and_order_are_the_references():
    ref = [(f.name, f.default) for f in dataclasses.fields(JPlanConfig)
           if f.name not in REF_ONLY_FIELDS]
    assert [(f.name, f.default) for f in dataclasses.fields(PlanConfig)] \
        == ref
    assert PlanConfig().describe() == ",".join(
        f"{k}={v}" for k, v in ref)
    assert (PlanConfig().fsdp, PlanConfig().seq_shard,
            PlanConfig().shard_moe_experts, PlanConfig().use_tp,
            PlanConfig().overlap_collectives) == (True,) * 4 + (False,)


def test_plan_refuses_a_sharding_gene_that_is_not_a_bool():
    with pytest.raises(ValueError, match="use_tp"):
        PlanConfig(use_tp="no")


def test_genes_equal_the_references_in_order():
    assert list(plan.GENES) == list(j_plan.GENES)
    for g, (alleles, _) in plan.GENES.items():
        assert alleles == j_plan.GENES[g][0]


@pytest.mark.parametrize("arch", ALL)
@pytest.mark.parametrize("kind", KINDS)
def test_gene_predicates_and_genomes_equal_the_references(arch, kind):
    cfg, jcfg = get_config(arch), jget(arch)
    _same = [g for g, (_, pred) in plan.GENES.items() if pred(cfg, kind)]
    assert _same == [g for g, (_, pred) in j_plan.GENES.items()
                     if pred(jcfg, kind)]
    assert plan.PlanGenome.from_plan(cfg, kind, cfg.plan).alleles == \
        j_plan.PlanGenome.from_plan(jcfg, kind, jcfg.plan).alleles


@pytest.mark.parametrize("arch", ALL)
def test_arch_plans_equal_the_references(arch):
    assert dataclasses.asdict(get_config(arch).plan) == \
        _shared(jget(arch).plan)
    assert dataclasses.asdict(get_config(arch, reduced=True).plan) == \
        _shared(jget(arch, reduced=True).plan)


@pytest.mark.parametrize("arch", ALL)
@pytest.mark.parametrize("kind", KINDS)
def test_optimized_plan_equals_the_references(arch, kind):
    assert dataclasses.asdict(optimized_plan(arch, kind)) == \
        _shared(j_optimized_plan(arch, kind))


def test_moe_trains_keep_expert_parallelism():
    for arch in ("moonshot-v1-16b-a3b", "granite-moe-1b-a400m"):
        assert optimized_plan(arch, "train").use_tp is True


def test_pure_dp_only_for_single_chip_weights():
    for arch in _PURE_DP:
        assert get_config(arch).param_count() * 2 < 15 * 2**30, arch


def test_decode_plans_quantize_cache():
    for arch in ("llama3-405b", "qwen2-7b", "stablelm-12b"):
        assert optimized_plan(arch, "decode").kv_cache_dtype == "int8"
    assert optimized_plan("mamba2-1.3b", "decode").use_tp is False


# ---------------------------------------------------------------------------
# (b) estimate_program
# ---------------------------------------------------------------------------

def _plans(arch):
    cfg = get_config(arch)
    out = {"arch": cfg.plan}
    out.update({f"opt_{k}": optimized_plan(arch, k) for k in KINDS})
    for g in SHARDING_GENES:
        out[f"flip_{g}"] = cfg.plan.replace(**{g: not getattr(cfg.plan, g)})
    return out


@pytest.mark.parametrize("arch", ALL)
@pytest.mark.parametrize("n_chips,tp", MESHES)
def test_estimate_program_equals_the_reference(arch, n_chips, tp):
    cfg, jcfg = get_config(arch), jget(arch)
    for pname, p in _plans(arch).items():
        jp = _ref(p, jcfg)
        for shape in cfg.applicable_shapes():
            got = intensity.estimate_program(cfg, SHAPES[shape], p, n_chips,
                                             tp)
            want = j_intensity.estimate_program(jcfg, J_SHAPES[shape], jp,
                                                n_chips, tp)
            for f in ("flops", "hbm_bytes", "coll_bytes",
                      "peak_mem_per_chip"):
                _close(getattr(got, f), getattr(want, f))
            assert got.coll_ops == want.coll_ops, (pname, shape)
            assert got.breakdown == want.breakdown


def test_estimate_program_tp_moves_the_collectives():
    """At 256 chips the TP reductions and the seq-sharded KV gather are
    charged under use_tp and vanish without it (qwen2-7b's 4 KV heads do
    not divide 16)."""
    cfg = get_config("qwen2-7b")
    dec = SHAPES["decode_32k"]
    tp = intensity.estimate_program(cfg, dec, cfg.plan, 256, 16)
    dp = intensity.estimate_program(cfg, dec, cfg.plan.replace(use_tp=False),
                                    256, 16)
    assert tp.coll_bytes > 0 and tp.coll_ops == 2 * cfg.n_layers
    assert dp.coll_bytes == 0.0 and dp.coll_ops == 0
    assert intensity.estimate_program(cfg, dec, cfg.plan, 256).coll_bytes \
        == 0.0                                       # the port's tp=1


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-1.3b",
                                  "recurrentgemma-9b", "tiny-lm"])
def test_c6_one_chip_train_charges_fsdp_gathers(arch):
    """Reference fault C6, kept: at one chip, with no data axis to gather
    over, a plan with fsdp=True is still charged the FSDP gathers
    (``n_active * cdt``, twice under full remat) and two collectives a
    layer per pass, in both packages alike."""
    cfg, jcfg = get_config(arch), jget(arch)
    shape = SHAPES["train_4k"]
    on, off = cfg.plan.replace(fsdp=True), cfg.plan.replace(fsdp=False)
    e_on = intensity.estimate_program(cfg, shape, on, 1, 1)
    e_off = intensity.estimate_program(cfg, shape, off, 1, 1)
    gather = cfg.active_param_count() * 2 * (2 if on.remat == "full" else 1)
    _close(e_on.coll_bytes - e_off.coll_bytes, gather)
    assert e_off.coll_bytes == 0.0                   # dp = 1: no reduction
    passes = 2 if on.remat == "none" else 3
    assert e_on.coll_ops - e_off.coll_ops == \
        cfg.n_layers * 2 * passes * on.microbatches
    j_on = j_intensity.estimate_program(jcfg, J_SHAPES["train_4k"],
                                        _ref(on, jcfg), 1, 1)
    _close(j_on.coll_bytes, e_on.coll_bytes)
    assert j_on.coll_ops == e_on.coll_ops


# ---------------------------------------------------------------------------
# (c) the analytic verifier at 256 chips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_optimized_plan_measures_no_worse(arch):
    """The reference's property on the port's analytic verifier (the H100
    spec): for every runnable (arch, shape) at 256 chips with a 16-way
    model axis, the optimized plan is never worse than the arch's."""
    cfg = get_config(arch)
    for shape_name, shape in SHAPES.items():
        if shape_name in cfg.skip_shapes:
            continue
        v = Verifier(cfg, shape_name, n_chips=256, tp=16, mode="analytic")
        base = v.measure_plan(cfg.plan, shape.kind)
        opt = v.measure_plan(optimized_plan(arch, shape.kind), shape.kind)
        assert opt.ok, (arch, shape_name, opt.error)
        assert opt.seconds <= base.seconds * 1.02, (arch, shape_name)
        assert opt.energy_j <= base.energy_j * 1.05, (arch, shape_name)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_verifier_equals_the_reference_at_256_chips(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for shape_name, shape in SHAPES.items():
        if shape_name in cfg.skip_shapes:
            continue
        v = Verifier(cfg, shape_name, n_chips=256, tp=16,
                     power=power.PowerModel(power.HardwareSpec(**SPEC)))
        jv = JVerifier(jcfg, shape_name, n_chips=256, tp=16,
                       power=j_power.PowerModel(j_power.HardwareSpec(**SPEC)))
        for p in (cfg.plan, optimized_plan(arch, shape.kind)):
            got, want = v.measure_plan(p), jv.measure_plan(_ref(p, jcfg))
            assert (got.ok, got.error) == (want.ok, want.error)
            for f in ("seconds", "watts", "energy_j", "flops", "hbm_bytes",
                      "coll_bytes", "peak_mem_per_chip"):
                _close(getattr(got, f), getattr(want, f))
            _close(got.trace.integrate(), want.trace.integrate())

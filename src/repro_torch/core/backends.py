"""Measurement rungs — the verification environment as a backend layer.

Counterpart of ``repro.core.backends``.  The paper measures every offload
pattern on a *verification machine*, but not every trial costs the same:
the GA inner loop needs thousands of cheap estimates while the narrowed
finalists earn a real (expensive) trial — the FPGA-compile asymmetry that
§3.2's narrowing exists for.  A ``MeasurementBackend`` turns a plan into a
``Measurement``, and the registered rungs order themselves by fidelity and
cost:

  * ``analytic`` — roofline estimate on the H100 spec +
    ``synthesize_phase_trace``: milliseconds per pattern, the GA inner
    loop's rung.
  * ``measured`` — one real trial on the card: the plan's model runs the
    shape's prefill or decode, timed on the wall clock, its energy read
    from the card's NVML counter through the sampler.  This is the paper's
    own verification step, and takes the place of the reference's
    compiled rung (a 512-device dry-run, which comes with the sharding
    slice).
  * ``replay`` — re-read a trace a measured trial persisted (JSONL), for
    offline analysis on machines without the card.

Every rung obeys one invariant: ``Measurement.energy_j`` equals the
integral of its trace (``trace.integrate()``), so Watt·second comparisons
across rungs always compare trace-backed numbers.

``core.verifier.Verifier`` is the thin cache over this layer; its
``RungPolicy`` holds the promotion rules (which consumer measures on which
rung).
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, PlanConfig, ShapeSpec, \
    get_shape
from repro_torch.core.fitness import TIMEOUT_PENALTY_S, TIMEOUT_SECONDS, \
    fitness
from repro_torch.core.intensity import estimate_program
from repro_torch.core.power import H100, PowerModel
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import flash_attention, rglru, ssd, swiglu
from repro_torch.telemetry.nvml import WINDOW_S, NvmlSource, \
    describe_window, sample_window
from repro_torch.telemetry.sampler import synthesize_phase_trace
from repro_torch.telemetry.trace import PowerTrace

REPO_ROOT = Path(__file__).resolve().parents[3]
ART_MEASURED = REPO_ROOT / "artifacts" / "measured"

#: plan gene -> the kernel its 'pallas' destination launches
PLAN_KERNELS = {"attn_impl": flash_attention.KERNEL,
                "mlp_impl": swiglu.KERNEL, "ssm_impl": ssd.KERNEL,
                "rglru_impl": rglru.KERNEL}
#: what the device may hold above its level before a trial once a penalty
#: is cleaned up: cuBLAS keeps a workspace per handle and stream, made at
#: the first product
MEMORY_SLACK = 64 * 2**20


# ---------------------------------------------------------------------------
# Measurement — one verification trial's result, whatever rung produced it
# ---------------------------------------------------------------------------

@dataclass
class Measurement:
    seconds: float
    watts: float
    energy_j: float
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    peak_mem_per_chip: float = 0.0
    source: str = "analytic"            # which rung measured this
    ok: bool = True
    error: str = ""
    # phase-marked power trace of the trial.  The analytic rung synthesizes
    # it from the roofline terms; the measured/replay rungs carry the
    # sampled one.  On every rung integral(trace) == energy_j.
    trace: Optional[PowerTrace] = field(default=None, repr=False)
    # measured per-phase utilization (empty when the rung had no counter
    # to read)
    utilization: dict = field(default_factory=dict)

    def fitness(self, alpha: float = 0.5, beta: float = 0.5) -> float:
        return fitness(self.seconds, self.watts, alpha, beta)


def penalty_measurement(error: str, power: PowerModel) -> Measurement:
    """Paper §4.1: timeout/failure -> processing time := 1000 s."""
    trace = synthesize_phase_trace(
        [("penalty", TIMEOUT_PENALTY_S, 0.0)],
        static_watts=power.hw.p_static, samples_per_phase=4,
        meta={"source": "penalty"})
    return Measurement(seconds=TIMEOUT_PENALTY_S,
                       watts=power.hw.p_static,
                       energy_j=TIMEOUT_PENALTY_S * power.hw.p_static,
                       ok=False, error=error, source="penalty", trace=trace)


# ---------------------------------------------------------------------------
# The backend contract + registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeasureContext:
    """Everything a rung needs to know about the trial besides the plan."""
    cfg: ArchConfig
    shape_name: str
    n_chips: int = 1
    tp: int = 1
    power: PowerModel = field(default_factory=lambda: PowerModel(H100))
    overlap: float = 0.0                # collective/compute overlap fraction
    timeout_s: float = TIMEOUT_SECONDS

    @property
    def shape(self) -> ShapeSpec:
        """``SHAPES``, then ``CARD_SHAPES``."""
        return get_shape(self.shape_name)


@runtime_checkable
class MeasurementBackend(Protocol):
    name: str

    def measure(self, ctx: MeasureContext,
                plan: PlanConfig) -> Measurement: ...


BACKENDS: dict = {}          # rung name -> backend class


def register_backend(cls):
    """Class decorator: make the rung constructible by name."""
    BACKENDS[cls.name] = cls
    return cls


def make_backend(name: str, **kwargs) -> MeasurementBackend:
    if name not in BACKENDS:
        raise KeyError(f"unknown measurement rung {name!r}; "
                       f"registered: {sorted(BACKENDS)}")
    return BACKENDS[name](**kwargs)


def plan_tag(plan: PlanConfig) -> str:
    """Stable pattern id for a concrete plan (cache keys, artifact names)."""
    doc = json.dumps(dataclasses.asdict(plan), sort_keys=True)
    return hashlib.sha1(doc.encode()).hexdigest()[:10]


# ---------------------------------------------------------------------------
# Rung 1 — analytic: roofline + synthesized trace (the GA inner loop)
# ---------------------------------------------------------------------------

def _roofline_measurement(ctx: MeasureContext, flops: float, hbm: float,
                          coll: float, peak_mem: float, source: str,
                          overlap: Optional[float] = None,
                          coll_ops: int = 0) -> Measurement:
    if peak_mem > ctx.power.hw.hbm_bytes:
        return penalty_measurement(
            f"OOM: {peak_mem/2**30:.1f} GiB/chip > "
            f"{ctx.power.hw.hbm_bytes/2**30:.0f} GiB", ctx.power)
    overlap = ctx.overlap if overlap is None else overlap
    t = ctx.power.step_time(flops, hbm, coll, ctx.n_chips, overlap)
    if coll_ops:
        import math as _m
        # per-collective launch/hop latency grows with ring size
        t += coll_ops * 5e-6 * max(_m.log2(max(ctx.n_chips, 2)), 1.0) \
            * (1.0 - overlap)
    w = ctx.power.watts(flops, hbm, coll * ctx.n_chips, t,
                        ctx.n_chips) / ctx.n_chips
    e = w * t * ctx.n_chips
    return Measurement(seconds=t, watts=w, energy_j=e, flops=flops,
                       hbm_bytes=hbm, coll_bytes=coll,
                       peak_mem_per_chip=peak_mem, source=source,
                       trace=_synthesize_roofline_trace(ctx, flops, hbm,
                                                        coll, t, source))


def _synthesize_roofline_trace(ctx: MeasureContext, flops: float,
                               hbm: float, coll: float, t: float,
                               source: str) -> Optional[PowerTrace]:
    """Phase-marked trace from the roofline decomposition: the
    compute/memory-bound span followed by the exposed-collective span,
    each drawing static + its dynamic joules.  By construction the
    trapezoidal integral equals ``energy_j``."""
    if t <= 0:
        return None
    hw = ctx.power.hw
    t_cm = min(ctx.power.capped(
        max(ctx.power.compute_term(flops, ctx.n_chips),
            ctx.power.memory_term(hbm, ctx.n_chips)),
        flops, hbm, 0.0, ctx.n_chips), t)
    dyn_cm = flops * hw.e_flop + hbm * hw.e_hbm
    dyn_coll = coll * ctx.n_chips * hw.e_ici
    return synthesize_phase_trace(
        [("compute", t_cm, dyn_cm), ("collective", t - t_cm, dyn_coll)],
        static_watts=hw.p_static * ctx.n_chips,
        meta={"source": source, "arch": ctx.cfg.name,
              "shape": ctx.shape_name, "chips": ctx.n_chips})


@register_backend
@dataclass
class AnalyticBackend:
    """estimate_program + PowerModel: milliseconds per pattern."""

    name = "analytic"

    def measure(self, ctx: MeasureContext,
                plan: PlanConfig) -> Measurement:
        try:
            est = estimate_program(ctx.cfg, ctx.shape, plan,
                                   ctx.n_chips, ctx.tp)
        except Exception as e:
            return penalty_measurement(f"{type(e).__name__}: {e}", ctx.power)
        return _roofline_measurement(
            ctx, est.flops, est.hbm_bytes, est.coll_bytes,
            est.peak_mem_per_chip, self.name, coll_ops=est.coll_ops)


# ---------------------------------------------------------------------------
# Rung 2 — measured: one real trial on the card
# ---------------------------------------------------------------------------

class TrialTimeout(Exception):
    """A trial ran past the paper's verification timeout."""


@register_backend
@dataclass
class MeasuredBackend:
    """One real trial of the plan on the card, sampled on the wall clock.

    The plan's ``Model`` runs the shape's kind: prefill runs
    ``Model.prefill`` on the shape's batch; decode runs ``decode_steps``
    steps from a cache whose first ``seq_len - decode_steps`` positions
    hold seeded random values (a step's cost does not depend on them).
    Parameters come from one seeded generator per architecture, shared
    across plans (a plan changes no parameter); ``params`` may hold loaded
    ones, by arch name.

    One warm-up call, then calls back to back under ``source`` (the card's
    ``NvmlSource`` by default) until at least ``min_calls`` calls and
    ``window_s`` seconds: ``seconds`` is the median call, ``watts`` the
    window's mean draw, ``energy_j`` the window's integral over its calls.
    The last call's logits must be finite (else it raises) and are kept in
    ``outputs`` by plan tag, so trials of two plans can be compared.
    The trace is the window's with its time axis divided by the calls, so
    it integrates to ``energy_j`` and keeps the measured watts; its meta
    holds the window, the counter's own difference beside the integral
    (``counter``), and each kernel's launches during the trial
    (``launches``).

    Only ``torch.cuda.OutOfMemoryError`` and the paper's timeout (checked
    between calls: a CUDA call cannot be stopped) become penalties; after
    one the cache is emptied and the device's memory must be back at its
    level before the trial.  Every other exception propagates: a kernel
    that fails to build or launch must never lose the search quietly.
    """

    name = "measured"

    device: DeviceLike = None
    source: Optional[object] = None     # PowerSource; NvmlSource on a card
    params: dict = field(default_factory=dict)    # arch name -> weights
    seed: int = 0
    window_s: float = WINDOW_S
    min_calls: int = 3
    decode_steps: int = 16
    record_dir: Optional[Path] = None   # persist traces for the replay rung
    log: Optional[Callable[[str], None]] = None
    #: plan tag -> the last position's logits of its last trial call
    outputs: dict = field(default_factory=dict)

    def weights(self, model):
        """The arch's parameters: loaded or made once from ``seed``."""
        name = model.cfg.name
        if name not in self.params:
            dev = model.device
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            self.params[name] = model.init(gen)
        return self.params[name]

    def power_source(self, dev: torch.device):
        if self.source is None:
            self.source = NvmlSource(dev)
        return self.source

    def _trial(self, model, params, shape: ShapeSpec,
               dev: torch.device) -> Callable[[], torch.Tensor]:
        """One call of the shape's kind, waiting for the device; it
        returns a copy of the last position's logits (the model's are a
        view that would keep all positions' logits alive)."""
        cfg = model.cfg
        rng = np.random.default_rng(self.seed)
        sync = (lambda: torch.cuda.synchronize(dev)) \
            if dev.type == "cuda" else (lambda: None)
        b, s = shape.global_batch, shape.seq_len
        cache = model.init_cache(b, s)
        if shape.kind == "prefill":
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)

            def call() -> torch.Tensor:
                logits, _ = model.prefill(params, {"tokens": toks}, cache)
                logits = logits.clone()
                sync()
                return logits
            return call
        if shape.kind != "decode":
            raise NotImplementedError(
                f"{shape.kind} shapes: training is not ported yet "
                f"(ROADMAP.md, section A item 5)")
        n = self.decode_steps
        s0 = max(s - n, 0)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        _fill_cache(cache, s0, gen)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, n)).astype(np.int32)).to(dev)

        def call() -> torch.Tensor:
            for i in range(n):
                logits, _ = model.decode_step(
                    params, {"tokens": toks[:, i:i + 1], "pos": s0 + i},
                    cache)
            logits = logits.clone()
            sync()
            return logits
        return call

    def measure(self, ctx: MeasureContext,
                plan: PlanConfig) -> Measurement:
        from repro_torch.models.model import Model
        dev = resolve_device(self.device)
        shape = ctx.shape
        cfg = dataclasses.replace(ctx.cfg, plan=plan)
        model = Model(cfg, plan, dev)
        params = self.weights(model)
        source = self.power_source(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            level = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        before = {k.name: k.launches for k in PLAN_KERNELS.values()}
        t_start = time.perf_counter()

        def check(_elapsed: float) -> None:
            if time.perf_counter() - t_start > ctx.timeout_s:
                raise TrialTimeout(
                    f"verification timeout after {ctx.timeout_s:.0f}s "
                    f"(paper's 3-minute rule)")

        error = None
        last: list = []

        def call() -> None:
            last[:] = [trial()]
        try:
            trial = self._trial(model, params, shape, dev)
            call()                                  # warm-up
            check(0.0)
            win = sample_window(source, call, seconds=self.window_s,
                                min_calls=self.min_calls, check=check,
                                phase="trial")
        except torch.cuda.OutOfMemoryError as e:
            error = "OOM: " + str(e).splitlines()[0]
        except TrialTimeout as e:
            error = str(e)
        if error is not None:
            trial = last = None
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                now = torch.cuda.memory_allocated(dev)
                if now > level + MEMORY_SLACK:
                    raise RuntimeError(
                        f"after the penalty ({error}) the device holds "
                        f"{now} B, above the {level} B before the trial")
            self._log(f"[measured] {ctx.cfg.name} {ctx.shape_name} plan "
                      f"{plan_tag(plan)}: PENALTY {error}")
            return penalty_measurement(error, ctx.power)

        launches = {k.name: k.launches - before[k.name]
                    for k in PLAN_KERNELS.values()}
        logits = last[0].float().cpu()
        if not torch.isfinite(logits).all():
            raise RuntimeError(f"plan {plan_tag(plan)} gave non-finite "
                               f"logits on {ctx.cfg.name} {ctx.shape_name}")
        self.outputs[plan_tag(plan)] = logits
        trace = _per_call_trace(win.trace, win.calls)
        trace.meta.update({
            "source": self.name, "arch": ctx.cfg.name,
            "shape": ctx.shape_name, "plan": plan_tag(plan),
            "device": str(dev), "calls": win.calls,
            "call_seconds": win.call_seconds, "window_s": win.seconds,
            "window_j": win.joules, "counter": win.counter,
            "launches": launches,
            "power_source": getattr(source, "name", type(source).__name__),
            "power_limit_w": getattr(source, "power_limit_w", None)})
        est = estimate_program(ctx.cfg, shape, plan, ctx.n_chips, ctx.tp)
        m = Measurement(
            seconds=win.median_call_s(), watts=win.watts,
            energy_j=trace.integrate(), flops=est.flops,
            hbm_bytes=est.hbm_bytes,
            peak_mem_per_chip=float(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0.0,
            source=self.name, trace=trace)
        self._log(f"[measured] {ctx.cfg.name} {ctx.shape_name} plan "
                  f"{plan_tag(plan)}: {win.calls} calls in "
                  f"{win.seconds:.3f} s ("
                  + ", ".join(f"{x:.4f}" for x in win.call_seconds)
                  + f" s), median {m.seconds:.4f} s, "
                  f"{m.watts:.2f} W, {m.energy_j:.3f} J a call"
                  f"{describe_window(win.counter)}; "
                  f"launches {launches}")
        if self.record_dir is not None:
            trace.to_jsonl(Path(self.record_dir) / (
                f"{ctx.cfg.name}__{ctx.shape_name}__card_p"
                f"{plan_tag(plan)}.trace.jsonl"))
        return m

    def _log(self, msg: str) -> None:
        if self.log is not None:
            self.log(msg)


def plan_kernels(plan: PlanConfig, genes) -> list[str]:
    """The kernels a plan's genes name: each of ``genes`` (the genome's
    gene names) whose destination is 'pallas'."""
    return [k.name for g, k in PLAN_KERNELS.items()
            if g in genes and getattr(plan, g) == "pallas"]


def _fill_cache(cache: list, filled: int, gen: torch.Generator) -> None:
    """Seeded random values in every cache tensor; an attention cache's
    first ``filled`` positions marked as held."""
    for layer in cache:
        for key, t in layer.items():
            if key == "kpos":
                t.fill_(-1)
                n = min(filled, t.shape[0])
                t[:n] = torch.arange(n, dtype=t.dtype, device=t.device)
            elif t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                      device=t.device, dtype=torch.int8))
            elif key.endswith("_scale"):
                t.uniform_(0.0, 0.02, generator=gen)
            else:
                t.normal_(generator=gen)


def _per_call_trace(trace: PowerTrace, calls: int) -> PowerTrace:
    """The window's trace with its time axis divided by ``calls``: the same
    watts, one call's share of the joules."""
    t0 = trace.samples[0][0]
    out = PowerTrace(maxlen=max(trace.maxlen, len(trace)),
                     meta=dict(trace.meta))
    for t, w in trace.samples:
        out.add(t0 + (t - t0) / calls, w)
    for s in trace.spans:
        out.mark_phase(s.name, t0 + (s.t0 - t0) / calls,
                       t0 + (s.t1 - t0) / calls, s.depth)
    return out


# ---------------------------------------------------------------------------
# Rung 3 — replay: recorded traces for offline runs
# ---------------------------------------------------------------------------

@register_backend
@dataclass
class ReplayBackend:
    """Re-serve persisted measured-rung traces without the card.

    Looks for ``<arch>__<shape>__<mesh>_p<plan_tag>.trace.jsonl`` under
    ``root`` (what ``MeasuredBackend(record_dir=root)`` records);
    ``default`` is a fallback recording used when the plan has no trace of
    its own.  A missing recording is a penalty, not a crash — the
    cache/promotion machinery treats it like any other failed trial.
    """

    name = "replay"

    root: Path = ART_MEASURED
    default: Optional[Path] = None
    mesh_name: str = "card"

    def __post_init__(self) -> None:
        self.root = Path(self.root)
        if self.default is not None:
            self.default = Path(self.default)

    def trace_path(self, ctx: MeasureContext,
                   plan: PlanConfig) -> Optional[Path]:
        p = self.root / (f"{ctx.cfg.name}__{ctx.shape_name}__"
                         f"{self.mesh_name}_p{plan_tag(plan)}.trace.jsonl")
        if p.is_file():
            return p
        if self.default is not None and self.default.is_file():
            return self.default
        return None

    def measure(self, ctx: MeasureContext,
                plan: PlanConfig) -> Measurement:
        path = self.trace_path(ctx, plan)
        if path is None:
            return penalty_measurement(
                f"no recorded trace for plan _p{plan_tag(plan)} "
                f"under {self.root}", ctx.power)
        try:
            trace = PowerTrace.from_jsonl(path)
        except (OSError, ValueError, KeyError):
            return penalty_measurement(f"unreadable recording {path}",
                                       ctx.power)
        if len(trace) < 2:
            return penalty_measurement(f"empty recording {path}", ctx.power)
        seconds = trace.duration
        energy = trace.integrate()
        return Measurement(
            seconds=seconds,
            watts=energy / seconds if seconds > 0 else 0.0,
            energy_j=energy, source=self.name, trace=trace,
            utilization=dict(trace.meta.get("utilization", {})))


# ---------------------------------------------------------------------------
# Cross-rung agreement (the governor's re-verification gate)
# ---------------------------------------------------------------------------

def confirms_preference(new: Measurement, old: Measurement,
                        alpha: float = 0.5, beta: float = 0.5,
                        slack: float = 0.02) -> bool:
    """Does this rung confirm that ``new`` should replace ``old``?

    The cheap rung's estimate already preferred ``new`` (that is why it is
    a pending migration); both plans were then re-measured on a higher
    rung and the verdicts land here.  The migration is confirmed only when
    the new plan's trial succeeded AND its paper fitness on this rung is
    at least the incumbent's (minus ``slack``, so measurement jitter on an
    equal pair does not veto).  A penalty on the new plan — timeout, OOM —
    always vetoes, whatever the estimate promised; a penalty on the
    incumbent alone confirms (migrating away from a plan that cannot even
    run is never wrong).
    """
    if not new.ok:
        return False
    if not old.ok:
        return True
    return new.fitness(alpha, beta) \
        >= old.fitness(alpha, beta) * (1.0 - slack)

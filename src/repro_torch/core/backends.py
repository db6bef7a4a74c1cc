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
    shape's prefill, decode or train step on the mesh the rung is given,
    timed on the wall clock, its energy read from the card's NVML counter
    through the sampler.  This is the paper's own verification step for
    a context the card holds.
  * ``compiled`` — the pod dry run (``launch.dryrun``) in a child process
    for a context larger than the card (``n_chips > 1``): one step over a
    fake 256/512-rank process group on the meta device, its stage sidecar
    sampled at the verification host's CPU-node envelope.
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
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.artifacts import DRYRUN, MEASURED, REPO_ROOT
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
            est.peak_mem_per_chip, self.name,
            overlap=0.5 if plan.overlap_collectives else None,
            coll_ops=est.coll_ops)


# ---------------------------------------------------------------------------
# Rung 2 — measured: one real trial on the card
# ---------------------------------------------------------------------------

class TrialTimeout(Exception):
    """A trial ran past the paper's verification timeout."""


def check_context_fits(ctx: MeasureContext, mesh) -> None:
    """Raise when the context asks for more chips, or a wider model axis,
    than ``mesh`` holds (no mesh: one card, (1, 1)): a trial on fewer
    devices is another trial, never a measurement of the larger one."""
    n, tp = 1, 1
    if mesh is not None:
        n = mesh.size()
        tp = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get("model", 1)
    if ctx.n_chips > n or ctx.tp > tp:
        raise ValueError(
            f"{ctx.cfg.name} {ctx.shape_name}: the context asks for "
            f"{ctx.n_chips} chips with a {ctx.tp}-way model axis; the "
            f"measured rung's mesh holds {n} devices with a {tp}-way model "
            f"axis")


@register_backend
@dataclass
class MeasuredBackend:
    """One real trial of the plan on the card, sampled on the wall clock.

    The plan runs on ``mesh`` (a ``DeviceMesh``; ``None`` is one card, the
    same computation as ``launch.mesh.make_host_mesh()``'s ``(1, 1)``
    mesh, where every rule resolves to replicated): every kind under
    ``parallel.sharding.make_rules`` for it.  A context whose ``n_chips``
    or ``tp`` exceeds the mesh raises (``check_context_fits``).

    The plan's ``Model`` runs the shape's kind: prefill runs
    ``Model.prefill`` on the shape's batch, eagerly (one forward a call);
    decode runs ``decode_steps`` steps a call from a cache whose first
    ``seq_len - decode_steps`` positions hold seeded random values (a
    step's cost does not depend on them), through ``DecodeTrial``: on
    ``cuda`` the step captured as ``ServeLoop`` captures it
    (``serve.engine.DecodeGraph``) at the warm-up call and replayed; train
    runs whole train steps (loss, backward, the arch's optimizer) on
    seeded random tokens through ``train.step.TrainGraph(model, rules)``,
    on parameters and optimizer state laid out on the mesh
    (``parallel.param_sharding.distribute``): on ``cuda`` the warm-up call
    is the eager step and the step's capture as a CUDA graph, and each
    timed call a replay.  Parameters
    come from one seeded generator per architecture, shared across plans
    (a plan changes no parameter); ``params`` may hold loaded ones, by
    arch name.  A train trial makes its own parameters and optimizer state
    from ``seed`` and updates only those: it never touches weights that
    another trial or a serving phase reads.

    One warm-up call, then calls back to back under ``source`` (the card's
    ``NvmlSource`` by default) until at least ``min_calls`` calls and
    ``window_s`` seconds: ``seconds`` is the median call, ``watts`` the
    window's mean draw, ``energy_j`` the window's integral over its calls.
    The last call's logits (a train step's: its loss) must be finite
    (else it raises) and are kept in ``outputs`` by plan tag, so trials of
    two plans can be compared.
    The trace is the window's with its time axis divided by the calls, so
    it integrates to ``energy_j`` and keeps the measured watts; its meta
    holds the window, the counter's own difference beside the integral
    (``counter``), each kernel's launches during the trial (``launches``,
    a graph's replays included) and the trial's captured graph
    (``graph``: its capture ms and pool bytes; None for an eager trial).

    Only ``torch.cuda.OutOfMemoryError`` (in a capture too) and the
    paper's timeout (checked between calls: a CUDA call cannot be
    stopped) become penalties; after one the trial and its graph are
    dropped, the cache is emptied and the device's memory must be back at
    its level before the trial.  Every other exception propagates: a
    kernel that fails to build or launch, or a capture that fails, must
    never lose the search quietly.
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
    #: plan tag -> the last position's logits of its last trial call (a
    #: train trial's: the loss of its last step)
    outputs: dict = field(default_factory=dict)
    mesh: Optional[object] = None       # DeviceMesh; None: one card

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

    def make_trial(self, model, params, shape: ShapeSpec,
                   dev: torch.device,
                   rules=None) -> Callable[[], torch.Tensor]:
        """The trial ``measure`` times: each call is one call of the
        shape's kind, waiting for the device; it returns a copy of the
        last position's logits (the model's are a view that would keep
        all positions' logits alive).  A decode trial is a
        ``DecodeTrial``, a train trial a ``TrainTrial``."""
        cfg = model.cfg
        rng = np.random.default_rng(self.seed)
        sync = (lambda: torch.cuda.synchronize(dev)) \
            if dev.type == "cuda" else (lambda: None)
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            return TrainTrial(model, shape, self.seed, rng, sync, rules)
        cache = model.init_cache(b, s)
        if shape.kind == "prefill":
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (b, s)).astype(np.int32)).to(dev)
            kw = {} if rules is None else {"rules": rules}

            def call() -> torch.Tensor:
                logits, _ = model.prefill(params, {"tokens": toks}, cache,
                                          **kw)
                logits = logits.clone()
                sync()
                return logits
            return call
        if shape.kind != "decode":
            raise ValueError(f"unknown shape kind {shape.kind!r}")
        n = self.decode_steps
        s0 = max(s - n, 0)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        _fill_cache(cache, s0, gen)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (b, n)).astype(np.int32)).to(dev)
        return DecodeTrial(model, params, cache, toks, s0, sync, rules)

    def measure(self, ctx: MeasureContext,
                plan: PlanConfig) -> Measurement:
        from repro_torch.models.model import Model
        from repro_torch.parallel.sharding import make_rules
        check_context_fits(ctx, self.mesh)
        dev = resolve_device(self.device)
        shape = ctx.shape
        cfg = dataclasses.replace(ctx.cfg, plan=plan)
        model = Model(cfg, plan, dev)
        rules = None if self.mesh is None else make_rules(cfg, self.mesh,
                                                          plan)
        # a train trial makes its own weights (TrainTrial)
        params = self.weights(model) if shape.kind != "train" else None
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
            trial = self.make_trial(model, params, shape, dev, rules)
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
            # the trial holds its graph and the graph its private pool
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
            what = "loss" if shape.kind == "train" else "logits"
            raise RuntimeError(f"plan {plan_tag(plan)} gave non-finite "
                               f"{what} on {ctx.cfg.name} {ctx.shape_name}")
        self.outputs[plan_tag(plan)] = logits
        graph = getattr(trial, "graph", None)
        graph = None if graph is None or graph.capture_ms is None else {
            "capture_ms": graph.capture_ms, "pool_bytes": graph.pool_bytes}
        trace = _per_call_trace(win.trace, win.calls)
        trace.meta.update({
            "source": self.name, "arch": ctx.cfg.name,
            "shape": ctx.shape_name, "plan": plan_tag(plan),
            "device": str(dev), "calls": win.calls,
            "call_seconds": win.call_seconds, "window_s": win.seconds,
            "window_j": win.joules, "counter": win.counter,
            "launches": launches, "graph": graph,
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
                  f"launches {launches}"
                  + ("" if graph is None else
                     f"; captured in {graph['capture_ms']:.1f} ms, pool "
                     f"{graph['pool_bytes']} B"))
        if self.record_dir is not None:
            trace.to_jsonl(Path(self.record_dir) / (
                f"{ctx.cfg.name}__{ctx.shape_name}__card_p"
                f"{plan_tag(plan)}.trace.jsonl"))
        return m

    def _log(self, msg: str) -> None:
        if self.log is not None:
            self.log(msg)


class DecodeTrial:
    """The measured rung's decode trial: ``toks.shape[1]`` decode steps a
    call from ``cache`` (its first ``s0`` positions held), step ``i`` at
    position ``s0 + i`` on token column ``i``, the cache written in place.

    The inputs go through static buffers, as ``ServeLoop``'s: ``tokens``
    (b, 1) and a 0-d ``pos``.  On ``cuda`` the first call captures the
    step under ``rules`` as ``serve.engine.DecodeGraph`` (``graph``), its
    weights' casts frozen where the card's memory holds them, and a call
    captures it again once a frozen weight has been written in place;
    every call copies each token column into ``tokens``, fills ``pos``
    and replays; on the CPU the same buffers go through the eager step.  A
    call waits for the device (``sync``) and returns a clone of the last
    step's logits.  ``eager()`` is one call through the eager step on the
    card too, which a replayed call is held to."""

    def __init__(self, model, params, cache: list, toks: torch.Tensor,
                 s0: int, sync: Callable[[], None], rules=None):
        from repro_torch.serve.engine import make_decode_step
        self.model, self.params, self.cache = model, params, cache
        self.toks, self.s0, self.sync, self.rules = toks, s0, sync, rules
        dev = toks.device
        self.tokens = torch.zeros((toks.shape[0], 1), dtype=torch.int32,
                                  device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.step = make_decode_step(model, rules)
        self.graph = None

    def _eager_step(self) -> torch.Tensor:
        with torch.no_grad():
            return self.step(self.params, {"tokens": self.tokens,
                                           "pos": self.pos}, self.cache)[0]

    def _run(self, step: Callable[[], torch.Tensor]) -> torch.Tensor:
        for i in range(self.toks.shape[1]):
            self.tokens.copy_(self.toks[:, i:i + 1])
            self.pos.fill_(self.s0 + i)
            logits = step()
        logits = logits.clone()
        self.sync()
        return logits

    def __call__(self) -> torch.Tensor:
        if self.toks.device.type != "cuda":
            return self._run(self._eager_step)
        if self.graph is None or self.graph.stale():
            from repro_torch.serve.engine import DecodeGraph
            self.graph = None               # free the old copies first
            self.graph = DecodeGraph(self.model, self.params, self.cache,
                                     self.tokens, self.pos, self.rules)
        return self._run(self.graph.replay)

    def eager(self) -> torch.Tensor:
        return self._run(self._eager_step)


class TrainTrial:
    """The measured rung's train trial: one call is one train step of
    ``model`` on the trial's own parameters and optimizer state, made from
    ``seed`` and, under ``rules``, laid out on ``rules.mesh``
    (``parallel.param_sharding.distribute``), on seeded random tokens of
    the shape's batch.  The step is ``train.step.TrainGraph(model,
    rules)`` (``graph``): its first call captures it on ``cuda``, the
    later calls replay it.  A call waits for the device and returns the
    step's loss (a ``DTensor``'s read whole)."""

    def __init__(self, model, shape: ShapeSpec, seed: int,
                 rng: np.random.Generator, sync: Callable[[], None],
                 rules=None):
        from repro_torch.train.step import TrainGraph, make_opt_init
        dev = model.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init(gen)
        opt = make_opt_init(model)(params)
        if rules is not None:
            from repro_torch.parallel.param_sharding import distribute
            params, opt, _ = distribute(rules, params, opt)
        self.params, self.opt, self.sync = params, opt, sync
        self.graph = TrainGraph(model, rules)
        toks = torch.from_numpy(rng.integers(
            0, model.cfg.vocab_size, (shape.global_batch, shape.seq_len + 1))
            .astype(np.int32)).to(dev)
        self.batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __call__(self) -> torch.Tensor:
        from repro_torch.parallel.sharding import is_dtensor
        self.params, self.opt, metrics = self.graph(self.params, self.opt,
                                                    self.batch)
        loss = metrics["loss"]
        if is_dtensor(loss):
            loss = loss.full_tensor()
        loss = loss.reshape(1).clone()
        self.sync()
        return loss


def plan_kernels(plan: PlanConfig, genes) -> list[str]:
    """The kernels a plan's genes name: each of ``genes`` (the genome's
    gene names) whose destination is 'pallas'."""
    return [k.name for g, k in PLAN_KERNELS.items()
            if g in genes and getattr(plan, g) == "pallas"]


def _fill_cache(cache: list, filled: int, gen: torch.Generator) -> None:
    """Seeded random values in every cache tensor; an attention cache's
    first ``filled`` positions marked as held.  Keys and values are f32
    normals stored as the cache stores a new entry (cast, or quantised
    with per-(pos, head) scales in an int8 cache), so caches of two KV
    dtypes hold the same values up to the storage rounding."""
    from repro_torch.models.layers import _kv_quant
    for layer in cache:
        for key, t in layer.items():
            if key == "kpos":
                t.fill_(-1)
                n = min(filled, t.shape[0])
                t[:n] = torch.arange(n, dtype=t.dtype, device=t.device)
            elif key in ("k", "v") and "kpos" in layer:
                x = torch.empty(t.shape, dtype=torch.float32,
                                device=t.device).normal_(generator=gen)
                if t.dtype == torch.int8:
                    q, scale = _kv_quant(x)
                    t.copy_(q)
                    layer[f"{key}_scale"].copy_(scale)
                else:
                    t.copy_(x)
                del x
            elif not key.endswith("_scale"):
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
# Rung 2b — compiled: the pod dry run in a subprocess, wall-clock sampled
# ---------------------------------------------------------------------------

def load_record(path: Path) -> Optional[dict]:
    """A dry-run JSON artifact, or None when missing/malformed/stale.

    ``None`` tells the caller to fall back to running the cell again (or,
    for a rung, to a penalty) — a half-written or hand-edited cache file
    must never crash the measurement spine."""
    try:
        rec = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None
    if not isinstance(rec, dict) or "status" not in rec:
        return None
    return rec


def load_stage_sidecar(path: Path) -> Optional[list]:
    """The per-stage timestamp/utilization sidecar, or None when unusable.

    Values are validated, not just keys: a hand-edited sidecar with
    non-numeric or non-monotonic windows must fall back to a penalty,
    never crash the measurement spine downstream (the stage sampler and
    ``PowerTrace.add`` both reject such input with exceptions)."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None
    stages = doc.get("stages") if isinstance(doc, dict) else None
    if not isinstance(stages, list) or not stages:
        return None
    t_prev = float("-inf")
    for s in stages:
        if not isinstance(s, dict) or not {"name", "t0", "t1"} <= set(s):
            return None
        try:
            t0, t1 = float(s["t0"]), float(s["t1"])
            float(s.get("util", 0.0))
        except (TypeError, ValueError):
            return None
        if not (t_prev <= t0 <= t1):    # windows must be ordered
            return None
        t_prev = t1
    return stages


@register_backend
@dataclass
class CompiledBackend:
    """The pod dry run in a subprocess, measured on its wall clock.

    The rung for contexts larger than the card (``n_chips > 1``).  The
    child (``python -m repro_torch.launch.dryrun``) runs one step of the
    plan on the production mesh over a fake process group of 256 or 512
    ranks (parameters, state, batch and cache on the meta device as
    ``DTensor``s) and writes two artifacts: the record (FLOPs, collective
    census, per-rank argument bytes) and a *stage sidecar* — per-stage
    wall-clock timestamps plus the utilization its CPU clock measured.
    The parent turns the sidecar into the trial's ``PowerTrace`` by
    sampling the verification node's envelope (the paper's R740 CPU-node
    points) at the measured utilization across the recorded windows
    (``sample_stage_trace``).  ``seconds``/``watts``/``energy_j`` are that
    trace's duration/average/integral: the verification-machine trial, as
    the paper measures it.  The record's counters ride along — the FLOPs
    and the census as they are, with no trip-count correction (the dry
    run unrolls every layer and microbatch), the census that of the
    route each layer kind ran (the record's ``execution``, also in the
    trace's meta: tensor-parallel regions under a ``use_tp`` plan, ZeRO-3
    without) — and a plan whose per-rank
    argument bytes exceed the card's ``hbm_bytes`` penalties out.

    Every successful trial persists its trace next to the record
    (``<key>.trace.jsonl``) so the replay rung can re-serve it.
    """

    name = "compiled"

    interval: float = 0.05              # the IPMI poll cadence analogue
    envelope: Optional[object] = None   # verification node envelope
    # stage name -> envelope that stage samples through; the dry run's
    # stages (build/trace/analyze) are CPU work and fall back to
    # ``envelope``; an ``execute`` stage would draw the accelerated point
    stage_envelopes: Optional[dict] = None
    art_dir: Path = DRYRUN
    multi_pod: bool = False             # the 2-pod production mesh
    record_trace: bool = True
    # injectable trial runner (tests stub the subprocess out); signature
    # matches subprocess.run's use below
    runner: Optional[Callable] = None

    def __post_init__(self) -> None:
        from repro_torch.core.power import R740_ARRIA10
        from repro_torch.telemetry.dvfs import node_envelope
        if self.envelope is None:
            # the dry run executes on the verification host (a CPU node)
            self.envelope = node_envelope(R740_ARRIA10, accelerated=False)
        if self.stage_envelopes is None:
            self.stage_envelopes = {
                "execute": node_envelope(R740_ARRIA10, accelerated=True)}
        self.art_dir = Path(self.art_dir)

    @property
    def mesh_name(self) -> str:
        return "pod2x16x16" if self.multi_pod else "pod16x16"

    def _spawn(self, ctx: MeasureContext, plan: PlanConfig,
               tag: str) -> Optional[str]:
        """Run the dry-run child; returns an error string on failure."""
        plan_json = json.dumps(dataclasses.asdict(plan), sort_keys=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", ctx.cfg.name, "--shape", ctx.shape_name,
               "--plan-json", plan_json, "--tag", tag]
        if self.multi_pod:
            cmd.append("--multi-pod")
        env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
        run = self.runner or subprocess.run
        try:
            run(cmd, timeout=ctx.timeout_s, capture_output=True,
                cwd=REPO_ROOT, env=env, check=False)
        except subprocess.TimeoutExpired:
            return (f"verification timeout after {ctx.timeout_s:.0f}s "
                    f"(paper's 3-minute rule)")
        return None

    def measure(self, ctx: MeasureContext,
                plan: PlanConfig) -> Measurement:
        tag = "_p" + plan_tag(plan)
        err = self._spawn(ctx, plan, tag)
        if err is not None:
            return penalty_measurement(err, ctx.power)
        key = f"{ctx.cfg.name}__{ctx.shape_name}__{self.mesh_name}{tag}"
        rec = load_record(self.art_dir / f"{key}.json")
        if rec is None:
            return penalty_measurement("dry-run produced no usable record",
                                       ctx.power)
        if rec.get("status") != "OK":
            return penalty_measurement(rec.get("error", "dry-run failed"),
                                       ctx.power)
        stages = load_stage_sidecar(self.art_dir / f"{key}.stages.json")
        if stages is None:
            return penalty_measurement("dry-run produced no stage sidecar",
                                       ctx.power)
        try:
            m = self.measurement_from_trial(ctx, rec, stages)
        except (TypeError, ValueError) as e:
            return penalty_measurement(f"malformed stage sidecar: {e}",
                                       ctx.power)
        if m.ok and self.record_trace and m.trace is not None:
            try:
                m.trace.to_jsonl(self.art_dir / f"{key}.trace.jsonl")
            except OSError:
                pass                    # recording is best-effort
        return m

    def measurement_from_trial(self, ctx: MeasureContext, rec: dict,
                               stages: list) -> Measurement:
        """Pure assembly: record + sidecar -> measured Measurement."""
        from repro_torch import obs
        from repro_torch.telemetry.sampler import sample_stage_trace
        peak_mem = _target_mem_estimate(rec)
        if peak_mem > ctx.power.hw.hbm_bytes:
            return penalty_measurement(
                f"OOM: {peak_mem/2**30:.1f} GiB/chip > "
                f"{ctx.power.hw.hbm_bytes/2**30:.0f} GiB", ctx.power)
        trace = sample_stage_trace(
            stages, self.envelope, chips=1, interval=self.interval,
            stage_envelopes=self.stage_envelopes,
            meta={"source": self.name, "arch": ctx.cfg.name,
                  "shape": ctx.shape_name, "mesh": rec.get("mesh", ""),
                  "plan": rec.get("plan", ""),
                  "execution": rec.get("execution", "")})
        tr = obs.TRACER
        if tr.enabled and stages:
            row = f"dryrun:{ctx.cfg.name}:{ctx.shape_name}"
            root = tr.begin("backend.compiled", node=row,
                            t0=min(s["t0"] for s in stages),
                            tags={"rung": self.name,
                                  "mesh": rec.get("mesh", ""),
                                  "plan": rec.get("plan", "")})
            for s in stages:
                tr.begin(f"dryrun.{s['name']}", node=row, t0=s["t0"],
                         parent=root,
                         tags={"util": s.get("util", 0.0)}
                         ).finish(s["t1"])
            root.finish(max(s["t1"] for s in stages))
        seconds = trace.duration
        energy = trace.integrate()
        coll = rec.get("collectives", {}).get("total_bytes", 0.0)
        return Measurement(
            seconds=seconds,
            watts=energy / seconds if seconds > 0 else 0.0,
            energy_j=energy,
            flops=float(rec.get("flops", 0.0)),
            coll_bytes=float(coll),
            peak_mem_per_chip=peak_mem,
            source=self.name, trace=trace,
            utilization=dict(trace.meta.get("utilization", {})))


def _target_mem_estimate(rec: dict) -> float:
    """Per-rank bytes a record says the step holds: its arguments' local
    shards (the dry run measures no temporaries)."""
    mem = rec.get("memory", {})
    if not isinstance(mem, dict):
        return 0.0
    return float(mem.get("argument_size_in_bytes", 0))


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

    root: Path = MEASURED
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

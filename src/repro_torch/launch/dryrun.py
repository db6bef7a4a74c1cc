"""Pod dry run: one real step of every (arch × shape × mesh) cell, no pod.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
its jitted step for 512 placeholder host devices.  The port has no
compiler to ask, so it runs the step itself, once, over a *fake* process
group of 256 or 512 ranks (torch's ``FakeStore``/``"fake"`` backend: every
collective returns at once, nothing is sent) in this one process:

  build    the production mesh (``launch.mesh.make_production_mesh``) over
           the fake group; parameters, optimizer state, batch and cache on
           the meta device (shapes only, nothing allocated), laid out as
           ``DTensor``s at the plan's placements
           (``parallel.param_sharding.distribute``);
  trace    one call of the train, prefill or decode step on them, under
           ``core.transfer.CollectiveRecorder`` (every collective DTensor
           launches, with its payload) and a ``FlopCounterMode``
           (``global_flops``);
  analyze  the census, the batching report and the per-rank bytes.

The record keeps the reference's keys where they mean the same thing:
``status``, ``n_chips``, ``collectives``, ``batching``, ``model_flops``,
``plan`` and ``memory.argument_size_in_bytes`` — per rank, the bytes of
rank 0's local shards of the step's arguments (with even shards, every
rank's).  ``flops`` is whole-program and global (below).  The
port unrolls its layers and microbatches, so no count here is "a loop
body once", and nothing downstream multiplies it by a trip count.  No
temporary or peak memory is recorded: the meta device allocates nothing
to measure.

Under a ``use_tp`` plan every layer runs on its shards (``parallel.tp``):
each product split over the model axis, weights gathered over the batch
axes only, the collectives over ``model`` on activations and small
statistics; a plan without it folds ``model`` into the batch axes and its
layers run on their gathered operands (ZeRO-3).  Every OK record says
which route each layer kind ran under ``execution``
(``parallel.tp.describe_routes``).  A region runs on rank 0's local
tensors, so the counter sees its ops at local shapes: ``flops`` weighs
each by the ranks whose work it stands for (``global_flops``), and counts
each op on ``DTensor``s once at its global shapes.  A cell whose op has
no DTensor sharding strategy, or whose layout a region cannot split, ends
``FAIL`` with the error: nothing is caught and re-run replicated.  The fake group is
destroyed when a cell ends.

This is also the *compiled measurement rung*'s child process
(``repro_torch.core.backends.CompiledBackend``): every cell emits a stage
sidecar (``<key>.stages.json``) — per-stage wall-clock timestamps plus the
utilization the process's CPU clock measured — which the parent samples
into a phase-marked power trace.

Results are JSON-cached under artifacts/torch/dryrun/ (``repro_torch.
artifacts``; the JAX package keeps its own records in artifacts/dryrun/);
reruns are incremental, and a malformed or stale cache file falls back to
running the cell again.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all                # single pod
  python -m repro_torch.launch.dryrun --all --multi-pod    # two pods
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

from repro_torch.artifacts import DRYRUN

ART = DRYRUN

#: ranks of the fake process group: one pod, or two
WORLD = {False: 256, True: 512}


def global_flops():
    """A ``FlopCounterMode`` whose total is the whole program's: an op on
    ``DTensor``s counts once, at its global shapes (the counter sees it
    before DTensor splits it); an op of a tensor-parallel region's body,
    which runs on rank 0's local tensors, counts as many times as the
    ranks whose shares of the work it stands for (``parallel.tp.
    flop_weight``, forward and backward), so replicated work counts
    once, as a ``DTensor`` op's does."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.parallel.tp import flop_weight

    class GlobalFlops(FlopCounterMode):
        extra = 0.0

        def _count_flops(self, func_packet, out, args, kwargs):
            w = flop_weight()
            if w != 1.0 and func_packet in self.flop_registry and not any(
                    isinstance(a, DTensor)
                    for a in tree_leaves((args, kwargs))):
                self.extra += (w - 1) * self.flop_registry[func_packet](
                    *args, **kwargs, out_val=out)
            return super()._count_flops(func_packet, out, args, kwargs)

        def total(self) -> float:
            return self.get_total_flops() + self.extra
    return GlobalFlops(display=False)


def model_flops(cfg, shape) -> float:
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch     # decode: one token per sequence


def _clamp_microbatches(plan, shape, mesh) -> int:
    """Microbatch size must stay divisible by the batch sharding ways."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    ways = sizes.get("data", 1) * sizes.get("pod", 1)
    if not plan.use_tp:   # model axis joins batch sharding (pure DP)
        ways *= sizes.get("model", 1)
    per_shard = max(shape.global_batch // ways, 1)
    n = min(plan.microbatches, per_shard)
    while per_shard % n:
        n -= 1
    return n


# ---------------------------------------------------------------------------
# Stage clock — the sidecar the compiled rung samples
# ---------------------------------------------------------------------------

class StageClock:
    """Wall-clock stage windows + measured utilization for one trial.

    Each ``stage(name)`` block records ``(t0, t1)`` on the trial's wall
    clock and the utilization the process's CPU clock measured over the
    window — CPU seconds (``time.process_time``: user + system across the
    process's threads) per wall second, clamped to [0, 1], tagged
    ``util_src="process_time"``.  This is the verification host's
    achieved utilization during the dry run, the signal the parent's power
    sampler drives the node envelope with."""

    def __init__(self) -> None:
        self._base = time.perf_counter()
        self.stages: list[dict] = []

    @contextmanager
    def stage(self, name: str):
        t0, c0 = time.perf_counter(), time.process_time()
        try:
            yield
        finally:
            t1, c1 = time.perf_counter(), time.process_time()
            wall = max(t1 - t0, 1e-9)
            self.stages.append({
                "name": name,
                "t0": t0 - self._base,
                "t1": t1 - self._base,
                "util": min(max((c1 - c0) / wall, 0.0), 1.0),
                "util_src": "process_time",
            })

    def sidecar(self) -> dict:
        return {"wall_s": time.perf_counter() - self._base,
                "stages": self.stages}


@contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process is rank 0) for a
    block, destroyed when it ends."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the "
                           "dry run lays its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------


def _leaves(x) -> list:
    """Every tensor of a step's arguments or outputs (a module's
    parameters; nested dicts, lists and tuples)."""
    import torch
    if isinstance(x, torch.nn.Module):
        return [p for _, p in x.named_parameters()]
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def local_bytes(x) -> int:
    """Bytes of this rank's shards of every tensor in ``x`` (a plain
    tensor whole)."""
    from repro_torch.parallel.sharding import is_dtensor
    total = 0
    for t in _leaves(x):
        loc = t.to_local() if is_dtensor(t) else t
        total += loc.numel() * loc.element_size()
    return total


def build_step(arch: str, shape_name: str, mesh, plan=None):
    """Returns (fn, args, cfg, shape) for the cell: ``fn(*args)`` is one
    call of the step on meta ``DTensor``s laid out on ``mesh``."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from repro_torch.parallel.param_sharding import (batch_shardings,
                                                     distribute,
                                                     distribute_tree)
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.train.step import make_opt_init, make_train_step

    cfg = get_config(arch)
    if plan is not None:
        cfg = dataclasses.replace(cfg, plan=plan)
    shape = SHAPES[shape_name]
    n_micro = _clamp_microbatches(cfg.plan, shape, mesh)
    if n_micro != cfg.plan.microbatches:
        cfg = dataclasses.replace(
            cfg, plan=cfg.plan.replace(microbatches=n_micro))
    meta = torch.device("meta")
    model = Model(cfg, cfg.plan, "cpu")       # its tensors: on ``meta``
    rules = make_rules(cfg, mesh, cfg.plan)
    params = T.Transformer(cfg, meta)
    batch = {k: torch.zeros(s.shape, dtype=s.dtype, device=meta)
             for k, s in model.input_specs(shape).items()}
    batch = distribute_tree(batch, batch_shardings(model, shape, rules),
                            mesh)

    if shape.kind == "train":
        opt = make_opt_init(model)(params)
        params, opt, _ = distribute(rules, params, opt)
        step = make_train_step(model, rules)
        return step, (params, opt, batch), cfg, shape

    cache = T.init_cache(cfg, shape.global_batch, shape.seq_len, meta)
    params, _, cache = distribute(rules, params, cache=cache)
    call = model.prefill if shape.kind == "prefill" else model.decode_step

    def fn(params, batch, cache):
        with torch.no_grad():
            return call(params, batch, cache, rules)
    return fn, (params, batch, cache), cfg, shape


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             force: bool = False, plan=None, tag: str = "",
             art: Optional[Path] = None) -> dict:
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.backends import load_record
    from repro_torch.core.transfer import (CollectiveRecorder,
                                           batching_report, census)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import tp

    art = ART if art is None else Path(art)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    key = f"{arch}__{shape_name}__{mesh_name}{tag}"
    out_path = art / f"{key}.json"
    if out_path.exists() and not force:
        cached = load_record(out_path)   # None: missing or malformed
        # a record without its stage file is honoured only when it is not
        # OK: else run again, so both artifacts are made together
        if cached is not None and (cached.get("status") != "OK"
                                   or (art / f"{key}.stages.json").exists()):
            return cached

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    if shape_name in cfg.skip_shapes:
        rec.update(status="SKIP", reason=cfg.skip_shapes[shape_name])
        art.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    clock = StageClock()
    t0 = time.time()
    try:
        with contextlib.ExitStack() as stack:
            with clock.stage("build"):
                stack.enter_context(fake_world(WORLD[multi_pod]))
                mesh = make_production_mesh(multi_pod=multi_pod,
                                            device_type="cpu")
                fn, args, cfg2, shape = build_step(arch, shape_name, mesh,
                                                   plan)
            with clock.stage("trace"):
                # the flop counter innermost: it sees each op on its
                # DTensors (global shapes) before DTensor runs it, and the
                # recorder the collectives DTensor then launches
                with tp.weigh_flops(), tp.record_routes() as routes, \
                        CollectiveRecorder() as recorder, \
                        global_flops() as flop_counter:
                    out = fn(*args)
            with clock.stage("analyze"):
                ops = recorder.ops
                brep = batching_report(ops)
                arg_bytes = local_bytes(args)
                out_bytes = local_bytes(out)
                n_chips = mesh.size()
        stage_s = {s["name"]: s["t1"] - s["t0"] for s in clock.stages}
        rec.update(
            status="OK",
            build_s=round(stage_s.get("build", 0.0), 2),
            trace_s=round(stage_s.get("trace", 0.0), 2),
            n_chips=n_chips,
            flops=float(flop_counter.total()),
            collectives=census(ops),
            batching={"fusible_ops": brep.fusible_ops,
                      "fusible_bytes": brep.fusible_bytes,
                      "groups": brep.groups[:6]},
            memory={"argument_size_in_bytes": arg_bytes,
                    "output_size_in_bytes": out_bytes,
                    "how": "rank 0's local shard bytes of the step's "
                           "arguments and outputs; no temporaries (the "
                           "meta device allocates nothing)"},
            model_flops=model_flops(cfg2, shape),
            plan=cfg2.plan.describe(),
            execution=tp.describe_routes(routes),
        )
    except Exception as e:  # a missing strategy / a bad layout: recorded
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:],
                   seconds=round(time.time() - t0, 2))
    art.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    # stage sidecar: the compiled rung's wall-clock measurement input
    (art / f"{key}.stages.json").write_text(
        json.dumps(clock.sidecar(), indent=1))
    return rec


def describe(rec: dict) -> str:
    """One line of the sweep's output for a record."""
    line = (f"{rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:10s} "
            f"{rec['status']}")
    if rec["status"] == "OK":
        mem = rec["memory"]
        line += (f"  trace={rec['trace_s']:.1f}s"
                 f" flops={rec['flops']:.3g}"
                 f" coll={rec['collectives']['total_bytes']:.3g}B"
                 f" args/rank="
                 f"{mem['argument_size_in_bytes']/2**30:.2f}GiB")
    elif rec["status"] == "FAIL":
        line += "  " + rec["error"][:160]
    else:
        line += "  " + rec["reason"][:80]
    return line


def main(argv=None) -> None:
    import logging

    from repro_torch.configs import SHAPES, list_archs

    # DTensor's advice to flatten the mesh, once a redistribute
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--plan-json", default=None,
                    help="PlanConfig overrides as JSON (verifier subprocess)")
    ap.add_argument("--tag", default="",
                    help="cache-key suffix for plan variants")
    args = ap.parse_args(argv)

    plan = None
    if args.plan_json:
        from repro_torch.configs.base import PlanConfig
        plan = PlanConfig(**json.loads(args.plan_json))

    if args.all or not args.arch:
        archs = [a for a in list_archs() if not a.startswith("tiny")]
    else:
        archs = [args.arch]
    cells = [(a, s) for a in archs
             for s in ([args.shape] if args.shape else list(SHAPES))]
    for a, s in cells:
        rec = run_cell(a, s, args.multi_pod, args.force or bool(args.tag),
                       plan=plan, tag=args.tag)
        print(describe(rec), flush=True)


if __name__ == "__main__":
    main()

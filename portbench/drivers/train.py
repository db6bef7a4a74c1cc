"""The train driver: the port's captured train step (``TrainGraph``) on
seeded batches, measured over a window of steps.

Set-up makes the weights from the seed, builds the model, the optimizer
state and one ``TrainGraph``, and drives that same object through its
first ``check_steps`` steps on the mix's batches 0.. (each row of each
batch differs): the first call runs one eager step and captures the step,
the later ones replay it.  Their losses, each parameter's gradient norm
as the first update took it (read back from AdamW's first moment, m =
(1 - b1) g), its gradient norm as the second update, the first replay,
took it (from the second moment's sums: |g2|^2 = (sum v2 - b2 sum v1) /
(1 - b2)) and each parameter's change after the last of them are the
program's readings.  The window then calls the graph on the next batches
until ``seconds`` have passed; the host makes the next batch while the
card runs the step before it.

With ``trace`` the window records CUDA events around every step, and
``profile_steps`` more steps run under the profiler.  Once the window has
closed and the peak memory is read, the program is freed and the plain
reference runs the first steps again from the same weights and batches
(``reference.train``).
"""
from __future__ import annotations

import gc
import inspect
import math
import sys
import time

import torch

from portbench import core, mixes, profiling, weights
from portbench import program as prog
from portbench.drivers.serve import device_dict
from portbench.energy import Nvml, Window
from portbench.reference import train as ref_train


def check_optimizer(arch, opt: dict) -> None:
    """The port's train step is the one the configuration file states:
    AdamW at its learning rate, moments, eps and weight decay, and its
    clip."""
    from repro_torch.train import optimizer as O, step as S
    kw = inspect.signature(O.adamw_update).parameters
    port = {"optimizer": arch.optimizer, "lr": arch.learning_rate,
            "b1": kw["b1"].default, "b2": kw["b2"].default,
            "eps": kw["eps"].default,
            "weight_decay": kw["wd"].default, "clip": S.CLIP_NORM}
    for k, v in port.items():
        if opt[k] != v:
            raise ValueError(f"the port's train step has {k} {v!r}, the "
                             f"configuration file {opt[k]!r}")


def per_parameter(arch, opt_state, key: str, fn) -> dict:
    """name -> fn(the parameter's slice of the optimizer state ``key``)."""
    from repro_torch.convert import leaf_groups
    from repro_torch.train.optimizer import is_stacked
    out = {}
    for path, names in leaf_groups(arch):
        t = opt_state[key][path]
        for i, n in enumerate(names):
            out[n] = fn(t[i] if is_stacked(path) else t)
    return out


def first_grads(arch, opt_state, b1: float) -> dict:
    """Each parameter's gradient norm as the first AdamW update took it,
    from its first moment after that update."""
    return per_parameter(
        arch, opt_state, "m",
        lambda m: float(torch.linalg.vector_norm(m.float()) / (1 - b1)))


def v_sums(arch, opt_state) -> dict:
    """Each parameter's sum of AdamW's second moment, in float64."""
    return per_parameter(arch, opt_state, "v",
                         lambda v: float(v.double().sum()))


def second_grads(v1: dict, v2: dict, b2: float) -> dict:
    """Each parameter's gradient norm as the second AdamW update took it:
    v2 = b2 v1 + (1 - b2) g2^2, summed."""
    return {n: math.sqrt(max(v2[n] - b2 * v1[n], 0.0) / (1 - b2))
            for n in v2}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        arch=None) -> dict:
    from repro_torch.train.step import TrainGraph, make_opt_init
    config, mix = cell.config, cell.traffic
    opt = config["train"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ref = core.reference(config["reference"])
    arch = prog.arch_for(config, arch)
    check_optimizer(arch, opt)
    model, w = prog.build(config, arch, weights.for_model(ref, config, seed, dev), dev)
    prog.kernel_modules()
    micro = model.plan.microbatches
    opt_state = make_opt_init(model)(w)
    graph = TrainGraph(model)
    source = mixes.train_source(mix, seed, config["vocab_size"])

    def batch(k: int) -> dict:
        return {n: torch.from_numpy(v).to(dev)
                for n, v in source.batch(k).items()}

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    got = {"loss": [], "grad": {}, "grad2": {}, "delta": {}}
    first_call_s = None
    for k in range(mix["check_steps"]):
        b = batch(k)
        t = time.perf_counter()
        _, _, metrics = graph(w, opt_state, b)
        got["loss"].append(float(metrics["loss"]))
        if k == 0:
            first_call_s = time.perf_counter() - t
            got["grad"] = first_grads(arch, opt_state, opt["b1"])
            v1 = v_sums(arch, opt_state)
        elif k == 1:             # the first replay
            got["grad2"] = second_grads(v1, v_sums(arch, opt_state),
                                        opt["b2"])
    with torch.no_grad():
        p0 = weights.for_model(ref, config, seed, dev)
        for n, p in w.named_parameters():
            got["delta"][n] = float(torch.linalg.vector_norm(p - p0[n]))
        del p0
    sync()
    setup_s = time.perf_counter() - t_start

    k = mix["check_steps"]
    events = []
    energy = Window(Nvml(dev).energy_j) if on_card else None
    nxt = batch(k)
    if energy is not None:
        energy.open()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < seconds:
        if trace and on_card:
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
        graph(w, opt_state, nxt)
        if trace and on_card:
            e.record()
            events.append((s, e))
        steps += 1
        k += 1
        nxt = batch(k)           # made while the card runs the step
    sync()
    window_s = time.perf_counter() - t0
    if energy is not None:
        energy.close()
    readings = {"setup_s": setup_s, "window_s": window_s,
                "train_steps": steps,
                "train_tokens": steps * mix["batch"] * mix["seq_len"],
                "first_call_s": first_call_s, "config": config,
                "reference": config["reference"], "batch": mix["batch"],
                "seq_len": mix["seq_len"],
                "micro_rows": mix["batch"] // micro}
    if energy is not None:
        readings.update(energy_j=energy.joules, energy_s=energy.seconds)
    breakdown = None
    if trace and on_card:
        readings["step_ms"] = [s.elapsed_time(e) for s, e in events]
        before = prog.launches()
        batches = [batch(k + j) for j in range(mix["profile_steps"])]

        def stretch():
            for b in batches:
                graph(w, opt_state, b)
        readings["profile"] = profiling.profile(stretch)
        after = prog.launches()
        readings["launches"] = {n: after[n] - before.get(n, 0) for n in after}
        breakdown = profiling.breakdown(readings["profile"])
    device_info = device_dict(dev)

    del graph, opt_state, w, model, nxt
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, gaps = judge(ref, config, cell.limits, got, mix, micro, seed, dev)
    return {"readings": readings, "checks": checks, "gaps": gaps,
            "device": device_info,
            "attempted": steps + mix["check_steps"], "failed": 0,
            "breakdown": breakdown}


def reference_readings(ref, config: dict, mix: dict, micro: int, seed: int,
                       dev, steps: int, lowp: bool = False,
                       rows: int = 0) -> dict:
    """The plain reference's readings of the first ``steps`` steps from
    the cell's weights and batches: in float32, or with ``lowp`` the
    float8 control; ``rows`` > 0 keeps only each batch's first ``rows``
    rows, as many microbatches as rows (a fault: half the batch left out,
    the mean taken over the rest)."""
    source = mixes.train_source(mix, seed, config["vocab_size"])
    batches = [{n: torch.from_numpy(v[:rows] if rows else v).to(dev)
                for n, v in source.batch(k).items()} for k in range(steps)]
    p0 = weights.for_model(ref, config, seed, dev)
    return ref_train.readings(ref, p0, config, config["train"], batches,
                              rows or micro, lowp=lowp)


def judge(ref, config: dict, limits: dict, got: dict, mix: dict,
          micro: int, seed: int, dev) -> dict:
    """(The compared numbers, those ``limits`` names; every reading) of
    the program's readings ``got`` against the plain reference's first
    steps from the same weights and batches; every reading also goes to
    standard error."""
    want = reference_readings(ref, config, mix, micro, seed, dev,
                              len(got["loss"]))
    g = ref_train.gaps(got, want)
    print(f"losses: program {got['loss']} reference {want['loss']}",
          file=sys.stderr)
    for k in ("grad", "grad2", "delta"):
        names = ref_train.moving(want["grad"]) if k == "delta" else want[k]
        worst = sorted(ref_train.leaf_gaps(got[k], want[k], names).items(),
                       key=lambda kv: -kv[1])[:3]
        print(f"{k} worst parameters: "
              + ", ".join(f"{n} {v:.4g} (program {got[k][n]:.4g}, "
                          f"reference {want[k][n]:.4g})" for n, v in worst),
              file=sys.stderr)
    print("readings: " + ", ".join(f"{k} {v!r}" for k, v in g.items()),
          file=sys.stderr)
    return {k: {"value": v, "limit": limits[k]} for k, v in g.items()
            if k in limits}, g

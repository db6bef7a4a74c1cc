"""Paper §4.2 / Fig. 5 on the H100: MRI-Q Watt*seconds, CPU-only against
offloaded.

    python -m repro_torch.benchmarks.bench_mriq

Counterpart of ``benchmarks/bench_mriq.py``, at the paper's size (64^3
voxels, 3072 k-space points), with both legs run:

  * the CPU-only leg: the plain ``ops.mriq`` on CPU tensors, wall clock,
    sampled at the paper's CPU-only node point (121 W);
  * the offloaded leg: the inputs from pinned host buffers to the card
    (H2D), the mriq kernel, the results back into pinned host buffers
    (D2H), CUDA events between the parts; ``LEGS`` legs, each part's
    median and range, the median leg billed at the paper's offloaded node
    point (111 W);
  * the offloaded leg at the card's measured draw: a leg is far shorter
    than the energy counter's resolution, so it is repeated back to back
    for a window of at least ``WINDOW_S`` under the NVML sampler and the
    window's joules are divided by the legs.  That row covers the card
    alone, not the node the paper metered, and is not comparable with the
    node rows; beside it, the card's idle draw over ``WINDOW_S`` before
    the legs.

Both node-point legs go into one ``WsComparison``.  The rows keep the
reference's ``table,...`` format.  On the CPU (``run(device="cpu",
source=ConstantSource(...))``) the offloaded leg is the plain version
again, with no copies: it shows the harness, not a time.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Callable

import torch

from repro_torch.core.power import R740_ARRIA10
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.telemetry.compare import RunEnergy, compare
from repro_torch.telemetry.nvml import WINDOW_S, NvmlSource, \
    describe_window, sample_window
from repro_torch.telemetry.report import (render_comparison_csv,
                                          render_comparison_text)
from repro_torch.telemetry.sampler import ConstantSource, PowerSampler

#: the paper's dataset: 64^3 voxels; Parboil 'small' uses 3072 k-points
N_VOX = 64 * 64 * 64
N_K = 3072
#: offloaded legs timed part by part; the median is the one billed
LEGS = 5
PARTS = ("h2d", "kernel", "d2h", "total")
#: the offloaded leg against the CPU-only leg: atol 5e-4 + rtol 1e-4 (both
#: f32, sums over 3072 k-points in another order)
TOL = (5e-4, 1e-4)


class OffloadLeg:
    """One offloaded leg on ``device``: H2D from pinned host buffers, the
    kernel, D2H into pinned host buffers, CUDA events between the parts.
    On the CPU a leg is the plain version alone, timed by the host clock.
    ``out`` holds the last leg's (Qr, Qi) on the host."""

    def __init__(self, host: list, device: torch.device):
        self.device = device
        if device.type == "cuda":
            self.src = [a.pin_memory() for a in host]
            self.dev = [torch.empty_like(a, device=device) for a in host]
            self.out = tuple(torch.empty_like(host[4]).pin_memory()
                             for _ in range(2))
        else:
            self.src = host

    def __call__(self) -> dict:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            self.out = ops.mriq(*self.src)
            t = time.perf_counter() - t0
            return {"h2d": 0.0, "kernel": t, "d2h": 0.0, "total": t}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        for d, s in zip(self.dev, self.src):
            d.copy_(s, non_blocking=True)
        ev[1].record()
        qr, qi = ops.mriq(*self.dev)
        ev[2].record()
        self.out[0].copy_(qr, non_blocking=True)
        self.out[1].copy_(qi, non_blocking=True)
        ev[3].record()
        ev[3].synchronize()
        parts = [ev[i].elapsed_time(ev[i + 1]) / 1e3 for i in range(3)]
        return dict(zip(PARTS, parts + [ev[0].elapsed_time(ev[3]) / 1e3]))


def max_err(got, want, what: str = "mriq offloaded leg") -> float:
    """The largest |got - want| over (Qr, Qi); raises where ``got`` is not
    finite or misses ``want`` by more than ``TOL``."""
    err = 0.0
    for g, w in zip(got, want):
        d = (g - w).abs()
        if not bool(torch.isfinite(g).all()) or \
                bool((d > TOL[0] + TOL[1] * w.abs()).any()):
            raise RuntimeError(f"{what}: max_err "
                               f"{float(d.max()):.3e} over atol {TOL[0]} + "
                               f"rtol {TOL[1]}*|CPU-only|")
        err = max(err, float(d.max()))
    return err


def run(device: DeviceLike = None, source=None, n_vox: int = N_VOX,
        n_k: int = N_K, seed: int = 0, legs: int = LEGS,
        window_s: float = WINDOW_S, host: list | None = None,
        log: Callable[[str], None] = print) -> dict:
    """Both legs and the card-draw window; ``source`` is the offloaded
    device's ``PowerSource`` (an ``NvmlSource`` on the card by default),
    ``host`` the seven ``ops.mriq`` inputs on the host
    (``ref.mriq_inputs(seed, n_vox, n_k)`` by default).  Returns the rows,
    the comparison and the numbers behind them, and the CPU-only leg's
    (Qr, Qi) as ``cpu_q``."""
    dev = resolve_device(device)
    source = source if source is not None else NvmlSource(dev)
    node = R740_ARRIA10
    if host is None:
        host = ref.mriq_inputs(seed, n_vox, n_k)
    n_vox, n_k = host[4].shape[0], host[0].shape[0]
    card = getattr(source, "name", type(source).__name__)
    limit = getattr(source, "power_limit_w", None)

    # the card's draw with nothing running, before the legs
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    idle = sample_window(source, lambda: time.sleep(0.1), seconds=window_s)

    # CPU-only leg, sampled at the paper's CPU-only node point, after a
    # warm-up on its first rows: torch 2.13's CPU build was seen to compute
    # one thread's share of a process's first cos/sin call less closely
    # (1.5e-4 against 3.6e-8 at arguments of ~300 rad)
    ops.mriq(*host[:4], *(a[:ref.MRIQ_ROWS] for a in host[4:]))
    box: list = []
    _, cpu_trace = PowerSampler(ConstantSource(node.p_cpu_active)) \
        .sample_during(lambda: box.append(ops.mriq(*host)))
    want = box[0]
    baseline = RunEnergy.from_trace("cpu_only(host-measured)", cpu_trace)

    leg = OffloadLeg(host, dev)
    leg()                                       # warm-up
    timed = [leg() for _ in range(legs)]
    err = max_err(leg.out, want)
    stats = {}
    for part in PARTS:
        v = sorted(t[part] for t in timed)
        stats[part] = {"median": v[len(v) // 2], "min": v[0], "max": v[-1]}
    t_off = stats["total"]["median"]
    candidate = RunEnergy("offloaded(R740 node point)", seconds=t_off,
                          ws=t_off * node.p_accel_active)
    cmp = compare(baseline, candidate, workload="mriq_fig5")

    # the card's draw: legs back to back under the sampler
    win = sample_window(source, leg, seconds=window_s)
    card_s = win.seconds / win.calls
    card_ws = win.joules_per_call
    out = {"n_vox": n_vox, "n_k": n_k, "device": str(dev), "card": card,
           "power_limit_w": limit, "counter_period_s":
               getattr(source, "period", None),
           "idle_w": idle.watts, "idle_counter": idle.counter,
           "cpu_s": baseline.seconds, "cpu_ws": baseline.ws,
           "cpu_threads": torch.get_num_threads(),
           "offload_s": t_off, "offload_ws": candidate.ws,
           "offload_parts": stats, "legs": legs, "max_abs_err": err,
           "card_legs": win.calls, "card_window_s": win.seconds,
           "card_w": win.watts, "card_leg_s": card_s, "card_ws": card_ws,
           "card_counter": win.counter, "comparison": cmp.to_dict(),
           "cpu_q": want}
    label = f"offloaded(card-only draw: {card} at {limit} W limit)"
    out["rows"] = [
        "table,destination,seconds,node_watts,watt_seconds",
        f"mriq_fig5,cpu_only(host-measured),{baseline.seconds:.3f},"
        f"{node.p_cpu_active:.0f},{baseline.ws:.1f}",
        f"mriq_fig5,offloaded(card-measured leg),{t_off:.6f},"
        f"{node.p_accel_active:.0f},{candidate.ws:.4f}",
        "mriq_fig5,paper_cpu_only,14.000,121,1690.0",
        "mriq_fig5,paper_fpga_offload,2.000,111,223.0",
        f"mriq_fig5,{label},{card_s:.6f},{win.watts:.1f},{card_ws:.6f}",
        f"mriq_fig5,card_idle({card}),{idle.seconds:.3f},{idle.watts:.1f},"
        f"{idle.joules:.3f}",
        f"mriq_fig5,derived,kernel_allclose_err={err:.2e},"
        f"energy_ratio_ours={cmp.energy_cut:.1f}x,"
        f"energy_ratio_paper={1690 / 223:.1f}x",
    ]
    out["text"] = render_comparison_text(cmp) + render_comparison_csv(cmp)
    period = out["counter_period_s"]
    log(f"[mriq] {card}, power limit {limit} W, energy counter period "
        + ("n/a" if period is None else f"{period * 1e3:.3f} ms")
        + f"; idle draw {idle.watts:.3f} W over {idle.seconds:.3f} s")
    for part in PARTS:
        st = stats[part]
        log(f"[mriq] offloaded leg {part}: median {st['median']:.6f} s, "
            f"range {st['min']:.6f}-{st['max']:.6f} s over {legs} legs; "
            f"{st['median'] / t_off:.4f} of the median leg")
    log(f"[mriq] card-only window: {win.calls} legs in {win.seconds:.4f} s "
        f"at {win.watts:.3f} W -> {card_ws:.6f} Ws a leg"
        + describe_window(win.counter))
    for line in out["rows"] + out["text"]:
        log(line)
    return out


def main() -> int:
    out = run()
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("rows", "text", "cpu_q")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The H100 spec's energy constants, measured on the card.

    python -m repro_torch.benchmarks.calibrate_power

``core.power.H100`` carries three energy constants, the card's own:

  * ``p_static``: the card's idle draw, from its energy counter over
    ``nvml.WINDOW_S`` with nothing running;
  * ``e_flop`` and ``e_hbm``: solved from two kernel windows, each a CUDA
    graph of launches replayed back to back under the NVML sampler for at
    least ``nvml.WINDOW_S``, as a 2x2 system
    ``E - p_static t = F e_flop + B e_hbm``: swiglu at T=1024 (qwen2-7b's
    widths, bf16, bound by its operations) and rglru at S 2560
    (recurrentgemma-9b's, f32, bound by its bytes).  F and B are the
    operations and bytes the card's bound counts for each call (each input
    read once, each output written once).

It also yields the two rates the analytic rung times a plan at:
``reached_flops``, the operations a second of the swiglu window, and
``reached_bw``, the bytes a second of the rglru window.  With them the
model's time and energy for each window are the measured ones, so its
watts stay those the card draws.

It runs ``REPEATS`` calibrations in a row on one card and prints each
constant's median (``chip_smoke.py`` runs one, beside the committed
constants).  Prints each window and the constants, then one JSON line.
Needs the card; raises without one.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Callable

import torch
import torch.nn.functional as F


def _graph(fn: Callable[[], object], reps: int) -> Callable[[], None]:
    """``reps`` calls of ``fn`` captured in one CUDA graph; returns a call
    that replays it and waits for the card."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()

    def replay() -> None:
        graph.replay()
        torch.cuda.synchronize()
    return replay


def swiglu_work(t: int = 1024, d: int = 3584, f: int = 18944, reps: int = 20):
    """swiglu at qwen2-7b's widths, bf16: (replay, FLOP, bytes a replay)."""
    from repro_torch.kernels.swiglu import swiglu_cuda
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, scale):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(torch.bfloat16)
    x = randn((t, d), 1.0)
    wi, wg, wo = randn((d, f), d ** -0.5), randn((d, f), d ** -0.5), \
        randn((f, d), f ** -0.5)
    return (_graph(lambda: swiglu_cuda(x, wi, wg, wo), reps),
            reps * 6.0 * t * d * f, reps * (3.0 * d * f + 2.0 * t * d) * 2)


def rglru_work(b: int = 2, s: int = 2560, w: int = 4096, reps: int = 200):
    """rglru at recurrentgemma-9b's prefill, f32: (replay, FLOP, bytes a
    replay)."""
    from repro_torch.kernels.rglru import rglru_cuda
    g = torch.Generator(device="cuda").manual_seed(1)
    log_a = -F.softplus(torch.randn((b, s, w), generator=g, device="cuda"))
    bb = torch.randn((b, s, w), generator=g, device="cuda")
    return (_graph(lambda: rglru_cuda(log_a, bb), reps),
            reps * 3.0 * b * s * w, reps * 12.0 * b * s * w)


def solve(p_static: float, windows: list[dict]) -> tuple[float, float]:
    """(e_flop, e_hbm) from two windows' seconds, joules, FLOP and bytes:
    each window's dynamic joules E - p_static t = F e_flop + B e_hbm."""
    (f1, b1, d1), (f2, b2, d2) = (
        (w["flops"], w["bytes"], w["joules"] - p_static * w["seconds"])
        for w in windows)
    det = f1 * b2 - f2 * b1
    if det == 0:
        raise ValueError("the two windows do not separate FLOP from bytes")
    return (d1 * b2 - d2 * b1) / det, (f1 * d2 - f2 * d1) / det


def calibrate(source, log: Callable[[str], None] = print) -> dict:
    """Idle draw, the two kernel windows, the rates they reach and the
    solved constants, on the card behind ``source`` (an ``NvmlSource``)."""
    from repro_torch.telemetry.nvml import WINDOW_S, describe_window, \
        sample_window
    torch.cuda.synchronize()
    idle = sample_window(source, lambda: time.sleep(0.1), WINDOW_S)
    log(f"[calibrate] {source.describe()}; idle draw {idle.watts:.3f} W "
        f"over {idle.seconds:.3f} s{describe_window(idle.counter)}")
    windows = []
    for name, make in (("swiglu T=1024 d=3584 f=18944 bf16", swiglu_work),
                       ("rglru B=2 S=2560 W=4096 f32", rglru_work)):
        replay, flops, nbytes = make()
        win = sample_window(source, replay, seconds=WINDOW_S, min_calls=3)
        row = {"name": name, "seconds": win.seconds, "joules": win.joules,
               "watts": win.watts, "replays": win.calls,
               "flops": flops * win.calls, "bytes": nbytes * win.calls,
               "counter": win.counter}
        windows.append(row)
        log(f"[calibrate] {name}: {win.calls} graph replays in "
            f"{win.seconds:.4f} s, {win.joules:.3f} J ({win.watts:.3f} W); "
            f"{row['flops'] / win.seconds / 1e12:.3f} TFLOP/s, "
            f"{row['bytes'] / win.seconds / 1e12:.4f} TB/s"
            f"{describe_window(win.counter)}")
    e_flop, e_hbm = solve(idle.watts, windows)
    swiglu, rglru = windows
    out = {"card": source.name, "power_limit_w": source.power_limit_w,
           "counter_period_s": source.period, "p_static": idle.watts,
           "e_flop": e_flop, "e_hbm": e_hbm,
           "reached_flops": swiglu["flops"] / swiglu["seconds"],
           "reached_bw": rglru["bytes"] / rglru["seconds"],
           "idle_counter": idle.counter, "windows": windows}
    log(f"[calibrate] p_static {idle.watts:.3f} W, e_flop {e_flop:.4e} "
        f"J/FLOP, e_hbm {e_hbm:.4e} J/B, reached "
        f"{out['reached_flops'] / 1e12:.2f} TFLOP/s and "
        f"{out['reached_bw'] / 1e12:.4f} TB/s ({source.name}, "
        f"{source.power_limit_w} W)")
    return out


#: the constants a calibration yields, as ``core.power.H100`` names them
CONSTANTS = ("p_static", "e_flop", "e_hbm", "reached_flops", "reached_bw")
#: calibrations in a row on one card; each constant is their median
REPEATS = 3


def median_constants(runs: list[dict]) -> dict:
    """Each constant's median over ``runs`` (an odd count: the middle
    run's value)."""
    out = {}
    for key in CONSTANTS:
        v = sorted(r[key] for r in runs)
        out[key] = v[len(v) // 2]
    return out


def main() -> int:
    from repro_torch.device import resolve_device
    from repro_torch.telemetry.nvml import NvmlSource
    dev = resolve_device("cuda")
    source = NvmlSource(dev)
    runs = [calibrate(source) for _ in range(REPEATS)]
    med = median_constants(runs)
    print(f"[calibrate] median of {len(runs)}: " + ", ".join(
        f"{k} {med[k]:.6g}" for k in CONSTANTS))
    print(json.dumps({"median": med, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time an earlier version of the port's ssd and rglru kernels against the
current one, in turns, on one CUDA card.

    python3 scripts/kernel_ab.py --parent DIR [--out FILE]

DIR holds the earlier version's ``csrc`` (``ssd.cu``, ``rglru.cu`` and the
headers they include), for example unpacked with

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C DIR

Each earlier source is built with ``kernels/_build.py``'s flags into
``DIR/build`` and bound with ctypes at its own launcher's arguments (ssd
before the scratch arguments: x, dt, A, B, C, y, state, B, S, H, P, N, Q,
dtype, stream; rglru unchanged).  The current version runs through its
wrapper.  At each of the main path's shapes (mamba2-1.3b's prefill and
forward, in bf16 and f32; recurrentgemma-9b's prefill and forward) the two
are timed earlier, current, current, earlier (the mean of ``reps`` calls
captured in a CUDA graph and replayed, CUDA events: the card's time
without the host's launch cost), and their outputs compared.
Prints the card's name and power limit and one JSON line per shape; with
``--out`` also writes them all to FILE as JSON.  ``--profile`` adds, for
the current ssd at each shape, each of its kernels' mean device time from
``torch.profiler`` over ``reps`` calls.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rglru as RG  # noqa: E402
from repro_torch.kernels import ssd as SD  # noqa: E402

c_ptr, c_int = ctypes.c_void_p, ctypes.c_int


def build_old(src_dir: Path, name: str):
    """The earlier ``name.cu`` built into ``src_dir/build``; its launcher."""
    out = src_dir / "build"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir),
                    "-o", str(lib), str(src_dir / f"{name}.cu")],
                   check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
    fn.restype = c_int
    return fn


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls replayed from one
    CUDA graph (as chip_smoke.py times the kernels)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(old, new, reps: int) -> dict:
    """earlier, current, current, earlier"""
    t = [graph_ms(old, reps), graph_ms(new, reps), graph_ms(new, reps),
         graph_ms(old, reps)]
    return {"earlier_ms": [t[0], t[3]], "current_ms": [t[1], t[2]]}


def kernel_times(fn, reps: int) -> dict:
    """Mean device time in ms of each kernel ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]:
            e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def ssd_case(old_fn, dtype, s: int, chunk: int, reps: int,
             profile: bool = False) -> dict:
    b, h, p, n = 2, 64, 64, 128
    g = torch.Generator(device="cuda").manual_seed(s)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    x = F.silu(randn(b, s, h, p)).to(dtype)
    dt = F.softplus(randn(b, s, h))
    A = -torch.exp(0.2 * randn(h))
    Bm, Cm = randn(b, s, n).to(dtype), randn(b, s, n).to(dtype)
    y_old = torch.empty_like(x)
    st_old = torch.empty((b, h, p, n), device="cuda")
    code = SD.DTYPES[dtype]
    old_fn.argtypes = [c_ptr] * 7 + [c_int] * 7 + [c_ptr]

    def old():
        rc = old_fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), y_old.data_ptr(),
                    st_old.data_ptr(), b, s, h, p, n, chunk, code,
                    torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier ssd launch failed: {rc}")

    def new():
        return SD.ssd_cuda(x, dt, A, Bm, Cm, chunk)
    old()
    y_new, st_new = new()
    torch.cuda.synchronize()
    out = {"kernel": "ssd", "dtype": str(dtype).split(".")[-1],
           "shape": f"B={b} S={s} H={h} P={p} N={n} chunk {chunk}",
           **in_turns(old, new, reps),
           "y_max_diff": float((y_old.float() - y_new.float()).abs().max()),
           "state_max_diff": float((st_old - st_new).abs().max())}
    if profile:
        out["current_kernels_ms"] = kernel_times(new, reps)
    return out


def rglru_case(old_fn, s: int, reps: int) -> dict:
    b, w = 2, 4096
    g = torch.Generator(device="cuda").manual_seed(s)
    log_a = -0.2 * torch.rand((b, s, w), generator=g, device="cuda")
    bb = torch.randn((b, s, w), generator=g, device="cuda")
    h_old = torch.empty_like(bb)
    old_fn.argtypes = [c_ptr] * 3 + [c_int] * 3 + [c_ptr]

    def old():
        rc = old_fn(log_a.data_ptr(), bb.data_ptr(), h_old.data_ptr(), b, s,
                    w, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"earlier rglru launch failed: {rc}")

    def new():
        return RG.rglru_cuda(log_a, bb)
    old()
    h_new = new()
    torch.cuda.synchronize()
    return {"kernel": "rglru", "dtype": "float32",
            "shape": f"B={b} S={s} W={w}", **in_turns(old, new, reps),
            "h_max_diff": float((h_old - h_new).abs().max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    print(smi, flush=True)
    _build.build(["ssd", "rglru"])
    old_ssd = build_old(args.parent, "ssd")
    old_rglru = build_old(args.parent, "rglru")
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for s, chunk in ((512, 256), (520, 130)):
            rows.append(ssd_case(old_ssd, dtype, s, chunk, args.reps,
                                 args.profile))
            print(json.dumps(rows[-1]), flush=True)
    for s in (2560, 2568):
        rows.append(rglru_case(old_rglru, s, args.reps))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        args.out.write_text(json.dumps({"card": smi, "rows": rows},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

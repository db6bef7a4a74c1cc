#!/usr/bin/env python3
"""Time an earlier version of the port's ssd, rglru and mriq kernels against
the current one, in turns, on one CUDA card.

    python3 scripts/kernel_ab.py --parent DIR --only ssd,rglru|mriq
                                 [--out FILE] [--profile]

DIR holds the earlier version's ``csrc`` (``ssd.cu``, ``rglru.cu``,
``mriq.cu`` and the headers they include), for example unpacked with

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C DIR

Each earlier source is built with ``kernels/_build.py``'s flags into
``DIR/build`` and bound with ctypes at its own launcher's arguments: ssd's
with its scratch arguments (x, dt, A, B, C, y, state, ws_states, ws_enter,
ws_cum, ws_gram, B, S, H, P, N, Q, dtype, stream; the scratch laid out by
the current ``ssd.scratch_ends``, whose f32-sized ws_enter also holds an
earlier bf16 one), rglru's and mriq's as they are.  ``--only`` names the
kernels to compare, since an earlier csrc serves some of them only.  The
current version runs through its wrapper.  At each of the main path's
shapes (mamba2-1.3b's prefill and forward, in bf16 and f32, and its train
microbatch, 1 x 4096 in bf16; recurrentgemma-9b's prefill and forward;
MRI-Q at the paper's N = 64^3, M = 3072) the two are timed earlier, current,
current, earlier (the mean of ``reps`` calls captured in a CUDA graph and
replayed, CUDA events: the card's time without the host's launch cost),
and their outputs compared.  For mriq it then sweeps the current source's
design constants: each variant is a copy of ``mriq.cu`` with other values
of ``V`` (voxels a thread) and ``POLY_EVERY`` (one pair in this many on the
FP32 pipe; 0: all on the SFU), built into ``DIR/build/mriq_sweep``; every
variant is timed twice (the variants in order, then in reverse) and held to
the plain version at the kernel's tolerance.
Prints the card's name and power limit and one JSON line per shape or
variant; with ``--out`` also writes them all to FILE as JSON.
``--profile`` adds, for the earlier and the current ssd at each shape, each
of its kernels' mean device time from ``torch.profiler`` over ``reps``
calls.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mriq as MQ  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru as RG  # noqa: E402
from repro_torch.kernels import ssd as SD  # noqa: E402

c_ptr, c_int = ctypes.c_void_p, ctypes.c_int


def compile_lib(src_dir: Path, name: str, lib: Path) -> subprocess.Popen:
    """Start nvcc on ``src_dir/name.cu`` with _build.py's flags into
    ``lib``."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o",
         str(lib), str(src_dir / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def launcher(lib: Path, name: str):
    fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
    fn.restype = c_int
    return fn


def build_old(src_dir: Path, name: str):
    """The earlier ``name.cu`` built into ``src_dir/build``; its launcher."""
    lib = src_dir / "build" / f"lib{name}.so"
    proc = compile_lib(src_dir, name, lib)
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"earlier {name} build failed:\n{out}")
    return launcher(lib, name)


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


def ssd_case(old_fn, dtype, b: int, s: int, chunk: int, reps: int,
             profile: bool = False) -> dict:
    h, p, n = 64, 64, 128
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
    old_fn.argtypes = [c_ptr] * 11 + [c_int] * 7 + [c_ptr]
    ends = SD.scratch_ends(b, s, h, p, n, min(chunk, s))
    ws = torch.empty(ends[-1], dtype=torch.uint8, device="cuda")

    def old():
        rc = old_fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), y_old.data_ptr(),
                    st_old.data_ptr(),
                    *(ws.data_ptr() + e for e in ends[:4]), b, s, h, p, n,
                    chunk, code, torch.cuda.current_stream().cuda_stream)
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
        out["earlier_kernels_ms"] = kernel_times(old, reps)
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


#: (dtype, batch, tokens, chunk): mamba2-1.3b's prefill and forward in
#: bf16 and f32, and its train microbatch in bf16
SSD_SHAPES = [(dt, 2, s, q) for dt in (torch.bfloat16, torch.float32)
              for s, q in ((512, 256), (520, 130))] \
    + [(torch.bfloat16, 1, 4096, 256)]
MRIQ_ARGTYPES = [c_ptr] * 9 + [c_int, c_int, c_ptr]
#: the sweep of mriq's design constants: (voxels a thread, poly_every)
MRIQ_VARIANTS = [(2, p) for p in (0, 24, 16, 12, 8, 6, 4, 2, 1)] + \
    [(4, p) for p in (0, 24, 12, 8)]


def clock_under_load(fn, seconds: float = 2.0) -> dict:
    """The card's SM clock and power draw (nvidia-smi, sampled every ~0.2
    s) while ``fn`` runs back to back for about ``seconds``."""
    import threading
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.split(",")
            samples.append((float(out[0]), float(out[1])))
            stop.wait(0.2)
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(1, int(seconds * 1e3 / start.elapsed_time(end)))
    th = threading.Thread(target=sample)
    th.start()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    stop.set()
    th.join()
    mhz = sorted(c for c, _ in samples)
    return {"sm_mhz_min": mhz[0], "sm_mhz_median": mhz[len(mhz) // 2],
            "sm_mhz_max": mhz[-1], "power_w_max": max(w for _, w in samples),
            "samples": len(samples), "calls": reps}


def mriq_variant(out: Path, voxels: int, poly_every: int) -> Path:
    """A copy of the current ``csrc`` in ``out`` whose ``mriq.cu`` has
    ``V = voxels`` and ``POLY_EVERY = poly_every``."""
    cur = Path(_build.CSRC)
    out.mkdir(parents=True, exist_ok=True)
    for h in _build.HEADERS:
        shutil.copy(cur / h, out / h)
    src = (cur / "mriq.cu").read_text()
    for name, value in (("V", voxels), ("POLY_EVERY", poly_every)):
        src, k = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if k != 1:
            raise RuntimeError(f"mriq.cu: no single constant {name}")
    (out / "mriq.cu").write_text(src)
    return out


def mriq_bound(fn, args) -> tuple:
    """A launch of a ctypes mriq launcher ``fn`` on ``args`` into fresh
    outputs: the call and the outputs."""
    fn.argtypes = MRIQ_ARGTYPES
    qr, qi = torch.empty_like(args[4]), torch.empty_like(args[4])
    n, m = args[4].shape[0], args[0].shape[0]

    def call():
        rc = fn(*(a.data_ptr() for a in args), qr.data_ptr(), qi.data_ptr(),
                n, m, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"mriq launch failed: {rc}")
    return call, (qr, qi)


def mriq_err(got, want) -> float:
    """max |got - want|; raises past atol 5e-4 + rtol 1e-4 (the kernel's
    tolerance against the plain version)."""
    err = 0.0
    for g, w in zip(got, want):
        d = (g - w).abs()
        if bool((d > 5e-4 + 1e-4 * w.abs()).any()):
            raise RuntimeError(f"mriq variant off its tolerance: {d.max()}")
        err = max(err, float(d.max()))
    return err


def mriq_rows(src_dir: Path, reps: int) -> list:
    """The earlier mriq against the current one in turns, then the sweep
    of the current source's design constants."""
    var_dir = src_dir / "build" / "mriq_sweep"
    procs = {}
    for v, p in MRIQ_VARIANTS:
        d = mriq_variant(var_dir / f"v{v}_p{p}", v, p)
        procs[(v, p)] = compile_lib(d, "mriq", d / "libmriq.so")
    old_fn = build_old(src_dir, "mriq")
    _build.build(["mriq"])
    args = ref.mriq_inputs(0, 64 ** 3, 3072, device="cuda")
    n, m = args[4].shape[0], args[0].shape[0]
    want = ref.mriq_ref(*args)
    old, old_out = mriq_bound(old_fn, args)

    def new():
        return MQ.mriq_cuda(*args)
    old()
    got = new()
    torch.cuda.synchronize()
    rows = [{"kernel": "mriq", "dtype": "float32", "shape": f"N={n} M={m}",
             **in_turns(old, new, reps),
             "earlier_max_err": mriq_err(old_out, want),
             "current_max_err": mriq_err(got, want),
             "qr_max_diff": float((old_out[0] - got[0]).abs().max()),
             "current_under_load": clock_under_load(new)}]
    print(json.dumps(rows[-1]), flush=True)
    calls = {}
    for (v, p), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"mriq variant {v}/{p} build failed:\n{log}")
        fn = launcher(var_dir / f"v{v}_p{p}" / "libmriq.so", "mriq")
        call, out = mriq_bound(fn, args)
        call()
        torch.cuda.synchronize()
        ptxas = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        calls[(v, p)] = (call, {"variant": f"voxels {v}, poly_every {p}",
                                "voxels": v, "poly_every": p,
                                "max_err": mriq_err(out, want),
                                "ptxas": ptxas, "ms": []})
    order = list(calls)
    for key in order + order[::-1]:
        calls[key][1]["ms"].append(graph_ms(calls[key][0], reps))
    for key in order:
        rows.append({"kernel": "mriq sweep", "shape": f"N={n} M={m}",
                     **calls[key][1]})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--only", required=True,
                    help="comma-separated kernels: ssd, rglru, mriq")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    print(smi, flush=True)
    rows = []
    if "ssd" in only:
        _build.build(["ssd"])
        old_ssd = build_old(args.parent, "ssd")
        for dtype, b, s, chunk in SSD_SHAPES:
            rows.append(ssd_case(old_ssd, dtype, b, s, chunk, args.reps,
                                 args.profile))
            print(json.dumps(rows[-1]), flush=True)
    if "rglru" in only:
        _build.build(["rglru"])
        old_rglru = build_old(args.parent, "rglru")
        for s in (2560, 2568):
            rows.append(rglru_case(old_rglru, s, args.reps))
            print(json.dumps(rows[-1]), flush=True)
    if "mriq" in only:
        rows += mriq_rows(args.parent, min(args.reps, 20))
    if args.out:
        args.out.write_text(json.dumps({"card": smi, "rows": rows},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

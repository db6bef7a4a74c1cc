#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure (build, launch, tolerance) ends the run with
a non-zero exit and no result line:

  1. card     the card's name and power limit, and the device count;
  2. build    nvcc builds the five kernels (mriq, flash_attention, swiglu,
              ssd, rglru) for sm_90a from the sources in the checkout, all
              at once, and prints each kernel's registers, shared memory
              and spills, and, from ``cuobjdump -sass``, the tensor-core
              (HMMA/HGMMA) and atomic instructions of each function of the
              three tensor-core kernels (flash_attention, swiglu, ssd:
              each of ssd's bf16 functions must hold HMMA/HGMMA) and of
              rglru (no RED/ATOM in any function of ssd or rglru), and the
              special-function (MUFU) instructions of mriq, which must
              hold some and whose ptxas report must show no stack frame
              and no spills;
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes the main path gives it (mriq also against the
              plain version in f64 at the bound its arithmetic allows
              (ref.mriq_f32_tolerance), at N 262147 / M 3073 and with
              phases up to 2^12 turns, and launched twice and held bit
              for bit; its SFU floor on a log line; flash_attention also at
              recurrentgemma-9b's D=256 with its 2048 window; ssd in bf16
              and f32 at mamba2-1.3b's prefill (S 512, chunk 256) and
              forward (S 520, chunk 130), also against the token-by-token
              recurrence; rglru at recurrentgemma-9b's prefill and forward
              S; ssd and rglru launched twice and held bit for bit); plain
              and library times from CUDA events, the kernel's from a CUDA
              graph of its launches replayed (the host's launch cost does
              not bound a short kernel; ssd's also eager), the card's least
              time (bound) and the kernel's share of it; for the bf16
              tensor-core kernels also the library call's error against
              the same plain version (the kernel's may be at most twice
              it), and both swiglu designs timed on either side of their
              switch; plus reduced qwen2-7b, mamba2-1.3b and
              recurrentgemma-9b on the card (kernels, f32) against the
              plain path on the CPU;
  4. calibrate the card's idle draw and two kernel windows (swiglu T=1024,
              rglru S 2560) under the NVML sampler, and the energy
              constants solved from them beside the ones ``core.power.H100``
              commits (``repro_torch.benchmarks.calibrate_power``);
  5. models   for each of qwen2-7b, mamba2-1.3b and recurrentgemma-9b at
              full width under the offload plan (every site on the
              kernels), random weights from seeded generators on the card,
              one model at a time:
              Fig. 5   (qwen2-7b's path) the paper's MRI-Q A/B at its size
                       (64^3 voxels, 3072 k-space points) through
                       ``repro_torch.benchmarks.bench_mriq``: the card's name,
                       power limit and energy counter period, its idle
                       draw, the CPU-only leg, the offloaded leg from pinned
                       buffers (H2D + kernel + D2H, each part's median and
                       range over 5 legs), the Fig. 5 rows at the paper's
                       R740 node points and the offloaded leg at the card's
                       measured draw (card-only);
              prefill  2 x 512 tokens (2 x 2560 for recurrentgemma-9b, past
                       its 2048 window), then 8 decode steps, held against
                       the teacher-forced forward (qwen2-7b for three weight
                       seeds; mamba2-1.3b in f32 compute, its bf16 run held
                       to finite logits, see PREFILL_F32);
              serve    ``ServeLoop`` (8 slots, max_seq 256) billing a
                       ``DecodeEnergyMeter`` at the accelerated R740 node
                       point: 8 requests, 16 new tokens each;
              offload  (qwen2-7b's path, on its loaded weights) the paper's
                       offload search, ``core.adapt`` at prefill_32k_b1:
                       GA and narrowing on the analytic rung, the finalists
                       and the chosen plan's smoke trial measured on the
                       card (wall clock, NVML energy); each finalist's
                       seconds, W, Ws and fitness or its penalty, the chosen
                       plan; fails unless a finalist is confirmed on the
                       measured rung and the chosen plan's trial launched
                       the kernels its genes name;
              counts   the kernels' launch counts over that model's path,
                       each kernel of the path > 0;
  6. profile  qwen2-7b's 8 requests served again, and one bf16 prefill of
              mamba2-1.3b, under torch.profiler: kernels by device time,
              the CUDA runtime calls by host time, and the device's busy
              share of each window.

Every window sampled from the card's NVML energy counter must agree with
the counter's own difference over it within 5 %.  Kernel phase 3 also times
flash_attention and swiglu at qwen2-7b's 32k-token prefill, beside their
bounds (their plain versions are held at the shapes above).  It exits
non-zero when no CUDA device is visible, and when the port's package is
not beside it.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W)
PEAK_BF16 = 989e12      # FLOP/s, tensor cores
PEAK_F32 = 67e12        # FLOP/s, CUDA cores
PEAK_BYTES = 3.35e12    # B/s, HBM3

#: one bf16 rounding, f32 sums in another order: rtol 2^-8 (bf16's 8-bit
#: mantissa) + atol 1e-5
BF16_TOL = (1e-5, 2.0 ** -8)
#: the bf16 flash and swiglu kernels run on the tensor cores and round one
#: intermediate to bf16 before the second product, as the library calls
#: do: P (each weight moves by at most 2^-9 of itself and the weights sum
#: to 1, so o moves by at most 2^-9 max|v|) and a (y moves by at most
#: 2^-9 (|a| @ |wo|)).  Held against the plain version in f32 on the same
#: bf16 inputs at that bound + BF16_TOL, and at most 2x the library call's
#: error against the same plain version.
ROUND = 2.0 ** -9
#: f32 sums of many products in another order on the tensor cores, as a
#: share of the sum of |products| (readings sit near 2^-22)
SUM_ORDER = 2.0 ** -20
FLASH_TOL_TEXT = ("atol 2^-9 max|v| + 1e-5 + rtol 2^-8, vs the plain "
                  "version in f32")
SWIGLU_TOL_TEXT = ("atol 2^-9 (|a| @ |wo|) + 1e-5 + rtol 2^-8, vs the plain "
                   "version in f32; a and y = a @ wo each at atol 2^-20 "
                   "sum|products| + 1e-5 + rtol 2^-8")
#: the bf16 kernels' error may be at most this multiple of the library's
LIBRARY_ERR_FACTOR = 2.0

#: prefill + decode against the full forward, as a share of max|logit|:
#: about 3x the largest reading on H100 runs (PERF.md, section 6: 0.0159,
#: 0.0086 in f32, 0.0179)
PREFILL_TOL = {"qwen2-7b": 0.045, "mamba2-1.3b": 0.025,
               "recurrentgemma-9b": 0.05}
#: archs whose check runs in f32 compute: mamba2-1.3b's random-init stack
#: amplifies last-bit differences through its 48 layers, so in bf16 its
#: prefill + decode and its forward (SSD chunks of 256 and of 130) part
#: completely (0.88 of max|logit| on the H100 and on the CPU's plain
#: path), while in f32 they agree (0.0086 on the H100).  Its bf16 run, the
#: config's plan that serving uses, is held to finite logits.
PREFILL_F32 = ("mamba2-1.3b",)
#: weight seeds of qwen2-7b's prefill check; its serve phase uses the first
PREFILL_SEEDS = (0, 1, 2)
#: prompt length of each model's prefill check: recurrentgemma-9b's runs
#: past its 2048 local-attention window
PREFILL_LEN = {"qwen2-7b": 512, "mamba2-1.3b": 512,
               "recurrentgemma-9b": 2560}

SOURCES = {
    "mriq": ("src/repro_torch/kernels/csrc/mriq.cu",
             "src/repro/kernels/mriq.py:44"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:71"),
    "swiglu": ("src/repro_torch/kernels/csrc/swiglu.cu",
               "src/repro/kernels/swiglu.py:43"),
    "ssd": ("src/repro_torch/kernels/csrc/ssd.cu",
            "src/repro/kernels/ssd.py:58"),
    "rglru": ("src/repro_torch/kernels/csrc/rglru.cu",
              "src/repro/kernels/rglru.py:40"),
}
#: mriq, ssd and rglru: no single PyTorch call computes the same function
NO_LIBRARY = "none: no single PyTorch call computes it"
#: the offload plan: every compute site on its kernel (bench_power.py)
OFFLOAD = dict(attn_impl="pallas", mlp_impl="pallas", ssm_impl="pallas",
               rglru_impl="pallas")
#: the kernels each model's path must launch
PATH_KERNELS = {"qwen2-7b": ("mriq", "flash_attention", "swiglu"),
                "mamba2-1.3b": ("ssd",),
                "recurrentgemma-9b": ("flash_attention", "rglru")}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls,
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed, CUDA events: the card's time for the launches,
    without the host's time to make them (a wrapper's Python and launch
    cost would otherwise bound a kernel shorter than it)."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()          # warm-up off the capture, as
    side.wait_stream(torch.cuda.current_stream())   # torch.cuda.graphs asks
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


def bound(flops: float, peak: float, nbytes: float) -> dict:
    """The card's least time in ms for the work (the larger of its
    operations at ``peak`` and its bytes at the HBM rate), what bounds it,
    and which peak the operations were held to."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": by,
            "bound_peak": {PEAK_BF16: "bf16 989 TFLOP/s",
                           PEAK_F32: "f32 67 TFLOP/s"}[peak]}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, got, want, atol: float, rtol: float) -> float:
    err = max_err(got, want)
    if not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{name}: non-finite output")
    excess = float(((got.float() - want.float()).abs()
                    - (atol + rtol * want.float().abs())).max())
    if excess > 0:
        atol_s = f"{atol}" if isinstance(atol, float) else "(per element)"
        raise RuntimeError(f"{name}: max_err {err:.3e} over atol {atol_s} + "
                           f"rtol {rtol}*|plain|")
    return err


def check_library(name: str, err: float, lib_err: float) -> None:
    """A bf16 tensor-core kernel's error against the plain f32 version may
    be at most LIBRARY_ERR_FACTOR times the library call's."""
    if err > LIBRARY_ERR_FACTOR * lib_err:
        raise RuntimeError(f"{name}: max_err {err:.3e} over "
                           f"{LIBRARY_ERR_FACTOR} x the library's "
                           f"{lib_err:.3e}")


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def phase_card() -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = {"smi": smi.splitlines()[0],
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    log(f"[card] {card['smi']} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {card['kind']} x{card['count']}")
    return card


#: the kernels whose bf16 instance runs on the tensor cores
TENSOR_CORE = ("flash_attention", "swiglu", "ssd")
#: functions (by a part of their name) that must each hold a tensor-core
#: instruction: ssd's bf16 functions
TC_FUNCTIONS = {"ssd": "_tc"}
#: functions (by parts of their name; "" for all) whose sums must hold no
#: atomic instruction
NO_ATOMICS = {"swiglu": ("gemm", "combine"), "ssd": ("",), "rglru": ("",)}
#: kernels whose ptxas report must show no stack frame and no spills
NO_SPILLS = ("mriq",)
#: kernels whose SASS must hold special-function-unit (MUFU) instructions
SFU = ("mriq",)


def sass_counts(lib: Path) -> dict | None:
    """Tensor-core (HMMA/HGMMA), atomic (RED/ATOM) and special-function
    (MUFU) instructions in each function of a built library, from
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    from repro_torch.kernels._build import nvcc
    tool = Path(nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    filt = Path(nvcc()).parent / "cu++filt"
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = {"tensor_core": 0, "atomic": 0, "mufu": 0}
        elif fn is not None:
            # "/*0120*/  @P0 HMMA.16816.F32.BF16 R4, ... ;  /* 0x... */"
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                          line)
            op = m.group(1) if m else ""
            counts[fn]["tensor_core"] += op in ("HMMA", "HGMMA")
            counts[fn]["atomic"] += op.startswith(("RED", "ATOM"))
            counts[fn]["mufu"] += op == "MUFU"
    if filt.is_file():
        names = subprocess.run([str(filt)], input="\n".join(counts),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(counts):
            counts = dict(zip(names, counts.values()))
    return counts


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build(SOURCES)
    log(f"[build] {len(logs)} kernels in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, sm_90a)")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling")):
                log(f"[build] {name}: {line.strip()}")
            # "8 bytes stack frame, 12 bytes spill stores, 12 bytes spill
            # loads"
            if name in NO_SPILLS and "stack frame" in line and any(
                    int(v) for v in re.findall(r"(\d+) bytes", line)):
                raise RuntimeError(f"{name}: stack frame or spills: "
                                   f"{line.strip()}")
    for name in dict.fromkeys(TENSOR_CORE + tuple(NO_ATOMICS) + SFU):
        counts = sass_counts(_build.library_path(name))
        if counts is None:
            log(f"[build] {name}: no cuobjdump, SASS not read")
            continue
        for fn, c in counts.items():
            log(f"[build] {name} SASS: {c['tensor_core']} HMMA/HGMMA, "
                f"{c['atomic']} RED/ATOM, {c['mufu']} MUFU in {fn[:110]}")
        if name in SFU and not sum(c["mufu"] for c in counts.values()):
            raise RuntimeError(f"{name}: no MUFU instruction in SASS")
        if name in TENSOR_CORE and not sum(
                c["tensor_core"] for c in counts.values()):
            raise RuntimeError(f"{name}: no tensor-core instruction in SASS")
        part = TC_FUNCTIONS.get(name)
        bare = [fn for fn, c in counts.items()
                if part and part in fn and not c["tensor_core"]]
        if bare:
            raise RuntimeError(f"{name}: no tensor-core instruction in {bare}")
        held = [fn for fn, c in counts.items() if c["atomic"] and any(
            w in fn for w in NO_ATOMICS.get(name, ()))]
        if held:
            raise RuntimeError(f"{name}: atomics in {held}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


#: the SFU's sine/cosine rate assumed for its floor: 16 lanes an SM a
#: clock on 132 SMs at the H100 SXM's 1.98 GHz boost clock
SFU_RATE = 132 * 16 * 1.98e9
MRIQ_DESIGN = ("phase in turns reduced exactly; sin/cos on the SFU (MUFU); "
               "4 voxels a thread, k-space in shared memory; group sums of "
               "96 into Kahan sums")


def mriq_truth(label: str, args, vs_plain: bool = True) -> dict:
    """The kernel against the f32 plain version (atol 5e-4 + rtol 1e-4,
    tests/test_kernels.py's) where ``vs_plain``, and against the f64 plain
    version: elementwise within ``ref.mriq_f32_tolerance`` (derived from
    the kernel's arithmetic), with a max error at most twice the f32 plain
    version's; two launches bit for bit.  Without ``vs_plain`` (large
    phases) the f32 plain version must itself miss f64 by more than that
    tolerance: it rounds 2 pi t of thousands of turns."""
    from repro_torch.kernels import mriq as K, ref
    got = K.mriq_cuda(*args)
    assert_repeats(label, lambda: K.mriq_cuda(*args))
    plain = ref.mriq_ref(*args)
    exact = ref.mriq_ref(*[a.double() for a in args])
    bnd = ref.mriq_f32_tolerance(*args)
    row = {"max_abs_err": None, "f64_max_abs_err": 0.0,
           "plain_f64_max_abs_err": 0.0, "f64_bound_used": 0.0}
    for part, g, p, e in zip(("qr", "qi"), got, plain, exact):
        if vs_plain:
            row["max_abs_err"] = max(row["max_abs_err"] or 0.0, check(
                f"{label} {part}", g, p, 5e-4, 1e-4))
        err = (g.double() - e).abs()
        p_err = float((p.double() - e).abs().max())
        used = float((err / bnd).max())
        if used > 1:
            raise RuntimeError(f"{label} {part}: over the derived f64 bound "
                               f"({used:.3f} of it)")
        if float(err.max()) > 2 * p_err:
            raise RuntimeError(f"{label} {part}: f64 error {err.max():.3e} "
                               f"over twice the plain version's {p_err:.3e}")
        if not vs_plain and p_err <= 5e-4 + 1e-4 * float(e.abs().max()):
            raise RuntimeError(f"{label} {part}: the plain version is within "
                               f"the vs-plain tolerance; hold the kernel to "
                               f"it")
        row["f64_max_abs_err"] = max(row["f64_max_abs_err"], float(err.max()))
        row["plain_f64_max_abs_err"] = max(row["plain_f64_max_abs_err"],
                                           p_err)
        row["f64_bound_used"] = max(row["f64_bound_used"], used)
    del plain, exact, bnd
    log(f"[kernels] {label}: max_err vs f32 plain "
        + ("n/a (the plain version misses f64 by more than the tolerance)"
           if row["max_abs_err"] is None else f"{row['max_abs_err']:.3e}")
        + f"; vs f64 {row['f64_max_abs_err']:.3e} (the f32 plain version's "
        f"{row['plain_f64_max_abs_err']:.3e}; at most "
        f"{row['f64_bound_used']:.3f} of the derived bound); two launches "
        f"bit for bit")
    return row


def kernel_mriq(rows: dict) -> None:
    from repro_torch.kernels import mriq as K, ref
    args = ref.mriq_inputs(0, 64 ** 3, 3072, device="cuda")
    n, m = args[4].shape[0], args[0].shape[0]
    row = mriq_truth(f"mriq N={n} M={m}", args)
    bnd = bound(16.0 * n * m, PEAK_F32, (3 * n + 4 * m + 2 * n) * 4)
    rows["mriq"] = {
        **row, "tol": "atol 0.0005 + rtol 0.0001 vs the f32 plain version; "
        "derived bound (ref.mriq_f32_tolerance) vs the f64 plain version",
        "design": MRIQ_DESIGN,
        "ms": graph_ms(lambda: K.mriq_cuda(*args), reps=10),
        "plain_ms": cuda_ms(lambda: ref.mriq_ref(*args), reps=3),
        **bnd, "library_ms": None, "library": NO_LIBRARY,
        "shape": f"N={n} M={m} f32"}
    floor = 2.0 * n * m / SFU_RATE * 1e3
    log(f"[kernels] mriq: SFU floor {floor:.4f} ms (2 MUFU a pair at 16 "
        f"lanes/SM/clock x 132 SMs x 1.98 GHz, an assumed clock), kernel at "
        f"{floor / rows['mriq']['ms']:.4f} of it; design {MRIQ_DESIGN}")
    del args
    # ragged: N past a whole block, M past whole groups and strides
    args = ref.mriq_inputs(1, 64 ** 3 + 3, 3073, device="cuda")
    rows["mriq"]["ragged"] = mriq_truth("mriq N=262147 M=3073", args)
    # phases up to 2^12 turns: the turn reduction must still hold
    args = ref.mriq_inputs(2, 64 ** 3, 3072, t_max=2.0 ** 12, device="cuda")
    rows["mriq"]["large_phase"] = mriq_truth(
        "mriq N=262144 M=3072 |t| <= 2^12", args, vs_plain=False)


def flash_case(s: int, hq: int, hkv: int, d: int, window: int, seed: int,
               reps: int) -> dict:
    from repro_torch.kernels import flash_attention as K, ref
    b = 2
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    got = K.flash_attention_cuda(q, k, v, True, window)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), True,
                                   window)
    err = check(f"flash_attention D={d}", got, want,
                ROUND * float(v.float().abs().max()) + BF16_TOL[0],
                BF16_TOL[1])
    # library yardstick: SDPA on (B,H,S,D) with the KV heads repeated (and
    # the window as a boolean mask)
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    pos = torch.arange(s, device="cuda")
    keep = pos[None, :] <= pos[:, None]
    if window:
        keep &= pos[:, None] - pos[None, :] < window

    def sdpa():
        if window:
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    sdpa_err = max_err(sdpa().transpose(1, 2), want)
    del want
    check_library(f"flash_attention D={d}", err, sdpa_err)
    pairs = int(keep.sum())     # (q, k) pairs the mask keeps
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    bnd = bound(4.0 * b * hq * d * pairs, PEAK_BF16, nbytes)
    mask = "causal" + (f" window {window}" if window else "")
    return {"max_abs_err": err, "tol": FLASH_TOL_TEXT,
            "design": "mma.sync m16n8k16 bf16, cp.async 2-stage K/V ring, "
                      + ("64 queries x 4 warps" if d <= 128
                         else "128 queries x 8 warps") + ", 64-key tiles",
            "ms": graph_ms(lambda: K.flash_attention_cuda(q, k, v, True,
                                                          window), reps),
            "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, True, window), reps),
            **bnd,
            "library_ms": cuda_ms(sdpa, reps),
            "library": "F.scaled_dot_product_attention, KV repeated",
            "library_max_abs_err": sdpa_err,
            "shape": f"B={b} S=T={s} Hq={hq} Hkv={hkv} D={d} bf16 {mask}"}


SWIGLU_DESIGNS = {
    "decode": "mma.sync m16n8k16 bf16, 32-row x tiles, 64x64 weight tiles, "
              "cp.async 4 stages, K split over ~8 waves + fixed-order sums",
    "prefill": "wgmma m64n128k16 bf16, both operands by 128B-swizzled "
               "descriptor (weights M-major), dual GEMM 128x128x64 + GEMM "
               "128x128x64, cp.async 4 stages, a in bf16 scratch"}


def qwen_mlp(seed: int):
    """qwen2-7b's MLP weights (d 3584, f 18944) in bf16 on the card."""
    d, f = 3584, 18944
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(shape, scale):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(torch.bfloat16)
    return (randn((d, f), d ** -0.5), randn((d, f), d ** -0.5),
            randn((f, d), f ** -0.5), g)


def swiglu_case(t: int, seed: int) -> dict:
    from repro_torch.kernels import swiglu as K, ref
    wi, wg, wo, g = qwen_mlp(seed)
    d, f = wi.shape
    x = torch.randn((t, d), generator=g, device="cuda").to(torch.bfloat16)
    a_k = torch.empty((t, f), dtype=torch.bfloat16, device="cuda")
    got = K.swiglu_cuda(x, wi, wg, wo, out_a=a_k)
    x32, wi32, wg32, wo32 = (w.float() for w in (x, wi, wg, wo))
    h, gt = x32 @ wi32, x32 @ wg32
    a = F.silu(gt) * h
    # a moves by |silu(g)| dh + |h| |silu'(g)| dg, |silu'| < 1.1
    sums = (F.silu(gt).abs() * (x32.abs() @ wi32.abs())
            + 1.1 * h.abs() * (x32.abs() @ wg32.abs()))
    del wi32, wg32, h, gt
    want = a @ wo32
    err = check(f"swiglu T={t}", got, want,
                ROUND * (a.abs() @ wo32.abs()) + BF16_TOL[0], BF16_TOL[1])
    err_a = check(f"swiglu T={t} a", a_k, a, SUM_ORDER * sums + BF16_TOL[0],
                  BF16_TOL[1])
    err_y = check(f"swiglu T={t} y vs a @ wo", got, a_k.float() @ wo32,
                  SUM_ORDER * (a_k.float().abs() @ wo32.abs())
                  + BF16_TOL[0], BF16_TOL[1])
    del sums
    del a, wo32, x32
    lib_err = max_err((F.silu(x @ wg) * (x @ wi)) @ wo, want)
    del want
    check_library(f"swiglu T={t}", err, lib_err)
    nbytes = (3 * d * f + 2 * t * d) * 2
    bnd = bound(6.0 * t * d * f, PEAK_BF16, nbytes)
    reps = 20 if t <= K.DECODE_MAX_T else 5
    return {"max_abs_err": err, "tol": SWIGLU_TOL_TEXT,
            "a_max_abs_err": err_a, "y_vs_a_wo_max_abs_err": err_y,
            "design": SWIGLU_DESIGNS[K.plan(t, d, f, x.dtype)["design"]],
            "ms": graph_ms(lambda: K.swiglu_cuda(x, wi, wg, wo), reps),
            "plain_ms": cuda_ms(lambda: ref.swiglu_ref(x, wi, wg, wo), reps),
            **bnd,
            # the cuBLAS chain (silu(x@wg)*(x@wi))@wo, timed as a yardstick
            "library_ms": cuda_ms(
                lambda: (F.silu(x @ wg) * (x @ wi)) @ wo, reps),
            "library": "cuBLAS chain (silu(x@wg)*(x@wi))@wo",
            "library_max_abs_err": lib_err,
            "shape": f"T={t} d={d} f={f} bf16"}


#: token counts at which both bf16 swiglu designs are timed: decode,
#: prefill, and around the switch (swiglu.DECODE_MAX_T)
SWITCH_T = (8, 32, 33, 64, 65, 128, 256, 1024)


def swiglu_designs() -> dict:
    """Both bf16 swiglu designs timed at each of SWITCH_T, at qwen2-7b's
    widths (the wrapper takes decode up to swiglu.DECODE_MAX_T)."""
    from repro_torch.kernels import swiglu as K
    wi, wg, wo, g = qwen_mlp(8)
    out = {}
    for t in SWITCH_T:
        x = torch.randn((t, wi.shape[0]), generator=g,
                        device="cuda").to(torch.bfloat16)
        reps = 20 if t <= 256 else 5
        out[t] = {dz: graph_ms(lambda: K.swiglu_cuda(x, wi, wg, wo, dz),
                               reps) for dz in ("decode", "prefill")}
        log(f"[kernels] swiglu T={t} d=3584 f=18944 bf16: decode design "
            f"{out[t]['decode']:.4f} ms, prefill design "
            f"{out[t]['prefill']:.4f} ms (wrapper takes "
            f"{K.plan(t, 3584, 18944, x.dtype)['design']})")
    return out


#: the SSD shapes: mamba2-1.3b's prefill (2 x 512 tokens, chunk 256) and
#: forward (2 x 520, chunk _blk(520, 256) = 130), 64 heads of 64, state 128
SSD_SHAPE = dict(b=2, h=64, p=64, n=128)
SSD_CASES = {"": (torch.bfloat16, 512, 256), "forward": (torch.bfloat16, 520, 130),
             "f32": (torch.float32, 512, 256),
             "f32_forward": (torch.float32, 520, 130)}
SSD_TOL_TEXT = {
    torch.float32: "atol 1e-4 x max|plain| + rtol 1e-4, vs the plain version",
    torch.bfloat16: "derived (ref.ssd_bf16_tolerance): 3 x 2^-8 Y_abs (y), "
                    "2^-8 S_abs (state), + 1e-4 max|plain| + 2^-8 |plain|, "
                    "vs the plain version in f32"}
SSD_DESIGN = {
    torch.bfloat16: "scores C B^T once per chunk (mma.sync m16n8k16), chunk "
                    "states x^T B' (mma.sync), states passed in order, "
                    "64-row query tiles: W' in registers into W' x and "
                    "C S^T (mma.sync), x by a 2-stage cp.async ring",
    torch.float32: "the same passes on the CUDA cores, 4x4 register patches "
                   "from float4 rows of shared tiles"}


def ssd_inputs(seed: int, dtype, s: int, dt_shift: float = 0.0):
    """Inputs as mamba2's prefill gives them: x = silu(.), dt = softplus(.)
    (shifted down to make the decay slow), A = -exp(0.2 N(0,1))."""
    b, h, p, n = (SSD_SHAPE[k] for k in "bhpn")
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    x = F.silu(randn(b, s, h, p)).to(dtype)
    dt = F.softplus(randn(b, s, h) + dt_shift)
    A = -torch.exp(0.2 * randn(h))
    return x, dt, A, randn(b, s, n).to(dtype), randn(b, s, n).to(dtype)


def check_ssd(name: str, got, want, args, q: int) -> float:
    """y against y, state against state: f32 at atol 1e-4 x max|plain| +
    rtol 1e-4, bf16 at the derived bound of ``ref.ssd_bf16_tolerance``."""
    from repro_torch.kernels import ref
    if got[0].dtype == torch.bfloat16:
        bounds = ref.ssd_bf16_tolerance(*args, q, want)
        return max(check(f"{name} {part}", g, w, bnd, 0.0) for part, g, w, bnd
                   in zip(("y", "state"), got, want, bounds))
    return max(check(f"{name} {part}", g, w, 1e-4 * float(w.abs().max()),
                     1e-4) for part, g, w in zip(("y", "state"), got, want))


def ssd_work(b: int, s: int, h: int, p: int, n: int, q: int,
             elt: int) -> tuple:
    """Operations and bytes the SSD function needs at this shape: the
    scores C B^T once per chunk (they do not depend on the head); per head
    W' x over the pairs j <= i, the chunk's state and, for the chunks after
    the first (the state entering the first is zero), the carried state's
    part of y; each input read once, y and the final state written once."""
    flops = 0
    for c0 in range(0, s, q):
        L = min(q, s - c0)
        pairs = L * (L + 1) // 2
        flops += 2 * b * pairs * n + 2 * b * h * (
            pairs * p + L * p * n + (L * p * n if c0 else 0))
    nbytes = (2 * b * s * h * p + 2 * b * s * n) * elt + (b * s * h + h) * 4 \
        + b * h * p * n * 4
    return flops, nbytes


def assert_repeats(name: str, fn) -> None:
    """Two launches on the same inputs agree bit for bit."""
    a, b = fn(), fn()
    for u, v in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if not torch.equal(u, v):
            raise RuntimeError(f"{name}: two launches differ")


def ssd_case(dtype, s: int, q: int) -> dict:
    from repro_torch.kernels import ref, ssd as K
    args = ssd_inputs(4, dtype, s)
    x, dt, A, Bm, Cm = args
    f32 = (x.float(), dt, A, Bm.float(), Cm.float())
    got = K.ssd_cuda(*args, q)
    label = f"ssd {str(dtype).split('.')[-1]} S={s} chunk {q}"
    err = check_ssd(f"{label} vs plain", got, ref.ssd_ref(*f32, q), args, q)
    # the token-by-token recurrence holds the chunk math where the JAX
    # reference is NaN (chunk 256: cum spans far past 88)
    err_rec = check_ssd(f"{label} vs recurrence", got,
                        ref.ssd_scan_ref(*f32), args, q)
    assert_repeats(label, lambda: K.ssd_cuda(*args, q))
    b, h, p, n = (SSD_SHAPE[k] for k in "bhpn")
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    flops, nbytes = ssd_work(b, s, h, p, n, q, x.element_size())
    return {"max_abs_err": err, "tol": SSD_TOL_TEXT[dtype],
            "recurrence_max_abs_err": err_rec, "design": SSD_DESIGN[dtype],
            "ms": graph_ms(lambda: K.ssd_cuda(*args, q), 20),
            "eager_ms": cuda_ms(lambda: K.ssd_cuda(*args, q), 20),
            "plain_ms": cuda_ms(lambda: ref.ssd_ref(*args, q), 5),
            **bound(flops, peak, nbytes), "library_ms": None,
            "library": NO_LIBRARY,
            "shape": f"B={b} S={s} H={h} P={p} N={n} chunk {q}, x/B/C/y "
                     f"{str(dtype).split('.')[-1]}"}


def kernel_ssd(rows: dict) -> None:
    from repro_torch.kernels import ref, ssd as K
    for label, (dtype, s, q) in SSD_CASES.items():
        row = ssd_case(dtype, s, q)
        if label:
            rows["ssd"][label] = row
        else:
            rows["ssd"] = row
    # with dt small enough that the state carries across tiles and chunks,
    # the f32 kernel against the recurrence
    slow = ssd_inputs(5, torch.float32, 512, dt_shift=-4.0)
    rows["ssd"]["slow_decay_f32_max_abs_err"] = check_ssd(
        "ssd f32 slow decay vs recurrence", K.ssd_cuda(*slow, 256),
        ref.ssd_scan_ref(*slow), slow, 256)


def rglru_case(s: int) -> dict:
    from repro_torch.kernels import ref, rglru as K
    b, w = 2, 4096
    g = torch.Generator(device="cuda").manual_seed(6)
    # gates as the model makes them: a = exp(log_a) in (0.9, 0.999)^r
    u = torch.empty(w, device="cuda").uniform_(0.9 ** 2, 0.999 ** 2,
                                               generator=g)
    lam = torch.log(torch.exp(-torch.log(u) / 16.0) - 1.0)
    r = torch.sigmoid(torch.randn((b, s, w), generator=g, device="cuda"))
    log_a = -8.0 * F.softplus(lam) * r
    bb = torch.sqrt(1.0 - torch.exp(2.0 * log_a)) \
        * torch.randn((b, s, w), generator=g, device="cuda")
    got = K.rglru_cuda(log_a, bb)
    atol, rtol = 2e-5, 2e-5         # tests/test_kernels.py, rglru
    err = check("rglru", got, ref.rglru_ref(log_a, bb), atol, rtol)
    assert_repeats(f"rglru S={s}", lambda: K.rglru_cuda(log_a, bb))
    bnd = bound(3.0 * b * s * w, PEAK_F32, 12.0 * b * s * w)
    return {"max_abs_err": err, "tol": f"atol {atol} + rtol {rtol}",
            "design": "32 channels x one batch row a block, 8 warps x 32 "
                      "steps a window, segments combined in warp order",
            "ms": graph_ms(lambda: K.rglru_cuda(log_a, bb), 20),
            "plain_ms": cuda_ms(lambda: ref.rglru_ref(log_a, bb), 3),
            **bnd, "library_ms": None, "library": NO_LIBRARY,
            "shape": f"B={b} S={s} W={w} f32"}


#: qwen2-7b's prefill_32k_b1: one sequence of 32768 tokens
PREFILL_32K = 32768


def rows_32k(n: int) -> torch.Tensor:
    """The rows of a 32k-token output held against the plain version (which
    is not run in full there): the first 64, the 128 across the middle and
    the last 256, whose queries see every key."""
    return torch.cat([torch.arange(0, 64),
                      torch.arange(n // 2 - 64, n // 2 + 64),
                      torch.arange(n - 256, n)]).cuda()


def flash_32k() -> dict:
    """flash_attention at qwen2-7b's 32k-token prefill (B1 S=T=32768 Hq28
    Hkv4 D128 bf16 causal), timed beside its bound and SDPA; the rows of
    ``rows_32k`` held against the plain version in f32 over all 32768 keys
    and against SDPA's error there, as ``flash_case`` holds the full
    output."""
    from repro_torch.kernels import flash_attention as K, ref
    s, hq, hkv, d = PREFILL_32K, 28, 4, 128
    g = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn((1, s, h, d), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    o = K.flash_attention_cuda(q, k, v, True, 0)
    idx = rows_32k(s)
    want = ref.attention_naive(q[:, idx].float(), k.float(), v.float(), idx,
                               torch.arange(s, device="cuda"), True, 0)
    err = check(f"flash_attention S={s} rows", o[:, idx], want,
                ROUND * float(v.float().abs().max()) + BF16_TOL[0],
                BF16_TOL[1])
    del o
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2).contiguous()
    sdpa_err = max_err(F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)[:, :, idx].transpose(1, 2), want)
    del want
    check_library(f"flash_attention S={s} rows", err, sdpa_err)
    pairs = s * (s + 1) // 2
    return {"rows_max_abs_err": err, "rows": len(idx),
            "library_max_abs_err": sdpa_err, "tol": FLASH_TOL_TEXT,
            "ms": cuda_ms(lambda: K.flash_attention_cuda(q, k, v, True, 0),
                          3, warmup=1),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), 3, warmup=1),
            **bound(4.0 * hq * d * pairs, PEAK_BF16,
                    (2 * q.numel() + k.numel() + v.numel()) * 2),
            "shape": f"B=1 S=T={s} Hq={hq} Hkv={hkv} D={d} bf16 causal"}


def swiglu_32k() -> dict:
    """swiglu at qwen2-7b's 32k-token prefill (T 32768, d 3584, f 18944,
    bf16: the wgmma prefill design), timed beside its bound and the cuBLAS
    chain; the rows of ``rows_32k`` held against the plain version in f32
    and against the chain's error there, as ``swiglu_case`` holds y."""
    from repro_torch.kernels import swiglu as K
    wi, wg, wo, g = qwen_mlp(12)
    d, f = wi.shape
    t = PREFILL_32K
    x = torch.randn((t, d), generator=g, device="cuda").to(torch.bfloat16)
    y = K.swiglu_cuda(x, wi, wg, wo)
    idx = rows_32k(t)
    xr = x[idx]
    wo32 = wo.float()
    a = F.silu(xr.float() @ wg.float()) * (xr.float() @ wi.float())
    want = a @ wo32
    err = check(f"swiglu T={t} rows", y[idx], want,
                ROUND * (a.abs() @ wo32.abs()) + BF16_TOL[0], BF16_TOL[1])
    del y, a, wo32
    lib_err = max_err((F.silu(xr @ wg) * (xr @ wi)) @ wo, want)
    check_library(f"swiglu T={t} rows", err, lib_err)
    return {"rows_max_abs_err": err, "rows": len(idx),
            "library_max_abs_err": lib_err, "tol": SWIGLU_TOL_TEXT,
            "ms": cuda_ms(lambda: K.swiglu_cuda(x, wi, wg, wo), 3,
                          warmup=1),
            "library_ms": cuda_ms(
                lambda: (F.silu(x @ wg) * (x @ wi)) @ wo, 3, warmup=1),
            **bound(6.0 * t * d * f, PEAK_BF16, (3 * d * f + 2 * t * d) * 2),
            "design": K.plan(t, d, f, x.dtype)["design"],
            "shape": f"T={t} d={d} f={f} bf16"}


def kernel_rglru(rows: dict) -> None:
    rows["rglru"] = rglru_case(2560)
    rows["rglru"]["forward"] = rglru_case(2568)


def small_model_check(arch: str) -> float:
    """A reduced config in f32: the offload plan on the card (every
    kernel's model path) against the plain path on the CPU."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch, reduced=True)
    cfg = dataclasses.replace(cfg, plan=cfg.plan.replace(
        compute_dtype="float32", kv_cache_dtype="float32"))
    cpu = Model(cfg, cfg.plan.replace(attn_impl="xla"), device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, cfg.plan.replace(**OFFLOAD), device="cuda")
    gparams = gpu.load(params.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32))
    want = cpu.forward(params, {"tokens": toks})
    got = gpu.forward(gparams, {"tokens": toks.cuda()}).cpu()
    return check(f"reduced {arch} f32, card vs CPU", got, want, 1e-4, 1e-4)


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows: dict = {}
    kernel_mriq(rows)
    rows["flash_attention"] = flash_case(512, 28, 4, 128, 0, seed=1, reps=20)
    # recurrentgemma-9b's local attention
    rows["flash_attention"]["local"] = flash_case(2560, 16, 1, 256, 2048,
                                                  seed=7, reps=5)
    rows["swiglu"] = swiglu_case(8, seed=2)
    rows["swiglu"]["prefill"] = swiglu_case(1024, seed=3)
    rows["swiglu"]["designs_ms"] = swiglu_designs()
    kernel_ssd(rows)
    kernel_rglru(rows)
    rows["flash_attention"]["prefill_32k"] = flash_32k()
    rows["swiglu"]["prefill_32k"] = swiglu_32k()
    for name in ("flash_attention", "swiglu"):
        rr = rows[name]["prefill_32k"]
        log(f"[kernels] {name} prefill_32k ({rr['shape']}): kernel_ms "
            f"{rr['ms']:.4f} library_ms {rr['library_ms']:.4f} bound_ms "
            f"{rr['bound_ms']:.4f} ({rr['bound_by']}; operations at "
            f"{rr['bound_peak']}); share of bound "
            f"{rr['bound_ms'] / rr['ms']:.4f}; {rr['rows']} rows vs the "
            f"plain version: max_err {rr['rows_max_abs_err']:.3e} tol "
            f"{rr['tol']}, library's {rr['library_max_abs_err']:.3e}")
    for name, r in rows.items():
        for label in ("", "prefill", "local", "forward", "f32",
                      "f32_forward"):
            rr = r.get(label, r) if label else r
            if label and label not in r:
                continue
            lib = "null" if rr["library_ms"] is None \
                else f"{rr['library_ms']:.4f}"
            log(f"[kernels] {name} {label} ({rr['shape']}): max_err "
                f"{rr['max_abs_err']:.3e} tol {rr['tol']}; kernel_ms "
                f"{rr['ms']:.4f} plain_ms {rr['plain_ms']:.4f} library_ms "
                f"{lib} bound_ms {rr['bound_ms']:.4f} ({rr['bound_by']}; "
                f"operations at {rr['bound_peak']}); share of bound "
                f"{rr['bound_ms'] / rr['ms']:.4f}")
            if "library_max_abs_err" in rr:
                log(f"[kernels] {name} {label}: library max_err vs the plain "
                    f"version {rr['library_max_abs_err']:.3e}; design "
                    f"{rr.get('design', '')}")
    for label in SSD_CASES:
        rr = rows["ssd"][label] if label else rows["ssd"]
        log(f"[kernels] ssd {label or 'bf16'} vs the token-by-token "
            f"recurrence: max_err {rr['recurrence_max_abs_err']:.3e}; eager "
            f"(host launches included) {rr['eager_ms']:.4f} ms; design "
            f"{rr['design']}")
    log(f"[kernels] ssd f32 with slow decay vs the recurrence: max_err "
        f"{rows['ssd']['slow_decay_f32_max_abs_err']:.3e}; ssd and rglru "
        f"repeat bit for bit")
    for arch in PATH_KERNELS:
        err = small_model_check(arch)
        log(f"[kernels] reduced {arch} f32 logits, card (kernels) vs CPU "
            f"(plain): max_err {err:.3e} tol atol 1e-4 + rtol 1e-4")
    return rows


# ---------------------------------------------------------------------------
# phase 4-6: the main path
# ---------------------------------------------------------------------------


def phase_calibrate(source) -> dict:
    """The H100 spec's energy constants measured again, beside the
    committed ones."""
    from repro_torch.benchmarks.calibrate_power import CONSTANTS, calibrate
    from repro_torch.core.power import H100
    from repro_torch.telemetry.nvml import check_window
    out = calibrate(source, log=log)
    check_window("calibrate idle", out["idle_counter"])
    for w in out["windows"]:
        check_window(f"calibrate {w['name']}", w["counter"])
    log("[calibrate] committed in core.power.H100 / this run: " + ", ".join(
        f"{k} {getattr(H100, k):.6g} / {out[k]:.6g}" for k in CONSTANTS))
    return out


def phase_fig5(source) -> dict:
    """The paper's Fig. 5 through the port's harness (bench_mriq), on the
    card's power source."""
    from repro_torch.benchmarks import bench_mriq
    from repro_torch.telemetry.nvml import check_window
    out = bench_mriq.run(source=source, log=log)
    check_window("fig5 idle window", out["idle_counter"])
    check_window("fig5 card-draw window", out["card_counter"])
    return out


def init_weights(model, seed: int):
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    log(f"[prefill] {model.cfg.name} weights, seed {seed} "
        f"({model.cfg.param_count() / 1e9:.2f} B params, "
        f"{model.plan.param_dtype}) initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return params


def phase_prefill(model, params, held: bool = True) -> dict:
    """Prefill, then 8 decode steps, against the teacher-forced forward;
    ``held=False`` reads the errors and holds the logits to be finite."""
    cfg = model.cfg
    b, s, n_dec = 2, PREFILL_LEN[cfg.name], 8
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + n_dec))
                            .astype(np.int32)).cuda()
    cache = model.init_cache(b, s + n_dec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = model.prefill(params, {"tokens": toks[:, :s]}, cache)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    steps = []
    for t in range(s, s + n_dec):
        lg, cache = model.decode_step(
            params, {"tokens": toks[:, t:t + 1], "pos": t}, cache)
        steps.append(lg)
    dec = torch.stack(steps, dim=1)
    full = model.forward(params, {"tokens": toks})
    for name, t in (("forward", full), ("prefill", last), ("decode", dec)):
        if not torch.isfinite(t).all():
            raise RuntimeError(f"{cfg.name}: non-finite {name} logits")
    scale = float(full.abs().max())
    if held:
        # roundings taken in another order along the residual layers (at
        # prefill the kernels round P and a to bf16; decode attention runs
        # the stock ops)
        tol = PREFILL_TOL[cfg.name] * scale
        e_pre = check("prefill last logits vs forward", last,
                      full[:, s - 1], tol, 0.0)
        e_dec = check("decode logits vs forward", dec, full[:, s:], tol, 0.0)
        held_by = f"tol {tol:.4f} = {PREFILL_TOL[cfg.name]} max|logit|"
    else:
        tol = None
        e_pre = max_err(last, full[:, s - 1])
        e_dec = max_err(dec, full[:, s:])
        held_by = "not held: finite only"
    agree = float((dec.argmax(-1) == full[:, s:].argmax(-1)).float().mean())
    out = {"prefill_s": t_prefill, "prefill_err": e_pre, "decode_err": e_dec,
           "logit_scale": scale, "tol": tol, "argmax_agree": agree}
    log(f"[prefill] {cfg.name} full width, {model.plan.compute_dtype}, "
        f"2x{s} tokens: prefill {t_prefill:.4f} s; max|logit| {scale:.3f}; "
        f"prefill err {e_pre:.4f}, decode err {e_dec:.4f} = "
        f"{max(e_pre, e_dec) / scale:.4f} max|logit| ({held_by}); decode "
        f"argmax agrees with forward on {agree:.3f}")
    return out


def serve_loop(model, params, meter=None):
    """A ``ServeLoop`` with 8 slots holding the 8 requests of
    ``launch/serve.py``'s recipe."""
    from repro_torch.serve.engine import Request, ServeLoop
    loop = ServeLoop(model, params, batch_slots=8, max_seq=256, meter=meter)
    rng = np.random.default_rng(0)
    for i in range(8):
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(2, model.cfg.vocab_size,
                              size=plen).astype(np.int32)
        loop.submit(Request(rid=i, prompt=prompt, max_new=16))
    return loop


def phase_serve(model, params) -> float:
    from repro_torch.core.power import R740_ARRIA10
    from repro_torch.telemetry import DecodeEnergyMeter, node_envelope
    cfg = model.cfg
    meter = DecodeEnergyMeter(envelope=node_envelope(R740_ARRIA10,
                                                     accelerated=True))
    loop = serve_loop(model, params, meter)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = loop.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(r.rid for r in done) != list(range(8)):
        raise RuntimeError("serve: not every request finished")
    for r in done:
        if not (1 <= len(r.out) <= 16
                and all(0 <= t < cfg.vocab_size for t in r.out)):
            raise RuntimeError(f"serve: request {r.rid} output {r.out}")
    billed = sum(r.energy_ws for r in done)
    if not math.isclose(billed, meter.ledger.total_ws, rel_tol=1e-9):
        raise RuntimeError("serve: request bills do not sum to the ledger")
    n_tok = sum(len(r.out) for r in done)
    # every slot fill teacher-forces prompt[:-1] through full-batch steps
    forced = sum(len(r.prompt) - 1 for r in done)
    out = {"wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
           "steps": loop.steps_done, "forced_steps": forced,
           "ledger_ws": meter.ledger.total_ws,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "requests": [{"rid": r.rid, "prompt": len(r.prompt),
                         "tokens": len(r.out), "prefill_ws": r.prefill_ws,
                         "decode_ws": r.decode_ws} for r in done]}
    log(f"[serve] {cfg.name}: 8 requests, {n_tok} tokens in {wall:.3f} s "
        f"({out['tokens_per_s']:.2f} tokens/s; {forced} prompt steps + "
        f"{loop.steps_done} decode steps, all 8 slots wide); "
        f"ledger {out['ledger_ws']:.3f} Ws at the accelerated R740 point; "
        f"peak device memory {out['peak_gb']:.2f} GB")
    for r in out["requests"]:
        log(f"[serve] request {r['rid']}: prompt {r['prompt']} tokens, "
            f"{r['tokens']} new, prefill {r['prefill_ws']:.4f} Ws, decode "
            f"{r['decode_ws']:.4f} Ws")
    return wall


def profile_serve(model, params, wall_s: float) -> None:
    """Where the card's time goes while the 8 requests are served: the
    serve phase again, with no meter, under torch.profiler.  Busy share =
    device time of every kernel and copy over the profiled window's wall
    time (one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    loop = serve_loop(model, params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(f"{model.cfg.name} serve window", prof, wall_ms,
                   f"unprofiled {wall_s * 1e3:.3f} ms")


def report_profile(what: str, prof, wall_ms: float, note: str) -> None:
    """A profiled window: the device's busy share of its wall time (one
    stream, so kernels and copies do not overlap), the kernels by device
    time and the CUDA runtime calls by host time."""
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    launches = sum(e.count for e in device)
    log(f"[profile] {what}, profiled: wall {wall_ms:.3f} ms ({note}), "
        f"{launches} device ops, device time {busy_ms:.3f} ms -> busy "
        f"{busy_ms / wall_ms:.4f}, idle {1 - busy_ms / wall_ms:.4f}")
    for e in sorted(device, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        log(f"[profile]   device {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<6d} {e.key[:80]}")
    runtime = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.key.startswith("cuda")]
    for e in sorted(runtime, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:5]:
        log(f"[profile]   host   {e.self_cpu_time_total / 1e3:9.3f} ms "
            f"x{e.count:<6d} {e.key[:80]}")


def profile_prefill(model, params, prefill_s: float) -> None:
    """One prefill of the model's own plan (2 x PREFILL_LEN tokens) again,
    under torch.profiler: is it bound by the card or by the host?"""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    b, s = 2, PREFILL_LEN[cfg.name]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    cache = model.init_cache(b, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(f"{cfg.name} {model.plan.compute_dtype} prefill 2x{s}",
                   prof, wall_ms, f"unprofiled {prefill_s * 1e3:.3f} ms")


#: the offload search's requirement: a 32k-token prefill in 0.5 s.  The
#: estimate of no plan meets it on one H100 (2.48 s), so the search runs
#: all three stages (paper section 3.3 stops at the first stage whose
#: pattern meets the requirement) and promotes its finalists to the card
OFFLOAD_SLO_S = 0.5
OFFLOAD_SHAPE = "prefill_32k_b1"


class Recorded:
    """A measurement rung whose trials are kept, by plan, for the report."""

    def __init__(self, backend):
        self.backend = backend
        self.name = backend.name
        self.trials: list = []

    def measure(self, ctx, plan):
        m = self.backend.measure(ctx, plan)
        self.trials.append((plan, m))
        return m


def phase_offload(model, params, source) -> dict:
    """The paper's offload search for qwen2-7b at prefill_32k_b1 on the
    card: finalists and the smoke trial on the measured rung, on the
    loaded weights."""
    from repro_torch.core.adapt import adapt
    from repro_torch.core.backends import (MeasuredBackend, plan_kernels,
                                           plan_tag)
    from repro_torch.core.destinations import Requirement
    from repro_torch.core.verifier import RungPolicy
    from repro_torch.telemetry.nvml import check_window
    cfg = model.cfg
    t0 = time.perf_counter()
    rung = Recorded(MeasuredBackend(source=source, params={cfg.name: params},
                                    log=log))
    rep = adapt(cfg, OFFLOAD_SHAPE,
                requirement=Requirement(max_seconds=OFFLOAD_SLO_S),
                rungs=RungPolicy(search="analytic", finalist="measured",
                                 smoke="measured"),
                verify=True, backends={"measured": rung},
                log=lambda m: log(f"[offload] {m}"))
    for plan, m in rung.trials:
        what = f"[offload] trial plan {plan_tag(plan)} ({plan.attn_impl} " \
               f"attention, chunk {plan.attn_chunk}, {plan.mlp_impl} mlp, " \
               f"{plan.kv_cache_dtype} cache)"
        if not m.ok:
            log(f"{what}: PENALTY {m.error}")
            continue
        check_window(what, m.trace.meta["counter"])
        log(f"{what}: {m.seconds:.4f} s, {m.watts:.2f} W, {m.energy_j:.3f} Ws "
            f"a prefill (card-only), fitness {m.fitness():.6f}, peak "
            f"{m.peak_mem_per_chip / 1e9:.2f} GB")
    fin = [st for st in rep.selection.stages
           if st["stage"].startswith("finalist")]
    if not fin or not fin[0]["confirmed"]:
        raise RuntimeError(f"offload: no finalist confirmed on the measured "
                           f"rung ({fin})")
    smoke = rep.verified
    if smoke is None or smoke["status"] != "OK":
        raise RuntimeError(f"offload: the chosen plan's smoke trial failed "
                           f"({smoke})")
    want = plan_kernels(rep.plan, rep.genes)
    missing = [k for k in want if not smoke["launches"].get(k)]
    if missing:
        raise RuntimeError(f"offload: the chosen plan's trial launched no "
                           f"{missing} ({smoke['launches']})")
    # every plan tried computes the same function: each one's last logits
    # against the chosen plan's, held as a prefill is against the forward
    outputs = rung.backend.outputs
    mine = outputs[plan_tag(rep.plan)]
    tol = PREFILL_TOL[cfg.name] * float(mine.abs().max())
    agree = {tag: check(f"offload: plan {tag}'s last logits vs the chosen "
                        f"plan's", logits, mine, tol, 0.0)
             for tag, logits in outputs.items() if tag != plan_tag(rep.plan)}
    log(f"[offload] last logits of each plan tried vs the chosen plan's: "
        f"max_err {agree} tol {tol:.4f} = {PREFILL_TOL[cfg.name]} "
        f"max|logit|")
    chosen = rep.selection.chosen
    out = {"stage": chosen.name, "plan": chosen.genome.describe(),
           "kernels": want, "smoke": smoke, "logits_max_abs_err": agree,
           "seconds_total": time.perf_counter() - t0,
           "trials": [{"plan": plan_tag(p), "attn_impl": p.attn_impl,
                       "attn_chunk": p.attn_chunk, "mlp_impl": p.mlp_impl,
                       "kv_cache_dtype": p.kv_cache_dtype, "ok": m.ok,
                       "error": m.error, "seconds": m.seconds,
                       "watts": m.watts, "ws": m.energy_j,
                       "fitness": m.fitness()} for p, m in rung.trials]}
    log(f"[offload] chosen {chosen.name}: {out['plan']}; smoke trial "
        f"{smoke['seconds']:.4f} s, {smoke['watts']:.2f} W, "
        f"{smoke['energy_ws']:.3f} Ws, launches {smoke['launches']} (its "
        f"genes name {want}); search {out['seconds_total']:.1f} s")
    log("offload " + json.dumps(out))
    return out


def run_path(arch: str, counters: dict, seeds=(0,), before=None,
             after=None) -> dict:
    """One model's path under the offload plan: its weights on the card,
    prefill + decode against the forward for each of ``seeds`` (the serve
    phase keeps the first), then serving.  The launch counts are set to 0
    just before and read just after; ``before()`` (the Fig. 5 phase) runs
    first and ``after(model, params)`` (the offload search) last on the
    path, both counted.  Returns the counts, the model and its weights."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    for k in counters.values():
        k.launches = 0
    if before is not None:
        before()
    cfg = get_config(arch)
    model = Model(cfg, cfg.plan.replace(**OFFLOAD))
    torch.cuda.reset_peak_memory_stats()
    params = None
    for seed in reversed(seeds):        # ends on the serve phase's seed
        params = None                   # one set of weights at a time
        params = init_weights(model, seed)
        if arch in PREFILL_F32:
            phase_prefill(model.with_plan(model.plan.replace(
                compute_dtype="float32")), params)
            prefill = phase_prefill(model, params, held=False)
        else:
            prefill = phase_prefill(model, params)
    log(f"[prefill] {arch} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    wall_s = phase_serve(model, params)
    if after is not None:
        after(model, params)
    launches = {name: k.launches for name, k in counters.items()}
    log(f"kernels {arch} " + json.dumps(launches))
    missing = [k for k in PATH_KERNELS[arch] if not launches[k]]
    if missing:
        raise RuntimeError(f"{arch}: kernels of its path never launched: "
                           f"{missing} ({launches})")
    return {"launches": launches, "model": model, "params": params,
            "wall_s": wall_s, "prefill_s": prefill["prefill_s"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import (flash_attention, mriq, rglru, ssd,
                                         swiglu)
        from repro_torch.telemetry.nvml import NvmlSource
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    rows = phase_kernels()

    counters = {"mriq": mriq.KERNEL, "flash_attention": flash_attention.KERNEL,
                "swiglu": swiglu.KERNEL, "ssd": ssd.KERNEL,
                "rglru": rglru.KERNEL}
    launches = dict.fromkeys(counters, 0)
    source = NvmlSource(torch.device("cuda"))
    log(f"[nvml] {source.describe()} (bus {source.bus_id})")
    phase_calibrate(source)

    for arch in PATH_KERNELS:           # one model's weights at a time
        qwen = arch == "qwen2-7b"
        path = run_path(
            arch, counters,
            seeds=PREFILL_SEEDS if qwen else (0,),
            before=(lambda: phase_fig5(source)) if qwen else None,
            after=(lambda m, p: phase_offload(m, p, source)) if qwen
            else None)
        for name, n in path["launches"].items():
            launches[name] += n
        if arch == "qwen2-7b":          # outside the counted path
            profile_serve(path["model"], path["params"], path["wall_s"])
        if arch == "mamba2-1.3b":
            profile_prefill(path["model"], path["params"], path["prefill_s"])
        del path
        torch.cuda.empty_cache()
    log("kernels " + json.dumps(launches))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **rows[name]})
    print(card["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

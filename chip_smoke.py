#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure (build, launch, tolerance) ends the run with
a non-zero exit and no result line:

  1. card     the card's name and power limit, and the device count;
  2. build    nvcc builds the five kernels (mriq, flash_attention, swiglu,
              ssd, rglru) for sm_90a from the sources in the checkout, all
              at once, and prints each kernel's registers, shared memory
              and spills;
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes the main path gives it (flash_attention also at
              recurrentgemma-9b's D=256 with its 2048 window; ssd also
              against the token-by-token recurrence); kernel, plain and
              library times from CUDA events, and the card's least time
              (bound); plus reduced qwen2-7b, mamba2-1.3b and
              recurrentgemma-9b on the card (kernels, f32) against the
              plain path on the CPU;
  4. MRI-Q    the paper's Fig. 5 at its size (64^3 voxels, 3072 k-space
              points): the plain version on the host CPU against the
              offloaded leg (H2D + kernel + D2H), each leg's Watt*seconds at
              the paper's measured R740 node points;
  5. models   for each of qwen2-7b, mamba2-1.3b and recurrentgemma-9b at
              full width under the offload plan (every site on the
              kernels), random weights from seeded generators on the card,
              one model at a time:
              prefill  2 x 512 tokens (2 x 2560 for recurrentgemma-9b, past
                       its 2048 window), then 8 decode steps, held against
                       the teacher-forced forward (qwen2-7b for three weight
                       seeds; mamba2-1.3b in f32 compute, its bf16 run held
                       to finite logits, see PREFILL_F32);
              serve    ``ServeLoop`` (8 slots, max_seq 256) billing a
                       ``DecodeEnergyMeter`` at the accelerated R740 node
                       point: 8 requests, 16 new tokens each;
              counts   the kernels' launch counts over that model's path
                       (MRI-Q belongs to qwen2-7b's), each kernel of the
                       path > 0;
  6. profile  qwen2-7b's 8 requests served again under torch.profiler:
              kernels by device time, the CUDA runtime calls by host time,
              and the device's busy share of that window.

It takes about 4 minutes on the H100, the kernels' build included.  It
exits non-zero when no CUDA device is visible, and when the port's package
is not beside it.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import math
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

#: a bf16 kernel computes in f32 and rounds once, so it is held against the
#: plain version run in f32 on the same bf16 inputs, to that rounding:
#: rtol 2^-8 (bf16's 8-bit mantissa) + atol 1e-5 (f32 sums in another order)
BF16_TOL = (1e-5, 2.0 ** -8)
BF16_TOL_TEXT = "atol 1e-5 + rtol 2^-8, vs the plain version in f32"

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
        raise RuntimeError(f"{name}: max_err {err:.3e} over atol {atol} + "
                           f"rtol {rtol}*|plain|")
    return err


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


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def mriq_data(seed: int = 0, n: int = 64 ** 3, m: int = 3072):
    rng = np.random.default_rng(seed)
    kx, ky, kz = (rng.standard_normal(m, dtype=np.float32) for _ in range(3))
    phi = rng.random(m, dtype=np.float32)
    x, y, z = (rng.standard_normal(n, dtype=np.float32) for _ in range(3))
    return [torch.from_numpy(a) for a in (kx, ky, kz, phi, x, y, z)]


def kernel_mriq(rows: dict) -> None:
    from repro_torch.kernels import mriq as K, ref
    args = [a.cuda() for a in mriq_data()]
    n, m = args[4].shape[0], args[0].shape[0]
    got = K.mriq_cuda(*args)
    want = ref.mriq_ref(*args)
    atol, rtol = 5e-4, 1e-4     # tests/test_kernels.py, mriq
    err = max(check("mriq qr", got[0], want[0], atol, rtol),
              check("mriq qi", got[1], want[1], atol, rtol))
    bnd = bound(16.0 * n * m, PEAK_F32, (3 * n + 4 * m + 2 * n) * 4)
    rows["mriq"] = {
        "max_abs_err": err, "tol": f"atol {atol} + rtol {rtol}",
        "ms": cuda_ms(lambda: K.mriq_cuda(*args), reps=10),
        "plain_ms": cuda_ms(lambda: ref.mriq_ref(*args), reps=3),
        **bnd, "library_ms": None, "library": NO_LIBRARY,
        "shape": f"N={n} M={m} f32"}


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
    err = check(f"flash_attention D={d}", got, want, *BF16_TOL)
    del want
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
    sdpa_err = max_err(sdpa().transpose(1, 2), got)
    pairs = int(keep.sum())     # (q, k) pairs the mask keeps
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    bnd = bound(4.0 * b * hq * d * pairs, PEAK_BF16, nbytes)
    mask = "causal" + (f" window {window}" if window else "")
    return {"max_abs_err": err, "tol": BF16_TOL_TEXT,
            "ms": cuda_ms(lambda: K.flash_attention_cuda(q, k, v, True,
                                                         window), reps),
            "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, True, window), reps),
            **bnd,
            "library_ms": cuda_ms(sdpa, reps),
            "library": "F.scaled_dot_product_attention, KV repeated",
            "library_max_abs_err": sdpa_err,
            "shape": f"B={b} S=T={s} Hq={hq} Hkv={hkv} D={d} bf16 {mask}"}


def swiglu_case(t: int, seed: int) -> dict:
    from repro_torch.kernels import swiglu as K, ref
    d, f = 3584, 18944
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(shape, scale):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(torch.bfloat16)
    x = randn((t, d), 1.0)
    wi, wg = randn((d, f), d ** -0.5), randn((d, f), d ** -0.5)
    wo = randn((f, d), f ** -0.5)
    got = K.swiglu_cuda(x, wi, wg, wo)
    want = ref.swiglu_ref(x.float(), wi.float(), wg.float(), wo.float())
    err = check(f"swiglu T={t}", got, want, *BF16_TOL)
    nbytes = (3 * d * f + 2 * t * d) * 2
    bnd = bound(6.0 * t * d * f, PEAK_BF16, nbytes)
    reps = 20 if t <= 32 else 5
    return {"max_abs_err": err, "tol": BF16_TOL_TEXT,
            "ms": cuda_ms(lambda: K.swiglu_cuda(x, wi, wg, wo), reps),
            "plain_ms": cuda_ms(lambda: ref.swiglu_ref(x, wi, wg, wo), reps),
            **bnd,
            # the cuBLAS chain (silu(x@wg)*(x@wi))@wo, timed as a yardstick
            "library_ms": cuda_ms(
                lambda: (F.silu(x @ wg) * (x @ wi)) @ wo, reps),
            "library": "cuBLAS chain (silu(x@wg)*(x@wi))@wo",
            "shape": f"T={t} d={d} f={f} bf16"}


#: the SSD check's shape: mamba2-1.3b's prefill of 2 x 512 tokens
SSD_SHAPE = dict(b=2, s=512, h=64, p=64, n=128, chunk=256)
#: the SSD kernel sums up to N + Q products in f32 in another order than the
#: plain version (atol, as a share of max|plain|); a bf16 y also rounds once
#: (rtol 2^-8), an f32 result is held at rtol 1e-4
SSD_ATOL = 1e-4
SSD_TOL_TEXT = ("atol 1e-4 x max|plain| + rtol 2^-8 (bf16 y) or 1e-4 (f32 "
                "state), vs the plain version in f32")


def ssd_inputs(seed: int, dtype, dt_shift: float = 0.0):
    """Inputs as mamba2's prefill gives them: x = silu(.), dt = softplus(.)
    (shifted down to make the decay slow), A = -exp(0.2 N(0,1))."""
    b, s, h, p, n = (SSD_SHAPE[k] for k in "bshpn")
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    x = F.silu(randn(b, s, h, p)).to(dtype)
    dt = F.softplus(randn(b, s, h) + dt_shift)
    A = -torch.exp(0.2 * randn(h))
    return x, dt, A, randn(b, s, n).to(dtype), randn(b, s, n).to(dtype)


def check_ssd(name: str, got, want) -> float:
    """y against y, state against state, at the SSD tolerance."""
    err = 0.0
    for part, g, w in zip(("y", "state"), got, want):
        rtol = 2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-4
        atol = SSD_ATOL * float(w.float().abs().max())
        err = max(err, check(f"{name} {part}", g, w, atol, rtol))
    return err


def kernel_ssd(rows: dict) -> None:
    from repro_torch.kernels import ref, ssd as K
    q = SSD_SHAPE["chunk"]
    args = ssd_inputs(4, torch.bfloat16)
    x, dt, A, Bm, Cm = args
    f32 = (x.float(), dt, A, Bm.float(), Cm.float())
    got = K.ssd_cuda(*args, q)
    err = check_ssd("ssd vs plain", got, ref.ssd_ref(*f32, q))
    # the token-by-token recurrence holds the chunk math where the JAX
    # reference is NaN (chunk 256: cum spans far past 88); and, with dt
    # small enough that the state carries across tiles and chunks, the f32
    # kernel against it
    err_rec = check_ssd("ssd vs recurrence", got, ref.ssd_scan_ref(*f32))
    slow = ssd_inputs(5, torch.float32, dt_shift=-4.0)
    err_slow = check_ssd("ssd f32 slow decay vs recurrence",
                         K.ssd_cuda(*slow, q), ref.ssd_scan_ref(*slow))
    b, s, h, p, n = x.shape + (Bm.shape[-1],)
    chunks = s // q
    pairs = q * (q + 1) // 2
    flops = 2.0 * b * h * chunks * (pairs * (n + p) + 2 * q * p * n)
    nbytes = (x.numel() * 2 + dt.numel() * 4 + A.numel() * 4
              + (Bm.numel() + Cm.numel()) * 2 + x.numel() * 2
              + b * h * p * n * 4)
    bnd = bound(flops, PEAK_BF16, nbytes)
    rows["ssd"] = {
        "max_abs_err": err, "tol": SSD_TOL_TEXT,
        "recurrence_max_abs_err": err_rec,
        "slow_decay_f32_max_abs_err": err_slow,
        "ms": cuda_ms(lambda: K.ssd_cuda(*args, q), 20),
        "plain_ms": cuda_ms(lambda: ref.ssd_ref(*args, q), 5),
        **bnd, "library_ms": None, "library": NO_LIBRARY,
        "shape": f"B={b} S={s} H={h} P={p} N={n} chunk {q}, x/B/C/y bf16"}


def kernel_rglru(rows: dict) -> None:
    from repro_torch.kernels import ref, rglru as K
    b, s, w = 2, 2560, 4096
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
    bnd = bound(3.0 * b * s * w, PEAK_F32, 12.0 * b * s * w)
    rows["rglru"] = {
        "max_abs_err": err, "tol": f"atol {atol} + rtol {rtol}",
        "ms": cuda_ms(lambda: K.rglru_cuda(log_a, bb), 20),
        "plain_ms": cuda_ms(lambda: ref.rglru_ref(log_a, bb), 3),
        **bnd, "library_ms": None, "library": NO_LIBRARY,
        "shape": f"B={b} S={s} W={w} f32"}


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
    kernel_ssd(rows)
    kernel_rglru(rows)
    for name, r in rows.items():
        for label in ("", "prefill", "local"):
            rr = r.get(label, r) if label else r
            if label and label not in r:
                continue
            lib = "null" if rr["library_ms"] is None \
                else f"{rr['library_ms']:.4f}"
            log(f"[kernels] {name} {label} ({rr['shape']}): max_err "
                f"{rr['max_abs_err']:.3e} tol {rr['tol']} kernel_ms "
                f"{rr['ms']:.4f} plain_ms {rr['plain_ms']:.4f} library_ms "
                f"{lib} bound_ms {rr['bound_ms']:.4f} ({rr['bound_by']}; "
                f"operations at {rr['bound_peak']})")
    log(f"[kernels] ssd vs the token-by-token recurrence: max_err "
        f"{rows['ssd']['recurrence_max_abs_err']:.3e}; f32 with slow decay "
        f"{rows['ssd']['slow_decay_f32_max_abs_err']:.3e} (tol "
        f"{SSD_TOL_TEXT})")
    for arch in PATH_KERNELS:
        err = small_model_check(arch)
        log(f"[kernels] reduced {arch} f32 logits, card (kernels) vs CPU "
            f"(plain): max_err {err:.3e} tol atol 1e-4 + rtol 1e-4")
    return rows


# ---------------------------------------------------------------------------
# phase 4-6: the main path
# ---------------------------------------------------------------------------


def phase_mriq(card: dict) -> dict:
    from repro_torch.core.power import R740_ARRIA10
    from repro_torch.kernels import ops
    host = mriq_data(seed=0)
    t0 = time.perf_counter()
    want = ops.mriq(*host)                      # CPU tensors: plain version
    t_cpu = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    dev = [a.cuda() for a in host]              # H2D
    qr, qi = ops.mriq(*dev)                     # kernel
    got = (qr.cpu(), qi.cpu())                  # D2H
    end.record()
    end.synchronize()
    t_off = start.elapsed_time(end) / 1e3
    err = max(check("mriq offloaded qr", got[0], want[0], 5e-4, 1e-4),
              check("mriq offloaded qi", got[1], want[1], 5e-4, 1e-4))
    node = R740_ARRIA10
    out = {"cpu_s": t_cpu, "offload_s": t_off,
           "cpu_ws": t_cpu * node.p_cpu_active,
           "offload_ws": t_off * node.p_accel_active, "max_abs_err": err,
           "threads": torch.get_num_threads()}
    log(f"[mriq] N=262144 M=3072: CPU-only leg {t_cpu:.4f} s "
        f"({out['threads']} host threads) -> {out['cpu_ws']:.3f} Ws at "
        f"{node.p_cpu_active} W; offloaded leg (H2D+kernel+D2H) "
        f"{t_off:.6f} s -> {out['offload_ws']:.4f} Ws at "
        f"{node.p_accel_active} W (R740 node points); speedup "
        f"{t_cpu / t_off:.1f}x; max_err {err:.3e}; card {card['smi']}")
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
        # roundings taken in another order along the residual layers (the
        # kernels compute in f32 at prefill; decode runs the stock ops)
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
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    launches = sum(e.count for e in device)
    log(f"[profile] serve window, profiled: wall {wall_ms:.3f} ms "
        f"(unprofiled {wall_s * 1e3:.3f} ms), {launches} device ops, "
        f"device time {busy_ms:.3f} ms -> busy {busy_ms / wall_ms:.4f}, "
        f"idle {1 - busy_ms / wall_ms:.4f}")
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


def run_path(arch: str, counters: dict, seeds=(0,), card=None) -> dict:
    """One model's path under the offload plan: its weights on the card,
    prefill + decode against the forward for each of ``seeds`` (the serve
    phase keeps the first), then serving.  The launch counts are set to 0
    just before and read just after; MRI-Q runs on qwen2-7b's path.
    Returns the counts, the model and its weights."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    for k in counters.values():
        k.launches = 0
    if card is not None:
        phase_mriq(card)
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
            phase_prefill(model, params, held=False)
        else:
            phase_prefill(model, params)
    log(f"[prefill] {arch} peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    wall_s = phase_serve(model, params)
    launches = {name: k.launches for name, k in counters.items()}
    log(f"kernels {arch} " + json.dumps(launches))
    missing = [k for k in PATH_KERNELS[arch] if not launches[k]]
    if missing:
        raise RuntimeError(f"{arch}: kernels of its path never launched: "
                           f"{missing} ({launches})")
    return {"launches": launches, "model": model, "params": params,
            "wall_s": wall_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import (flash_attention, mriq, rglru, ssd,
                                         swiglu)
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
    for arch in PATH_KERNELS:           # one model's weights at a time
        path = run_path(arch, counters,
                        seeds=PREFILL_SEEDS if arch == "qwen2-7b" else (0,),
                        card=card if arch == "qwen2-7b" else None)
        for name, n in path["launches"].items():
            launches[name] += n
        if arch == "qwen2-7b":          # outside the counted path
            profile_serve(path["model"], path["params"], path["wall_s"])
        del path
        torch.cuda.empty_cache()
    log("kernels " + json.dumps(launches))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **rows[name]})
    print(card["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["kind"], "count": card["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

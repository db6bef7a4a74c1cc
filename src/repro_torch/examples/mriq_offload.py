"""Paper §4 end to end on the card: MRI-Q's offload patterns, measured.

    python -m repro_torch.examples.mriq_offload [--device cpu]

Counterpart of the repo's ``examples/mriq_offload.py``, the paper's
evaluation pipeline on its own application:

  1. 'Code analysis' — MRI-Q's 16 processable loops as offloadable sites,
     with arithmetic intensity and loop counts (``loop_census``).
  2. 'Narrowing' — the IO/control and loop-count filters keep 4
     measurement patterns (paper: 16 -> 4), including the combination
     round (§3.2's second measurement) (``narrow``).
  3. 'Verification environment' — every pattern is *measured* at the
     paper's size (64^3 voxels x 3072 k-space points), where the
     reference models the offloaded ones from its chip's constants:

       cpu_only              phiMag = phiR^2 + phiI^2 and the plain
                             ``ops.mriq`` on CPU tensors, wall clock;
       naive_per_voxel       per voxel: H2D from pinned buffers of the
                             whole k-space (4 x 3072 f32, 49,152 B) and the
                             voxel's coordinates, one mriq launch over that
                             voxel, D2H of its (Qr, Qi), a synchronise; over
                             the first ``NAIVE_VOXELS`` voxels, scaled to all;
       device_trig_host_sum  in chunks of ``CHUNK`` voxels, cos and sin of
                             2 pi (k . r) by stock torch ops on the card, D2H
                             into pinned buffers, the sums over k on the host
                             (no TPU kernel computes this; the reference
                             only models it);
       full_nest_batched     phiMag on the host, then Fig. 5's offloaded leg
                             (``bench_mriq.OffloadLeg``: H2D, kernel, D2H);
       full_nest+phiMag      H2D of phiR and phiI, phiMag on the card, the
                             kernel and the D2H.

     Each pattern's (Qr, Qi) is held to the CPU-only leg's at
     ``bench_mriq.TOL`` (the naive one on its voxels).  Rows are billed at
     the paper's node points (121 W CPU-only, 111 W offloaded); beside
     them, each offloaded pattern's card-only draw over a window of at
     least ``nvml.WINDOW_S`` of its calls back to back (full_nest_batched:
     Fig. 5's window of the same leg).
  4. Selection by (time)^-1/2 (power)^-1/2 over the measured medians, at
     the node points; a pattern whose median lies within the selected
     one's spread, and the selected one's within its, is a tie.

Beside each measured row stands the reference's model of it
(``model_patterns``), on the H100's constants: its f32 peak over 16
(``DEV_FLOPS``; the reference takes its chip's peak over 16 for this
trig-heavy loop, which runs on the CUDA cores and the SFU, not the tensor
cores), ``LAUNCH_S`` = 5 us a kernel launch and ``XFER_BW`` = 64 GB/s,
PCIe 5.0 x16's rate each way.

Runs on ``--device`` (default: the card; raises without one).  On the CPU
every offloaded pattern is the plain version with no copies, as
``bench_mriq.run(device="cpu")`` is: that run shows the harness, not a
time.
"""
from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.benchmarks import bench_mriq
from repro_torch.core.fitness import fitness
from repro_torch.core.power import R740_ARRIA10, NodeSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.telemetry.nvml import WINDOW_S, NvmlSource, \
    describe_window, sample_window

N_VOX = bench_mriq.N_VOX        # paper: 64*64*64 sample data
N_K = bench_mriq.N_K
#: voxels the naive pattern runs; its time is scaled by N_VOX / this
NAIVE_VOXELS = 4096
#: voxels whose naive launch is timed part by part (CUDA events)
NAIVE_PARTS = 64
#: voxels a device_trig_host_sum chunk: two (8192, 3072) f32 blocks of
#: 100.7 MB cross the bus a chunk
CHUNK = 8192

#: the model's device side: the H100 SXM's f32 peak outside the tensor
#: cores (67 TFLOP/s, NVIDIA's data sheet) over 16, a kernel launch, and
#: PCIe 5.0 x16 each way
PEAK_F32 = 67e12
DEV_FLOPS = PEAK_F32 / 16
LAUNCH_S = 5e-6
XFER_BW = 64e9

#: the patterns, in the reference's order, and its note on each
NOTES = {
    "cpu_only": "paper's baseline",
    "naive_per_voxel": "one launch+transfer per voxel (unbatched transfers)",
    "device_trig_host_sum":
        "sin/cos on device, accumulate on host (intermediate xfer)",
    "full_nest_batched":
        "whole nest on device, transfers hoisted+batched (§3.1)",
    "full_nest+phiMag": "combination round (§3.2 second measurement)",
}


@dataclass
class Site:
    name: str
    flops_per_elem: float
    elems: float
    bytes_moved: float
    offloadable: bool

    @property
    def flops(self):
        return self.flops_per_elem * self.elems

    @property
    def intensity(self):
        return self.flops / max(self.bytes_moved, 1)


def loop_census(n_vox: int = N_VOX, n_k: int = N_K) -> list:
    """MRI-Q's processable loops (paper: 16 for MRI-Q): the ComputePhiMag
    loop, the ComputeQ voxel x k-space nest (and its sub-loops), plus the
    IO/setup loops that the loop-count filter rejects immediately."""
    sites = [
        Site("phiMag", 3, n_k, 3 * 4 * n_k, True),
        Site("Q_nest", 16, n_vox * n_k, 4 * 4 * (n_vox + n_k), True),
        Site("Q_inner_k", 16, n_vox * n_k, 4 * 4 * n_k, True),
        Site("Q_sincos", 12, n_vox * n_k, 8 * n_vox * n_k, True),
        Site("init_Q", 1, n_vox, 2 * 4 * n_vox, True),
        Site("load_kvalues", 1, n_k, 4 * 4 * n_k, True),
    ]
    for i in range(10):   # IO / arg / buffer loops
        sites.append(Site(f"aux_loop_{i}", 1, 1024, 8192, False))
    return sites


def narrow(sites: list) -> list:
    """The static filters' rejects, (site, reason), in census order."""
    total = sum(s.flops for s in sites)
    rejects = []
    for s in sites:
        if not s.offloadable:
            rejects.append((s.name, "IO/control, not offloadable"))
        elif s.flops / total < 1e-4:
            rejects.append((s.name, "loop-count filter"))
    return rejects


def model_patterns(t_cpu: float, dev_flops: float = DEV_FLOPS,
                   launch_s: float = LAUNCH_S, xfer_bw: float = XFER_BW,
                   node: NodeSpec = R740_ARRIA10, n_vox: int = N_VOX,
                   n_k: int = N_K) -> dict:
    """The reference's model of each pattern from a measured CPU-only time:
    name -> (seconds, node watts, note)."""
    nest = [s for s in loop_census(n_vox, n_k) if s.name == "Q_nest"][0]
    t_rest = 0.02 * t_cpu                  # un-offloaded app remainder
    t_kernel = nest.flops / dev_flops
    in_bytes = (3 * n_vox + 4 * n_k) * 4
    out_bytes = 2 * n_vox * 4
    return {
        "cpu_only": (t_cpu, node.p_cpu_active, NOTES["cpu_only"]),
        "naive_per_voxel": (
            t_rest + t_kernel + n_vox * launch_s
            + n_vox * (4 * n_k * 4) / xfer_bw,
            node.p_accel_active, NOTES["naive_per_voxel"]),
        "device_trig_host_sum": (
            t_rest + nest.flops * 0.75 / dev_flops
            + 2.0 * n_vox * n_k * 4 / xfer_bw,
            node.p_accel_active, NOTES["device_trig_host_sum"]),
        "full_nest_batched": (
            t_rest + t_kernel + launch_s + (in_bytes + out_bytes) / xfer_bw,
            node.p_accel_active, NOTES["full_nest_batched"]),
        "full_nest+phiMag": (
            t_rest * 0.9 + t_kernel + 2 * launch_s
            + (in_bytes + out_bytes) / xfer_bw,
            node.p_accel_active, NOTES["full_nest+phiMag"]),
    }


def host_inputs(seed: int = 0, n_vox: int = N_VOX, n_k: int = N_K) -> dict:
    """MRI-Q's inputs on the host, f32: k-space and voxel coordinates as
    ``ref.mriq_inputs(seed, ...)`` draws them, phiR and phiI standard
    normal from numpy seed ``seed + 1``."""
    kx, ky, kz, _, x, y, z = ref.mriq_inputs(seed, n_vox, n_k)
    rng = np.random.default_rng(seed + 1)
    phi_r, phi_i = (torch.from_numpy(rng.standard_normal(n_k,
                                                         dtype=np.float32))
                    for _ in range(2))
    return {"kx": kx, "ky": ky, "kz": kz, "phi_r": phi_r, "phi_i": phi_i,
            "x": x, "y": y, "z": z}


def phi_mag(phi_r: torch.Tensor, phi_i: torch.Tensor) -> torch.Tensor:
    """ComputePhiMag: phiR^2 + phiI^2."""
    return phi_r * phi_r + phi_i * phi_i


def mriq_args(host: dict, mag: torch.Tensor) -> list:
    """``ops.mriq``'s seven arguments."""
    return [host["kx"], host["ky"], host["kz"], mag,
            host["x"], host["y"], host["z"]]


def fig5_inputs(seed: int = 0, n_vox: int = N_VOX, n_k: int = N_K) -> list:
    """Fig. 5's inputs for ``run(fig5=...)``: ``ops.mriq``'s arguments
    from ``host_inputs``, phiMag formed on the host."""
    host = host_inputs(seed, n_vox, n_k)
    return mriq_args(host, phi_mag(host["phi_r"], host["phi_i"]))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class NaivePass:
    """naive_per_voxel over the first ``voxels`` voxels: per voxel the
    k-space (4 x 3072 f32 at the paper's size, 49,152 B) and its
    coordinates from pinned buffers, one launch, its (Qr, Qi) back, a
    synchronise.  A call returns the pass's seconds;
    ``voxel_s`` holds each voxel's, ``out`` the (voxels, 2) results."""

    #: f32 slots to a 16 bytes: the kernel's operands are 16-byte aligned,
    #: so each voxel's x, y and z sit 16 bytes apart, and the k-space rows
    #: start at multiples of 16 bytes
    STRIDE = 4

    def __init__(self, args: list, dev: torch.device, voxels: int):
        kx, ky, kz, mag, x, y, z = args
        self.dev, self.m = dev, kx.shape[0]
        self.k = torch.zeros(4, -(-self.m // self.STRIDE) * self.STRIDE)
        for j, c in enumerate((kx, ky, kz, mag)):
            self.k[j, :self.m] = c
        self.v = torch.zeros(voxels, 3, self.STRIDE)
        for j, c in enumerate((x, y, z)):
            self.v[:, j, 0] = c[:voxels]
        self.v = self.v.reshape(voxels, 3 * self.STRIDE)
        self.out = torch.empty(voxels, 2)
        if dev.type == "cuda":
            self.k, self.v, self.out = (t.pin_memory() for t in
                                        (self.k, self.v, self.out))
            self.dk = torch.empty_like(self.k, device=dev)
            self.dv = torch.empty(3 * self.STRIDE, device=dev)
        self.voxel_s: list = []

    def operands(self, k: torch.Tensor, v: torch.Tensor) -> tuple:
        """``ops.mriq``'s arguments from the k-space rows and one voxel's
        row of ``v``."""
        return (*(k[j, :self.m] for j in range(4)),
                *(v[j * self.STRIDE:j * self.STRIDE + 1] for j in range(3)))

    def voxel(self, i: int, ev: Optional[list] = None) -> None:
        """Voxel ``i``: its copies in, one launch, (Qr, Qi) out, a
        synchronise; ``ev``, four CUDA events, marks the parts."""
        def mark(j: int) -> None:
            if ev is not None:
                ev[j].record()
        mark(0)
        if self.dev.type == "cuda":
            self.dk.copy_(self.k, non_blocking=True)
            self.dv.copy_(self.v[i], non_blocking=True)
            k, v = self.dk, self.dv
        else:
            k, v = self.k, self.v[i]
        mark(1)
        qr, qi = ops.mriq(*self.operands(k, v))
        mark(2)
        self.out[i, 0:1].copy_(qr, non_blocking=True)
        self.out[i, 1:2].copy_(qi, non_blocking=True)
        mark(3)
        _sync(self.dev)

    def parts(self, voxels: int) -> dict:
        """Each part's median over the first ``voxels`` voxels on the card,
        seconds, from CUDA events: the two H2D copies, the launch, the two
        D2H copies, and the voxel's whole time on the host clock."""
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(voxels)]
        host = []
        for i, e in enumerate(ev):
            t0 = time.perf_counter()
            self.voxel(i, e)
            host.append(time.perf_counter() - t0)
        out = {"host": _median(host)}
        for j, part in enumerate(("h2d", "kernel", "d2h")):
            out[part] = _median([e[j].elapsed_time(e[j + 1]) / 1e3
                                 for e in ev])
        return out

    def __call__(self) -> float:
        times = []
        for i in range(self.v.shape[0]):
            t0 = time.perf_counter()
            self.voxel(i)
            times.append(time.perf_counter() - t0)
        self.voxel_s = times
        return sum(times)


class TrigPass:
    """device_trig_host_sum over every voxel: per chunk, cos and sin of
    the phases by stock ops on the device, copied into pinned host
    buffers, summed against phiMag on the host.  A call returns the pass's
    seconds; ``out`` holds (Qr, Qi)."""

    def __init__(self, args: list, dev: torch.device, chunk: int):
        kx, ky, kz, mag, x, y, z = args
        self.dev, self.mag = dev, mag
        self.k = torch.stack([kx, ky, kz])
        self.v = torch.stack([x, y, z])
        n = x.shape[0]
        self.chunk = min(chunk, n)
        self.out = (torch.empty(n), torch.empty(n))
        if dev.type == "cuda":
            self.k, self.v = self.k.pin_memory(), self.v.pin_memory()
            self.dk = torch.empty_like(self.k, device=dev)
            self.dv = torch.empty_like(self.v, device=dev)
            self.host = [torch.empty(self.chunk, kx.shape[0]).pin_memory()
                         for _ in range(2)]

    def __call__(self) -> float:
        t0 = time.perf_counter()
        cuda = self.dev.type == "cuda"
        if cuda:
            self.dk.copy_(self.k, non_blocking=True)
            self.dv.copy_(self.v, non_blocking=True)
            k, v = self.dk, self.dv
        else:
            k, v = self.k, self.v
        n = v.shape[1]
        for i in range(0, n, self.chunk):
            sl = slice(i, min(i + self.chunk, n))
            ang = 2.0 * math.pi * (torch.outer(v[0, sl], k[0])
                                   + torch.outer(v[1, sl], k[1])
                                   + torch.outer(v[2, sl], k[2]))
            trig = (torch.cos(ang), torch.sin(ang))
            if cuda:
                rows = ang.shape[0]
                for h, t in zip(self.host, trig):
                    h[:rows].copy_(t, non_blocking=True)
                _sync(self.dev)
                trig = tuple(h[:rows] for h in self.host)
            for q, t in zip(self.out, trig):
                torch.mv(t, self.mag, out=q[sl])
        return time.perf_counter() - t0


class ComboLeg:
    """full_nest+phiMag: phiR, phiI and the rest from pinned buffers, phiMag
    on the device, the kernel, (Qr, Qi) back into pinned buffers; CUDA
    events around it (the host clock on the CPU).  A call returns the
    leg's seconds; ``out`` holds the last leg's (Qr, Qi)."""

    NAMES = ("kx", "ky", "kz", "phi_r", "phi_i", "x", "y", "z")

    def __init__(self, host: dict, dev: torch.device):
        self.dev = dev
        self.src = [host[k] for k in self.NAMES]
        n = host["x"].shape[0]
        self.out = (torch.empty(n), torch.empty(n))
        if dev.type == "cuda":
            self.src = [a.pin_memory() for a in self.src]
            self.dst = [torch.empty_like(a, device=dev) for a in self.src]
            self.out = tuple(t.pin_memory() for t in self.out)

    def __call__(self) -> float:
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            kx, ky, kz, pr, pi, x, y, z = self.src
            self.out = ops.mriq(kx, ky, kz, phi_mag(pr, pi), x, y, z)
            return time.perf_counter() - t0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for d, s in zip(self.dst, self.src):
            d.copy_(s, non_blocking=True)
        kx, ky, kz, pr, pi, x, y, z = self.dst
        qr, qi = ops.mriq(kx, ky, kz, phi_mag(pr, pi), x, y, z)
        self.out[0].copy_(qr, non_blocking=True)
        self.out[1].copy_(qi, non_blocking=True)
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / 1e3


def _median(v: list) -> float:
    v = sorted(v)
    return v[len(v) // 2]


def ties(rows: list, best: dict) -> list:
    """The rows whose median lies within ``best``'s spread while ``best``'s
    lies within theirs."""
    return [r["name"] for r in rows if r is not best
            and best["lo"] <= r["seconds"] <= best["hi"]
            and r["lo"] <= best["seconds"] <= r["hi"]]


def run(device: DeviceLike = None, source=None, n_vox: int = N_VOX,
        n_k: int = N_K, seed: int = 0, naive_voxels: int = NAIVE_VOXELS,
        legs: int = bench_mriq.LEGS,
        window_s: float = WINDOW_S, fig5: Optional[dict] = None,
        log: Callable[[str], None] = print) -> dict:
    """Steps 1-4 on ``device``; ``source`` is its ``PowerSource`` (an
    ``NvmlSource`` on the card by default).  ``fig5`` is
    ``bench_mriq.run``'s result on ``fig5_inputs(seed, n_vox, n_k)``: its
    CPU-only leg and card window are reused (run here when not given).
    Returns the rows, the selection and the model beside them."""
    dev = resolve_device(device)
    source = source if source is not None else NvmlSource(dev)
    node = R740_ARRIA10
    card = getattr(source, "name", type(source).__name__)
    limit = getattr(source, "power_limit_w", None)

    sites = loop_census(n_vox, n_k)
    log(f"step 1  code analysis: {len(sites)} processable loop sites "
        f"(paper: 16 for MRI-Q)")
    rejects = narrow(sites)
    log(f"step 2  narrowing: {len(sites)} loops -> 4 measurement patterns"
        f" (paper: -> 4); rejected e.g. "
        + ", ".join(n for n, _ in rejects[:3]))

    host = host_inputs(seed, n_vox, n_k)
    mag = phi_mag(host["phi_r"], host["phi_i"])     # and a warm-up
    mags = []
    for _ in range(legs):
        t0 = time.perf_counter()
        phi_mag(host["phi_r"], host["phi_i"])
        mags.append(time.perf_counter() - t0)
    t_mag = _median(mags)               # phiMag on the host, warm
    args = mriq_args(host, mag)
    if fig5 is None:
        fig5 = bench_mriq.run(dev, source, seed=seed, legs=legs,
                              window_s=window_s, host=args, log=log)
    if (fig5["n_vox"], fig5["n_k"]) != (n_vox, n_k):
        raise ValueError(f"Fig. 5's legs ran at {fig5['n_vox']} x "
                         f"{fig5['n_k']}, not {n_vox} x {n_k}")
    want = fig5["cpu_q"]
    rows = []

    def row(name, seconds, lo, hi, err, card_w=None, card_ws=None,
            counter=None, **extra):
        w = node.p_cpu_active if name == "cpu_only" else node.p_accel_active
        rows.append({"name": name, "seconds": seconds, "lo": lo, "hi": hi,
                     "node_w": w, "node_ws": seconds * w,
                     "card_w": card_w, "card_ws": card_ws,
                     "card_counter": counter, "max_abs_err": err,
                     "fitness": fitness(seconds, w), "note": NOTES[name],
                     **extra})

    t_cpu = t_mag + fig5["cpu_s"]
    row("cpu_only", t_cpu, t_cpu, t_cpu, 0.0)

    # naive_per_voxel: a window of passes over the subset, scaled
    naive_voxels = min(naive_voxels, n_vox)
    scale = n_vox / naive_voxels
    naive = NaivePass(args, dev, naive_voxels)
    win = sample_window(source, naive, seconds=window_s)
    err = bench_mriq.max_err(naive.out.T, [q[:naive_voxels] for q in want],
                             "mriq naive_per_voxel")
    passes = win.call_seconds
    vox = sorted(naive.voxel_s)
    parts = naive.parts(min(NAIVE_PARTS, naive_voxels)) \
        if dev.type == "cuda" else None
    row("naive_per_voxel", _median(passes) * scale, min(passes) * scale,
        max(passes) * scale, err, win.watts, win.joules_per_call * scale,
        win.counter, scaled=True, voxels=naive_voxels, scale=scale,
        passes=len(passes), subset_s=_median(passes),
        voxel_s={"min": vox[0], "median": _median(vox), "max": vox[-1]},
        voxel_parts=parts)

    # device_trig_host_sum: a window of whole passes
    trig = TrigPass(args, dev, CHUNK)
    win = sample_window(source, trig, seconds=window_s)
    err = bench_mriq.max_err(trig.out, want, "mriq device_trig_host_sum")
    passes = win.call_seconds
    row("device_trig_host_sum", _median(passes), min(passes), max(passes),
        err, win.watts, win.joules_per_call, win.counter,
        passes=len(passes), chunk=trig.chunk,
        bus_bytes=2 * 4 * n_vox * n_k)

    # the two full-nest patterns' legs in turns, so that both meet the
    # same bus and clocks; full_nest_batched is Fig. 5's leg, and its card
    # window Fig. 5's
    leg, combo = bench_mriq.OffloadLeg(args, dev), ComboLeg(host, dev)
    leg()                                       # warm-ups
    combo()
    full, both = [], []
    for _ in range(legs):
        full.append(t_mag + leg()["total"])
        both.append(combo())
    err = bench_mriq.max_err(leg.out, want, "mriq full_nest_batched")
    row("full_nest_batched", _median(full), min(full), max(full), err,
        fig5["card_w"], fig5["card_ws"], fig5["card_counter"], legs=legs)
    err = bench_mriq.max_err(combo.out, want, "mriq full_nest+phiMag")
    win = sample_window(source, combo, seconds=window_s)
    row("full_nest+phiMag", _median(both), min(both), max(both), err,
        win.watts, win.joules_per_call, win.counter, legs=legs,
        window_legs=win.calls)

    best = max(rows, key=lambda r: r["fitness"])
    tie = ties(rows, best)
    model = model_patterns(t_cpu, n_vox=n_vox, n_k=n_k)
    out = {"device": str(dev), "card": card, "power_limit_w": limit,
           "n_vox": n_vox, "n_k": n_k, "census": len(sites),
           "rejects": rejects, "rows": rows, "selected": best["name"],
           "tie": tie, "model": model}

    log(f"step 3  verification environment on {card} (power limit {limit} "
        f"W), {n_vox} voxels x {n_k} k-points; node watts = the paper's "
        f"IPMI figures (121 W CPU / 111 W offloaded), card W and Ws "
        f"card-only; model = the reference's, on the H100's constants:")
    log(f"        {'pattern':22s} {'s':>11s} {'spread':>23s} {'node Ws':>9s} "
        f"{'card W':>7s} {'card Ws':>9s} {'fitness':>8s} {'model s':>9s}")
    for r in rows:
        card_w = "-" if r["card_w"] is None else f"{r['card_w']:.1f}"
        card_ws = "-" if r["card_ws"] is None else f"{r['card_ws']:.4f}"
        log(f"        [{r['name']:20s}] {r['seconds']:11.6f} "
            f"{r['lo']:11.6f}-{r['hi']:11.6f} {r['node_ws']:9.3f} "
            f"{card_w:>7s} {card_ws:>9s} {r['fitness']:8.4f} "
            f"{model[r['name']][0]:9.4f}  <- {r['note']}"
            + (" (scaled)" if r.get("scaled") else ""))
        log(f"          {r['name']}: max_err vs cpu_only "
            f"{r['max_abs_err']:.3e}" + describe_window(r["card_counter"]))
    nv = [r for r in rows if r["name"] == "naive_per_voxel"][0]
    log(f"        naive_per_voxel: {nv['voxels']} voxels x {nv['passes']} "
        f"passes, median pass {nv['subset_s']:.6f} s, scaled x{scale:g}; "
        f"a voxel {nv['voxel_s']['min'] * 1e6:.2f} / "
        f"{nv['voxel_s']['median'] * 1e6:.2f} / "
        f"{nv['voxel_s']['max'] * 1e6:.2f} us (min / median / max)"
        + ("" if nv["voxel_parts"] is None else "; parts (median of "
           f"{min(NAIVE_PARTS, naive_voxels)} voxels): " + ", ".join(
               f"{k} {v * 1e6:.2f} us"
               for k, v in nv["voxel_parts"].items())))
    log(f"\nstep 4  selected: {best['name']}"
        + (f" (tie with {', '.join(tie)}: medians within each other's "
           f"spread)" if tie else ""))
    log(f"        time : {t_cpu:.3f}s -> {best['seconds']:.6f}s "
        f"({t_cpu / best['seconds']:.1f}x; paper Fig.5: 14 -> 2, 7.0x)")
    log(f"        energy: {rows[0]['node_ws']:.1f} W*s -> "
        f"{best['node_ws']:.4f} W*s ({rows[0]['node_ws'] / best['node_ws']:.1f}"
        f"x lower; paper Fig.5: 1690 -> 223, 7.6x)")
    full = [r for r in rows if r["name"] == "full_nest_batched"][0]
    log(f"        note: the naive per-voxel pattern is "
        f"{nv['seconds'] / full['seconds']:.1f}x slower than the "
        f"batched-transfer pattern (model: "
        f"{model['naive_per_voxel'][0] / model['full_nest_batched'][0]:.1f}"
        f"x) — measured pattern search, not blind offload, is the paper's "
        f"point (§2.1, §3.1).")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    source = None
    if dev.type == "cpu":
        from repro_torch.telemetry.sampler import ConstantSource
        source = ConstantSource(R740_ARRIA10.p_accel_active)
    run(dev, source)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

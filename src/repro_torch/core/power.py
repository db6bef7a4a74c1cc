"""Hardware and node power points, and the roofline energy model
(counterpart of ``repro.core.power``).

``HardwareSpec`` carries a chip's roofline and energy constants; the port's
spec is ``H100``, the card it runs on, in place of the reference's TPU
spec, whose figures are not carried over.  ``PowerModel`` is the
reference's model over it:

    E = FLOPs*e_flop + HBM_bytes*e_hbm + ICI_bytes*e_ici + t*P_static
    W = E / t

with two changes, both off for a spec without the fields (the
reference's case): the time terms divide by the rates the card's kernels
reach (``reached_flops``, ``reached_bw``) in place of the peaks, and a
phase whose dynamic joules would draw more than ``power_limit`` takes the
time that holds it to the limit, as the card's clocks do.  e_flop and
e_hbm are fitted to windows at the reached rates; timed at the peaks, the
same joules would land in 0.35 of the time, at twice the power limit.

``NodeSpec`` holds the whole-node operating points the paper measured.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # FLOP/s bf16 per chip
    hbm_bw: float              # B/s per chip
    hbm_bytes: float           # capacity per chip
    ici_bw: float              # B/s per link
    # energy constants
    e_flop: float              # J/FLOP
    e_hbm: float               # J/B
    e_ici: float               # J/B
    p_static: float            # W per chip (idle + host share)
    # the rates the roofline's time terms use: what the card's kernels
    # reach, measured with the energy constants (0: the peaks)
    reached_flops: float = 0.0  # FLOP/s
    reached_bw: float = 0.0     # B/s
    # W per chip the card holds its draw to (0: no cap)
    power_limit: float = 0.0

    @property
    def flops_rate(self) -> float:
        return self.reached_flops or self.peak_flops

    @property
    def bytes_rate(self) -> float:
        return self.reached_bw or self.hbm_bw


# One NVIDIA H100 SXM 80GB.  Peaks from NVIDIA's data sheet (dense, at the
# 700 W limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3,
# NVLink 450 GB/s each way to the other cards of a host.  hbm_bytes is the
# device memory PyTorch reports for the card (85,017,493,504 B).
# The energy constants and reached rates are the card's own: the median of
# three calibrations in a row on one NVIDIA H100 80GB HBM3 at its 700.00 W
# power limit (``python -m repro_torch.benchmarks.calibrate_power``, run
# 2026-10-17 at 11:22 UTC; each window 5 s, billed over its calls from the
# NVML energy counter; PERF.md lists the three runs):
#   p_static       its draw with a CUDA context and nothing running:
#                  121.549 W (119.060 / 125.025 / 121.549);
#   e_flop, e_hbm  solved from E - p_static t = FLOP e_flop + bytes e_hbm
#                  over two kernel windows: swiglu T=1024 bf16 (bound by
#                  operations; ~360.8 TFLOP/s at ~690 W) and rglru S 2560
#                  f32 (bound by bytes; ~2.84 TB/s at ~595 W);
#   reached_flops, the swiglu window's operations and the rglru window's
#   reached_bw     bytes a second, the rates the time terms use.
# power_limit is the card's 700 W.  e_ici is not measured: one card runs
# no collectives, and the port's estimate books none (tp = 1).
H100 = HardwareSpec(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    hbm_bytes=85017493504.0,
    ici_bw=450e9,
    e_flop=1.4061e-12,
    e_hbm=1.6596e-10,
    e_ici=0.0,
    p_static=121.549,
    reached_flops=360.781e12,
    reached_bw=2.8385e12,
    power_limit=700.0,
)


# The paper's evaluated node (Dell R740 + Arria10 FPGA): the measured
# whole-node watts of its Fig. 5 (idle, CPU-only compute, offloaded compute).
@dataclass(frozen=True)
class NodeSpec:
    name: str
    p_idle: float              # W, whole node at rest
    p_cpu_active: float        # W, node during CPU-only compute
    p_accel_active: float      # W, node during accelerator compute


R740_ARRIA10 = NodeSpec("r740_arria10", p_idle=105.0, p_cpu_active=121.0,
                        p_accel_active=111.0)


@dataclass
class PowerModel:
    hw: HardwareSpec = H100

    def energy(self, flops: float, hbm_bytes: float, ici_bytes: float,
               seconds: float, chips: int = 1) -> float:
        """Joules for a program phase across `chips` devices.

        flops/hbm_bytes/ici_bytes are TOTALS across chips; `seconds` is the
        wall time of the phase.
        """
        dyn = (flops * self.hw.e_flop + hbm_bytes * self.hw.e_hbm
               + ici_bytes * self.hw.e_ici)
        return dyn + seconds * self.hw.p_static * chips

    def watts(self, flops: float, hbm_bytes: float, ici_bytes: float,
              seconds: float, chips: int = 1) -> float:
        # zero-duration phases draw the static floor, not inf (inf would
        # poison downstream fitness averaging)
        if seconds <= 0:
            return self.hw.p_static * chips
        return self.energy(flops, hbm_bytes, ici_bytes, seconds, chips) / seconds

    # -- roofline time terms (per the §Roofline formulas) --------------------

    def compute_term(self, flops: float, chips: int) -> float:
        return flops / (chips * self.hw.flops_rate)

    def memory_term(self, hbm_bytes: float, chips: int) -> float:
        return hbm_bytes / (chips * self.hw.bytes_rate)

    def collective_term(self, coll_bytes: float, chips: int) -> float:
        return coll_bytes / (chips * self.hw.ici_bw)

    def step_time(self, flops: float, hbm_bytes: float, coll_bytes: float,
                  chips: int, overlap: float = 0.0) -> float:
        """Roofline wall-time estimate.

        overlap in [0,1]: fraction of the collective term hidden behind
        compute.
        """
        tc = self.compute_term(flops, chips)
        tm = self.memory_term(hbm_bytes, chips)
        tcoll = self.collective_term(coll_bytes, chips) * (1.0 - overlap)
        return self.capped(max(tc, tm) + tcoll, flops, hbm_bytes,
                           coll_bytes * chips, chips)

    def capped(self, seconds: float, flops: float, hbm_bytes: float,
               ici_bytes: float, chips: int) -> float:
        """``seconds``, or the longer time in which the phase's dynamic
        joules keep each chip at ``power_limit``."""
        headroom = (self.hw.power_limit - self.hw.p_static) * chips
        if self.hw.power_limit <= 0 or headroom <= 0:
            return seconds
        dyn = (flops * self.hw.e_flop + hbm_bytes * self.hw.e_hbm
               + ici_bytes * self.hw.e_ici)
        return max(seconds, dyn / headroom)

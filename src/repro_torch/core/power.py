"""Hardware and node power points (subset of ``repro.core.power``).

``HardwareSpec`` carries a chip's roofline and energy constants (what
``telemetry.dvfs.envelope_for`` derives an envelope from); ``NodeSpec`` the
whole-node operating points the paper measured.  The reference's ``V5E``
spec is a TPU's figure and is not carried over.
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

"""repro_torch.telemetry — Watt*second accounting for the serving loop.

The subset of ``repro.telemetry`` that ``ServeLoop`` bills through: the
phase-marked ``PowerTrace``, DVFS envelopes and utilization signals, and
the per-phase ``EnergyLedger`` behind ``DecodeEnergyMeter``.
"""
from repro_torch.telemetry.trace import PhaseSpan, PowerTrace  # noqa: F401
from repro_torch.telemetry.dvfs import (LiveUtilization,  # noqa: F401
                                        ModeledSource, PhaseUtilization,
                                        PowerEnvelope, UtilizationSpan,
                                        envelope_for, node_envelope)
from repro_torch.telemetry.energy import (DEFAULT_NODE,  # noqa: F401
                                          DEFAULT_TENANT, IDLE_PHASE,
                                          INFRA_TENANT, DecodeEnergyMeter,
                                          EnergyLedger, PhaseEnergy)

"""repro_torch.telemetry — sampled power tracing and Watt*second accounting.

Counterpart of ``repro.telemetry``: the phase-marked ``PowerTrace`` (with
its JSONL persistence), DVFS envelopes and utilization signals, the
fixed-interval sampler over pluggable sources, the per-phase
``EnergyLedger`` behind ``DecodeEnergyMeter``, and the Fig. 5 CPU-only vs
offloaded A/B harness with its reports.  ``nvml.NvmlSource`` is the
port's own source: the card's measured draw from its NVML energy counter,
the counterpart of the paper's IPMI reading.  The governor waits for the
serving slice (ROADMAP.md).
"""
from repro_torch.telemetry.trace import PhaseSpan, PowerTrace  # noqa: F401
from repro_torch.telemetry.dvfs import (LiveUtilization,  # noqa: F401
                                        ModeledSource, PhaseUtilization,
                                        PowerEnvelope, UtilizationSpan,
                                        envelope_for, node_envelope)
from repro_torch.telemetry.sampler import (ConstantSource,  # noqa: F401
                                           PowerSampler, ReplaySource,
                                           TickClock, sample_stage_trace,
                                           synthesize_phase_trace)
from repro_torch.telemetry.energy import (DEFAULT_NODE,  # noqa: F401
                                          DEFAULT_TENANT, IDLE_PHASE,
                                          INFRA_TENANT, DecodeEnergyMeter,
                                          EnergyLedger, PhaseEnergy)
from repro_torch.telemetry.compare import (RequestEnergy,  # noqa: F401
                                           RunEnergy, WsComparison,
                                           ab_sample, compare)
from repro_torch.telemetry.report import (  # noqa: F401
    render_comparison_csv, render_comparison_json, render_comparison_text,
    render_ledger, render_rollups, render_trace_summary)

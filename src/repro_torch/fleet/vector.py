"""``repro_torch.fleet.vector`` — the vectorized, event-driven fleet core.

Copy of ``repro.fleet.vector``, op for op: it is numpy in the reference and
stays numpy here.

The object-level ``FleetScheduler`` steps N Python ``ServeLoop``s one
request at a time — the right *reference* semantics, hopeless at
production scale.  This module re-expresses the whole fleet plane as
numpy arrays over nodes:

  * node state (slots, queue depths, occupancy, decode-step history,
    floor/active watts, power-machine states, per-tenant spend) lives in
    flat arrays indexed by node;
  * arrivals are one pre-sorted due-step event stream
    (``VectorArrivals``), dispatched by a cursor — O(1) per arrival;
  * routing and the planner's consolidate-and-gate are batched
    argmin / cumulative-slot searches over the node arrays;
  * the ledger is a dense ``(node, tenant, phase)`` cell tensor folded
    into a real ``EnergyLedger`` at run end.

**Equivalence is the contract, not a goal**: the core replicates the
reference float arithmetic op-for-op — the DVFS envelope expression, the
marginal-Ws routing key (with its load/name tie-breaks), the
``TickClock`` accumulation the serve loop brackets its windows with
(whose ~1-ULP window jitter feeds routing ties and therefore *placement
control flow*), the planner's ranked k-search, hysteresis, gate-pays
test and pending/checkpoint ordering — so that on one arrival script the
vector core reproduces the reference ``ledger.total_ws``, the
per-(node, tenant, phase) rollups and the placement-event sequence
(``tests/test_torch_fleet_vector.py`` pins this joule-for-joule against
the reference's vector core and the port's own object fleet).

Two loop models mirror the two reference loops:

  * ``loop_model="serve"`` — ``ServeLoop`` semantics under a virtual
    ``TickClock``: per-fill prefill windows, the ``max_seq`` position
    cap, idle windows measured between clock marks (EOS termination is
    object-only: run the reference with ``eos_id=-1``);
  * ``loop_model="sim"`` — the stub ``SimLoop`` semantics of the fleet
    tests: fixed ``step_s`` windows, decode + idle only.

Object-only (use ``FleetScheduler`` when you need them): drift-triggered
cross-node migration (``migrate_on_drift``), per-node ``PowerGovernor``s,
EOS-token termination, drifting (non-constant) power sources, per-request
spans and the meter's ``PowerTrace``.  Observability is preserved in
aggregate form: per-(node, phase) spans carrying exact booked Ws (so
``attribute_joules`` still conserves per node), live queue-wait /
routing-fanout histograms, and run-level counters.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.fleet.power.forecast import ArrivalForecaster
from repro_torch.fleet.power.planner import PlacementEvent, PowerPlanPolicy
from repro_torch.fleet.power.states import ACTIVE, GATED, PROBATION, WAKING
from repro_torch.fleet.scheduler import (_CANDIDATE_BUCKETS, FleetPolicy,
                                   normalize_arrivals)
from repro_torch.telemetry.dvfs import PowerEnvelope
from repro_torch.telemetry.energy import (IDLE_PHASE, INFRA_TENANT,
                                    TRANSITION_PHASE, EnergyLedger,
                                    PhaseEnergy)

#: ledger phases in dense-tensor order
PHASES = ("prefill", "decode", IDLE_PHASE, TRANSITION_PHASE)
_PRE, _DEC, _IDLE, _TRANS = range(4)

#: power-machine state codes (PARKED is object-only: it exists solely
#: for drift-migration drains, which the vector core does not run)
_ACTIVE, _GATED, _WAKING, _PROBATION = range(4)
_STATE_NAME = {_ACTIVE: ACTIVE, _GATED: GATED, _WAKING: WAKING,
               _PROBATION: PROBATION}
#: the planner's ranked-order preference per state (see planner._ranked)
_STATE_ORDER = {_ACTIVE: 0, _PROBATION: 0, _WAKING: 0, _GATED: 2}

_NO_CAP = 1 << 62                   # max_seq sentinel: uncapped

#: stand-in tracer for paths head sampling turns off (obs.FLIGHT
#: sampling keeps the tracer live for finalize-built request trees but
#: suppresses the per-arrival instants)
_NULL_TRACER = obs.NullTracer()


@dataclass(frozen=True)
class VectorNodeSpec:
    """Static description of one vector-core node.

    ``step_s`` is both the virtual tick (``TickClock(step_s)`` in serve
    model, the fixed window in sim model) and the routing prior
    (``nominal_step_s``) unless ``nominal_step_s`` overrides it.
    ``source_watts`` replays a constant draw (``ConstantSource``
    semantics); drifting sources are object-only.
    """
    name: str
    envelope: PowerEnvelope
    slots: int = 2
    chips: int = 1
    step_s: float = 2e-3
    max_seq: Optional[int] = None
    source_watts: Optional[float] = None
    nominal_step_s: Optional[float] = None


class VectorArrivals:
    """One due-sorted arrival stream as flat arrays.

    ``due`` is the fleet step each request becomes submittable;
    ``tenant_idx`` indexes ``tenant_names``; ``prompt_len`` /
    ``tokens_done`` / ``max_new`` are what the loop models need of a
    ``Request`` (token *values* never matter to the energy account).

    The stream must arrive due-sorted and non-negative — the dispatch
    cursor is O(1) *because* it never looks back, so an unsorted script
    would silently mis-dispatch every arrival already behind the
    cursor.  Sort scripts with ``normalize_arrivals`` (what
    ``from_requests`` does) rather than relying on construction.
    """

    def __init__(self, due, tenant_idx, prompt_len, max_new,
                 tenant_names, rid=None, tokens_done=None):
        self.due = due = np.asarray(due, np.float64)
        if due.size:
            if not np.all(due[:-1] <= due[1:]):
                bad = int(np.argmin(due[:-1] <= due[1:]))
                raise ValueError(
                    "arrival due steps must be non-decreasing (the "
                    "dispatch cursor never looks back) — "
                    f"due[{bad}]={due[bad]:g} > due[{bad + 1}]="
                    f"{due[bad + 1]:g}; sort the script first")
            if due[0] < 0:
                raise ValueError("arrival due steps must be >= 0, got "
                                 f"due[0]={due[0]:g}")
        self.tenant_idx = np.asarray(tenant_idx, np.int64)
        self.prompt_len = np.asarray(prompt_len, np.int64)
        self.max_new = np.asarray(max_new, np.int64)
        n = len(due)
        self.rid = (np.arange(n, dtype=np.int64) if rid is None
                    else np.asarray(rid, np.int64))
        self.tokens_done = (np.zeros(n, np.int64) if tokens_done is None
                            else np.asarray(tokens_done, np.int64))
        self.tenant_names = list(tenant_names)

    def __len__(self) -> int:
        return len(self.due)

    @classmethod
    def from_requests(cls, arrivals, arrival_every: int = 1
                      ) -> "VectorArrivals":
        """Build from the same script shapes ``FleetScheduler.run``
        takes: bare ``Request``s (paced) or ``(due_step, Request)``
        pairs — normalized/sorted identically, so both cores see one
        stream."""
        pairs = normalize_arrivals(arrivals, arrival_every)
        n = len(pairs)
        due = np.empty(n, np.float64)
        tidx = np.empty(n, np.int64)
        plen = np.empty(n, np.int64)
        max_new = np.empty(n, np.int64)
        rid = np.empty(n, np.int64)
        tokens_done = np.empty(n, np.int64)
        names: list = []
        index: dict = {}
        for k, (d, req) in enumerate(pairs):
            t = index.get(req.tenant)
            if t is None:
                t = index[req.tenant] = len(names)
                names.append(req.tenant)
            due[k] = d
            tidx[k] = t
            plen[k] = len(req.prompt)
            max_new[k] = req.max_new
            rid[k] = req.rid
            tokens_done[k] = len(req.out)
        return cls(due=due, tenant_idx=tidx, prompt_len=plen,
                   max_new=max_new, tenant_names=names, rid=rid,
                   tokens_done=tokens_done)

    @classmethod
    def synth(cls, n: int, tenants=4, mean_gap_steps: float = 1.0,
              prompt_len=(4, 12), max_new: int = 8,
              seed: int = 0) -> "VectorArrivals":
        """A reproducible synthetic stream: exponential inter-arrival
        gaps (mean ``mean_gap_steps`` fleet steps), uniform prompt
        lengths, round-robin-free random tenants — the ``fleet_scale``
        bench workload."""
        rng = np.random.default_rng(seed)
        names = ([f"tenant{i}" for i in range(tenants)]
                 if isinstance(tenants, int) else list(tenants))
        gaps = rng.exponential(mean_gap_steps, size=n)
        due = np.floor(np.cumsum(gaps)).astype(np.int64)
        return cls(due=due,
                   tenant_idx=rng.integers(0, len(names), size=n),
                   prompt_len=rng.integers(prompt_len[0], prompt_len[1],
                                           size=n),
                   max_new=np.full(n, max_new, np.int64),
                   tenant_names=names)

    #: relative per-hour arrival weights of the default synthetic day —
    #: a deep night trough, a morning ramp into the first peak, an
    #: evening second peak (the classic two-hump diurnal curve)
    DIURNAL_PROFILE = (2, 1, 1, 1, 1, 2, 5, 12, 20, 26, 28, 26,
                       22, 20, 18, 20, 24, 30, 32, 28, 18, 10, 6, 3)

    @classmethod
    def diurnal(cls, n: int, tenants=4, hours: int = 24,
                steps_per_hour: int = 2000, profile=None,
                prompt_len=(4, 12), max_new: int = 8,
                seed: int = 0) -> "VectorArrivals":
        """A reproducible diurnal stream: ``n`` arrivals split across
        ``hours`` virtual hours of ``steps_per_hour`` fleet steps each,
        hour weights following ``profile`` (relative rates; default the
        two-peak ``DIURNAL_PROFILE``), uniform within each hour — the
        ``fleet_diurnal_1m`` bench workload.  The per-hour counts are
        deterministic (largest-remainder split), so the trace shape is
        stable across seeds."""
        rng = np.random.default_rng(seed)
        names = ([f"tenant{i}" for i in range(tenants)]
                 if isinstance(tenants, int) else list(tenants))
        w = np.asarray(profile if profile is not None
                       else cls.DIURNAL_PROFILE, np.float64)
        if len(w) != hours or np.any(w < 0) or w.sum() <= 0:
            raise ValueError(f"profile needs {hours} non-negative hour "
                             "weights with a positive sum")
        exact = w * (n / w.sum())
        counts = np.floor(exact).astype(np.int64)
        rem = n - int(counts.sum())
        if rem > 0:
            counts[np.argsort(-(exact - counts), kind="stable")[:rem]] += 1
        dues = []
        for h in range(hours):
            c = int(counts[h])
            if c == 0:
                continue
            lo, hi = h * steps_per_hour, (h + 1) * steps_per_hour
            dues.append(np.sort(rng.uniform(lo, hi, size=c)))
        due = np.floor(np.concatenate(dues)) if dues \
            else np.empty(0, np.float64)
        return cls(due=due,
                   tenant_idx=rng.integers(0, len(names), size=n),
                   prompt_len=rng.integers(prompt_len[0], prompt_len[1],
                                           size=n),
                   max_new=np.full(n, max_new, np.int64),
                   tenant_names=names)


class _ReqView:
    """The slice of ``Request`` the admission controller reads."""
    __slots__ = ("rid", "tenant")

    def __init__(self, rid: int, tenant: str):
        self.rid = rid
        self.tenant = tenant


class _TenantLedgerView:
    """Live ``rollup("tenant")`` over the vector core's running spend —
    what ``WsBudget`` reads at admit time.  Equivalent to the object
    scheduler's flush-before-admit: the vector ledger is always
    current, so there is nothing to flush."""

    def __init__(self, fleet: "VectorFleet"):
        self._fleet = fleet

    def rollup(self, by: str = "node") -> dict:
        if by != "tenant":
            raise ValueError("vector admission view rolls up by tenant "
                             f"only, got {by!r}")
        f = self._fleet
        return {name: PhaseEnergy(ws=float(f._tenant_ws[t]))
                for t, name in enumerate(f.tenant_names)}


class VectorFleet:
    """N nodes, one arrival stream, one single-shot ``run``.

    Construction mirrors ``FleetScheduler``: a ``FleetPolicy`` (with
    ``migrate_on_drift=False`` — drift migration is object-only), an
    optional ``PowerPlanPolicy`` (the planner machinery itself is
    internal), an optional ``AdmissionController``.
    """

    def __init__(self, specs: list, policy: Optional[FleetPolicy] = None,
                 plan: Optional[PowerPlanPolicy] = None,
                 admission=None,
                 forecaster: Optional[ArrivalForecaster] = None,
                 loop_model: str = "serve"):
        if not specs:
            raise ValueError("a fleet needs at least one node")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"node names must be unique, got {names}")
        if loop_model not in ("serve", "sim"):
            raise ValueError("loop_model must be 'serve' or 'sim', got "
                             f"{loop_model!r}")
        policy = policy if policy is not None \
            else FleetPolicy(migrate_on_drift=False)
        if policy.migrate_on_drift:
            raise ValueError(
                "drift migration is object-only — construct the vector "
                "core with FleetPolicy(migrate_on_drift=False) and use "
                "FleetScheduler when you need drift drains")
        self.policy = policy
        self.plan = plan
        self.admission = admission
        self.loop_model = loop_model
        self._serve = loop_model == "serve"
        self.names = names
        n = self.n = len(specs)

        # -- static node arrays ---------------------------------------
        self._slots = np.array([s.slots for s in specs], np.int64)
        self._chips = np.array([float(s.chips) for s in specs])
        self._tick = np.array([float(s.step_s) for s in specs])
        self._nominal = np.array([float(s.nominal_step_s
                                        if s.nominal_step_s is not None
                                        else s.step_s) for s in specs])
        self._max_seq = np.array([s.max_seq if s.max_seq is not None
                                  else _NO_CAP for s in specs], np.int64)
        env = [s.envelope for s in specs]
        self._p_idle = np.array([e.p_idle for e in env])
        self._p_active = np.array([e.p_active for e in env])
        self._p_boost = np.array([e.p_boost for e in env])
        self._gate_util = np.array([e.gate_util for e in env])
        self._boost_util = np.array([e.boost_util for e in env])
        self._gated_idle = np.array([e.gated_idle for e in env])
        self._src_mask = np.array([s.source_watts is not None
                                   for s in specs])
        self._any_src = bool(self._src_mask.any())
        self._src_total = np.array(
            [(s.source_watts if s.source_watts is not None else 0.0)
             for s in specs]) * self._chips
        self._floor_w = self._gated_idle * self._chips
        # lexicographic name rank: the router's last tie-break, computed
        # with Python string ordering (the reference's tuple-min)
        self._name_rank = np.empty(n, np.int64)
        for r, i in enumerate(sorted(range(n), key=lambda i: names[i])):
            self._name_rank[i] = r
        self._iota = np.arange(n)       # reused by the routing hot path

        # -- mutable node state ---------------------------------------
        self.steps = 0
        self._occupied = np.zeros(n, np.int64)
        self._queued = np.zeros(n, np.int64)
        self._queues = [deque() for _ in range(n)]
        self._slot_req = [[-1] * s.slots for s in specs]
        self._loop_parked = np.zeros(n, bool)
        self._busy_steps = np.zeros(n, np.int64)    # decode windows done
        self._finish_at: list = [dict() for _ in range(n)]
        self._decode_s = np.zeros(n)                # meter decode seconds
        self._decode_n = np.zeros(n, np.int64)      # meter decode count
        self._decode_share_cum = np.zeros(n)        # per-slot ws so far
        self._clock = np.zeros(n)                   # TickClock.now
        self._t_mark = np.full(n, np.nan)           # None ≙ nan
        self._meter_now = np.zeros(n)               # meter busy-time
        self._steps_done = np.zeros(n, np.int64)
        self._finished_tokens: list = [[] for _ in range(n)]
        self._served: list = [set() for _ in range(n)]
        self._rr = 0
        # routing-hot statics and the per-step marginal cache: prefill
        # always runs at util 1/slots and idle at util 0, so their watt
        # points are node constants; the marginal vector stays valid
        # across a same-step submit burst with one-node patches
        self._w_idle = np.asarray(self._watts(slice(None), 0.0))
        self._w_pre = np.asarray(self._watts(slice(None),
                                             1.0 / self._slots))
        self._refresh_watt_tables()
        self._marg = None

        # -- power machines -------------------------------------------
        self._state = np.zeros(n, np.int64)         # _ACTIVE
        self._since = np.zeros(n, np.int64)
        self._wake_done = np.zeros(n, np.int64)
        self._canary = np.full(n, -1, np.int64)     # request index
        self._canary_step = np.zeros(n, np.int64)
        self._parked_w = None
        if plan is not None:
            self._parked_w = np.minimum(plan.states.gate_watts,
                                        self._floor_w)
        self.forecaster = forecaster or ArrivalForecaster()
        self.events: list = []                      # PlacementEvents
        self.max_queue_depth = 0
        self._plan_pending: dict = {}               # node idx -> dict

        # -- the account (cells filled per run) -----------------------
        self.tenant_names: list = []
        self.ledger = EnergyLedger()
        self._ledger_view = _TenantLedgerView(self)
        self._ran = False
        self._n_arrivals = 0
        self.profile = obs.PhaseProfiler()          # engine self-profiler
        self._flight = None

    # ------------------------------------------------------------------
    # energy model — op-for-op replicas of the reference arithmetic
    # ------------------------------------------------------------------

    def _env_watts(self, util, idx):
        """``PowerEnvelope.watts`` with identical operation order."""
        u = np.minimum(np.maximum(util, 0.0), 1.0)
        pi = self._p_idle[idx]
        gi = self._gated_idle[idx]
        gu = self._gate_util[idx]
        pa = self._p_active[idx]
        pb = self._p_boost[idx]
        bu = self._boost_util[idx]
        low = gi + (pi - gi) * u / np.maximum(gu, 1e-12)
        w = pi + (pa - pi) * u
        with np.errstate(divide="ignore", invalid="ignore"):
            boosted = w + (pb - pa) * (u - bu) / (1.0 - bu)
        w = np.where(u > bu, boosted, w)
        return np.where(u < gu, low, w)

    def _watts(self, idx, util):
        """``DecodeEnergyMeter.watts_at``/``predict_watts`` for a
        schedule-derived utilization: constant source override, else
        envelope point x chips.  (The live-utilization signal always
        returns exactly the utilization the loop just recorded, so the
        envelope path is exact for serve parity too.)"""
        w = self._env_watts(util, idx) * self._chips[idx]
        if self._any_src:
            w = np.where(self._src_mask[idx], self._src_total[idx], w)
        return w

    def _recent_dt(self):
        """``Node.recent_step_seconds`` over all nodes."""
        has = (self._decode_n > 0) & (self._decode_s > 0)
        return np.where(has,
                        self._decode_s / np.maximum(self._decode_n, 1),
                        self._nominal)

    def _refresh_watt_tables(self) -> None:
        """Hoist the routing-invariant envelope terms: a node's watt
        point depends only on its occupancy bucket ``m = min(next,
        slots)``, so ``_occ_w[i, m]`` precomputes ``_watts(i, m/slots)``
        for every bucket.  The table is static today (envelope and
        source draws never move under the vector core); any future
        placement-driven change to the watt model must re-call this."""
        s_max = int(self._slots.max()) if self.n else 0
        cols = [np.asarray(self._watts(
                    slice(None),
                    np.minimum(m, self._slots) / np.maximum(self._slots, 1)))
                for m in range(s_max + 1)]
        self._occ_w = np.stack(cols, axis=1)      # [n, s_max + 1]
        # python-float mirrors for the scalar hot path (_marginal_one):
        # one list index beats a numpy scalar chain by ~20x
        self._occ_w_py = self._occ_w.tolist()
        self._nominal_py = self._nominal.tolist()

    # ------------------------------------------------------------------
    # ledger cells
    # ------------------------------------------------------------------

    def _init_cells(self, arr: VectorArrivals) -> None:
        names = list(arr.tenant_names)
        if INFRA_TENANT not in names:
            names.append(INFRA_TENANT)
        self.tenant_names = names
        self._infra = names.index(INFRA_TENANT)
        t = len(names)
        n = self.n
        self._active_t = np.zeros((n, t), np.int64)
        self._cell_ws = np.zeros((n, t, 4))
        self._cell_s = np.zeros((n, t, 4))
        self._cell_n = np.zeros((n, t, 4), np.int64)
        self._cell_peak = np.zeros((n, t, 4))
        self._phase_ws = np.zeros(4)
        self._phase_s = np.zeros(4)
        self._phase_n = np.zeros(4, np.int64)
        self._phase_peak = np.zeros(4)
        self._node_ws = np.zeros(n)
        self._tenant_ws = np.zeros(t)

    def _book_infra(self, i: int, phase: int, ws: float, seconds: float,
                    w: float) -> None:
        """One single-tenant (infra) observation on node ``i``."""
        self._cell_ws[i, self._infra, phase] += ws
        self._cell_s[i, self._infra, phase] += seconds
        self._cell_n[i, self._infra, phase] += 1
        if w > self._cell_peak[i, self._infra, phase]:
            self._cell_peak[i, self._infra, phase] = w
        self._phase_ws[phase] += ws
        self._phase_s[phase] += seconds
        self._phase_n[phase] += 1
        if w > self._phase_peak[phase]:
            self._phase_peak[phase] = w
        self._node_ws[i] += ws
        self._tenant_ws[self._infra] += ws

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def _marginal(self):
        """``Node.marginal_ws_per_token`` over all nodes, with the
        non-finite clamp the reference router applies.  The watt point
        is a precomputed occupancy-bucket lookup (``_occ_w``) — the
        envelope expression never re-evaluates inside routing."""
        n_next = self._occupied + self._queued + 1
        m_occ = np.minimum(n_next, self._slots)
        dt = self._recent_dt()
        w = self._occ_w[self._iota, m_occ]
        share = w * dt / np.maximum(m_occ, 1)
        overload = np.maximum(n_next - self._slots, 0)
        marg = share * (1.0 + overload / np.maximum(self._slots, 1))
        return np.where(np.isfinite(marg), marg, np.inf)

    def _marginal_one(self, i: int) -> float:
        """Scalar ``_marginal`` for one node — the cache patch applied
        after a submit lands (same operations, Python floats)."""
        occ = int(self._occupied[i])
        qd = int(self._queued[i])
        slots = int(self._slots[i])
        n_next = occ + qd + 1
        m_occ = min(n_next, slots)
        dn = int(self._decode_n[i])
        ds = float(self._decode_s[i])
        dt = ds / max(dn, 1) if (dn > 0 and ds > 0) \
            else self._nominal_py[i]
        w = self._occ_w_py[i][m_occ]
        share = w * dt / max(m_occ, 1)
        m = share * (1.0 + max(n_next - slots, 0) / max(slots, 1))
        return m if math.isfinite(m) else float("inf")

    def _route(self, j: int, exclude: int = -1) -> int:
        """Pick the destination node for request ``j`` — the reference
        ``FleetScheduler.route`` as masked argmin."""
        healthy = ~self._loop_parked
        if exclude >= 0:
            healthy = healthy.copy()
            healthy[exclude] = False
        candidates = healthy
        chosen = -1
        if self.plan is not None and healthy.any():
            owed = healthy & (self._state == _PROBATION) & (self._canary < 0)
            if owed.any():
                chosen = int(np.argmax(owed))   # first in node order
                self._canary[chosen] = j
                self._canary_step[chosen] = self.steps
            else:
                routable = healthy & (self._state == _ACTIVE)
                candidates = routable if routable.any() else healthy
        if not candidates.any():
            raise RuntimeError("no healthy node to route to (all parked)")
        if chosen < 0:
            if self.policy.router == "round_robin":
                idxs = np.nonzero(candidates)[0]
                chosen = int(idxs[self._rr % len(idxs)])
                self._rr += 1
            else:
                if self._marg is None:
                    self._marg = self._marginal()
                marg = np.where(candidates, self._marg, np.inf)
                tie = candidates & (marg == marg.min())
                if int(tie.sum()) > 1:
                    load = (self._occupied + self._queued) \
                        / np.maximum(self._slots, 1)
                    load = np.where(tie, load, np.inf)
                    tie = tie & (load == load.min())
                idxs = np.nonzero(tie)[0]
                chosen = int(idxs[np.argmin(self._name_rank[idxs])])
        tr = obs.TRACER
        # head sampling thins the trace to request trees built at
        # finalize; the per-arrival instants stay off so big-rung
        # dispatch is not serialized through the tracer
        if tr.enabled and not obs.FLIGHT.sampling:
            tr.instant("fleet.route",
                       tags={"rid": int(self.r_rid[j]),
                             "tenant": self.tenant_names[
                                 int(self.r_tenant[j])],
                             "node": self.names[chosen],
                             "step": self.steps,
                             "candidates": int(candidates.sum())})
        mx = obs.METRICS
        if mx.enabled:
            mx.histogram("routing_candidates", "nodes eligible per route",
                         buckets=_CANDIDATE_BUCKETS
                         ).observe(int(candidates.sum()))
        return chosen

    def _node_submit(self, i: int, j: int) -> None:
        """``Node.submit``: track served, stamp enqueue on the node
        meter's busy-time timeline, enqueue."""
        self._served[i].add(j)
        self.r_enq_t[j] = self._meter_now[i]
        self._queues[i].append(j)
        self._queued[i] += 1
        self.r_node[j] = i
        if self._marg is not None:
            self._marg[i] = self._marginal_one(i)

    def _submit(self, j: int) -> None:
        """Admission-checked external submit of request ``j``."""
        self._n_arrivals += 1
        if self.plan is not None:
            self.forecaster.observe(self.steps)
        tr = obs.TRACER
        if obs.FLIGHT.sampling:
            tr = _NULL_TRACER       # per-arrival instants sampled out
        tenant = self.tenant_names[int(self.r_tenant[j])]
        if self.admission is not None:
            view = _ReqView(int(self.r_rid[j]), tenant)
            if not self.admission.admit(view, self.steps,
                                        self._ledger_view):
                self.r_admitted[j] = False
                if tr.enabled:
                    tr.instant("fleet.submit",
                               tags={"rid": view.rid, "tenant": tenant,
                                     "step": self.steps,
                                     "admitted": False})
                return
        i = self._route(j)
        self._node_submit(i, j)
        if tr.enabled:
            tr.instant("fleet.submit",
                       tags={"rid": int(self.r_rid[j]), "tenant": tenant,
                             "step": self.steps, "admitted": True,
                             "node": self.names[i]})

    # ------------------------------------------------------------------
    # the loops — fills, decode, idle
    # ------------------------------------------------------------------

    def _fill_node(self, i: int) -> None:
        """``ServeLoop._fill_slots`` / ``SimLoop`` fill: lowest free
        slot first, FIFO queue, queue-wait stamped, one prefill window
        booked per fill (serve model)."""
        slot_req = self._slot_req[i]
        q = self._queues[i]
        mx = obs.METRICS
        qws = [] if mx.enabled else None
        for s in range(len(slot_req)):
            if not q:
                break
            if slot_req[s] != -1:
                continue
            j = q.popleft()
            self._queued[i] -= 1
            slot_req[s] = j
            self.r_slot[j] = s
            self._occupied[i] += 1
            qw = max(float(self._meter_now[i]) - float(self.r_enq_t[j]),
                     0.0)
            self.r_queue_wait[j] += qw
            if qws is not None:
                qws.append(qw)
            tix = int(self.r_tenant[j])
            if self._serve:
                # prefill window: two TickClock calls bracket the
                # teacher-forced prompt (clock-free inner loop)
                tick = float(self._tick[i])
                t0 = float(self._clock[i]) + tick
                t1 = t0 + tick
                self._clock[i] = t1
                dt = t1 - t0
                w = float(self._w_pre[i])
                ws = w * dt
                self._cell_ws[i, tix, _PRE] += ws
                self._cell_s[i, tix, _PRE] += dt
                self._cell_n[i, tix, _PRE] += 1
                if w > self._cell_peak[i, tix, _PRE]:
                    self._cell_peak[i, tix, _PRE] = w
                self._phase_ws[_PRE] += ws
                self._phase_s[_PRE] += dt
                self._phase_n[_PRE] += 1
                if w > self._phase_peak[_PRE]:
                    self._phase_peak[_PRE] = w
                self._node_ws[i] += ws
                self._tenant_ws[tix] += ws
                self.r_prefill_ws[j] += ws
                self._meter_now[i] += dt
            self._active_t[i, tix] += 1
            # schedule the finish: tokens this residency are fixed at
            # fill time (greedy decode, EOS disabled)
            done = int(self.r_done_tokens[j])
            k = int(self.r_max_new[j]) - done
            if self._serve and self._max_seq[i] < _NO_CAP:
                cap = int(self._max_seq[i]) - int(self.r_plen[j]) - done
                k = min(k, cap)
            k = max(k, 1)
            key = int(self._busy_steps[i]) + k
            self.r_fill_busy[j] = self._busy_steps[i]
            self.r_fill_cum[j] = self._decode_share_cum[i]
            self.r_finish_key[j] = key
            self._finish_at[i].setdefault(key, []).append(j)
        if qws:
            # one batched call per fill burst, bit-identical to the old
            # per-slot observe loop (see Histogram.observe_many)
            mx.histogram("queue_wait_s",
                         "meter-time queued before a slot"
                         ).observe_many(qws)

    def _finish(self, i: int, j: int) -> None:
        self.r_done_tokens[j] += self._busy_steps[i] - self.r_fill_busy[j]
        self.r_decode_ws[j] += \
            self._decode_share_cum[i] - self.r_fill_cum[j]
        self.r_finished[j] = True
        self._slot_req[i][int(self.r_slot[j])] = -1
        self.r_slot[j] = -1
        self._occupied[i] -= 1
        self._active_t[i, int(self.r_tenant[j])] -= 1
        self._finished_tokens[i].append(int(self.r_done_tokens[j]))
        self._finished_idx.append(j)

    def _drain(self, i: int) -> list:
        """``ServeLoop.drain``: queue first, then active slots in slot
        order; evicted requests keep their generated tokens (and their
        decode-share account settles here)."""
        self._marg = None
        moved = list(self._queues[i])
        self._queues[i].clear()
        self._queued[i] = 0
        for s, j in enumerate(self._slot_req[i]):
            if j == -1:
                continue
            moved.append(j)
            self._slot_req[i][s] = -1
            self.r_slot[j] = -1
            self.r_done_tokens[j] += \
                self._busy_steps[i] - self.r_fill_busy[j]
            self.r_decode_ws[j] += \
                self._decode_share_cum[i] - self.r_fill_cum[j]
            key = int(self.r_finish_key[j])
            pend = self._finish_at[i].get(key)
            if pend is not None:
                pend.remove(j)
                if not pend:
                    del self._finish_at[i][key]
            self._active_t[i, int(self.r_tenant[j])] -= 1
        self._occupied[i] = 0
        return moved

    def _step(self) -> None:
        self.steps += 1
        self._marg = None       # fills/decode move every marginal input
        planned = self.plan is not None
        has_work = (self._occupied > 0) | \
            ((self._queued > 0) & ~self._loop_parked)
        step_mask = has_work | ~self._loop_parked if planned else has_work
        fillable = step_mask & ~self._loop_parked & (self._queued > 0) \
            & (self._occupied < self._slots)
        for i in np.nonzero(fillable)[0]:
            self._fill_node(int(i))
        busy = step_mask & (self._occupied > 0)
        bi = np.nonzero(busy)[0]
        if bi.size:
            parts = self._occupied[bi]
            util = parts / self._slots[bi]
            if self._serve:
                tick = self._tick[bi]
                t0 = self._clock[bi] + tick
                t1 = t0 + tick
                self._clock[bi] = t1
                dt = t1 - t0
                self._t_mark[bi] = t0 + dt
            else:
                dt = self._tick[bi]
            w = self._watts(bi, util)
            ws = w * dt
            share = ws / parts
            cnt = self._active_t[bi]
            self._cell_ws[bi, :, _DEC] += cnt * share[:, None]
            self._cell_s[bi, :, _DEC] += cnt * (dt / parts)[:, None]
            self._cell_n[bi, :, _DEC] += cnt
            peak = self._cell_peak[bi, :, _DEC]
            self._cell_peak[bi, :, _DEC] = \
                np.where(cnt > 0, np.maximum(peak, w[:, None]), peak)
            self._phase_ws[_DEC] += ws.sum()
            self._phase_s[_DEC] += dt.sum()
            self._phase_n[_DEC] += bi.size
            wmax = w.max()
            if wmax > self._phase_peak[_DEC]:
                self._phase_peak[_DEC] = wmax
            self._node_ws[bi] += ws
            self._tenant_ws += (cnt * share[:, None]).sum(axis=0)
            self._decode_s[bi] += dt
            self._decode_n[bi] += 1
            self._decode_share_cum[bi] += share
            self._busy_steps[bi] += 1
            self._meter_now[bi] += dt
            self._steps_done[bi] += 1
            for i in bi:
                done = self._finish_at[int(i)].pop(
                    int(self._busy_steps[i]), None)
                if done:
                    for j in done:
                        self._finish(int(i), j)
        idle = step_mask & ~busy
        ii = np.nonzero(idle)[0]
        if ii.size:
            if self._serve:
                tick = self._tick[ii]
                c1 = self._clock[ii] + tick
                tm = self._t_mark[ii]
                fresh = np.isnan(tm)
                c2 = c1 + tick
                dt_fresh = c2 - c1
                dt = np.where(fresh, dt_fresh,
                              np.maximum(c1 - tm, 0.0))
                self._clock[ii] = np.where(fresh, c2, c1)
                self._t_mark[ii] = np.where(fresh, c1 + dt_fresh, c1)
            else:
                dt = self._tick[ii]
            w = self._w_idle[ii]
            ws = w * dt
            self._cell_ws[ii, self._infra, _IDLE] += ws
            self._cell_s[ii, self._infra, _IDLE] += dt
            self._cell_n[ii, self._infra, _IDLE] += 1
            self._cell_peak[ii, self._infra, _IDLE] = np.maximum(
                self._cell_peak[ii, self._infra, _IDLE], w)
            self._phase_ws[_IDLE] += ws.sum()
            self._phase_s[_IDLE] += dt.sum()
            self._phase_n[_IDLE] += ii.size
            wmax = w.max()
            if wmax > self._phase_peak[_IDLE]:
                self._phase_peak[_IDLE] = wmax
            self._node_ws[ii] += ws
            self._tenant_ws[self._infra] += ws.sum()
            self._meter_now[ii] += dt
            self._steps_done[ii] += 1
        if planned:
            self._planner_tick()
        if self.steps % self.policy.checkpoint_every == 0:
            self._checkpoint()

    # ------------------------------------------------------------------
    # the power planner — vectorized FleetPowerPlanner
    # ------------------------------------------------------------------

    def _planner_tick(self) -> None:
        self.max_queue_depth = max(self.max_queue_depth,
                                   int(self._queued.sum()))
        dtr = np.maximum(self._recent_dt(), 1e-9)
        gated = np.nonzero(self._state == _GATED)[0]
        if gated.size:
            # a gated node books its parked draw every tick (watts
            # override: source and envelope both bypassed)
            for i in gated:
                i = int(i)
                dt = float(dtr[i])
                w = max(float(self._parked_w[i]), 0.0)
                self._book_infra(i, _IDLE, w * dt, dt, w)
                self._meter_now[i] += dt
        pending = np.nonzero((self._state != _ACTIVE)
                             & (self._state != _GATED))[0]
        for i in pending:
            i = int(i)
            st = int(self._state[i])
            action = None
            if st == _WAKING:
                if self.steps >= self._wake_done[i]:
                    self._begin_probation(i)
                    action = "probe"
            elif st == _PROBATION and self._canary[i] >= 0:
                c = int(self._canary[i])
                if self.r_finished[c]:
                    self._state[i] = _ACTIVE
                    self._since[i] = self.steps
                    self._canary[i] = -1
                    action = "admit"
                elif self.steps - self._canary_step[i] >= \
                        self.plan.states.canary_timeout_steps:
                    self._canary_step[i] = self.steps
                    if self._apply_regate(i):
                        action = "regate"
            if action is not None:
                self._emit_probe_event(i, action)
        mx = obs.METRICS
        if mx.enabled:
            mx.gauge("active_nodes", "routable (ACTIVE) nodes").set(
                int((self._state == _ACTIVE).sum()))
        if self.steps % self.plan.plan_every == 0:
            self._plan()

    def _emit_probe_event(self, i: int, action: str) -> None:
        self.events.append(PlacementEvent(
            step=self.steps, detected_step=self.steps, node=self.names[i],
            action=action, rate=self.forecaster.rate(now=self.steps),
            reason=f"probe policy ({_STATE_NAME[int(self._state[i])]})"))
        mx = obs.METRICS
        if mx.enabled:
            mx.counter("placement_events_total",
                       "gate/wake/probe/admit/regate decisions").inc()

    def _begin_probation(self, i: int) -> None:
        self._state[i] = _PROBATION
        self._since[i] = self.steps
        self._canary[i] = -1
        self._loop_parked[i] = False
        # ServeLoop.unpark resets the idle mark: the parked stretch was
        # the planner's to book, not the loop's
        self._t_mark[i] = np.nan

    def _apply_regate(self, i: int) -> bool:
        others = ~self._loop_parked
        others[i] = False           # scratch view is recomputed per call
        if not others.any():
            return False
        self._loop_parked[i] = True
        moved = self._drain(i)
        for j in moved:
            self._node_submit(self._route(j, exclude=i), j)
        self._state[i] = _GATED
        self._since[i] = self.steps
        self._canary[i] = -1
        return True

    def _service_steps(self) -> float:
        pol = self.plan
        if pol.service_steps > 0:
            return pol.service_steps
        done = [t for toks in self._finished_tokens
                for t in toks[-32:] if t]
        if done:
            recent = done[-32:]
            return max(sum(recent) / len(recent), 1.0)
        return 16.0

    def _gate_pays(self, i: int, dtr) -> bool:
        saved_w = float(self._floor_w[i]) - float(self._parked_w[i])
        horizon_s = float(dtr[i]) * self.plan.horizon_steps
        return saved_w * horizon_s > self.plan.states.boot_energy_ws

    def _plan(self) -> None:
        pol = self.plan
        ranked = sorted(range(self.n),
                        key=lambda i: (float(self._floor_w[i]),
                                       _STATE_ORDER[int(self._state[i])],
                                       self.names[i]))
        service = self._service_steps()
        rate = self.forecaster.rate(now=self.steps)
        backlog = int(self._queued.sum()) + int(self._occupied.sum())
        k, lq = self.n, 0.0
        slots_cum = np.cumsum(self._slots[ranked])
        for i in range(pol.min_active, self.n + 1):
            slots = int(slots_cum[i - 1])
            lq = self.forecaster.expected_queue_depth(
                slots, service, now=self.steps, horizon=pol.horizon_steps)
            if max(lq, backlog - slots) <= pol.slo_queue_depth:
                k = i
                break
        keep = set(ranked[:k])
        tr = obs.TRACER
        if tr.enabled:
            tr.instant("power.plan",
                       tags={"step": self.steps, "rate": rate, "lq": lq,
                             "active_target": k, "backlog": backlog})
        for i in list(self._plan_pending):
            if (self._plan_pending[i]["action"] == "gate") == (i in keep):
                del self._plan_pending[i]
        dtr = np.maximum(self._recent_dt(), 1e-9)
        for i in ranked:
            wanted = i in keep
            st = int(self._state[i])
            if wanted and st == _GATED:
                self._park_pending(i, "wake", rate, lq, k)
            elif (not wanted and pol.mode == "gate"
                  and st in (_ACTIVE, _PROBATION)
                  and self.steps - self._since[i] >= pol.min_active_steps
                  and self._gate_pays(i, dtr)):
                self._park_pending(i, "gate", rate, lq, k)

    def _park_pending(self, i: int, action: str, rate: float, lq: float,
                      k: int) -> None:
        if i in self._plan_pending:
            return
        self._plan_pending[i] = {"detected": self.steps, "action": action,
                                 "rate": rate, "lq": lq, "k": k}

    def _wake(self, i: int) -> None:
        self._state[i] = _WAKING
        self._since[i] = self.steps
        self._wake_done[i] = self.steps + self.plan.states.warmup_steps
        dtr = max(float(self._recent_dt()[i]), 1e-9)
        warmup_s = max(self.plan.states.warmup_steps, 1) * dtr
        w = max(float(self.plan.states.boot_energy_ws / warmup_s), 0.0)
        self._book_infra(i, _TRANS, w * warmup_s, warmup_s, w)
        self._meter_now[i] += warmup_s

    def _checkpoint(self) -> None:
        if self.plan is None or not self._plan_pending:
            return
        parked, self._plan_pending = self._plan_pending, {}
        applied = []
        for i, p in parked.items():
            st = int(self._state[i])
            if p["action"] == "gate":
                if st not in (_ACTIVE, _PROBATION):
                    continue
                active_after = (self._state == _ACTIVE) \
                    & ~self._loop_parked
                active_after[i] = False
                if int(active_after.sum()) < self.plan.min_active:
                    continue
                self._loop_parked[i] = True
                moved = self._drain(i)
                for j in moved:
                    self._node_submit(self._route(j, exclude=i), j)
                self._state[i] = _GATED
                self._since[i] = self.steps
                self._canary[i] = -1
                applied.append(PlacementEvent(
                    step=self.steps, detected_step=p["detected"],
                    node=self.names[i], action="gate", rate=p["rate"],
                    queue_depth_est=p["lq"], active_target=p["k"],
                    moved_rids=tuple(int(self.r_rid[j]) for j in moved),
                    reason="consolidate: forecast met by fewer nodes"))
            elif p["action"] == "wake":
                if st != _GATED:
                    continue
                self._wake(i)
                applied.append(PlacementEvent(
                    step=self.steps, detected_step=p["detected"],
                    node=self.names[i], action="wake", rate=p["rate"],
                    queue_depth_est=p["lq"], active_target=p["k"],
                    reason="forecast demand exceeds the active set"))
        self.events.extend(applied)
        if applied:
            mx = obs.METRICS
            if mx.enabled:
                mx.counter("placement_events_total",
                           "gate/wake/probe/admit/regate decisions"
                           ).inc(len(applied))

    # ------------------------------------------------------------------
    # the run
    # ------------------------------------------------------------------

    @property
    def _has_work(self) -> bool:
        return bool(np.any((self._occupied > 0)
                           | ((self._queued > 0) & ~self._loop_parked)))

    def _begin_run(self, arrivals, arrival_every: int = 1) -> int:
        """Shared run prologue: single-shot guard, request-array setup.
        Returns the request count."""
        if self._ran:
            raise RuntimeError("VectorFleet.run is single-shot — build a "
                               "fresh fleet per run")
        self._ran = True
        arr = arrivals if isinstance(arrivals, VectorArrivals) \
            else VectorArrivals.from_requests(arrivals, arrival_every)
        self._init_cells(arr)
        n_req = len(arr)
        self.r_due = arr.due
        self.r_rid = arr.rid
        self.r_tenant = arr.tenant_idx
        self.r_plen = arr.prompt_len
        self.r_max_new = arr.max_new
        self.r_done_tokens = arr.tokens_done.copy()
        self.r_finished = np.zeros(n_req, bool)
        self.r_admitted = np.ones(n_req, bool)
        self.r_node = np.full(n_req, -1, np.int64)
        self.r_slot = np.full(n_req, -1, np.int64)
        self.r_enq_t = np.zeros(n_req)
        self.r_queue_wait = np.zeros(n_req)
        self.r_prefill_ws = np.zeros(n_req)
        self.r_decode_ws = np.zeros(n_req)
        self.r_fill_busy = np.zeros(n_req, np.int64)
        self.r_fill_cum = np.zeros(n_req)
        self.r_finish_key = np.zeros(n_req, np.int64)
        self._finished_idx: list = []
        self.profile = obs.PhaseProfiler()
        self._flight_begin()
        return n_req

    # -- flight recorder: time-series snapshots -----------------------

    def _flight_begin(self) -> None:
        """Arm the snapshot cadence when a live ``FlightRecorder`` with
        ``snapshot_every > 0`` is installed; ``self._flight`` doubles as
        the hot-loop guard (one ``is not None`` per iteration)."""
        fl = obs.FLIGHT
        self._flight = fl if (fl.enabled and fl.snapshot_every > 0) \
            else None
        self._next_snap = fl.snapshot_every if self._flight is not None \
            else (1 << 62)
        self._snap_arrivals_mark = 0

    def _flight_snapshot(self) -> None:
        """Record one flight-log row at the current fleet step.  All the
        inputs are O(n) array reductions over state the engines keep
        anyway, so a snapshot costs microseconds and never perturbs the
        energy account."""
        fl = self._flight
        occ = np.minimum(self._occupied, self._slots)
        w = self._occ_w[self._iota, occ]
        if self.plan is not None:
            active = int((self._state == _ACTIVE).sum())
            w = np.where(self._state == _GATED,
                         np.maximum(self._parked_w, 0.0), w)
        else:
            active = self.n - int(self._loop_parked.sum())
        cum = float(self._phase_ws.sum())
        gm = getattr(self, "_gate_mark", None)
        if gm is not None:
            # segment engines defer gated bookings to wake/finalize;
            # fold the pending parked draw in so the curve stays smooth
            live = gm >= 0
            if live.any():
                dtr = np.maximum(self._recent_dt(), 1e-9)
                cum += float((np.maximum(self._parked_w, 0.0) * dtr
                              * (self.steps - gm))[live].sum())
        fl.record({"t": int(self.steps), "active_nodes": active,
                   "aggregate_watts": float(w.sum()),
                   "queue_depth": int(self._queued.sum()),
                   "cumulative_ws": cum,
                   "arrivals_in_window":
                       int(self._n_arrivals - self._snap_arrivals_mark)})
        self._snap_arrivals_mark = self._n_arrivals
        while self._next_snap <= self.steps:
            self._next_snap += fl.snapshot_every

    def run(self, arrivals, max_steps: int = 10_000,
            arrival_every: int = 1) -> list:
        """Serve one arrival stream to completion; returns the finished
        request ids sorted by rid.  Single-shot: the dense cell tensor
        is an append-only account of exactly one run."""
        n_req = self._begin_run(arrivals, arrival_every)
        due = self.r_due
        idx = 0
        for _ in range(max_steps):
            if idx >= n_req and not self._has_work:
                break
            while idx < n_req and due[idx] <= self.steps:
                self._submit(idx)
                idx += 1
            self._step()
            if self._flight is not None and self.steps >= self._next_snap:
                self._flight_snapshot()
        self._finalize()
        return sorted(int(self.r_rid[j]) for j in self._finished_idx)

    def _finalize(self) -> None:
        """Fold the dense cells into a real ``EnergyLedger`` and emit
        the aggregate observability edges."""
        led = EnergyLedger()
        for p, phase in enumerate(PHASES):
            if self._phase_n[p] == 0 and self._phase_ws[p] == 0.0:
                continue
            led.phases[phase] = PhaseEnergy(
                ws=float(self._phase_ws[p]),
                seconds=float(self._phase_s[p]),
                count=int(self._phase_n[p]),
                peak_w=float(self._phase_peak[p]))
        booked = np.nonzero(self._cell_n.sum(axis=(1, 2)) > 0)[0]
        for i in booked:
            led.nodes[self.names[int(i)]] = float(self._node_ws[i])
        for i, t, p in zip(*np.nonzero(self._cell_n)):
            i, t, p = int(i), int(t), int(p)
            led.cells[(self.names[i], self.tenant_names[t], PHASES[p])] = \
                PhaseEnergy(ws=float(self._cell_ws[i, t, p]),
                            seconds=float(self._cell_s[i, t, p]),
                            count=int(self._cell_n[i, t, p]),
                            peak_w=float(self._cell_peak[i, t, p]))
        self.ledger = led
        tr = obs.TRACER
        if tr.enabled:
            # one bulk append for the whole (node, phase) aggregate grid
            # instead of one tracer call per span
            n_np = self._cell_n.sum(axis=1)         # [n, 4]
            ws_np = self._cell_ws.sum(axis=1)
            s_np = self._cell_s.sum(axis=1)
            ii, pp = np.nonzero(n_np > 0)           # row-major: node, phase
            tr.add_spans([
                obs.Span(name=f"vector.{PHASES[p]}", node=self.names[i],
                         t0=0.0, t1=max(float(s_np[i, p]), 0.0),
                         tags={"phase": PHASES[p],
                               "ws": float(ws_np[i, p])})
                for i, p in zip(ii.tolist(), pp.tolist())])
            self._emit_sampled_requests(tr)
        mx = obs.METRICS
        if mx.enabled:
            mx.counter("fleet_steps_total", "fleet scheduler steps"
                       ).add(self.steps)
            mx.counter("arrivals_total", "submits offered to the fleet"
                       ).add(self._n_arrivals)
        if self._flight is not None and \
                (not self._flight.snapshots
                 or self._flight.snapshots[-1]["t"] < self.steps):
            self._flight_snapshot()     # close the curve at run end

    def _emit_sampled_requests(self, tr) -> None:
        """Emit ``serve.request`` span trees for the head-sampled slice
        of routed requests, with exact per-request booked Ws as the
        attribution weights, and note the per-request energy envelope
        the sampled scale-up needs for its error bound."""
        fl = obs.FLIGHT
        if not fl.enabled or not self.tenant_names:
            return
        routed = self.r_node >= 0
        req_ws = self.r_prefill_ws + self.r_decode_ws
        if routed.any():
            fl.note_population(int(routed.sum()),
                               float(req_ws[routed].min()),
                               float(req_ws[routed].max()))
        else:
            fl.note_population(0, 0.0, 0.0)
        picked = np.nonzero(routed & fl.sample_mask(self.r_rid))[0]
        if not picked.size:
            return
        roots, kids = [], []
        for j in picked.tolist():
            i = int(self.r_node[j])
            node = self.names[i]
            rid = int(self.r_rid[j])
            tenant = self.tenant_names[int(self.r_tenant[j])]
            tick = float(self._tick[i])
            t0 = float(self.r_enq_t[j])
            p0 = t0 + float(self.r_queue_wait[j])
            p1 = p0 + tick              # serve-model prefill window
            d1 = p1 + max(int(self.r_done_tokens[j]), 0) * tick
            roots.append(obs.Span(
                name="serve.request", node=node, t0=t0, t1=d1,
                tags={"rid": rid, "tenant": tenant, "sampled": True}))
            kids.append((j, node, rid, tenant, t0, p0, p1, d1))
        stored_roots = tr.add_spans(roots)
        batch = []
        for root, (j, node, rid, tenant, t0, p0, p1, d1) in \
                zip(roots, kids):
            pid = root.span_id
            batch.append(obs.Span(
                name="serve.queue_wait", node=node, t0=t0, t1=p0,
                parent_id=pid, tags={"rid": rid, "sampled": True}))
            batch.append(obs.Span(
                name="serve.prefill", node=node, t0=p0, t1=p1,
                parent_id=pid,
                tags={"rid": rid, "tenant": tenant, "phase": "prefill",
                      "ws": float(self.r_prefill_ws[j]),
                      "sampled": True}))
            batch.append(obs.Span(
                name="serve.decode", node=node, t0=p1, t1=d1,
                parent_id=pid,
                tags={"rid": rid, "tenant": tenant, "phase": "decode",
                      "ws": float(self.r_decode_ws[j]),
                      "sampled": True}))
        fl.sampled_spans += stored_roots + tr.add_spans(batch)

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------

    @property
    def total_ws(self) -> float:
        return float(self._phase_ws.sum()) if self.tenant_names else 0.0

    def results(self) -> list:
        """Per-request outcome rows, sorted by rid."""
        order = np.argsort(self.r_rid, kind="stable")
        rows = []
        for j in order:
            j = int(j)
            rows.append({
                "rid": int(self.r_rid[j]),
                "tenant": self.tenant_names[int(self.r_tenant[j])],
                "admitted": bool(self.r_admitted[j]),
                "finished": bool(self.r_finished[j]),
                "tokens": int(self.r_done_tokens[j]),
                "node": (self.names[int(self.r_node[j])]
                         if self.r_node[j] >= 0 else None),
                "queue_wait_s": float(self.r_queue_wait[j]),
                "prefill_ws": float(self.r_prefill_ws[j]),
                "decode_ws": float(self.r_decode_ws[j]),
            })
        return rows

    def summary(self) -> dict:
        doc = {"engine": "vector", "loop_model": self.loop_model,
               "steps": self.steps,
               "total_ws": self.ledger.total_ws,
               "router": self.policy.router,
               "arrivals": self._n_arrivals,
               "finished": int(self.r_finished.sum())
               if self.tenant_names else 0,
               "nodes": [{"name": self.names[i],
                          "slots": int(self._slots[i]),
                          "occupied": int(self._occupied[i]),
                          "queued": int(self._queued[i]),
                          "parked": bool(self._loop_parked[i]),
                          "served": len(self._served[i]),
                          "total_ws": float(self._node_ws[i])
                          if self.tenant_names else 0.0}
                         for i in range(self.n)]}
        if self.profile.seconds:
            doc["profile"] = self.profile.to_dict()
        if self.admission is not None:
            doc["admission"] = self.admission.summary(self._ledger_view)
        if self.plan is not None:
            doc["placement"] = {
                "mode": self.plan.mode,
                "slo_queue_depth": self.plan.slo_queue_depth,
                "max_queue_depth": self.max_queue_depth,
                "states": {self.names[i]:
                           _STATE_NAME[int(self._state[i])]
                           for i in range(self.n)},
                "forecast": self.forecaster.summary(),
                "events": [e.to_dict() for e in self.events]}
        return doc

"""Arrival forecasting — pricing *sustained* load, not the next request.

The energy router's ``marginal_ws_per_token`` is one-step-ahead: it prices
the request in hand against the fleet's current occupancy.  That is the
right signal for dispatch but the wrong one for *placement* — whether a
node should be powered at all depends on the traffic of the next planning
window, not of the next step.  ``ArrivalForecaster`` supplies that signal:

  * an EWMA over the inter-arrival gaps of recent submits estimates the
    offered rate.  Between arrivals the estimate *decays*: the effective
    gap is at least the time since the last arrival, so a trough reads as
    a falling rate even though no new observation lands (the property
    that lets the consolidation planner gate nodes during quiet hours);
  * an M/M/c-style queueing estimate (Erlang C) turns that rate plus a
    per-request service time into the expected steady-state queue depth
    for a candidate server count — the number the planner holds against
    its queue-depth SLO.  An overloaded candidate (utilization >= 1) has
    no steady state; the estimate falls back to the linear backlog growth
    over the planning horizon, which is large but *finite* — every output
    of this module is finite and non-negative by construction.

Time is whatever the caller passes to ``observe`` — the fleet scheduler
feeds fleet steps, so rates are requests/step and service times are
steps/request.  Copy of ``repro.fleet.power.forecast``, numpy throughout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

#: floors that keep every estimate finite whatever the inputs
_MIN_GAP = 1e-6
_MIN_SERVICE = 1e-6


@dataclass
class ArrivalForecaster:
    """EWMA inter-arrival estimator + Erlang-C queue-depth forecast."""
    alpha: float = 0.3          # EWMA weight on the newest gap
    prior_gap: float = 64.0     # assumed inter-arrival until warm
    _gap_ewma: float = field(default=0.0, init=False)
    _last_t: float = field(default=0.0, init=False)
    _n: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        self.prior_gap = max(float(self.prior_gap), _MIN_GAP)

    # -- observation ---------------------------------------------------------

    def observe(self, t: float) -> None:
        """Record one submit at time ``t``.  Out-of-order or duplicate
        timestamps clamp to the minimum gap rather than corrupting the
        EWMA — a forecast must survive whatever the scheduler feeds it.

        Gaps are also winsorized at ``prior_gap``: the silence before the
        first arrival of a burst measures the *trough*, not the burst's
        inter-arrival time, and folding one enormous gap into the EWMA
        would blind the forecast for the first half of the burst (the
        decaying ``gap(now)`` already prices long silences)."""
        t = float(t)
        if not math.isfinite(t):
            return
        if self._n > 0:
            gap = min(max(t - self._last_t, _MIN_GAP), self.prior_gap)
            self._gap_ewma += self.alpha * (gap - self._gap_ewma)
        else:
            self._gap_ewma = self.prior_gap
        self._last_t = max(t, self._last_t)
        self._n += 1

    # -- rate ----------------------------------------------------------------

    def gap(self, now: float | None = None) -> float:
        """Expected inter-arrival time.  With ``now`` the estimate decays
        through a trough: the gap is at least the silence since the last
        arrival (an EWMA over gaps alone never updates when traffic
        stops, which would hold stale burst rates forever)."""
        g = self._gap_ewma if self._n > 0 else self.prior_gap
        if now is not None and self._n > 0 and math.isfinite(now):
            g = max(g, float(now) - self._last_t)
        return max(g, _MIN_GAP)

    def rate(self, now: float | None = None) -> float:
        """Forecast arrival rate (requests per time unit); finite, >= 0."""
        return 1.0 / self.gap(now)

    # -- M/M/c queue depth (the router-horizon closure) ----------------------

    @staticmethod
    def _erlang_c(servers: int, offered: float) -> float:
        """P(wait) for M/M/c at ``offered`` erlangs (< servers).

        Computed with the iterative term ratio (term_k = a^k/k!) so no
        intermediate overflows even for large server counts.  The ratio
        chain is a cumprod and the partial sum a cumsum seeded with the
        k=0 term — both sequential reductions, so each float lands on
        the exact bit pattern the scalar loop produced."""
        if servers > 1:
            terms = np.cumprod(offered / np.arange(1, servers,
                                                   dtype=np.float64))
            partial = float(np.cumsum(
                np.concatenate(([1.0], terms)))[-1])
            term = float(terms[-1])
        else:
            term = 1.0                  # a^0/0!
            partial = 1.0               # sum_{k<1}
        term *= offered / servers       # a^c/c!
        rho = offered / servers
        last = term / max(1.0 - rho, _MIN_GAP)
        denom = partial + last
        if denom <= 0.0 or not math.isfinite(denom):
            return 1.0
        return min(max(last / denom, 0.0), 1.0)

    def expected_queue_depth(self, servers: int, service_time: float,
                             now: float | None = None,
                             horizon: float = 64.0) -> float:
        """Steady-state expected queue length Lq for ``servers`` slots
        each taking ``service_time`` per request, at the forecast rate.

        Overload (utilization >= 1) has no steady state, so the forecast
        is not Lq but a *saturation price*: one full horizon of arrivals
        plus the backlog the excess rate accumulates over it,
        ``(rate - capacity) * horizon``.  It grows with the rate, always
        dwarfs a queue-depth SLO, and — unlike extending the Erlang-C
        curve — never pretends a saturated set has a finite queue.
        Always finite, >= 0.
        """
        servers = max(int(servers), 1)
        service_time = max(float(service_time), _MIN_SERVICE)
        horizon = max(float(horizon), 0.0)
        lam = self.rate(now)
        mu = 1.0 / service_time
        offered = lam / mu              # erlangs
        rho = offered / servers
        if rho >= 1.0:
            h = max(horizon, 1.0)
            return lam * h + max((lam - servers * mu) * h, 0.0)
        p_wait = self._erlang_c(servers, offered)
        lq = p_wait * rho / max(1.0 - rho, _MIN_GAP)
        if not math.isfinite(lq):
            return horizon / service_time
        return max(lq, 0.0)

    def expected_queue_depth_many(self, servers, service_time: float,
                                  now: float | None = None,
                                  horizon: float = 64.0):
        """``expected_queue_depth`` for a whole array of server counts
        in one sweep — bit-identical per element to the scalar call.

        All candidate counts share one term chain: the scalar
        Erlang-C's sequential ``term *= offered/k`` multiplies are the
        prefixes of a single cumprod, and its ``partial += term`` adds
        the prefixes of a single cumsum, so evaluating every candidate
        costs one O(max servers) pass instead of O(sum of servers).
        The planner's ranked k-search gathers from this sweep."""
        servers = np.maximum(np.asarray(servers, np.int64), 1)
        if servers.size == 0:
            return np.zeros(0)
        service_time = max(float(service_time), _MIN_SERVICE)
        horizon = max(float(horizon), 0.0)
        lam = self.rate(now)
        mu = 1.0 / service_time
        offered = lam / mu
        c_max = int(servers.max())
        terms = (np.cumprod(offered / np.arange(1, c_max,
                                                dtype=np.float64))
                 if c_max > 1 else np.zeros(0))
        partial_all = np.cumsum(np.concatenate(([1.0], terms)))
        partial = partial_all[servers - 1]
        term = (np.where(servers > 1, terms[np.maximum(servers - 2, 0)],
                         1.0)
                if terms.size else np.ones(servers.shape))
        term = term * (offered / servers)
        rho = offered / servers
        last = term / np.maximum(1.0 - rho, _MIN_GAP)
        denom = partial + last
        p_wait = np.where((denom <= 0.0) | ~np.isfinite(denom), 1.0,
                          np.minimum(np.maximum(
                              last / np.where(denom != 0.0, denom, 1.0),
                              0.0), 1.0))
        lq = p_wait * rho / np.maximum(1.0 - rho, _MIN_GAP)
        lq = np.where(np.isfinite(lq), np.maximum(lq, 0.0),
                      horizon / service_time)
        h = max(horizon, 1.0)
        sat = lam * h + np.maximum((lam - servers * mu) * h, 0.0)
        return np.where(rho >= 1.0, sat, lq)

    def utilization(self, servers: int, service_time: float,
                    now: float | None = None) -> float:
        """Forecast offered load per server (rho); finite, >= 0."""
        servers = max(int(servers), 1)
        service_time = max(float(service_time), _MIN_SERVICE)
        return self.rate(now) * service_time / servers

    def summary(self) -> dict:
        return {"arrivals": self._n, "gap_ewma": self.gap(),
                "rate": self.rate()}

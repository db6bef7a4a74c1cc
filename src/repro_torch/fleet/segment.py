"""``repro_torch.fleet.segment`` — the event-horizon segment engine.

Copy of ``repro.fleet.segment``, with the reference's jax booking backend
replaced by the torch one.

``VectorFleet.run`` advances the fleet one step at a time: every tick
pays the full per-step Python cost (fill loops, finish-dict pops, the
per-gated-node planner booking) even when nothing is due, finishing,
or crossing a planner boundary.  This module keeps the stepped engine
as the pinned reference and subclasses it with a dispatcher that walks
**events**, not steps:

  * between consecutive interesting steps — next arrival due, earliest
    slot finish, a fill becoming possible, a plan/checkpoint boundary,
    a wake completing, a canary timing out — node occupancy is
    constant, so the idle/busy Ws booking, token progress and meter
    advance for the whole quiet stretch collapse into one batched
    array update (``_advance``);
  * the interesting steps themselves run through a flat live step
    whose fills, finishes and gated-node bookings are vectorized
    across nodes (no per-node Python iteration survives: the deque
    queues become one ring buffer, the slot lists one ``[n, s_max]``
    array, the finish dicts one next-finish key per node).

Equivalence contract (pinned by ``tests/test_torch_fleet_vector.py``
against the reference's engines): total and per-(node, tenant,
phase) cells within 1e-6 relative of the stepped reference, identical
placement-event sequences, identical finished sets and token counts.
Integer state (occupancy, tokens, counts, event steps) is exact; the
only drift is closed-form clock arithmetic (``k`` tick windows booked
as ``k * tick`` instead of ``k`` sequential roundings), ~1e-12
relative over million-step runs.

``backend="torch"`` defers the decode/idle booking plane to chunked
folds on a device (``repro_torch.fleet.torch_backend``: the card unless
``device`` names the CPU); control flow stays eager numpy either way, so
both backends emit the same events.  A torch backend that cannot reach
its device raises: nothing falls back to numpy.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch import obs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.torch_backend import TorchAccumulator
from repro_torch.fleet.vector import (_ACTIVE, _DEC, _GATED, _IDLE, _NO_CAP,
                                _PRE, _PROBATION, _WAKING, VectorFleet)

_NO_KEY = 1 << 62                   # next-finish sentinel: nothing occupied


class NumpyAccumulator:
    """Eager booking plane: applies each record with the same numpy
    operations the stepped engine's ``_step`` uses."""

    def __init__(self, fleet):
        self.f = fleet

    def book_dec(self, bi, cnt, tcell, scell, w, dt, ws, k, wmax):
        f = self.f
        f._cell_ws[bi, :, _DEC] += tcell
        f._cell_s[bi, :, _DEC] += scell
        f._cell_n[bi, :, _DEC] += cnt * k
        pk = f._cell_peak[bi, :, _DEC]
        f._cell_peak[bi, :, _DEC] = \
            np.where(cnt > 0, np.maximum(pk, w[:, None]), pk)
        f._phase_ws[_DEC] += ws.sum()
        f._phase_s[_DEC] += dt.sum()
        f._phase_n[_DEC] += bi.size * k
        if wmax > f._phase_peak[_DEC]:
            f._phase_peak[_DEC] = wmax
        f._node_ws[bi] += ws

    def book_idle(self, ii, w, dt, ws, k, wmax):
        f = self.f
        f._cell_ws[ii, f._infra, _IDLE] += ws
        f._cell_s[ii, f._infra, _IDLE] += dt
        f._cell_n[ii, f._infra, _IDLE] += k
        f._cell_peak[ii, f._infra, _IDLE] = np.maximum(
            f._cell_peak[ii, f._infra, _IDLE], w)
        f._phase_ws[_IDLE] += ws.sum()
        f._phase_s[_IDLE] += dt.sum()
        f._phase_n[_IDLE] += ii.size * k
        if wmax > f._phase_peak[_IDLE]:
            f._phase_peak[_IDLE] = wmax
        f._node_ws[ii] += ws

    def finalize(self):
        pass


class SegmentFleet(VectorFleet):
    """The stepped ``VectorFleet`` re-run as an event walk.

    Same construction surface plus ``backend``: ``"numpy"`` (eager
    booking) or ``"torch"`` (deferred chunked folds on ``device``: the
    card by default, which raises without one).  ``run`` produces the
    same ledger, placement events and finished set as the stepped
    parent on the same script.
    """

    def __init__(self, specs, policy=None, plan=None, admission=None,
                 forecaster=None, loop_model: str = "serve",
                 backend: str = "numpy", device: DeviceLike = None):
        super().__init__(specs, policy=policy, plan=plan,
                         admission=admission, forecaster=forecaster,
                         loop_model=loop_model)
        if backend not in ("numpy", "torch"):
            raise ValueError("backend must be 'numpy' or 'torch', got "
                             f"{backend!r}")
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" \
            else None
        n = self.n
        s_max = int(self._slots.max())
        # flat slot table: -1 free, -2 beyond this node's slot count
        self._slot_buf = np.full((n, s_max), -2, np.int64)
        self._slot_buf[np.arange(s_max)[None, :] < self._slots[:, None]] = -1
        # one ring buffer for every queue (doubling growth, re-laid out
        # to head 0 so wrap stays a single modulo)
        self._q_cap = 8
        self._q_buf = np.full((n, self._q_cap), -1, np.int64)
        self._q_head = np.zeros(n, np.int64)
        # earliest finish key (busy-step count at finish) per node
        self._nf_key = np.full(n, _NO_KEY, np.int64)
        self._fill_seq = 0              # global fill order stamp
        self._masks_dirty = True        # routing mask cache validity
        # gated-draw deferral: last step already booked, -1 = not gated
        # (while gated both the parked watts and the recent-dt seconds
        # are frozen, so the whole episode books as one scaled record)
        self._gate_mark = np.full(n, -1, np.int64)
        self._defer_gated = True
        self._acc = None

    # ------------------------------------------------------------------
    # flat queue / slot state
    # ------------------------------------------------------------------

    def _grow_ring(self) -> None:
        old, oldcap = self._q_buf, self._q_cap
        cap = oldcap * 2
        new = np.full((self.n, cap), -1, np.int64)
        idx = (self._q_head[:, None] + np.arange(oldcap)[None, :]) % oldcap
        new[:, :oldcap] = np.take_along_axis(old, idx, axis=1)
        self._q_buf = new
        self._q_cap = cap
        self._q_head[:] = 0

    def _node_submit(self, i: int, j: int) -> None:
        self._served[i].add(j)
        self.r_enq_t[j] = self._meter_now[i]
        depth = int(self._queued[i])
        if depth >= self._q_cap:
            self._grow_ring()
        self._q_buf[i, (int(self._q_head[i]) + depth) % self._q_cap] = j
        self._queued[i] += 1
        self.r_node[j] = i
        if self._marg is not None:
            self._marg[i] = self._marginal_one(i)

    def _drain(self, i: int) -> list:
        self._marg = None
        self._masks_dirty = True
        depth = int(self._queued[i])
        head = int(self._q_head[i])
        cap = self._q_cap
        moved = [int(self._q_buf[i, (head + p) % cap]) for p in range(depth)]
        self._queued[i] = 0
        self._q_head[i] = 0
        row = self._slot_buf[i]
        for s in range(int(self._slots[i])):
            j = int(row[s])
            if j < 0:
                continue
            moved.append(j)
            row[s] = -1
            self.r_slot[j] = -1
            self.r_done_tokens[j] += \
                self._busy_steps[i] - self.r_fill_busy[j]
            self.r_decode_ws[j] += \
                self._decode_share_cum[i] - self.r_fill_cum[j]
            self._active_t[i, int(self.r_tenant[j])] -= 1
        self._occupied[i] = 0
        self._nf_key[i] = _NO_KEY
        return moved

    # ------------------------------------------------------------------
    # routing with cached masks
    # ------------------------------------------------------------------

    def _begin_probation(self, i: int) -> None:
        super()._begin_probation(i)
        self._masks_dirty = True

    def _wake(self, i: int) -> None:
        # settle the deferred gated episode before the boot-energy
        # booking advances this node's meter
        if self._gate_mark[i] >= 0:
            self._flush_gated(np.array([i], np.int64))
        super()._wake(i)
        self._masks_dirty = True

    def _plan(self) -> None:
        """The reference ranked k-search with the rank and the Erlang
        sweep vectorized: one lexsort replaces the Python ``sorted``
        (identical total order — name rank is the lexicographic rank)
        and one ``expected_queue_depth_many`` sweep prices every
        candidate active-set size at once.  The first size satisfying
        the SLO — found by boolean argmax — is exactly the size the
        reference's linear scan breaks on."""
        pol = self.plan
        order = np.array([0, 2, 0, 0], np.int64)[self._state]
        ranked = np.lexsort((self._name_rank, order, self._floor_w))
        service = self._service_steps()
        rate = self.forecaster.rate(now=self.steps)
        backlog = int(self._queued.sum()) + int(self._occupied.sum())
        k, lq = self.n, 0.0
        slots_cum = np.cumsum(self._slots[ranked])
        cand = np.arange(pol.min_active, self.n + 1)
        if cand.size:
            scand = slots_cum[cand - 1]
            lqs = self.forecaster.expected_queue_depth_many(
                scand, service, now=self.steps, horizon=pol.horizon_steps)
            ok = np.maximum(lqs, (backlog - scand).astype(np.float64)) \
                <= pol.slo_queue_depth
            if ok.any():
                pos = int(np.argmax(ok))
                k = int(cand[pos])
                lq = float(lqs[pos])
            else:
                lq = float(lqs[-1])
        keep = set(ranked[:k].tolist())
        tr = obs.TRACER
        if tr.enabled:
            tr.instant("power.plan",
                       tags={"step": self.steps, "rate": rate, "lq": lq,
                             "active_target": k, "backlog": backlog})
        for i in list(self._plan_pending):
            if (self._plan_pending[i]["action"] == "gate") == (i in keep):
                del self._plan_pending[i]
        dtr = np.maximum(self._recent_dt(), 1e-9)
        for i in ranked.tolist():
            wanted = i in keep
            st = int(self._state[i])
            if wanted and st == _GATED:
                self._park_pending(i, "wake", rate, lq, k)
            elif (not wanted and pol.mode == "gate"
                  and st in (_ACTIVE, _PROBATION)
                  and self.steps - self._since[i] >= pol.min_active_steps
                  and self._gate_pays(i, dtr)):
                self._park_pending(i, "gate", rate, lq, k)

    def _rebuild_masks(self) -> None:
        healthy = ~self._loop_parked
        self._m_healthy_cnt = int(healthy.sum())
        if self.plan is not None:
            owed = healthy & (self._state == _PROBATION) & (self._canary < 0)
            ow = np.nonzero(owed)[0]
            self._m_owed_first = int(ow[0]) if ow.size else -1
            routable = healthy & (self._state == _ACTIVE)
            cand = routable if routable.any() else healthy
        else:
            self._m_owed_first = -1
            cand = healthy
        self._m_cand = cand
        self._m_cand_idxs = np.nonzero(cand)[0]
        self._masks_dirty = False

    def _route(self, j: int, exclude: int = -1) -> int:
        if exclude >= 0:
            # the drain-reroute path is rare; take the reference route
            # (it may claim a canary, so invalidate the mask cache)
            self._masks_dirty = True
            return super()._route(j, exclude)
        if self._masks_dirty:
            self._rebuild_masks()
        if self._m_healthy_cnt == 0:
            raise RuntimeError("no healthy node to route to (all parked)")
        chosen = -1
        cand_cnt = self._m_cand_idxs.size
        if self.plan is not None and self._m_owed_first >= 0:
            chosen = self._m_owed_first
            self._canary[chosen] = j
            self._canary_step[chosen] = self.steps
            self._masks_dirty = True
            cand_cnt = self._m_healthy_cnt  # reference counts healthy here
        if chosen < 0:
            if self.policy.router == "round_robin":
                idxs = self._m_cand_idxs
                chosen = int(idxs[self._rr % len(idxs)])
                self._rr += 1
            else:
                if self._marg is None:
                    self._marg = self._marginal()
                # gather only the candidate set: min/tie over the
                # compact view equals the reference's masked full-width
                # min (inf padding never wins a min or a tie)
                idxs = self._m_cand_idxs
                mc = self._marg[idxs]
                li = idxs[mc == mc.min()]
                if li.size > 1:
                    load = (self._occupied[li] + self._queued[li]) \
                        / np.maximum(self._slots[li], 1)
                    li = li[load == load.min()]
                chosen = int(li[np.argmin(self._name_rank[li])])
        tr = obs.TRACER
        if tr.enabled and not obs.FLIGHT.sampling:
            tr.instant("fleet.route",
                       tags={"rid": int(self.r_rid[j]),
                             "tenant": self.tenant_names[
                                 int(self.r_tenant[j])],
                             "node": self.names[chosen],
                             "step": self.steps,
                             "candidates": cand_cnt})
        mx = obs.METRICS
        if mx.enabled:
            from repro_torch.fleet.scheduler import _CANDIDATE_BUCKETS
            mx.histogram("routing_candidates", "nodes eligible per route",
                         buckets=_CANDIDATE_BUCKETS).observe(cand_cnt)
        return chosen

    # ------------------------------------------------------------------
    # batched fills and finishes
    # ------------------------------------------------------------------

    def _fill_nodes(self, fi) -> None:
        """Every pending fill across the fleet in one ragged batch:
        per node, FIFO queue order into lowest free slots first."""
        m = np.minimum(self._queued[fi], self._slots[fi] - self._occupied[fi])
        tot = int(m.sum())
        rows = np.repeat(fi, m)
        cum = np.cumsum(m)
        pos = np.arange(tot) - np.repeat(cum - m, m)
        cap = self._q_cap
        js = self._q_buf[rows, (self._q_head[rows] + pos) % cap]
        self._q_head[fi] = (self._q_head[fi] + m) % cap
        self._queued[fi] -= m
        # lowest free slots in order: stable-sort free-ness per row
        order = np.argsort(self._slot_buf[fi] != -1, axis=1, kind="stable")
        li = np.repeat(np.arange(fi.size), m)
        slots_for = order[li, pos]
        self._slot_buf[rows, slots_for] = js
        self.r_slot[js] = slots_for
        self._occupied[fi] += m
        tix = self.r_tenant[js]
        if self._serve:
            tickr = self._tick[rows]
            # meter at each fill = meter now + the prefill windows of
            # the fills ahead of it on the same node
            qw = np.maximum(
                self._meter_now[rows] + pos * tickr - self.r_enq_t[js], 0.0)
        else:
            qw = np.maximum(self._meter_now[rows] - self.r_enq_t[js], 0.0)
        self.r_queue_wait[js] += qw
        mx = obs.METRICS
        if mx.enabled:
            mx.histogram("queue_wait_s",
                         "meter-time queued before a slot"
                         ).observe_many(qw)
        if self._serve:
            w = self._w_pre[rows]
            ws = w * tickr
            np.add.at(self._cell_ws, (rows, tix, _PRE), ws)
            np.add.at(self._cell_s, (rows, tix, _PRE), tickr)
            np.add.at(self._cell_n, (rows, tix, _PRE), 1)
            # the reference peak update is `if w > peak` — NaN watt
            # points never write, so map them to -inf before maximum.at
            wpk = np.where(np.isnan(w), -np.inf, w)
            np.maximum.at(self._cell_peak, (rows, tix, _PRE), wpk)
            self._phase_ws[_PRE] += ws.sum()
            self._phase_s[_PRE] += tickr.sum()
            self._phase_n[_PRE] += tot
            wm = wpk.max()
            if wm > self._phase_peak[_PRE]:
                self._phase_peak[_PRE] = wm
            np.add.at(self._node_ws, rows, ws)
            np.add.at(self._tenant_ws, tix, ws)
            self.r_prefill_ws[js] += ws
            # the prefill clock brackets must replay per fill: the
            # clock seeds the decode dt chain the router's marginal
            # reads, where one ulp moves placement ties
            mm = int(m.max())
            c = self._clock[fi]
            tk = self._tick[fi]
            for p in range(mm):
                sel = m > p
                t1 = (c[sel] + tk[sel]) + tk[sel]
                c[sel] = t1
            self._clock[fi] = c
            self._meter_now[fi] += m * self._tick[fi]
        np.add.at(self._active_t, (rows, tix), 1)
        done = self.r_done_tokens[js]
        ktok = self.r_max_new[js] - done
        if self._serve:
            capped = self._max_seq[rows] < _NO_CAP
            if capped.any():
                lim = self._max_seq[rows] - self.r_plen[js] - done
                ktok = np.where(capped, np.minimum(ktok, lim), ktok)
        ktok = np.maximum(ktok, 1)
        key = self._busy_steps[rows] + ktok
        self.r_fill_busy[js] = self._busy_steps[rows]
        self.r_fill_cum[js] = self._decode_share_cum[rows]
        self.r_finish_key[js] = key
        self.r_fill_seq[js] = self._fill_seq + np.arange(tot)
        self._fill_seq += tot
        np.minimum.at(self._nf_key, rows, key)

    def _finish_nodes(self, fn) -> None:
        """All finishes on the nodes whose busy-step count just hit
        their next-finish key, in the stepped engine's order (node
        ascending, fill order within a node)."""
        buf = self._slot_buf[fn]
        occ = buf >= 0
        keys = np.where(occ, self.r_finish_key[np.maximum(buf, 0)], -1)
        hit = occ & (keys == self._busy_steps[fn][:, None])
        rows_l, cols = np.nonzero(hit)
        js = buf[rows_l, cols]
        nodes = fn[rows_l]
        order = np.lexsort((self.r_fill_seq[js], nodes))
        js = js[order]
        nodes = nodes[order]
        cols = cols[order]
        self.r_done_tokens[js] += self._busy_steps[nodes] \
            - self.r_fill_busy[js]
        self.r_decode_ws[js] += self._decode_share_cum[nodes] \
            - self.r_fill_cum[js]
        self.r_finished[js] = True
        self._slot_buf[nodes, cols] = -1
        self.r_slot[js] = -1
        np.subtract.at(self._occupied, nodes, 1)
        np.subtract.at(self._active_t, (nodes, self.r_tenant[js]), 1)
        for node, j in zip(nodes.tolist(), js.tolist()):
            self._finished_tokens[node].append(int(self.r_done_tokens[j]))
            self._finished_idx.append(j)
        buf2 = self._slot_buf[fn]
        occ2 = buf2 >= 0
        k2 = np.where(occ2, self.r_finish_key[np.maximum(buf2, 0)], _NO_KEY)
        self._nf_key[fn] = k2.min(axis=1)

    # ------------------------------------------------------------------
    # the live step and the quiet stretch
    # ------------------------------------------------------------------

    def _planner_tick_vec(self, k: int) -> None:
        """``_planner_tick`` over ``k`` steps: the gated-node parked
        draw is booked for all gated nodes and all ``k`` ticks in one
        array update; state transitions and plan boundaries only occur
        on live steps (``k == 1``) — the event walk guarantees no
        boundary falls inside a quiet stretch."""
        self.max_queue_depth = max(self.max_queue_depth,
                                   int(self._queued.sum()))
        if self._defer_gated:
            # stamp the step *before* a node's first gated tick; the
            # whole episode is booked at wake/finalize by _flush_gated
            fresh = (self._state == _GATED) & (self._gate_mark < 0)
            if fresh.any():
                self._gate_mark[fresh] = self.steps - k
        else:
            gated = np.nonzero(self._state == _GATED)[0]
            if gated.size:
                self._book_gated(gated, np.full(gated.size, k, np.int64))
        if k == 1:
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
                        self._masks_dirty = True
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
        if k == 1 and self.steps % self.plan.plan_every == 0:
            t0 = time.perf_counter()
            self._plan()
            self.profile.add("plan", time.perf_counter() - t0)

    def _book_gated(self, gi, kt) -> None:
        """Book ``kt[i]`` ticks of parked draw for gated nodes ``gi``
        with the stepped reference's per-tick quantities scaled by the
        tick count (draw and per-tick seconds are constant per gated
        episode — a gated node never decodes, so its recent-dt meter
        is frozen, and the parked override is a spec constant)."""
        dtr = np.maximum(self._recent_dt()[gi], 1e-9)
        w = np.maximum(self._parked_w[gi], 0.0)
        tot_dt = dtr * kt
        tot_ws = (w * dtr) * kt
        inf_t = self._infra
        self._cell_ws[gi, inf_t, _IDLE] += tot_ws
        self._cell_s[gi, inf_t, _IDLE] += tot_dt
        self._cell_n[gi, inf_t, _IDLE] += kt
        pk = self._cell_peak[gi, inf_t, _IDLE]
        self._cell_peak[gi, inf_t, _IDLE] = np.where(w > pk, w, pk)
        self._phase_ws[_IDLE] += tot_ws.sum()
        self._phase_s[_IDLE] += tot_dt.sum()
        self._phase_n[_IDLE] += int(kt.sum())
        wm = w.max()
        if wm > self._phase_peak[_IDLE]:
            self._phase_peak[_IDLE] = wm
        self._node_ws[gi] += tot_ws
        self._tenant_ws[inf_t] += tot_ws.sum()
        self._meter_now[gi] += tot_dt

    def _flush_gated(self, gi) -> None:
        """Settle the deferred gated episodes for nodes ``gi`` (marked
        in ``_gate_mark``) through the current step, then clear the
        marks.  Called on wake and at end of run."""
        kt = self.steps - self._gate_mark[gi]
        live = kt > 0
        if live.any():
            self._book_gated(gi[live], kt[live])
        self._gate_mark[gi] = -1

    def _step(self) -> None:
        """One live (interesting) step over the flat state — the
        stepped reference's ``_step`` with batched fills, keyed
        finishes and accumulator-routed decode/idle booking."""
        self.steps += 1
        self._marg = None
        planned = self.plan is not None
        has_work = (self._occupied > 0) | \
            ((self._queued > 0) & ~self._loop_parked)
        step_mask = has_work | ~self._loop_parked if planned else has_work
        fillable = step_mask & ~self._loop_parked & (self._queued > 0) \
            & (self._occupied < self._slots)
        fi = np.nonzero(fillable)[0]
        if fi.size:
            self._fill_nodes(fi)
        busy = step_mask & (self._occupied > 0)
        bi = np.nonzero(busy)[0]
        if bi.size:
            parts = self._occupied[bi]
            if self._serve:
                tick = self._tick[bi]
                t0 = self._clock[bi] + tick
                t1 = t0 + tick
                self._clock[bi] = t1
                dt = t1 - t0
                self._t_mark[bi] = t0 + dt
            else:
                dt = self._tick[bi]
            w = self._occ_w[bi, parts]
            ws = w * dt
            share = ws / parts
            cnt = self._active_t[bi]
            tcell = cnt * share[:, None]
            self._tenant_ws += tcell.sum(axis=0)
            self._acc.book_dec(bi, cnt, tcell, cnt * (dt / parts)[:, None],
                               w, dt, ws, 1, float(w.max()))
            self._decode_s[bi] += dt
            self._decode_n[bi] += 1
            self._decode_share_cum[bi] += share
            self._busy_steps[bi] += 1
            self._meter_now[bi] += dt
            self._steps_done[bi] += 1
            fin = self._busy_steps[bi] == self._nf_key[bi]
            if fin.any():
                self._finish_nodes(bi[fin])
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
                dt = np.where(fresh, dt_fresh, np.maximum(c1 - tm, 0.0))
                self._clock[ii] = np.where(fresh, c2, c1)
                self._t_mark[ii] = np.where(fresh, c1 + dt_fresh, c1)
            else:
                dt = self._tick[ii]
            w = self._w_idle[ii]
            ws = w * dt
            self._tenant_ws[self._infra] += ws.sum()
            self._acc.book_idle(ii, w, dt, ws, 1, float(w.max()))
            self._meter_now[ii] += dt
            self._steps_done[ii] += 1
        if planned:
            self._planner_tick_vec(1)
        if self.steps % self.policy.checkpoint_every == 0:
            self._checkpoint()

    def _advance(self, k: int) -> None:
        """``k`` quiet steps in one batched update.  Preconditions
        (guaranteed by ``_next_event``): no fill is possible, no slot
        finishes, no arrival lands, and no planner/checkpoint boundary
        or state-machine deadline falls within the stretch.

        The control-plane floats — ``_clock``/``_t_mark`` and the
        decode meters the energy router's marginal reads — must land
        on the stepped reference's exact bit patterns: with a large
        fleet of identical nodes the router breaks ties by float
        equality, so one ulp of closed-form drift would change
        *placement*, not just the bill.  Busy stretches replay the
        per-step float ops (they are short: the next slot finish
        bounds them).  Idle stretches use an exact closed form: within
        one binade the rounded increment ``fl(c + tick) - c`` is
        constant, so ``j`` iterated adds equal ``c + j*inc`` exactly —
        the stretch advances in per-binade chunks, one chunk per
        doubling of the clock.  Only the booking plane (accumulator
        records) is summed in batched arithmetic, inside the 1e-6
        equivalence budget."""
        self._marg = None           # decode meters move below
        planned = self.plan is not None
        has_work = (self._occupied > 0) | \
            ((self._queued > 0) & ~self._loop_parked)
        step_mask = has_work | ~self._loop_parked if planned else has_work
        busy = step_mask & (self._occupied > 0)
        bi = np.nonzero(busy)[0]
        if bi.size:
            parts = self._occupied[bi]
            tick = self._tick[bi]
            w = self._occ_w[bi, parts]
            c = self._clock[bi]
            d_s = self._decode_s[bi]
            shc = self._decode_share_cum[bi]
            dt = np.zeros(bi.size)
            for _ in range(k):      # k <= steps to the next finish
                if self._serve:
                    t0 = c + tick
                    t1 = t0 + tick
                    c = t1
                    dtp = t1 - t0
                else:
                    dtp = tick
                d_s = d_s + dtp
                shc = shc + (w * dtp) / parts
                dt = dt + dtp
            if self._serve:
                self._clock[bi] = c
                self._t_mark[bi] = c
            self._decode_s[bi] = d_s
            self._decode_share_cum[bi] = shc
            ws = w * dt
            share = ws / parts
            cnt = self._active_t[bi]
            tcell = cnt * share[:, None]
            self._tenant_ws += tcell.sum(axis=0)
            self._acc.book_dec(bi, cnt, tcell, cnt * (dt / parts)[:, None],
                               w, dt, ws, k, float(w.max()))
            self._decode_n[bi] += k
            self._busy_steps[bi] += k
            self._meter_now[bi] += dt
            self._steps_done[bi] += k
        idle = step_mask & ~busy
        ii = np.nonzero(idle)[0]
        if ii.size:
            tick = self._tick[ii]
            if self._serve:
                c = self._clock[ii]
                tm = self._t_mark[ii]
                # first step explicit (it consumes any fresh marks)
                c1 = c + tick
                fresh = np.isnan(tm)
                c2 = c1 + tick
                dt = np.where(fresh, c2 - c1, np.maximum(c1 - tm, 0.0))
                c = np.where(fresh, c2, c1)
                rem = np.full(ii.size, k - 1, np.int64)
                while True:
                    act = np.nonzero(rem > 0)[0]
                    if not act.size:
                        break
                    ca = c[act]
                    ta = tick[act]
                    c1 = ca + ta
                    inc = c1 - ca           # exact (c1, ca adjacent)
                    c2 = c1 + ta
                    # chunk span: increments provably constant while
                    # the clock stays >2 increments inside its binade
                    # and the first two steps agree (rounding ties at
                    # exactly half an ulp fall back to single steps)
                    lin = (c2 - c1) == inc
                    pos = inc > 0
                    bound = np.ldexp(1.0, np.frexp(ca)[1])
                    span = np.floor((bound - ca)
                                    / np.where(pos, inc, 1.0)) - 2.0
                    span = np.where(pos & lin, np.maximum(span, 1.0), 1.0)
                    span = np.where(pos, span, rem[act].astype(np.float64))
                    span = np.minimum(span, rem[act].astype(np.float64))
                    adv = span * inc        # exact: grid multiple
                    c[act] = ca + adv
                    dt[act] = dt[act] + adv
                    rem[act] -= span.astype(np.int64)
                self._clock[ii] = c
                self._t_mark[ii] = c
            else:
                dt = k * tick
            w = self._w_idle[ii]
            ws = w * dt
            self._tenant_ws[self._infra] += ws.sum()
            self._acc.book_idle(ii, w, dt, ws, k, float(w.max()))
            self._meter_now[ii] += dt
            self._steps_done[ii] += k
        self.steps += k
        if planned:
            self._planner_tick_vec(k)

    # ------------------------------------------------------------------
    # the event walk
    # ------------------------------------------------------------------

    def _make_accumulator(self):
        """The booking plane for this run — subclasses swap it out."""
        return TorchAccumulator(self, self.device) \
            if self.backend == "torch" else NumpyAccumulator(self)

    def _next_event(self, idx: int, n_req: int) -> int:
        """The earliest step (> ``self.steps``) at which anything can
        change: a fill, an arrival, a finish, a planner boundary, a
        wake deadline or a canary timeout."""
        s = self.steps
        # a fill is possible right now — the very next step is live
        if bool(np.any(~self._loop_parked & (self._queued > 0)
                       & (self._occupied < self._slots))):
            return s + 1
        nxt = s + (1 << 60)
        if idx < n_req:
            nxt = min(nxt, int(self.r_due[idx]) + 1)
        busy = self._occupied > 0
        if busy.any():
            gap = self._nf_key[busy] - self._busy_steps[busy]
            nxt = min(nxt, s + int(gap.min()))
        if self.plan is not None:
            pe = self.plan.plan_every
            nxt = min(nxt, s - s % pe + pe)
            if self._plan_pending:
                ce = self.policy.checkpoint_every
                nxt = min(nxt, s - s % ce + ce)
            waking = self._state == _WAKING
            if waking.any():
                nxt = min(nxt, int(self._wake_done[waking].min()))
            prob = (self._state == _PROBATION) & (self._canary >= 0)
            if prob.any():
                nxt = min(nxt, int(self._canary_step[prob].min())
                          + self.plan.states.canary_timeout_steps)
        return max(nxt, s + 1)

    def run(self, arrivals, max_steps: int = 10_000,
            arrival_every: int = 1) -> list:
        n_req = self._begin_run(arrivals, arrival_every)
        self.r_fill_seq = np.zeros(n_req, np.int64)
        # gated-draw deferral is safe unless admission could read the
        # infra tenant's running spend (a request tenanted "infra")
        self._defer_gated = self.plan is None or self.admission is None \
            or not bool((self.r_tenant == self._infra).any())
        self._acc = self._make_accumulator()
        due = self.r_due
        idx = 0
        remaining = max_steps
        clock = time.perf_counter
        prof = self.profile
        while remaining > 0:
            if idx >= n_req and not self._has_work:
                break
            if idx < n_req and due[idx] <= self.steps:
                t0 = clock()
                n0 = idx
                while idx < n_req and due[idx] <= self.steps:
                    self._submit(idx)
                    idx += 1
                prof.add("dispatch", clock() - t0, idx - n0)
            nxt = self._next_event(idx, n_req)
            quiet = min(nxt - self.steps - 1, remaining)
            if quiet > 0:
                t0 = clock()
                self._advance(quiet)
                prof.add("book", clock() - t0)
                remaining -= quiet
            else:
                t0 = clock()
                self._step()
                prof.add("step", clock() - t0)
                remaining -= 1
            # snapshots ride the event walk: a row lands on the first
            # boundary at/after each cadence mark, so recording never
            # re-cuts a quiet stretch (the float account is untouched)
            if self._flight is not None and self.steps >= self._next_snap:
                self._flight_snapshot()
        still_gated = np.nonzero(self._gate_mark >= 0)[0]
        if still_gated.size:
            self._flush_gated(still_gated)
        t0 = clock()
        self._acc.finalize()
        prof.add("flush", clock() - t0)
        self._finalize()
        return sorted(int(self.r_rid[j]) for j in self._finished_idx)

    def summary(self) -> dict:
        doc = super().summary()
        doc["engine"] = "vector-torch" if self.backend == "torch" \
            else "vector-seg"
        doc["backend_effective"] = self.backend
        if self.device is not None:
            doc["device"] = str(self.device)
        return doc

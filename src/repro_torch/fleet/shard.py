"""``repro_torch.fleet.shard`` — the segment engine partitioned into node
shards.  Copy of ``repro.fleet.shard``, numpy only, as in the reference.

``SegmentFleet`` walks events over one flat node array; every route is
a compact argmin over the whole candidate set and every booking record
is folded eagerly.  At the 10^7-arrival rung both costs are dominated
by per-arrival work, so this module partitions the fleet into ``w``
node shards (node ``i`` belongs to shard ``i % w`` — striding, not
contiguous ranges, because the consolidation planner concentrates the
active set at the cheap end of the rank order and contiguous ranges
would put every routable candidate in shard 0) and splits the engine
into:

  * a **two-level routing index**: each shard caches its local winner
    as a ``(marginal, load, name_rank, node)`` tuple and the router
    reduces the ``w`` cached tuples instead of re-scanning the fleet.
    A submit only moves the receiving node's marginal and load, so it
    only invalidates *one* shard — per-arrival routing work drops from
    O(candidates) to O(candidates / w + w).  The reduce preserves the
    stepped engine's exact tie-break order (see below);
  * a **sharded booking plane**: the fleet-wide rollups (phase
    scalars, per-node Ws) stay eager in the control plane — same
    formulas and record order as the eager backend, so they are
    bit-identical to ``vector-seg``.  Only the per-(node, tenant,
    phase) cell tensors defer: decode/idle records buffer whole and a
    flush splits the concatenated batch by shard in one vectorized
    pass, folding each slice into private partial tensors merged into
    the fleet ledger at finalize — the defer-to-finalize contract the
    torch backend already pins.  With ``parallel="process"`` each
    shard's partials live in ``multiprocessing.shared_memory`` and a
    worker process folds its shard's slices as they stream in; the
    control plane only barriers on the workers at finalize.  With
    ``parallel="inline"`` the identical fold runs in-process at the
    same flush boundaries, so both modes produce bit-identical ledgers
    (``parallel="auto"`` picks ``process`` only when more than one CPU
    is actually usable).

Why the two-level argmin is exact: the reference router picks the
minimum marginal Ws/token, breaks float-equal ties by load
``(occupied + queued) / max(slots, 1)``, and breaks load ties by name
rank.  Float equality defines the tie sets, so they decompose over any
partition of the candidates: each shard's winner tuple carries its
local minimum marginal, the minimum load *among its marginal ties*,
and the minimum name rank *among those load ties* — and the
lexicographic minimum of the ``w`` tuples is exactly the reference
winner.  A shard with no candidates contributes nothing (the inf
padding of the stepped engine never wins a min, an empty shard never
enters the reduce).

Equivalence contract vs ``vector-seg``: identical placement events,
finished sets and token counts; the whole ledger — per-(node, tenant,
phase) cells, per-node Ws, phase rollups — is bit-identical for any
shard count, because the rollups replay the eager backend's exact
record order and each cell's deferred adds are its own chronological
records.
"""
from __future__ import annotations

import math
import os
import time
from multiprocessing import get_context, shared_memory

import numpy as np

from repro_torch import obs
from repro_torch.fleet.power.forecast import _MIN_GAP
from repro_torch.fleet.segment import SegmentFleet
from repro_torch.fleet.vector import _ACTIVE, _DEC, _GATED, _IDLE, _PROBATION

#: booking records buffered between shard flushes.  The cadence is a
#: constant (never derived from the shard count or the execution mode)
#: so the fold batch boundaries — and therefore every float in the
#: ledger — are identical across 1/2/4/8 workers and inline/process.
_FLUSH_RECORDS = 512

_PARALLEL_MODES = ("auto", "inline", "process")

# Cached winner tuple for a shard with no routable candidates.  It loses
# every comparison against a real winner — even one with an infinite
# marginal, whose load entry is always finite — so the cross-shard
# reduce can be a bare ``min(...)`` with no None guard.
_WIN_EMPTY = (float("inf"), float("inf"), float("inf"), -1)


def _usable_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:                      # pragma: no cover
        return os.cpu_count() or 1


# ----------------------------------------------------------------------
# the sharded booking plane
# ----------------------------------------------------------------------

def _part_specs(n_s: int, t: int):
    """(name, shape, dtype) for one shard's partial cell tensors."""
    return (("cell_ws", (n_s, t, 4), np.float64),
            ("cell_s", (n_s, t, 4), np.float64),
            ("cell_n", (n_s, t, 4), np.int64),
            ("cell_peak", (n_s, t, 4), np.float64))


def _part_nbytes(n_s: int, t: int) -> int:
    return sum(int(np.prod(shape)) * np.dtype(dt).itemsize
               for _, shape, dt in _part_specs(n_s, t))


def _layout(buf, n_s: int, t: int) -> dict:
    """Carve one shard's partial tensors out of a flat buffer."""
    parts, off = {}, 0
    for name, shape, dt in _part_specs(n_s, t):
        nb = int(np.prod(shape)) * np.dtype(dt).itemsize
        parts[name] = np.ndarray(shape, dtype=dt, buffer=buf, offset=off)
        off += nb
    return parts


def _init_parts(parts: dict) -> None:
    for name, arr in parts.items():
        arr[...] = -np.inf if name.endswith("peak") else 0


def _fold(parts: dict, infra: int, dec, idl) -> None:
    """Apply one shard's flush payload to its partial cell tensors.

    ``dec``/``idl`` are the concatenated (batch-wide) column arrays for
    this shard, or ``None``.  Per cell the ``np.add.at`` adds land in
    record (chronological) order — the same order the eager backend
    applies them — so cell values are bit-identical to ``vector-seg``
    for any shard count and any flush cadence.
    """
    cws, cs = parts["cell_ws"], parts["cell_s"]
    cn, cpk = parts["cell_n"], parts["cell_peak"]
    if dec is not None:
        rows, cnt, tcell, scell, wv, kk = dec
        np.add.at(cws[:, :, _DEC], rows, tcell)
        np.add.at(cs[:, :, _DEC], rows, scell)
        np.add.at(cn[:, :, _DEC], rows, cnt * kk[:, None])
        np.maximum.at(cpk[:, :, _DEC], rows,
                      np.where(cnt > 0, wv[:, None], -np.inf))
    if idl is not None:
        rows, wv, dtv, wsv, kk = idl
        np.add.at(cws[:, infra, _IDLE], rows, wsv)
        np.add.at(cs[:, infra, _IDLE], rows, dtv)
        np.add.at(cn[:, infra, _IDLE], rows, kk)
        np.maximum.at(cpk[:, infra, _IDLE], rows, wv)


def _worker_main(conn, shm_name: str, n_s: int, t: int,
                 infra: int) -> None:
    """One shard worker: attach the shared partials, fold batches as
    they stream in, ack the ``done`` barrier, detach."""
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        parts = _layout(shm.buf, n_s, t)
        while True:
            msg = conn.recv()
            if msg[0] == "batch":
                _fold(parts, infra, msg[1], msg[2])
            elif msg[0] == "done":
                del parts               # release buffer exports
                conn.send("ok")
                return
    finally:
        shm.close()


class ShardAccumulator:
    """Booking plane for ``ShardedSegmentFleet``.

    The fleet-wide rollups (phase scalars, per-node Ws) are applied
    *eagerly* in the control plane with exactly the eager backend's
    formulas and record order — they stay bit-identical to
    ``vector-seg`` and never touch a worker.  Only the per-(node,
    tenant, phase) cell tensors defer: records buffer whole, a flush
    concatenates the batch, splits it by ``node % shards`` in one
    vectorized pass, and folds each shard's slice into private partial
    tensors (inline, or in a worker process over shared memory),
    merged into the fleet ledger at finalize.  Implements the same
    ``book_dec``/``book_idle``/``finalize`` surface as
    ``NumpyAccumulator``."""

    def __init__(self, fleet, shards: int, parallel: str):
        self.f = fleet
        self.w = shards
        self.mode = parallel
        self._t = len(fleet.tenant_names)
        self._dec = []
        self._idl = []
        self._nrec = 0
        self._closed = False
        self._shms, self._procs, self._conns = [], [], []
        self._parts = []
        n = fleet.n
        for s in range(shards):
            n_s = len(range(s, n, shards))
            if self.mode == "process":
                shm = shared_memory.SharedMemory(
                    create=True, size=max(_part_nbytes(n_s, self._t), 1))
                self._shms.append(shm)
                parts = _layout(shm.buf, n_s, self._t)
            else:
                parts = _layout(bytearray(_part_nbytes(n_s, self._t)),
                                n_s, self._t)
            _init_parts(parts)
            self._parts.append(parts)
        if self.mode == "process":
            # forked, as in the reference, also after the parent has
            # brought up the card: a worker runs only ``_worker_main``
            # (numpy, a pipe and shared memory) and touches neither torch
            # nor CUDA.  ``spawn`` or ``forkserver`` would re-import this
            # package, and with it torch, in every worker
            ctx = get_context("fork")
            for s in range(shards):
                parent, child = ctx.Pipe()
                p = ctx.Process(
                    target=_worker_main,
                    args=(child, self._shms[s].name,
                          len(range(s, n, shards)), self._t,
                          fleet._infra),
                    daemon=True)
                p.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(p)

    # -- record intake (called once per live step / quiet stretch) -----

    def book_dec(self, bi, cnt, tcell, scell, w, dt, ws, k, wmax):
        f = self.f
        f._phase_ws[_DEC] += ws.sum()
        f._phase_s[_DEC] += dt.sum()
        f._phase_n[_DEC] += bi.size * k
        if wmax > f._phase_peak[_DEC]:
            f._phase_peak[_DEC] = wmax
        f._node_ws[bi] += ws
        self._dec.append((bi, cnt, tcell, scell, w, k))
        self._nrec += 1
        if self._nrec >= _FLUSH_RECORDS:
            self.flush()

    def book_idle(self, ii, w, dt, ws, k, wmax):
        f = self.f
        f._phase_ws[_IDLE] += ws.sum()
        f._phase_s[_IDLE] += dt.sum()
        f._phase_n[_IDLE] += ii.size * k
        if wmax > f._phase_peak[_IDLE]:
            f._phase_peak[_IDLE] = wmax
        f._node_ws[ii] += ws
        self._idl.append((ii, w, dt, ws, k))
        self._nrec += 1
        if self._nrec >= _FLUSH_RECORDS:
            self.flush()

    def flush(self) -> None:
        dec, idl = self._dec, self._idl
        if not dec and not idl:
            return
        self._dec, self._idl, self._nrec = [], [], 0
        w = self.w
        pay = [[None, None] for _ in range(w)]
        if dec:
            rows = np.concatenate([r[0] for r in dec])
            cnt = np.concatenate([r[1] for r in dec])
            tcell = np.concatenate([r[2] for r in dec])
            scell = np.concatenate([r[3] for r in dec])
            wv = np.concatenate([r[4] for r in dec])
            kk = np.concatenate([np.full(r[0].size, r[5], np.int64)
                                 for r in dec])
            if w == 1:
                pay[0][0] = (rows, cnt, tcell, scell, wv, kk)
            else:
                mod = rows % w
                for s in range(w):
                    sel = mod == s
                    if sel.any():
                        pay[s][0] = (rows[sel] // w, cnt[sel],
                                     tcell[sel], scell[sel],
                                     wv[sel], kk[sel])
        if idl:
            rows = np.concatenate([r[0] for r in idl])
            wv = np.concatenate([r[1] for r in idl])
            dtv = np.concatenate([r[2] for r in idl])
            wsv = np.concatenate([r[3] for r in idl])
            kk = np.concatenate([r[4] if isinstance(r[4], np.ndarray)
                                 else np.full(r[0].size, r[4], np.int64)
                                 for r in idl])
            if w == 1:
                pay[0][1] = (rows, wv, dtv, wsv, kk)
            else:
                mod = rows % w
                for s in range(w):
                    sel = mod == s
                    if sel.any():
                        pay[s][1] = (rows[sel] // w, wv[sel],
                                     dtv[sel], wsv[sel], kk[sel])
        infra = self.f._infra
        prof = self.f.profile
        clock = time.perf_counter
        for s in range(w):
            pd, pi = pay[s]
            if pd is None and pi is None:
                continue
            t0 = clock()
            if self.mode == "process":
                self._conns[s].send(("batch", pd, pi))
            else:
                _fold(self._parts[s], infra, pd, pi)
            prof.add(f"flush.shard{s}", clock() - t0)

    # -- the finalize barrier ------------------------------------------

    def _merge(self) -> None:
        f = self.f
        for s in range(self.w):
            p = self._parts[s]
            sl = slice(s, None, self.w)
            f._cell_ws[sl] += p["cell_ws"]
            f._cell_s[sl] += p["cell_s"]
            f._cell_n[sl] += p["cell_n"]
            np.maximum(f._cell_peak[sl], p["cell_peak"],
                       out=f._cell_peak[sl])

    def finalize(self) -> None:
        self.flush()
        if self.mode == "process":
            for conn in self._conns:
                conn.send(("done",))
            for conn in self._conns:        # the control-plane barrier
                conn.recv()
        self._merge()
        self.close()

    def close(self) -> None:
        """Tear down workers and shared memory; idempotent, safe to
        call on the failure path before ``finalize`` ever ran."""
        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            try:
                conn.close()
            except OSError:                 # pragma: no cover
                pass
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():                # pragma: no cover
                p.terminate()
                p.join(timeout=5.0)
        self._parts = []                    # release buffer exports
        for shm in self._shms:
            try:
                shm.close()
                shm.unlink()
            except FileNotFoundError:       # pragma: no cover
                pass
        self._shms = []


# ----------------------------------------------------------------------
# the sharded engine
# ----------------------------------------------------------------------

class ShardedSegmentFleet(SegmentFleet):
    """``SegmentFleet`` with the node array partitioned into ``shards``
    strided shards: two-level argmin routing, a vectorized planning
    window, and the shard booking plane above.

    ``parallel``: ``"inline"`` folds shard partials in-process,
    ``"process"`` forks one worker per shard over shared memory,
    ``"auto"`` picks ``process`` only when >1 CPU is usable.  Both
    modes are bit-identical by construction.
    """

    def __init__(self, specs, policy=None, plan=None, admission=None,
                 forecaster=None, loop_model: str = "serve",
                 shards: int = 2, parallel: str = "auto"):
        if int(shards) < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if parallel not in _PARALLEL_MODES:
            raise ValueError("parallel must be one of "
                             f"{_PARALLEL_MODES}, got {parallel!r}")
        self._marg_arr = None
        super().__init__(specs, policy=policy, plan=plan,
                         admission=admission, forecaster=forecaster,
                         loop_model=loop_model, backend="numpy")
        self._shards = min(int(shards), self.n)
        if parallel == "auto":
            parallel = "process" if _usable_cpus() > 1 else "inline"
        self._parallel = parallel
        w = self._shards
        self._win = [_WIN_EMPTY] * w
        # generation-counter invalidation: shard ``s`` is clean iff
        # ``_win_gen[s] == _gen``.  Bumping ``_gen`` dirties every
        # shard in O(1); a submit stamps one shard with -1.
        self._gen = 1
        self._win_gen = [0] * w
        empty = np.zeros(0, np.int64)
        self._sh_cand = [empty] * w
        self._cand_cnt = 0
        # static per-node lookups for the scalar hot paths (slots and
        # name rank never move under the vector core)
        self._slots_c = np.maximum(self._slots, 1)
        self._slots_py = [int(x) for x in self._slots]
        self._rank_py = [int(x) for x in self._name_rank]
        self._rr_router = self.policy.router == "round_robin"
        # homogeneous fleets divide the load tie-break by one scalar
        # (identical IEEE result to the per-node column, one gather
        # cheaper per scan)
        self._slots_u = float(self._slots_c[0]) \
            if bool((self._slots_c == self._slots_c[0]).all()) else None
        # the load tie-break column ``(occupied + queued) / max(slots,
        # 1)``, rebuilt in place once per generation and patched by
        # the same scalar kernels that patch the marginal cache.  The
        # vector rebuild and the Python-float patches produce the same
        # IEEE doubles as the reference's per-route computation.
        self._load = np.zeros(self.n)
        self._load_gen = 0
        # Homogeneous fleets fold the whole (load, rank) tie-break into
        # one int64 key ``(occupied + queued) * n + name_rank``.  With a
        # single shared divisor the float loads order — and tie — exactly
        # as the integer occupancy sums (distinct sums a < b differ by
        # >= 1/slots after division, far above one ulp at these
        # magnitudes), and rank < n keeps the key lexicographic.  A tie
        # scan then needs one gather and one argmin instead of the
        # min/mask/gather chain on the float column.
        self._n_py = int(self.n)
        self._lk = np.zeros(self.n, np.int64) \
            if self._slots_u is not None and self._slots_u < 2.0 ** 20 \
            else None

    # -- cache plumbing -------------------------------------------------
    #
    # ``_marg`` becomes a property so the parent engines' cache
    # invalidations (``self._marg = None`` when decode meters move)
    # also invalidate every shard's cached winner; the per-submit
    # scalar patch goes through ``_node_submit`` below and dirties only
    # the receiving node's shard.

    @property
    def _marg(self):
        return self._marg_arr

    @_marg.setter
    def _marg(self, v):
        self._marg_arr = v
        if getattr(self, "_win_gen", None) is not None:
            self._gen += 1

    def _node_submit(self, i: int, j: int) -> None:
        # the segment engine's _node_submit fused with the marginal
        # patch (``_marginal_one`` inlined — the queue depth is already
        # in hand, slots/nominal come from the static python tables)
        # and the shard-winner invalidation.  Same operations, same
        # floats, one call frame.
        self._served[i].add(j)
        self.r_enq_t[j] = self._meter_now[i]
        depth = int(self._queued[i])
        if depth >= self._q_cap:
            self._grow_ring()
        self._q_buf[i, (int(self._q_head[i]) + depth) % self._q_cap] = j
        self._queued[i] = depth + 1
        self.r_node[j] = i
        if self._marg_arr is not None:
            occ = int(self._occupied[i])
            slots = self._slots_py[i]
            n_next = occ + depth + 2        # occ + queued + 1
            m_occ = n_next if n_next < slots else slots
            dn = int(self._decode_n[i])
            ds = float(self._decode_s[i])
            dt = ds / max(dn, 1) if (dn > 0 and ds > 0) \
                else self._nominal_py[i]
            share = self._occ_w_py[i][m_occ] * dt / max(m_occ, 1)
            m = share * (1.0 + max(n_next - slots, 0) / max(slots, 1))
            self._marg_arr[i] = m if math.isfinite(m) else float("inf")
            # keep the load tie-break column current within the
            # generation — same int64 sum (or sum/divisor double) as the
            # vectorized rebuild in _shard_winner
            if self._lk is not None:
                self._lk[i] = (occ + depth + 1) * self._n_py \
                    + self._rank_py[i]
            else:
                self._load[i] = (occ + depth + 1) / max(slots, 1)
        self._win_gen[i % self._shards] = -1

    def _submit(self, j: int) -> None:
        """The reference ``_submit`` with the no-admission, no-tracer
        fast path short-circuited (the forecaster EWMA inlined — same
        float ops as ``ArrivalForecaster.observe``)."""
        tr = obs.TRACER
        if self.admission is not None \
                or (tr.enabled and not obs.FLIGHT.sampling):
            super()._submit(j)
            return
        self._n_arrivals += 1
        if self.plan is not None:
            fc = self.forecaster
            t = float(self.steps)
            if fc._n > 0:
                gap = min(max(t - fc._last_t, _MIN_GAP), fc.prior_gap)
                fc._gap_ewma += fc.alpha * (gap - fc._gap_ewma)
            else:
                fc._gap_ewma = fc.prior_gap
            fc._last_t = max(t, fc._last_t)
            fc._n += 1
        self._node_submit(self._route(j), j)

    def _submit_seq(self, lo: int, hi: int) -> None:
        """Dispatch arrivals ``[lo, hi)`` (all due this step) through
        one fused loop: the ``_submit`` → ``_route`` → ``_node_submit``
        chain of the scalar path with the per-arrival call frames,
        attribute loads and observability checks hoisted out of the
        loop.  Every numpy scalar read/write and every float op is the
        scalar path's, in the scalar path's order, so the placement
        sequence and the ledger are unchanged — this loop only removes
        Python dispatch overhead.  Any feature that needs per-arrival
        hooks (admission, unsampled tracing, round-robin) falls back
        to the per-arrival path; metrics stay fused — every sub-batch
        between slow checks shares one candidate set, so its per-route
        ``routing_candidates`` observes collapse into one
        ``observe_many`` carrying the scalar path's exact values."""
        tr = obs.TRACER
        if self.admission is not None or self._rr_router \
                or (tr.enabled and not obs.FLIGHT.sampling):
            for j in range(lo, hi):
                self._submit(j)
            return
        mx = obs.METRICS
        h_cand = None
        if mx.enabled:
            from repro_torch.fleet.scheduler import _CANDIDATE_BUCKETS
            h_cand = mx.histogram("routing_candidates",
                                  "nodes eligible per route",
                                  buckets=_CANDIDATE_BUCKETS)
        self._n_arrivals += hi - lo
        fc = self.forecaster if self.plan is not None else None
        if fc is not None:
            # the EWMA replayed per arrival on local floats (all
            # arrivals in the batch share the same timestamp)
            t = float(self.steps)
            n, last, g = fc._n, fc._last_t, fc._gap_ewma
            a, pg = fc.alpha, fc.prior_gap
            for _ in range(lo, hi):
                if n > 0:
                    gap = min(max(t - last, _MIN_GAP), pg)
                    g += a * (gap - g)
                else:
                    g = pg
                last = max(t, last)
                n += 1
            fc._n, fc._last_t, fc._gap_ewma = n, last, g
        plan = self.plan
        served = self._served
        meter_now = self._meter_now
        queued, occupied = self._queued, self._occupied
        decode_n, decode_s = self._decode_n, self._decode_s
        slots_py, nominal_py = self._slots_py, self._nominal_py
        occ_w_py = self._occ_w_py
        win, wg = self._win, self._win_gen
        load_arr = self._load            # rebuilt in place, identity stable
        lk_arr, n_py = self._lk, self._n_py
        rank_py = self._rank_py
        w = self._shards
        shard_winner = self._shard_winner
        isfinite, inf = math.isfinite, float("inf")
        # routed (node, request) pairs; r_enq_t / r_node are not read
        # inside the dispatch loop, so their writes land vectorized at
        # the end of the batch
        ri, rj = [], []
        ri_append, rj_append = ri.append, rj.append
        j = lo
        while j < hi:
            # --- slow checks: a canary or a drain left the masks or
            # the owed queue hot.  Inside the fast loop nothing sets
            # either (a submit only stamps a shard winner), so these
            # re-checks run once per batch plus once per canary.
            if self._masks_dirty:
                self._rebuild_masks()
            if self._m_healthy_cnt == 0:
                raise RuntimeError(
                    "no healthy node to route to (all parked)")
            if plan is not None and self._m_owed_first >= 0:
                i = self._m_owed_first
                self._canary[i] = j
                self._canary_step[i] = self.steps
                self._masks_dirty = True
                if h_cand is not None:
                    # the scalar _route observes the healthy count for
                    # a canary pick; keep the value stream in order
                    h_cand.observe(self._m_healthy_cnt)
                self._node_submit(i, j)
                j += 1
                continue
            if self._marg_arr is None:
                self._marg = self._marginal()
            marg = self._marg_arr
            gen = self._gen
            for s in range(w):
                if wg[s] != gen:
                    shard_winner(s)
                    wg[s] = gen
            # --- fast loop: a submit dirties exactly one shard, so
            # track it in a local instead of re-scanning the stamp
            # list, and only recompute that shard's winner.  The
            # clock brackets the routing decision (shard rescan +
            # cross-shard reduce) — the two-level argmin itself.
            clock = time.perf_counter
            route_s = 0.0
            dirty_s = -1
            j0, cand_cnt = j, self._cand_cnt
            sh_cand = self._sh_cand
            slots_u = self._slots_u
            for j in range(j, hi):
                t0 = clock()
                if dirty_s >= 0:
                    if lk_arr is not None:
                        # _shard_winner's uniform-key scan inlined on
                        # prebound locals.  The gen check is hoisted:
                        # nothing in this loop bumps _gen, and the wg
                        # sync above refreshed the key column for this
                        # generation.  dirty_s just received a submit,
                        # so its candidate set is non-empty.
                        idxs = sh_cand[dirty_s]
                        mc = marg[idxs]
                        mn = mc.min()
                        ti = idxs[mc == mn]
                        if ti.size > 1:
                            kt = lk_arr[ti]
                            p = kt.argmin()
                            nd, k = int(ti[p]), int(kt[p])
                        else:
                            nd = int(ti[0])
                            k = int(lk_arr[nd])
                        win[dirty_s] = (float(mn), (k // n_py) / slots_u,
                                        k % n_py, nd)
                    else:
                        shard_winner(dirty_s)
                best = min(win)
                i = best[3]
                route_s += clock() - t0
                # ---- _node_submit inlined ----
                served[i].add(j)
                ri_append(i)
                rj_append(j)
                depth = int(queued[i])
                if depth >= self._q_cap:
                    self._grow_ring()
                self._q_buf[i, (int(self._q_head[i]) + depth)
                            % self._q_cap] = j
                queued[i] = depth + 1
                occ = int(occupied[i])
                slots = slots_py[i]
                n_next = occ + depth + 2
                m_occ = n_next if n_next < slots else slots
                dn = int(decode_n[i])
                ds = float(decode_s[i])
                dt = ds / max(dn, 1) if (dn > 0 and ds > 0) \
                    else nominal_py[i]
                share = occ_w_py[i][m_occ] * dt / max(m_occ, 1)
                m = share * (1.0 + max(n_next - slots, 0)
                             / max(slots, 1))
                marg[i] = m if isfinite(m) else inf
                if lk_arr is not None:
                    lk_arr[i] = (occ + depth + 1) * n_py + rank_py[i]
                else:
                    load_arr[i] = (occ + depth + 1) / max(slots, 1)
                dirty_s = i % w
            j += 1
            self.route_s += route_s
            if dirty_s >= 0:
                wg[dirty_s] = -1
            if h_cand is not None and j > j0:
                # nothing in the fast loop touches the masks, so the
                # scalar path would observe cand_cnt once per arrival
                h_cand.observe_many([cand_cnt] * (j - j0))
        if ri:
            ia = np.asarray(ri, np.int64)
            ja = np.asarray(rj, np.int64)
            self.r_enq_t[ja] = meter_now[ia]
            self.r_node[ja] = ia

    def _drain(self, i: int) -> list:
        """A drain only moves node ``i`` — it is parked by every
        caller before the reroutes land — so instead of dropping the
        whole marginal cache and the mask cache (each forcing an O(n)
        rebuild plus an O(C) winner sweep on the next route), patch
        node ``i``'s marginal with the scalar kernel (the same values
        a full rebuild would produce — the invariant the submit-time
        patch already pins), drop ``i`` from its shard's candidates in
        O(C/w), and dirty only that shard's winner."""
        marg = self._marg_arr
        gen = self._gen
        clean = not self._masks_dirty
        moved = super()._drain(i)       # sets _marg = None, masks dirty
        if marg is not None:
            marg[i] = self._marginal_one(i)
            tot = int(self._occupied[i]) + int(self._queued[i])
            if self._lk is not None:
                self._lk[i] = tot * self._n_py + self._rank_py[i]
            else:
                self._load[i] = tot / max(self._slots_py[i], 1)
            self._marg_arr = marg
            self._gen = gen             # undo the blanket invalidation
            self._win_gen[i % self._shards] = -1
        if clean and self.policy.router == "energy" \
                and self._m_owed_first != i:
            s = i % self._shards
            sc = self._sh_cand[s]
            keep = sc != i
            if keep.all():
                # i was healthy but not a candidate (PROBATION while
                # the cand set is the routable one): only the healthy
                # count moves
                self._m_healthy_cnt -= 1
                self._masks_dirty = False
            elif self._cand_cnt > 1:
                self._sh_cand[s] = sc[keep]
                self._cand_cnt -= 1
                self._m_healthy_cnt -= 1
                self._win_gen[s] = -1
                self._masks_dirty = False
            # else: i was the last candidate — the reference flips the
            # cand set to the healthy fallback; take the full rebuild
        return moved

    def _rebuild_masks(self) -> None:
        super()._rebuild_masks()
        w = self._shards
        idxs = self._m_cand_idxs
        self._cand_cnt = idxs.size
        mod = idxs % w
        self._sh_cand = [idxs[mod == s] for s in range(w)]
        self._gen += 1

    # -- the two-level argmin ------------------------------------------

    def _shard_winner(self, s: int) -> None:
        """Recompute shard ``s``'s cached ``(marginal, load, rank,
        node)`` winner with exactly the reference tie-break floats.

        The scan gathers the *authoritative* engine columns (marginal
        cache, occupancy, queue depth, name rank) through the shard's
        candidate index on every recompute — nothing but the winner
        tuple itself is cached, so the only invalidation surface is
        the generation counter.  Dividing by the precomputed
        ``max(slots, 1)`` column is the exact reference float path."""
        idxs = self._sh_cand[s]
        if idxs.size == 0:
            self._win[s] = _WIN_EMPTY
            return
        lk = self._lk
        if self._load_gen != self._gen:
            if lk is not None:
                np.add(np.multiply(self._occupied + self._queued,
                                   self._n_py, out=lk),
                       self._name_rank, out=lk)
            else:
                np.divide(self._occupied + self._queued, self._slots_c,
                          out=self._load)
            self._load_gen = self._gen
        mc = self._marg_arr[idxs]
        mn = mc.min()
        ti = idxs[mc == mn]
        if lk is not None:
            # homogeneous fleet: the int64 key IS the (load, rank)
            # lexicographic order, so first-occurrence argmin settles
            # both tie levels in one pass
            if ti.size > 1:
                kt = lk[ti]
                p = int(kt.argmin())
                node, k = int(ti[p]), int(kt[p])
            else:
                node = int(ti[0])
                k = int(lk[node])
            self._win[s] = (float(mn), (k // self._n_py) / self._slots_u,
                            k % self._n_py, node)
            return
        if ti.size > 1:
            load = self._load[ti]
            lm = load.min()
            ti = ti[load == lm]
            if ti.size > 1:
                rk = self._name_rank[ti]
                p = rk.argmin()
                node, rmin = int(ti[p]), int(rk[p])
            else:
                node = int(ti[0])
                rmin = self._rank_py[node]
            lmv = float(lm)
        else:
            node = int(ti[0])
            rmin = self._rank_py[node]
            lmv = float(self._load[node])
        self._win[s] = (float(mn), lmv, rmin, node)

    def _route(self, j: int, exclude: int = -1) -> int:
        if exclude >= 0 and not bool(self._loop_parked[exclude]):
            # every in-tree drain-reroute parks the excluded node
            # before rerouting, so the rebuilt masks already exclude
            # it and the sharded path below is exact.  A caller that
            # excludes a live node gets the reference path.
            self._masks_dirty = True
            return super()._route(j, exclude)
        if self._masks_dirty:
            self._rebuild_masks()
        if self._m_healthy_cnt == 0:
            raise RuntimeError("no healthy node to route to (all parked)")
        chosen = -1
        cand_cnt = self._cand_cnt
        if self.plan is not None and self._m_owed_first >= 0:
            chosen = self._m_owed_first
            self._canary[chosen] = j
            self._canary_step[chosen] = self.steps
            self._masks_dirty = True
            cand_cnt = self._m_healthy_cnt
        if chosen < 0:
            if self._rr_router:
                idxs = self._m_cand_idxs
                chosen = int(idxs[self._rr % len(idxs)])
                self._rr += 1
            else:
                if self._marg_arr is None:
                    self._marg = self._marginal()
                gen, wg = self._gen, self._win_gen
                for s in range(self._shards):
                    if wg[s] != gen:
                        self._shard_winner(s)
                        wg[s] = gen
                chosen = min(self._win)[3]
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

    # -- gated-draw booking through the shard plane --------------------

    def _book_gated(self, gi, kt) -> None:
        """The reference ``_book_gated`` with its cell adds routed
        through the shard accumulator's idle stream (gated draw lands
        in the same (infra, IDLE) cells as idle ticks — deferring both
        keeps every cell's add order chronological, hence bit-identical
        to the eager backend).  The fleet-wide rollups and the meters
        the engine reads mid-run stay eager, in the reference's record
        order."""
        acc = self._acc
        if acc is None:                 # pragma: no cover - safety net
            super()._book_gated(gi, kt)
            return
        # _recent_dt on the gi subset only (same elementwise ops as the
        # full-width kernel, so the same floats)
        dn = self._decode_n[gi]
        ds = self._decode_s[gi]
        dtr = np.maximum(np.where((dn > 0) & (ds > 0),
                                  ds / np.maximum(dn, 1),
                                  self._nominal[gi]), 1e-9)
        w = np.maximum(self._parked_w[gi], 0.0)
        tot_dt = dtr * kt
        tot_ws = (w * dtr) * kt
        self._phase_ws[_IDLE] += tot_ws.sum()
        self._phase_s[_IDLE] += tot_dt.sum()
        self._phase_n[_IDLE] += int(kt.sum())
        wm = w.max()
        if wm > self._phase_peak[_IDLE]:
            self._phase_peak[_IDLE] = wm
        self._node_ws[gi] += tot_ws
        self._tenant_ws[self._infra] += tot_ws.sum()
        self._meter_now[gi] += tot_dt
        acc._idl.append((gi, w, tot_dt, tot_ws, kt))
        acc._nrec += 1
        if acc._nrec >= _FLUSH_RECORDS:
            acc.flush()

    # -- vectorized planning window ------------------------------------

    def _service_steps(self) -> float:
        """The reference ``_service_steps`` without the full O(n)
        list build: the last 32 tokens of the node-ordered concat can
        only come from the highest-indexed contributing nodes, so walk
        from the tail and stop once 32 are in hand.  Token lists hold
        ints, so the mean is bit-identical to the reference's."""
        pol = self.plan
        if pol.service_steps > 0:
            return pol.service_steps
        chunks, total = [], 0
        for toks in reversed(self._finished_tokens):
            if not toks:
                continue
            f = [t for t in toks[-32:] if t]
            if f:
                chunks.append(f)
                total += len(f)
                if total >= 32:
                    break
        if total:
            recent = [t for c in reversed(chunks) for t in c][-32:]
            return max(sum(recent) / len(recent), 1.0)
        return 16.0

    def _plan(self) -> None:
        """The segment engine's ranked k-search with the per-node
        pending scan vectorized: the wake/gate candidate masks are
        array expressions (the ``_gate_pays`` floats composed exactly
        as the scalar reference composes them) and the Python loop
        touches only the nodes that actually park a pending action."""
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
        tr = obs.TRACER
        if tr.enabled:
            tr.instant("power.plan",
                       tags={"step": self.steps, "rate": rate, "lq": lq,
                             "active_target": k, "backlog": backlog})
        keep_mask = np.zeros(self.n, bool)
        keep_mask[ranked[:k]] = True
        for i in list(self._plan_pending):
            if (self._plan_pending[i]["action"] == "gate") \
                    == bool(keep_mask[i]):
                del self._plan_pending[i]
        st = self._state
        wake_m = keep_mask & (st == _GATED)
        if pol.mode == "gate":
            dtr = np.maximum(self._recent_dt(), 1e-9)
            pays = (self._floor_w - self._parked_w) \
                * (dtr * pol.horizon_steps) \
                > pol.states.boot_energy_ws
            gate_m = ~keep_mask & ((st == _ACTIVE) | (st == _PROBATION)) \
                & (self.steps - self._since >= pol.min_active_steps) \
                & pays
        else:
            gate_m = np.zeros(self.n, bool)
        act = wake_m | gate_m
        if act.any():
            for i in ranked[act[ranked]].tolist():
                self._park_pending(i, "wake" if wake_m[i] else "gate",
                                   rate, lq, k)

    # -- lifecycle ------------------------------------------------------

    def _make_accumulator(self):
        return ShardAccumulator(self, self._shards, self._parallel)

    def run(self, arrivals, max_steps: int = 10_000,
            arrival_every: int = 1) -> list:
        # the segment engine's event loop with the arrival dispatch
        # batched through _submit_seq (all arrivals due on one step go
        # through a single fused loop) and the dispatch plane timed:
        # ``dispatch_s`` accumulates the route+submit wall time and
        # ``route_s`` the two-level argmin inside it — the part of the
        # run the shard index accelerates.  Keep in lockstep with
        # SegmentFleet.run.
        self.dispatch_s = 0.0
        self.route_s = 0.0
        try:
            n_req = self._begin_run(arrivals, arrival_every)
            self.r_fill_seq = np.zeros(n_req, np.int64)
            self._defer_gated = self.plan is None \
                or self.admission is None \
                or not bool((self.r_tenant == self._infra).any())
            self._acc = self._make_accumulator()
            due = self.r_due                 # non-decreasing (validated
            idx = 0                          # by VectorArrivals)
            remaining = max_steps
            clock = time.perf_counter
            prof = self.profile
            while remaining > 0:
                if idx >= n_req and not self._has_work:
                    break
                if idx < n_req:
                    hi = int(np.searchsorted(due, self.steps,
                                             side="right"))
                    if hi > idx:
                        t0 = clock()
                        self._submit_seq(idx, hi)
                        dt = clock() - t0
                        self.dispatch_s += dt
                        prof.add("dispatch", dt, hi - idx)
                        idx = hi
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
                # snapshots ride the event walk (see SegmentFleet.run):
                # rows land on event boundaries, never re-cutting a
                # quiet stretch, so the account is untouched
                if self._flight is not None \
                        and self.steps >= self._next_snap:
                    self._flight_snapshot()
            still_gated = np.nonzero(self._gate_mark >= 0)[0]
            if still_gated.size:
                self._flush_gated(still_gated)
            prof.add("route", self.route_s, int(self._n_arrivals))
            t0 = clock()
            self._acc.finalize()
            prof.add("flush", clock() - t0)
            self._finalize()
            return sorted(int(self.r_rid[j]) for j in self._finished_idx)
        finally:
            acc = self._acc
            if acc is not None:
                acc.close()             # idempotent; covers failures

    def summary(self) -> dict:
        doc = super().summary()
        doc["engine"] = "vector-shard"
        doc["shards"] = self._shards
        doc["parallel"] = self._parallel
        doc["dispatch_s"] = round(getattr(self, "dispatch_s", 0.0), 6)
        doc["route_s"] = round(getattr(self, "route_s", 0.0), 6)
        return doc

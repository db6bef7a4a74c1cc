"""``repro_torch.fleet.torch_backend`` — the torch array backend for the
segment-batched fleet core (``repro_torch.fleet.segment``).

Counterpart of ``repro.fleet.jax_backend``, whose ``jax.jit`` functions of
stock ops become stock torch ops here.  The segment engine splits its
bookkeeping into two planes:

  * the **control plane** (routing, admission, the planner, clocks,
    decode meters, per-tenant spend) stays eager numpy — every branch
    the reference engine takes reads these live, so deferring them
    would change placement control flow;
  * the **booking plane** (the dense decode/idle ledger cells, phase
    rollups and per-node Ws) is a pure fold over per-step/per-stretch
    records — no control flow ever reads it mid-run (admission reads
    ``_tenant_ws``, which the fleet keeps eager).

``TorchAccumulator`` implements the booking plane on a device.  Records
are staged dense (one ``[n]``/``[n, t]`` row set per live step or quiet
stretch) into one host buffer per column, pinned when the device is the
card; every ``CHUNK`` records the buffers go over with one non-blocking
copy per column and fold into float64/int64 carry tensors with one sum
over the record axis for the adds and one masked ``amax`` for the peaks.
The carries live on the device from construction to ``finalize``, the
only point that waits for it; ``finalize`` adds them into the fleet's
numpy cell tensors.

Float contract: every fold operation is an add or a max-compare mirroring
the numpy accumulator; a sum over a chunk in place of the reference's
sequential scan only reorders the additions, so the torch path lands
within reduction-reorder distance (~1e-15 rel) of the stepped reference,
while integer counts and placement events stay exact.  Peaks keep the
reference's NaN rules: a cell peak takes a NaN watt point of a record
that books the cell (``maximum``), a phase peak never does (``>``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

#: records folded per host-to-device copy
CHUNK = 64

_MIN_GAP = 1e-6                         # forecast.py's _MIN_SERVICE floor

# ----------------------------------------------------------------------
# control-plane functions
# ----------------------------------------------------------------------
#
# The routing argmin and the planner's Erlang-C k-search are the two
# control-plane hot spots.  numpy stays the bit-exact reference the
# engines run on (placement control flow reads these live); the torch
# twins are the device path for offline sweeps and the planner's
# ``backend="torch"``.  The equivalence contract
# (tests/test_torch_fleet_backend.py) pins the torch results to the numpy
# references: integer winners exactly, Lq floats within reduction-reorder
# distance.


def route_argmin_np(marg, load, rank, active):
    """Reference energy-router winner: lowest marginal Ws/token among
    ``active`` nodes, float-equal marginal ties broken by lowest load,
    load ties by lowest name rank.  Returns -1 with no active node."""
    marg = np.asarray(marg, np.float64)
    active = np.asarray(active, bool)
    idxs = np.flatnonzero(active)
    if idxs.size == 0:
        return -1
    mc = marg[idxs]
    ti = idxs[mc == mc.min()]
    if ti.size > 1:
        lc = np.asarray(load, np.float64)[ti]
        ti = ti[lc == lc.min()]
        if ti.size > 1:
            rc = np.asarray(rank)[ti]
            return int(ti[rc.argmin()])
    return int(ti[0])


def route_argmin_torch(marg, load, rank, active,
                       device: DeviceLike = None) -> int:
    """Torch twin of ``route_argmin_np`` on ``device`` (default the card):
    one masked three-level lexicographic argmin.  Inactive lanes are
    padded to +inf so they never win; the final argmin runs on the rank
    column, a permutation, so the winner is unique."""
    dev = resolve_device(device)
    active = torch.as_tensor(np.asarray(active, bool), device=dev)
    if active.numel() == 0:
        return -1
    marg = torch.as_tensor(np.asarray(marg, np.float64), device=dev)
    load = torch.as_tensor(np.asarray(load, np.float64), device=dev)
    rank = torch.as_tensor(np.asarray(rank, np.int64), device=dev)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    m = torch.where(active, marg, inf)
    t1 = active & (m == m.min())
    lo = torch.where(t1, load, inf)
    t2 = t1 & (lo == lo.min())
    r = torch.where(t2, rank, torch.iinfo(torch.int64).max)
    return int(torch.where(active.any(), r.argmin(), -1))


def expected_queue_depth_many_torch(servers, service_time, lam,
                                    horizon=64.0,
                                    device: DeviceLike = None):
    """Erlang-C sweep over candidate server counts on ``device`` (default
    the card): ``ArrivalForecaster.expected_queue_depth_many`` given the
    same forecast rate ``lam``.  The term chain is one cumprod and the
    partial sums one cumsum up to ``c_max`` (the largest candidate: the
    fleet's total slots in the planner's k-search), gathered at each
    candidate — the numpy sweep's op sequence, so the floats land within
    reduction-reorder distance of it.  Returns a numpy array."""
    servers = np.maximum(np.asarray(servers, np.int64), 1)
    if servers.size == 0:
        return np.zeros(0)
    dev = resolve_device(device)
    f64 = torch.float64
    service_time = max(float(service_time), _MIN_GAP)
    horizon = max(float(horizon), 0.0)
    lam = float(lam)
    mu = 1.0 / service_time
    offered = lam / mu
    c_max = int(servers.max())
    s = torch.as_tensor(servers, device=dev)
    sf = s.to(f64)
    if c_max > 1:
        terms = torch.cumprod(
            offered / torch.arange(1, c_max, dtype=f64, device=dev), 0)
        term = torch.where(s > 1, terms[torch.clamp(s - 2, min=0)], 1.0)
    else:
        terms = torch.zeros(0, dtype=f64, device=dev)
        term = torch.ones(s.shape, dtype=f64, device=dev)
    partial_all = torch.cumsum(
        torch.cat([torch.ones(1, dtype=f64, device=dev), terms]), 0)
    partial = partial_all[s - 1]
    term = term * (offered / sf)
    rho = offered / sf
    gap = torch.clamp(1.0 - rho, min=_MIN_GAP)
    last = term / gap
    denom = partial + last
    p_wait = torch.where(
        (denom <= 0.0) | ~torch.isfinite(denom), 1.0,
        torch.clamp(last / torch.where(denom != 0.0, denom, 1.0), 0.0, 1.0))
    lq = p_wait * rho / gap
    lq = torch.where(torch.isfinite(lq), torch.clamp(lq, min=0.0),
                     horizon * mu)
    h = max(horizon, 1.0)
    sat = lam * h + torch.clamp((lam - sf * mu) * h, min=0.0)
    return torch.where(rho >= 1.0, sat, lq).cpu().numpy()


# ----------------------------------------------------------------------
# the booking plane
# ----------------------------------------------------------------------

def _dec_columns(n: int, t: int):
    """(column, per-record shape, dtype) of one staged decode record over
    ``n`` nodes and ``t`` tenants.  The last two columns are per-record
    scalars: the phase count increment and the record's peak watt
    point."""
    f64, i64 = torch.float64, torch.int64
    return (("tcell", (n, t), f64), ("scell", (n, t), f64),
            ("count", (n, t), i64), ("w", (n,), f64), ("dt", (n,), f64),
            ("ws", (n,), f64), ("phase_n", (), i64), ("wmax", (), f64))


def _idle_columns(n: int):
    """The idle record's columns (infra tenant only)."""
    f64, i64 = torch.float64, torch.int64
    return (("w", (n,), f64), ("dt", (n,), f64), ("ws", (n,), f64),
            ("count", (n,), i64), ("phase_n", (), i64), ("wmax", (), f64))


class _Stage:
    """One chunk of records being written on the host: a buffer per
    column (pinned for the card) and numpy views the fleet's records are
    written through."""

    def __init__(self, columns, pin: bool):
        self.bufs = [torch.empty((CHUNK,) + shape, dtype=dt, pin_memory=pin)
                     for _, shape, dt in columns]
        self.views = [b.numpy() for b in self.bufs]
        self.k = 0


class TorchAccumulator:
    """Deferred booking plane on a device: stage dense records, fold in
    chunks.

    The fleet calls ``book_dec``/``book_idle`` with the *already
    computed* batched arrays (indices, per-tenant cell adds, watt
    points); this class only defers the fold.  ``finalize`` drains the
    stages and adds the carries into the fleet's numpy tensors.  On the
    card every chunk's copy and fold are bracketed by CUDA events, read
    by ``timings`` after ``finalize``.
    """

    def __init__(self, fleet, device: DeviceLike = None):
        self.f = fleet
        self.device = resolve_device(device)
        n, t = fleet.n, len(fleet.tenant_names)
        self.n, self.t = n, t
        self._pin = self.device.type == "cuda"
        self._dec_cols = _dec_columns(n, t)
        self._idle_cols = _idle_columns(n)

        def carry(*shapes):
            return [torch.zeros(shape, dtype=dt, device=self.device)
                    for shape, dt in shapes]
        f64, i64 = torch.float64, torch.int64
        # cell ws, s, n, peak; phase ws, s, n, peak; node ws
        self._dec_carry = carry(((n, t), f64), ((n, t), f64),
                                ((n, t), i64), ((n, t), f64), ((), f64),
                                ((), f64), ((), i64), ((), f64), ((n,), f64))
        self._idle_carry = carry(((n,), f64), ((n,), f64), ((n,), i64),
                                 ((n,), f64), ((), f64), ((), f64),
                                 ((), i64), ((), f64), ((n,), f64))
        self._dec = _Stage(self._dec_cols, self._pin)
        self._idle = _Stage(self._idle_cols, self._pin)
        #: (kind, records, copy start, copy end, fold end) per chunk
        self._events: list = []
        self.records = 0

    # -- record builders ----------------------------------------------

    def book_dec(self, bi, cnt, tcell, scell, w, dt, ws, k, wmax):
        st = self._dec
        r = st.k
        tc, sc, cnk, dw, ddt, dws, pn, wm = st.views
        for a in (tc, sc, cnk, dw, ddt, dws):
            a[r] = 0
        tc[r, bi] = tcell
        sc[r, bi] = scell
        cnk[r, bi] = cnt * k
        dw[r, bi] = w
        ddt[r, bi] = dt
        dws[r, bi] = ws
        pn[r] = bi.size * k
        wm[r] = wmax
        st.k = r + 1
        if st.k == CHUNK:
            self._flush_dec()

    def book_idle(self, ii, w, dt, ws, k, wmax):
        st = self._idle
        r = st.k
        iw, idt, iws, cnk, pn, wm = st.views
        for a in (iw, idt, iws, cnk):
            a[r] = 0
        iw[r, ii] = w
        idt[r, ii] = dt
        iws[r, ii] = ws
        cnk[r, ii] = k
        pn[r] = ii.size * k
        wm[r] = wmax
        st.k = r + 1
        if st.k == CHUNK:
            self._flush_idle()

    # -- folds --------------------------------------------------------

    def _ship(self, st: _Stage, cols):
        """Copy a stage's first ``st.k`` records to the device (one
        non-blocking copy per column) and open a fresh stage.  A pinned
        buffer dropped here returns to torch's host cache only once its
        copy has run, so no wait is needed."""
        ev = None
        if self._pin:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        recs = [b[:st.k].to(self.device, non_blocking=True)
                for b in st.bufs]
        if ev is not None:
            ev[1].record()
        self.records += st.k
        fresh = _Stage(cols, self._pin)
        return recs, ev, fresh

    def _close(self, kind: str, k: int, ev) -> None:
        if ev is not None:
            ev[2].record()
            self._events.append((kind, k, ev))

    def _flush_dec(self):
        st = self._dec
        if not st.k:
            return
        k = st.k
        (tc, sc, cnk, w, dt, ws, pn, wm), ev, self._dec = \
            self._ship(st, self._dec_cols)
        cws, cs, cn, cpk, pws, ps, pnc, ppk, nws = self._dec_carry
        cws += tc.sum(0)
        cs += sc.sum(0)
        cn += cnk.sum(0)
        torch.maximum(cpk, torch.where(cnk > 0, w[:, :, None],
                                       -torch.inf).amax(0), out=cpk)
        pws += ws.sum()
        ps += dt.sum()
        pnc += pn.sum()
        top = torch.where(torch.isnan(wm), -torch.inf, wm).amax()
        ppk.copy_(torch.where(top > ppk, top, ppk))
        nws += ws.sum(0)
        self._close("dec", k, ev)

    def _flush_idle(self):
        st = self._idle
        if not st.k:
            return
        k = st.k
        (w, dt, ws, cnk, pn, wm), ev, self._idle = \
            self._ship(st, self._idle_cols)
        cws, cs, cn, cpk, pws, ps, pnc, ppk, nws = self._idle_carry
        cws += ws.sum(0)
        cs += dt.sum(0)
        cn += cnk.sum(0)
        # the stepped reference books idle peaks with np.maximum
        # (NaN-propagating), masked here to the nodes actually idling
        torch.maximum(cpk, torch.where(cnk > 0, w, -torch.inf).amax(0),
                      out=cpk)
        pws += ws.sum()
        ps += dt.sum()
        pnc += pn.sum()
        top = torch.where(torch.isnan(wm), -torch.inf, wm).amax()
        ppk.copy_(torch.where(top > ppk, top, ppk))
        nws += ws.sum(0)
        self._close("idle", k, ev)

    def finalize(self):
        """Drain the stages and add the deferred deltas into the fleet's
        numpy account (phase indices match ``vector.PHASES``)."""
        self._flush_dec()
        self._flush_idle()
        f = self.f
        from repro_torch.fleet.vector import _DEC, _IDLE
        cws, cs, cn, cpk, pws, ps, pn, ppk, nws = \
            [x.cpu().numpy() for x in self._dec_carry]
        f._cell_ws[:, :, _DEC] += cws
        f._cell_s[:, :, _DEC] += cs
        f._cell_n[:, :, _DEC] += cn
        f._cell_peak[:, :, _DEC] = np.maximum(f._cell_peak[:, :, _DEC], cpk)
        f._phase_ws[_DEC] += pws
        f._phase_s[_DEC] += ps
        f._phase_n[_DEC] += pn
        if ppk > f._phase_peak[_DEC]:
            f._phase_peak[_DEC] = ppk
        f._node_ws += nws
        iws_c, is_c, in_c, ipk, pws, ps, pn, ppk, nws = \
            [x.cpu().numpy() for x in self._idle_carry]
        f._cell_ws[:, f._infra, _IDLE] += iws_c
        f._cell_s[:, f._infra, _IDLE] += is_c
        f._cell_n[:, f._infra, _IDLE] += in_c
        f._cell_peak[:, f._infra, _IDLE] = np.maximum(
            f._cell_peak[:, f._infra, _IDLE], ipk)
        f._phase_ws[_IDLE] += pws
        f._phase_s[_IDLE] += ps
        f._phase_n[_IDLE] += pn
        if ppk > f._phase_peak[_IDLE]:
            f._phase_peak[_IDLE] = ppk
        f._node_ws += nws

    def timings(self) -> list:
        """Per chunk on the card, after ``finalize``: ``{"kind", "records",
        "h2d_ms", "fold_ms"}`` from the CUDA events around its copy and its
        fold (empty on the CPU)."""
        return [{"kind": kind, "records": k,
                 "h2d_ms": ev[0].elapsed_time(ev[1]),
                 "fold_ms": ev[1].elapsed_time(ev[2])}
                for kind, k, ev in self._events]

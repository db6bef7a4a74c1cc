"""The card's own power draw, read from NVML: the port's counterpart of the
paper's IPMI reading.

The paper reads whole-node watts from IPMI at a fixed interval during each
trial.  On the H100 the NVML library (``libnvidia-ml.so.1``, bound here
with ``ctypes`` as the kernels are) keeps a counter of the energy the card
has drawn since the GPU's kernel module loaded, in millijoules
(``nvmlDeviceGetTotalEnergyConsumption``).  ``nvmlDeviceGetPowerUsage`` is
not used: NVML documents it as a one-second average on Ampere and later
parts (GA100 aside), too slow for a window of a few seconds.

The counter's update period is not documented: ``update_period`` measures
it (poll at ~1 ms for 1 s, count the changes), and nothing here reads the
counter sooner than one period after its last reading.  A reading gives
the energy of the interval since the one before, so the draw it yields is
that interval's mean: ``sample_counter_during`` writes each as a step over
its interval, and bills a window only for the span of the calls it ran
(the last reading, one period after the calls end, is not billed beyond
them).  The billed energy is good to about one counter update at each end
of that span: the first reading may be up to a period stale, and the last
interval is split in proportion to time.  ``window_agreement`` states that
share (``ends``, two periods over the span) beside the share of the
counter's own difference the window did not bill (``rel``), and
``check_window`` refuses a window where either passes ``WINDOW_TOL``.
``NvmlSource`` is the same reading as a ``PowerSource`` (``watts(t)``:
the mean draw since the last reading, held between readings).

What the card draws is the card alone, not the node the paper metered: a
Watt*second figure from this source is card-only.

Every failure raises: a library that will not load, a call that returns a
non-zero ``nvmlReturn_t``.  Nothing falls back to a constant or a node
point.
"""
from __future__ import annotations

import ctypes
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.telemetry.sampler import PowerSampler
from repro_torch.telemetry.trace import PowerTrace

#: NVML's shared library
LIBRARY = "libnvidia-ml.so.1"
NVML_SUCCESS = 0
#: buffer sizes NVML documents for names and PCI bus ids
NAME_BUFFER = 96
#: how long and how often ``update_period`` polls the counter
PROBE_SECONDS = 1.0
PROBE_POLL = 1e-3
#: the sampler's poll interval for a source without a counter (the
#: reference's IPMI cadence analogue)
INTERVAL = 0.05
#: the most a window may leave unbilled of the counter's difference, and
#: the most one counter step at each end may be of its span
WINDOW_TOL = 0.05
#: a window's least length on the card, seconds: 50 periods of the H100's
#: ~0.1-s energy counter, so one step at each end is 4 % of it
WINDOW_S = 5.0


class NvmlError(RuntimeError):
    """NVML could not be loaded, or one of its calls failed."""


class Nvml:
    """NVML, bound with ``ctypes``: ``lib`` is the loaded library (tests
    hand in a stub object with the same functions).  Initialised on
    construction; every call raises ``NvmlError`` on a non-zero return."""

    def __init__(self, lib=None, library: str = LIBRARY):
        if lib is None:
            try:
                lib = ctypes.CDLL(library)
            except OSError as e:
                raise NvmlError(f"cannot load {library}: {e}") from e
            _declare(lib)
        self.lib = lib
        self.call("nvmlInit_v2")

    def call(self, fn: str, *args) -> None:
        rc = getattr(self.lib, fn)(*args)
        if rc != NVML_SUCCESS:
            raise NvmlError(f"{fn} returned {rc} ({self.error_string(rc)})")

    def error_string(self, rc: int) -> str:
        s = self.lib.nvmlErrorString(rc)
        return s.decode() if isinstance(s, bytes) else str(s)

    def handle(self, bus_id: str) -> ctypes.c_void_p:
        h = ctypes.c_void_p()
        self.call("nvmlDeviceGetHandleByPciBusId_v2", bus_id.encode(),
                  ctypes.byref(h))
        return h

    def name(self, handle) -> str:
        buf = ctypes.create_string_buffer(NAME_BUFFER)
        self.call("nvmlDeviceGetName", handle, buf, ctypes.c_uint(NAME_BUFFER))
        return buf.value.decode()

    def power_limit_w(self, handle) -> float:
        mw = ctypes.c_uint()
        self.call("nvmlDeviceGetPowerManagementLimit", handle,
                  ctypes.byref(mw))
        return mw.value / 1e3

    def energy_j(self, handle) -> float:
        """The card's energy since the GPU's kernel module loaded, in
        joules."""
        mj = ctypes.c_ulonglong()
        self.call("nvmlDeviceGetTotalEnergyConsumption", handle,
                  ctypes.byref(mj))
        return mj.value / 1e3


def _declare(lib) -> None:
    """Argument and return types of the NVML functions used here."""
    p, u = ctypes.c_void_p, ctypes.c_uint
    for fn, args in (("nvmlInit_v2", []),
                     ("nvmlDeviceGetHandleByPciBusId_v2",
                      [ctypes.c_char_p, ctypes.POINTER(p)]),
                     ("nvmlDeviceGetName", [p, ctypes.c_char_p, u]),
                     ("nvmlDeviceGetPowerManagementLimit",
                      [p, ctypes.POINTER(u)]),
                     ("nvmlDeviceGetTotalEnergyConsumption",
                      [p, ctypes.POINTER(ctypes.c_ulonglong)])):
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = ctypes.c_int
    lib.nvmlErrorString.argtypes = [ctypes.c_int]
    lib.nvmlErrorString.restype = ctypes.c_char_p


def pci_bus_id(device) -> str:
    """NVML's bus id (``DDDDDDDD:BB:DD.0``) of a CUDA device, from the
    properties PyTorch reads for it: the same card whatever the CUDA and
    NVML index orders."""
    import torch
    p = torch.cuda.get_device_properties(device)
    return f"{p.pci_domain_id:08X}:{p.pci_bus_id:02X}:{p.pci_device_id:02X}.0"


def update_period(read: Callable[[], float], seconds: float = PROBE_SECONDS,
                  poll: float = PROBE_POLL,
                  clock: Callable[[], float] = time.perf_counter,
                  sleep: Callable[[float], None] = time.sleep) -> float:
    """The median time between changes of the counter ``read`` returns,
    polled every ``poll`` seconds for ``seconds``.  Raises when it changed
    fewer than three times."""
    changes = []
    t_end = clock() + seconds
    last = read()
    while clock() < t_end:
        sleep(poll)
        v = read()
        if v != last:
            changes.append(clock())
            last = v
    if len(changes) < 3:
        raise NvmlError(f"the energy counter changed {len(changes)} times "
                        f"in {seconds} s: no update period to measure")
    gaps = sorted(b - a for a, b in zip(changes, changes[1:]))
    return gaps[len(gaps) // 2]


class NvmlSource:
    """The card behind a CUDA device (or a PCI ``bus_id``): its name, power
    limit, energy counter and the counter's ``period`` (measured by
    ``update_period`` unless given).

    As a ``PowerSource``, ``watts(t)`` is the mean draw between the two
    latest readings; it reads the counter when at least ``period`` has
    passed since the last reading and otherwise returns the last value."""

    def __init__(self, device=None, bus_id: Optional[str] = None,
                 period: Optional[float] = None, nvml: Optional[Nvml] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.nvml = nvml if nvml is not None else Nvml()
        self.bus_id = bus_id if bus_id is not None else pci_bus_id(device)
        self.handle = self.nvml.handle(self.bus_id)
        self.name = self.nvml.name(self.handle)
        self.power_limit_w = self.nvml.power_limit_w(self.handle)
        self.clock = clock
        self.period = period if period is not None \
            else update_period(self.energy_j)
        self._t = clock()
        self._j = self.energy_j()
        self._w = 0.0

    def energy_j(self) -> float:
        return self.nvml.energy_j(self.handle)

    def watts(self, t: float) -> float:
        now = self.clock()
        if now - self._t < self.period:
            return self._w
        j = self.energy_j()
        self._w = (j - self._j) / (now - self._t)
        self._t, self._j = now, j
        return self._w

    def describe(self) -> str:
        return (f"{self.name}, power limit {self.power_limit_w:.2f} W, "
                f"energy counter period {self.period * 1e3:.3f} ms")


def sample_counter_during(source: NvmlSource, fn: Callable[[], object],
                          sleep: Callable[[float], None] = time.sleep
                          ) -> tuple[object, PowerTrace, float]:
    """Run ``fn`` while a thread reads the card's energy counter, one
    period after each reading ends; one reading before ``fn`` and, once it
    returns, one at least a period after both the reading before and the
    return, so that the counter has moved past the calls.  Each reading's
    mean draw is a step over its interval, and the trace holds those steps
    over the span of ``fn`` only, on the span's own clock (from 0).
    Returns ``fn``'s result, that trace and the counter's difference
    between the first reading and the last."""
    start = source.clock()
    readings = [(0.0, source.energy_j())]       # (t, joules)
    stop = threading.Event()

    def read() -> None:
        readings.append((source.clock() - start, source.energy_j()))

    def poll() -> None:
        while not stop.wait(source.period):
            read()

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    t0 = source.clock() - start
    try:
        result = fn()
    finally:
        t1 = source.clock() - start
        stop.set()
        thread.join()
    wait = max(readings[-1][0], t1) + source.period \
        - (source.clock() - start)
    if wait > 0:
        sleep(wait)
    read()
    trace = PowerTrace()
    for (ta, ja), (tb, jb) in zip(readings, readings[1:]):
        a, b = max(ta, t0), min(tb, t1)
        if b > a:
            w = (jb - ja) / (tb - ta)
            trace.add(a - t0, w)
            trace.add(b - t0, w)
    return result, trace, readings[-1][1] - readings[0][1]


def window_agreement(trace: PowerTrace, counter_j: float,
                     period: float) -> dict:
    """A billed window beside the counter's difference over its readings:
    ``rel`` is the share of the counter's difference the trace does not
    hold (the first reading's staleness and the wait for the counter after
    the calls), ``ends`` the share of the span one counter ``period`` at
    each end makes (the billed energy's uncertainty at a steady draw)."""
    trace_j = trace.integrate()
    return {"counter_j": counter_j, "trace_j": trace_j,
            "rel": abs(counter_j - trace_j) / max(abs(counter_j), 1e-12),
            "ends": 2.0 * period / max(trace.duration, 1e-12),
            "period_s": period, "span_s": trace.duration}


def check_window(what: str, counter: Optional[dict],
                 tol: float = WINDOW_TOL) -> None:
    """Raise unless a window was read from the counter with ``rel`` and
    ``ends`` both within ``tol``."""
    if counter is None:
        raise NvmlError(f"{what}: the window was not read from the card's "
                        f"energy counter")
    for key, meaning in (("rel", "of the counter's difference unbilled"),
                         ("ends", "of the span in one counter step at each "
                                  "end")):
        if counter[key] > tol:
            raise NvmlError(
                f"{what}: {counter[key]:.4f} {meaning} > {tol} (counter "
                f"{counter['counter_j']:.3f} J, trace "
                f"{counter['trace_j']:.3f} J over {counter['span_s']:.4f} "
                f"s, period {counter['period_s'] * 1e3:.3f} ms)")


def describe_window(counter: Optional[dict]) -> str:
    """The counter's part of a window's log line ('' for no counter)."""
    if counter is None:
        return ""
    return (f"; counter {counter['counter_j']:.3f} J vs billed "
            f"{counter['trace_j']:.3f} J (unbilled {counter['rel']:.4f}, "
            f"ends {counter['ends']:.4f})")


@dataclass
class Window:
    """Calls of one function repeated back to back under a sampler: the
    trace over their span, each call's seconds, and (from an
    ``NvmlSource``) the counter's difference beside the trace's integral
    (``window_agreement``)."""
    trace: PowerTrace
    call_seconds: list = field(default_factory=list)
    counter: Optional[dict] = None

    @property
    def calls(self) -> int:
        return len(self.call_seconds)

    @property
    def seconds(self) -> float:
        return self.trace.duration

    @property
    def joules(self) -> float:
        return self.trace.integrate()

    @property
    def watts(self) -> float:
        return self.joules / self.seconds if self.seconds > 0 else 0.0

    @property
    def joules_per_call(self) -> float:
        return self.joules / self.calls

    def median_call_s(self) -> float:
        v = sorted(self.call_seconds)
        return v[len(v) // 2]


def sample_window(source, call: Callable[[], object], seconds: float = 2.0,
                  min_calls: int = 1,
                  check: Optional[Callable[[float], None]] = None,
                  phase: str = "window",
                  clock: Callable[[], float] = time.perf_counter) -> Window:
    """Repeat ``call`` (which waits for the device itself) back to back
    until at least ``min_calls`` calls and ``seconds`` have passed, under
    ``sample_counter_during`` for an ``NvmlSource`` and under a
    ``PowerSampler`` polling every ``INTERVAL`` for any other source;
    the window is marked as ``phase``.  ``check``, if given, sees the
    seconds elapsed after each call and may raise (a timeout)."""
    times: list = []

    def run() -> None:
        t0 = clock()
        while len(times) < min_calls or clock() - t0 < seconds:
            t = clock()
            call()
            times.append(clock() - t)
            if check is not None:
                check(clock() - t0)

    counter = None
    if isinstance(source, NvmlSource):
        _, trace, counter_j = sample_counter_during(source, run)
        counter = window_agreement(trace, counter_j, source.period)
    else:
        _, trace = PowerSampler(source, INTERVAL).sample_during(run)
    trace.mark_phase(phase, trace.samples[0][0], trace.samples[-1][0])
    return Window(trace=trace, call_seconds=times, counter=counter)

"""The card's energy counter through NVML: a frozen copy of the reader in
the port's ``repro_torch.telemetry.nvml`` (``Nvml.energy_j``,
``pci_bus_id`` and the library's declarations), bound with ``ctypes``.

``nvmlDeviceGetTotalEnergyConsumption`` counts the millijoules the card
has drawn since its driver loaded; the H100 updates it about every 0.1 s.
``Window`` brackets a measured window by two updates of the counter: it
waits for an update before the window opens and for the first update
after it closes, so the joules and seconds between the two updates are
the card's own, with no stale reading at either end.  Every failure
raises; nothing falls back to a constant.
"""
from __future__ import annotations

import ctypes
import time

LIBRARY = "libnvidia-ml.so.1"
#: how long to wait for the counter to move, and how often to look
TICK_WAIT_S = 1.0
POLL_S = 1e-3


class NvmlError(RuntimeError):
    pass


class Nvml:
    def __init__(self, device):
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            raise NvmlError(f"cannot load {LIBRARY}: {e}") from e
        p, u = ctypes.c_void_p, ctypes.c_uint
        for fn, args in (("nvmlInit_v2", []),
                         ("nvmlDeviceGetHandleByPciBusId_v2",
                          [ctypes.c_char_p, ctypes.POINTER(p)]),
                         ("nvmlDeviceGetPowerManagementLimit",
                          [p, ctypes.POINTER(u)]),
                         ("nvmlDeviceGetTotalEnergyConsumption",
                          [p, ctypes.POINTER(ctypes.c_ulonglong)])):
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_int
        self.lib = lib
        self._call("nvmlInit_v2")
        self.handle = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByPciBusId_v2",
                   pci_bus_id(device).encode(), ctypes.byref(self.handle))

    def _call(self, fn: str, *args) -> None:
        rc = getattr(self.lib, fn)(*args)
        if rc != 0:
            raise NvmlError(f"{fn} returned {rc}")

    def energy_j(self) -> float:
        mj = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self.handle,
                   ctypes.byref(mj))
        return mj.value / 1e3

    def power_limit_w(self) -> float:
        mw = ctypes.c_uint()
        self._call("nvmlDeviceGetPowerManagementLimit", self.handle,
                   ctypes.byref(mw))
        return mw.value / 1e3


def pci_bus_id(device) -> str:
    """NVML's bus id of a CUDA device, from PyTorch's properties."""
    import torch
    p = torch.cuda.get_device_properties(device)
    return f"{p.pci_domain_id:08X}:{p.pci_bus_id:02X}:{p.pci_device_id:02X}.0"


def next_tick(read, clock=time.perf_counter, sleep=time.sleep,
              wait: float = TICK_WAIT_S) -> tuple[float, float]:
    """(time, value) of the counter's next update."""
    last = read()
    end = clock() + wait
    while clock() < end:
        sleep(POLL_S)
        v = read()
        if v != last:
            return clock(), v
    raise NvmlError(f"the energy counter did not move in {wait} s")


class Window:
    """Joules and seconds between the counter update just before
    ``open()`` returns and the first one after ``close()`` is called."""

    def __init__(self, read, clock=time.perf_counter, sleep=time.sleep):
        self.read, self.clock, self.sleep = read, clock, sleep
        self.t0 = self.j0 = self.t1 = self.j1 = None

    def open(self) -> None:
        self.t0, self.j0 = next_tick(self.read, self.clock, self.sleep)

    def close(self) -> None:
        self.t1, self.j1 = next_tick(self.read, self.clock, self.sleep)

    @property
    def joules(self) -> float:
        return self.j1 - self.j0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

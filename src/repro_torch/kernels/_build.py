"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each kernel is one ``csrc/<name>.cu`` with a plain ``extern "C"`` launcher
that returns ``cudaGetLastError()``.  ``build`` compiles every requested
source that has no library yet, one ``nvcc`` process per source, all started
together, into ``kernels/build/lib<name>-<hash>.so`` (the hash covers the
source, the shared headers and the flags, so an edit rebuilds).  A library
is written under a temporary name and renamed into place, so processes that
build at once never load a half-written file.

Nothing is built or loaded when a module is imported: ``CudaKernel.launch``
builds its library at first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterable, Optional

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "build"
HEADERS = ("common.cuh", "mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

c_ptr = ctypes.c_void_p
c_int = ctypes.c_int


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in HEADERS:
        h.update((CSRC / hdr).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> dict[str, str]:
    """Compile each named kernel whose library is missing, all ``nvcc``s
    at once.  Returns ``name -> compiler log`` (the ``-Xptxas -v`` report
    of registers, shared memory and spills; read back from the log kept
    beside a library built earlier).  Raises if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs: dict[str, tuple[subprocess.Popen, Path, Path]] = {}
    logs: dict[str, str] = {}
    try:
        for name in names:
            lib = library_path(name)
            if lib.exists():
                log = lib.with_suffix(".log")
                logs[name] = log.read_text() if log.exists() else ""
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
            os.close(fd)
            cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), Path(tmp), lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            logs[name] = out
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                              f"{out}")
                continue
            lib.with_suffix(".log").write_text(out)
            os.replace(tmp, lib)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return logs


class CudaKernel:
    """One kernel's library, its launcher and its launch count.

    ``launch`` adds one to ``launches`` each time it calls the launcher —
    and nowhere else — so a run can show that its path went through the
    kernel.  A non-zero CUDA error from the launcher raises."""

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.argtypes = argtypes
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._fn: Optional[ctypes._CFuncPtr] = None
        self._errstr: Optional[ctypes._CFuncPtr] = None

    def load(self) -> None:
        if self._fn is not None:
            return
        build([self.name])
        lib = ctypes.CDLL(str(library_path(self.name)))
        fn = getattr(lib, f"{self.name}_launch")
        fn.argtypes = self.argtypes
        fn.restype = c_int
        err = getattr(lib, f"{self.name}_error_string")
        err.argtypes = [c_int]
        err.restype = ctypes.c_char_p
        self._lib, self._fn, self._errstr = lib, fn, err

    def launch(self, *args) -> None:
        self.load()
        self.launches += 1
        rc = self._fn(*args)
        if rc != 0:
            msg = self._errstr(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {rc} ({msg})")

    def requested_smem(self) -> int:
        """The most dynamic shared memory a kernel of the last launch
        asked for, as the launcher recorded it (``<name>_requested_smem``;
        the four kernels narrowing pre-checks export it)."""
        self.load()
        fn = getattr(self._lib, f"{self.name}_requested_smem")
        fn.argtypes = []
        fn.restype = c_int
        return int(fn())


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_operand(name: str, t: torch.Tensor, ndim: int,
                  dtypes: tuple, device: torch.device) -> None:
    """What every launcher assumes of a pointer it is given: a dense
    row-major CUDA tensor on ``device``, 16-byte aligned, of a taken
    dtype."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got "
                         f"{t.device}")
    if t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")

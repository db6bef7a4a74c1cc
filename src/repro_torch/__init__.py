"""repro_torch — the PyTorch/CUDA port of ``repro``, for one NVIDIA H100.

The JAX package ``repro`` stays the reference; every module here names its
counterpart and keeps its module path, so ``repro.models.layers`` is ported
by ``repro_torch.models.layers``.  The port imports ``torch`` and nothing of
``jax`` or ``repro``: what it needs of a jax-free reference module is copied.

Entry points (``models.model.Model``, ``serve.engine.ServeLoop``) run on the
CUDA device unless the caller passes ``device="cpu"``; with no card and no
such argument they raise (``repro_torch.device.resolve_device``).  The three
kernels of the offload plan (``kernels.mriq``, ``kernels.flash_attention``,
``kernels.swiglu``) are hand-written CUDA C++ for ``sm_90a``, built with
``nvcc`` at first use and bound with ``ctypes``; on CPU tensors the public
wrappers in ``kernels.ops`` run the plain PyTorch versions in
``kernels.ref``.
"""
from repro_torch.device import resolve_device  # noqa: F401

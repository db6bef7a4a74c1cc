"""Device resolution for the port's entry points.

The port runs on the CUDA device by default.  The CPU is used only when the
caller names it (the tests do, to compare against the JAX reference); a
missing card with no explicit device is an error, never a quiet fallback.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without a card);
    ``"cpu"``/``"cuda[:n]"``/``torch.device`` as given, checked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        hint = " (pass device='cpu' to run the plain versions)" \
            if device is None else ""
        raise RuntimeError(f"no CUDA device available{hint}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def same_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` lie on; raises when they differ."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors lie on different devices: "
                         f"{sorted(map(str, devs))}")
    return devs.pop()

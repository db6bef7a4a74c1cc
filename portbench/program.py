"""What the harness takes from the program under test, the port
(``repro_torch``): its configuration, its model on the harness's
weights, and its kernels' launch counters.  The plain references never
import this module.
"""
from __future__ import annotations

import sys

import torch
from torch import nn

from portbench import core

if str(core.ROOT / "src") not in sys.path:
    sys.path.insert(0, str(core.ROOT / "src"))

from repro_torch.configs.base import ArchConfig, get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


def arch_for(config: dict, arch: ArchConfig | None = None) -> ArchConfig:
    """The port's configuration of ``config["arch"]`` (or ``arch``),
    held to the numbers of the configuration file: a key that differs
    raises."""
    arch = arch or get_config(config["arch"])
    for k, v in core.reference(config["reference"]).port_numbers(arch).items():
        if config[k] != v:
            raise ValueError(f"{config['arch']}: the port's {k} is {v!r}, "
                             f"the configuration file's {config[k]!r}")
    return arch


def build(config: dict, arch: ArchConfig, params: dict, device):
    """(Model under the file's plan, its weights: the port's module
    holding the harness's tensors ``params``)."""
    model = Model(arch, arch.plan.replace(**config["plan"]),
                  torch.device(device))
    weights = T.Transformer(arch, torch.device("meta"))
    have = {n: tuple(p.shape) for n, p in weights.named_parameters()}
    want = {n: tuple(t.shape) for n, t in params.items()}
    if have != want:
        raise ValueError(f"the port's parameters differ from the "
                         f"reference's: {sorted(set(have) ^ set(want))[:5]}"
                         f" {[n for n in have if have[n] != want.get(n)][:5]}")
    for name, t in params.items():
        mod, _, leaf = name.rpartition(".")
        sub = weights.get_submodule(mod) if mod else weights
        p = nn.Parameter(t, requires_grad=False)
        if isinstance(sub, nn.ParameterDict):
            sub[leaf] = p
        else:
            sub.register_parameter(leaf, p)
    return model, weights


def launches() -> dict:
    """Each of the port's kernels' launch count so far."""
    from repro_torch.kernels._build import KERNELS
    return {k.name: k.launches for k in KERNELS}


def kernel_modules() -> None:
    """Import every kernel wrapper, so each launch counter exists."""
    from repro_torch.kernels import ops  # noqa: F401

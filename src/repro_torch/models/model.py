"""Model facade: init / prefill / decode on one device.

Counterpart of ``repro.models.model.Model``.  ``Model`` holds the config,
the plan and the device; the weights are a ``models.transformer.Transformer``
that ``init`` or ``load`` returns and every step takes, as the reference's
steps take their params pytree.  ``loss`` waits for the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, PlanConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T


class Model:
    def __init__(self, cfg: ArchConfig, plan: Optional[PlanConfig] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.plan = plan or cfg.plan
        self.device = resolve_device(device)
        T.check_supported(cfg)

    def with_plan(self, plan: PlanConfig) -> "Model":
        return Model(self.cfg, plan, self.device)

    # -- parameters ----------------------------------------------------------

    def init(self, generator: torch.Generator) -> T.Transformer:
        """Random weights from ``generator`` (which lies on this model's
        device), allocated directly on the device."""
        return T.Transformer(self.cfg, self.device).init_(generator)

    def load(self, state: dict) -> T.Transformer:
        """Weights from a state dict (e.g. ``convert.params_from_jax``)."""
        params = T.Transformer(self.cfg, self.device)
        params.load_state_dict(state)
        return params

    def init_cache(self, batch: int, seq_len: int) -> list:
        return T.init_cache(self.cfg, batch, seq_len, self.device)

    # -- steps ---------------------------------------------------------------

    def forward(self, params: T.Transformer, batch: dict):
        """Teacher-forced logits (B,S,V) over the whole batch."""
        return T.forward(params, batch, self.cfg, self.plan)[0]

    def prefill(self, params: T.Transformer, batch: dict, cache: list):
        logits, cache = T.forward(params, batch, self.cfg, self.plan,
                                  cache=cache)
        return logits[:, -1], cache

    def decode_step(self, params: T.Transformer, batch: dict, cache: list):
        logits, cache = T.forward(params, batch, self.cfg, self.plan,
                                  cache=cache, decode=True)
        return logits[:, -1], cache

"""Weights of the JAX reference -> the port's state dict.

``params_from_jax(cfg, tree)`` takes the pytree of ``repro.models.model.
Model.init`` with its leaves as numpy arrays (``jax.tree.map(np.asarray,
params)``): the ``scan`` stack (one unit of stacked layers), the ``tail``
dict of unrolled layers, ``embed``, ``lm_head`` and ``final_norm``.  It
returns the ``state_dict`` of ``models.transformer.Transformer`` on the CPU
(``Model.load`` moves it to the model's device).  This is how the tests put
the same weights into both packages: the two have different random
generators, so they are never compared by seed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import check_supported


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr))


def _put(state: dict, prefix: str, sub: dict, index=None) -> None:
    for k, val in sub.items():
        if isinstance(val, dict):
            _put(state, f"{prefix}{k}.", val, index)
        else:
            arr = np.asarray(val)
            state[prefix + k] = _tensor(arr if index is None else arr[index])


def params_from_jax(cfg: ArchConfig, tree: dict) -> dict:
    check_supported(cfg)
    state: dict = {"embed": _tensor(np.asarray(tree["embed"]))}
    if "lm_head" in tree:
        state["lm_head"] = _tensor(np.asarray(tree["lm_head"]))
    _put(state, "final_norm.", tree["final_norm"])
    layer = 0
    scan = tree.get("scan", {})
    if scan:
        units = sorted(scan, key=lambda k: int(k[1:]))      # l0, l1, ...
        n_full = np.asarray(scan[units[0]]["norm1"]["scale"]).shape[0]
        for li in range(n_full):
            for u in units:
                _put(state, f"layers.{layer}.", scan[u], index=li)
                layer += 1
    tail = tree.get("tail", {})
    for t in sorted(tail, key=lambda k: int(k[1:])):        # t0, t1, ...
        _put(state, f"layers.{layer}.", tail[t])
        layer += 1
    if layer != cfg.n_layers:
        raise ValueError(f"tree holds {layer} layers, config has "
                         f"{cfg.n_layers}")
    return state

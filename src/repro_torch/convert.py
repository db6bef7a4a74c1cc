"""Weights of the JAX reference -> the port's state dict.

``params_from_jax(cfg, tree)`` takes the pytree of ``repro.models.model.
Model.init`` with its leaves as numpy arrays (``jax.tree.map(np.asarray,
params)``): the ``scan`` stack (one unit of stacked layers), the ``tail``
dict of unrolled layers (MoE experts, LayerNorm biases and all), ``embed``,
``lm_head``, the audio ``frontend`` and ``final_norm``.  It
returns the ``state_dict`` of ``models.transformer.Transformer`` on the CPU
(``Model.load`` moves it to the model's device).  This is how the tests put
the same weights into both packages: the two have different random
generators, so they are never compared by seed.

``leaf_groups(cfg)`` maps each leaf of that pytree, in the reference's leaf
order, to the port's parameter names it stacks (the ``scan`` leaves: one
name per full unit, in unit order).  The optimizers and the gradient
compression keep their state and statistics per reference leaf through it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import (_norm_spec, check_supported,
                                            layer_spec, unit_structure)


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
    for k in ("lm_head", "frontend"):
        if k in tree:
            state[k] = _tensor(np.asarray(tree[k]))
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


def leaf_groups(cfg: ArchConfig) -> list[tuple[str, list[str]]]:
    """[(reference leaf path, the port's parameter names)] in the order
    ``jax.tree.leaves`` walks the reference's params (dict keys sorted).
    A ``scan/l<u>/...`` leaf stacks layer ``li * size + u`` of each full
    unit ``li``; every other leaf is one parameter."""
    check_supported(cfg)
    kinds = cfg.layer_kinds()
    size, n_full = unit_structure(cfg)
    top: dict = {"embed": ["embed"],
                 "final_norm": {k: [f"final_norm.{k}"]
                                for k in _norm_spec(cfg)}}
    if not cfg.tie_embeddings:
        top["lm_head"] = ["lm_head"]
    if cfg.frontend == "audio_frames":
        top["frontend"] = ["frontend"]

    def layer(rows: list[int]) -> dict:
        return {name: {k: [f"layers.{i}.{name}.{k}" for i in rows]
                       for k in params}
                for name, params in layer_spec(cfg, kinds[rows[0]]).items()}
    if n_full:
        top["scan"] = {f"l{u}": layer([li * size + u for li in range(n_full)])
                       for u in range(size)}
    tail = range(n_full * size, len(kinds))
    if len(tail):
        top["tail"] = {f"t{j}": layer([i]) for j, i in enumerate(tail)}

    out: list = []

    def walk(prefix: str, node) -> None:
        if isinstance(node, list):
            out.append((prefix, node))
            return
        for k in sorted(node):
            walk(f"{prefix}/{k}" if prefix else k, node[k])
    walk("", top)
    return out

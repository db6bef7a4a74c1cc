"""Parameter / optimizer-state / cache / batch sharding specs.

Counterpart of ``repro.parallel.param_sharding``.  Maps every parameter,
optimizer-state, cache and batch tensor to a spec (``parallel.sharding``:
one entry per dim) by dispatching on its names.  Weights use 2D (fsdp ×
tensor) sharding; optimizer state inherits the param sharding (ZeRO by
construction); factored adafactor stats drop the reduced axis; KV caches
shard (batch, seq-or-kvheads).

A sharded tensor must divide every dimension evenly, so each leaf carries a
*candidate list* of logical specs; the first candidate that keeps the most
mesh axes after the divisibility check wins (e.g. qwen2's 28 heads can't
take 16-way TP, so its attention weights fall back to sharding the d_head
dimension; mamba2's 50280 vocab falls back to sharding d_model).  The
tables, ``legalize`` and ``pick_spec`` are the reference's, op for op.

The walks differ from the reference's, which walks a jax pytree whose
layer units are stacked for ``lax.scan`` (a leading stack axis, always
replicated):

  * ``param_spec_tree`` walks the port's ``state_dict`` names
    (``layers.{i}.mixer.wq``); each per-layer parameter gets the
    reference's spec of the stacked leaf it came from without the stack
    axis.
  * ``opt_shardings`` walks the port's optimizer state, which is kept per
    reference leaf (``convert.leaf_groups``: ``m``/``v``/``ef`` keyed by
    ``scan/l0/mixer/wq``, stacked as the reference stacks them), so each
    state tensor gets the reference's spec, stack axis included.  The
    reference's quirks are kept: a state leaf whose path is not a
    parameter's (int8 Adam's ``q``/``scale`` blocks, Adafactor's unfactored
    ``v``) falls to the empty spec, replicated (ROADMAP.md §C, C7).
  * ``cache_shardings`` walks the port's per-layer cache list; each entry
    gets the reference's spec without the stack axis.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

from repro_torch.parallel.sharding import (ShardingRules, axis_sizes,
                                           entry_axes, spec_entry)

# 'model_dim' is a direct model-axis binding used for fallback candidates.
_ATTN = {
    "wq": [("embed", "heads", None), ("embed", None, "model_dim")],
    "wk": [("embed", "kv_heads", None), ("embed", None, "model_dim")],
    "wv": [("embed", "kv_heads", None), ("embed", None, "model_dim")],
    "wo": [("heads", None, "embed"), (None, "model_dim", "embed")],
    "bq": [("heads", None), (None, "model_dim")],
    "bk": [("kv_heads", None), (None, "model_dim")],
    "bv": [("kv_heads", None), (None, "model_dim")],
}
_MLP = {
    "wi": [("embed", "ff")],
    "wg": [("embed", "ff")],
    "wo": [("ff", "embed")],
    "bi": [("ff",)],
    "bo": [(None,)],
}
_MOE = {
    "router": [("embed", "experts")],
    "wi": [("experts", "embed", None)],
    "wg": [("experts", "embed", None)],
    "wo": [("experts", None, "embed")],
}
_SSM = {
    "in_proj": [("embed", "inner")],
    "conv_w": [(None, "inner")],
    "conv_b": [("inner",)],
    "A_log": [(None,)],
    "D": [(None,)],
    "dt_bias": [(None,)],
    "norm": [("inner",)],
    "out_proj": [("inner", "embed")],
}
_RGLRU = {
    "w_in_x": [("embed", "inner")],
    "w_in_g": [("embed", "inner")],
    "conv_w": [(None, "inner")],
    "conv_b": [("inner",)],
    "w_a": [(None, "inner")],
    "b_a": [("inner",)],
    "w_x": [(None, "inner")],
    "b_x": [("inner",)],
    "lam": [("inner",)],
    "w_out": [("inner", "embed")],
}


def _leaf_candidates(names: list[str], ndim: int) -> list[tuple]:
    last = names[-1]
    if last == "embed":
        return [("vocab", "embed"), (None, "model_dim")]
    if last == "lm_head":
        return [("embed", "vocab"), ("model_dim", None)]
    if last == "frontend":
        return [("embed", "model_dim")]
    if "norm1" in names or "norm2" in names or "final_norm" in names:
        return [(None,) * ndim]
    table = None
    if "moe" in names:
        table = _MOE
    elif "mlp" in names:
        table = _MLP
    elif "mixer" in names:
        table = {**_ATTN, **_SSM, **_RGLRU}
    cands = table.get(last) if table else None
    return cands or [(None,) * ndim]


def _axes_for(rules: ShardingRules, name: Optional[str]):
    if name is None:
        return None
    if name == "model_dim":
        # direct model-axis fallback; inert when the plan disables TP
        return ("model",) if rules.rules.get("ff") else None
    return rules.rules.get(name)


def legalize(shape: tuple, spec: Sequence, rules: ShardingRules) -> tuple:
    """Drop mesh axes that don't divide their dimension evenly."""
    sizes = axis_sizes(rules.mesh)
    out = []
    for i, name in enumerate(spec):
        axes = _axes_for(rules, name)
        if not axes:
            out.append(None)
            continue
        k = 1
        for a in axes:
            k *= sizes[a]
        out.append(tuple(axes) if shape[i] % k == 0 else None)
    return tuple(out)


def _n_sharded(spec: tuple) -> int:
    return sum(1 for s in spec if s)


def pick_spec(shape: tuple, candidates: list[tuple],
              rules: ShardingRules) -> tuple:
    best: tuple = (None,) * len(shape)
    best_n = -1
    for cand in candidates:
        cand = tuple(cand)[:len(shape)]
        cand = cand + (None,) * (len(shape) - len(cand))
        legal = legalize(shape, cand, rules)
        if _n_sharded(legal) > best_n:
            best, best_n = legal, _n_sharded(legal)
    return tuple(spec_entry(a) for a in best)


def leaf_spec(names: list[str], shape: tuple, rules: ShardingRules) -> tuple:
    """The spec of one parameter leaf by its path ``names``; a reference
    path under ``scan`` is a stacked leaf (its first axis replicated)."""
    stacked = "scan" in names
    cands = _leaf_candidates(names, len(shape) - (1 if stacked else 0))
    if stacked:
        cands = [(None,) + tuple(c) for c in cands]
    return pick_spec(tuple(shape), cands, rules)


def _named(params: Any) -> Mapping:
    return params if isinstance(params, Mapping) \
        else dict(params.named_parameters())


def param_spec_tree(params: Any, rules: ShardingRules) -> dict:
    """Parameter name -> spec, for ``params`` (a ``Transformer``, or a dict
    of its ``state_dict`` names -> tensors)."""
    return {name: leaf_spec(name.split("."), tuple(t.shape), rules)
            for name, t in _named(params).items()}


def _reference_leaf_specs(cfg, params: Any, rules: ShardingRules) -> dict:
    """Reference leaf path (a tuple of names) -> the spec of that (stacked)
    leaf, over the port's parameters grouped by ``convert.leaf_groups``."""
    from repro_torch.convert import leaf_groups
    from repro_torch.train.optimizer import leaf_shape
    named = _named(params)
    out = {}
    for path, names in leaf_groups(cfg):
        keys = path.split("/")
        out[tuple(keys)] = leaf_spec(
            keys, leaf_shape(path, [named[n] for n in names]), rules)
    return out


def opt_shardings(opt_state: Any, params: Any, rules: ShardingRules,
                  cfg=None) -> Any:
    """Specs of the port's optimizer state (``train.step.make_opt_init``),
    in its nesting: ``m``/``v``/``ef`` inherit the spec of their parameter
    leaf, Adafactor's ``vr`` drops the last axis and ``vc`` the second to
    last, and everything else (``step``, int8 Adam's blocks, Adafactor's
    unfactored ``v``) is replicated, as the reference resolves them.
    ``cfg`` defaults to ``params.cfg``."""
    cfg = params.cfg if cfg is None else cfg
    flat_pspecs = _reference_leaf_specs(cfg, params, rules)
    sizes = axis_sizes(rules.mesh)

    def fn(names: list[str], leaf) -> tuple:
        if not hasattr(leaf, "shape") or leaf.ndim == 0:
            return ()
        head, kind = names[0], names[-1]
        if head in ("m", "v", "ef"):
            ppath = tuple(names[1:])
            k = "full"
            if kind in ("vr", "vc"):
                ppath = tuple(names[1:-1])
                k = kind
            pspec = flat_pspecs.get(ppath)
            if pspec is None:
                return ()
            parts = tuple(pspec)
            if k == "vr":
                parts = parts[:-1]
            elif k == "vc":
                parts = parts[:-2] + parts[-1:]
            parts = parts[:leaf.ndim]
            parts = parts + (None,) * (leaf.ndim - len(parts))
            # re-check divisibility (factored shapes differ from params)
            legal = []
            for i, ax in enumerate(parts):
                if not ax:
                    legal.append(None)
                    continue
                axes = entry_axes(ax)
                kk = 1
                for a in axes:
                    kk *= sizes[a]
                legal.append(spec_entry(axes)
                             if leaf.shape[i] % kk == 0 else None)
            return tuple(legal)
        return ()

    def walk(names: list[str], node):
        if isinstance(node, Mapping):
            return {k: walk(names + k.split("/"), v) for k, v in node.items()}
        return fn(names, node)

    return walk([], opt_state)


_CACHE = {
    "k": [("cache_batch", "cache_seq", "cache_kv_heads", None)],
    "v": [("cache_batch", "cache_seq", "cache_kv_heads", None)],
    "k_scale": [("cache_batch", "cache_seq", "cache_kv_heads", None)],
    "v_scale": [("cache_batch", "cache_seq", "cache_kv_heads", None)],
    "kpos": [(None,)],
    "conv": [("cache_batch", None, "act_inner")],
    "h": [("cache_batch", "act_inner")],
    "ssm": [("cache_batch", "act_inner", None, None)],   # (B,H,P,N): H on model
}


def cache_shardings(cache: list, rules: ShardingRules) -> list:
    """One dict of specs per layer of the port's cache
    (``Model.init_cache``)."""
    return [{k: pick_spec(tuple(t.shape),
                          _CACHE.get(k, [(None,) * t.ndim]), rules)
             for k, t in layer.items()} for layer in cache]


def batch_shardings(model, shape, rules: ShardingRules) -> dict:
    """Input name -> spec for the step of ``shape`` (``Model.input_specs``,
    ``Model.batch_spec_names``)."""
    names = model.batch_spec_names(shape)
    specs = model.input_specs(shape)
    return {k: pick_spec(specs[k].shape, [v], rules)
            for k, v in names.items()}


# ---------------------------------------------------------------------------
# DTensor parameters, optimizer state and caches
# ---------------------------------------------------------------------------


def distribute_tensor(t, spec: Sequence, mesh: Any):
    """``t`` (the whole tensor, the same on every rank) as a ``DTensor`` at
    the placements of ``spec`` on ``mesh``.  Each rank keeps its own slice
    of the tensor it holds: nothing is sent (on the meta device nothing is
    allocated).  A ``DTensor`` is redistributed."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import distribute_tensor as dist_t
    from repro_torch.parallel.sharding import to_placements
    placements = to_placements(spec, mesh)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements)
    return dist_t(t.detach(), mesh, placements, src_data_rank=None)


def distribute_tree(tree: Any, specs: Any, mesh: Any) -> Any:
    """``distribute_tensor`` over nested dicts and lists of tensors, with
    ``specs`` in the same nesting (0-d leaves replicated)."""
    if isinstance(tree, Mapping):
        return {k: distribute_tree(v, specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return distribute_tensor(tree, specs, mesh)


def distribute(rules: ShardingRules, params: Any, opt_state: Any = None,
               cache: Optional[list] = None, cfg=None):
    """Lay a ``Transformer``'s parameters, and optionally an optimizer
    state (``train.step.make_opt_init``) and a cache
    (``Model.init_cache``), onto ``rules.mesh`` as ``DTensor``s at the
    placements that ``param_spec_tree``, ``opt_shardings`` and
    ``cache_shardings`` resolve.  The parameters are replaced in place
    (each a frozen ``nn.Parameter`` over its ``DTensor``); returns
    ``(params, opt_state, cache)``, ``None`` for what was not given."""
    import torch
    mesh = rules.mesh
    if opt_state is not None:
        # the state's specs are resolved on the parameters' global shapes
        opt_state = distribute_tree(
            opt_state, opt_shardings(opt_state, params, rules, cfg), mesh)
    specs = param_spec_tree(params, rules)
    for name, p in list(params.named_parameters()):
        *path, leaf = name.split(".")
        mod = params.get_submodule(".".join(path)) if path else params
        d = distribute_tensor(p.data, specs[name], mesh)
        q = torch.nn.Parameter(d, requires_grad=False)
        if isinstance(mod, torch.nn.ParameterDict):
            mod[leaf] = q
        else:
            setattr(mod, leaf, q)
    if cache is not None:
        cache = distribute_tree(cache, cache_shardings(cache, rules), mesh)
    return params, opt_state, cache


def shardings_of(tree: Any) -> Any:
    """The ``(mesh, placements)`` of every ``DTensor`` in ``tree`` (a
    module as its ``state_dict``; nested dicts), in its nesting: what
    ``ckpt.checkpoint.restore(..., shardings=)`` lays a checkpoint onto."""
    import torch
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, Mapping):
        return {k: shardings_of(v) for k, v in tree.items()}
    return (tree.device_mesh, tuple(tree.placements))

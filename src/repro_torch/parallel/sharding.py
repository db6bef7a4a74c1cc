"""Logical-axis sharding rules on a torch ``DeviceMesh``.

Counterpart of ``repro.parallel.sharding``.  Model code annotates tensors
with *logical* axis names; this module maps them to mesh axes for a given
mesh + plan.  The mapping is where the per-arch divisibility decisions live
(e.g. qwen2's 28 heads on a 16-way TP axis), and where the plan's FSDP /
sequence-parallel genes take effect.  ``MeshAxes``, ``mesh_axes``,
``head_strategy``, ``make_rules``, ``logical`` and ``spec_for`` are the
reference's, op for op, over a ``DeviceMesh``'s dimension names and sizes.

A spec is the port's ``PartitionSpec``: a tuple with one entry per tensor
dim, each ``None`` (replicated), a mesh axis name, or a tuple of axis
names (the dim split over several mesh axes, the first the most
significant), normalised as jax normalises its ``PartitionSpec`` (a
one-axis tuple is the name).  An empty spec replicates every dim.
``to_placements`` turns a spec into DTensor placements, one per mesh dim;
``constrain`` redistributes a ``DTensor`` to them.

Parameters distributed as DTensors (``param_sharding.distribute``) are
stored at their specs' placements.  Under a plan with ``use_tp`` a layer
runs on its shards (``parallel.tp``): the model axis splits its products.
A plan without it folds the model axis into the batch axes, and its
layers run on their gathered operands (``layer_operands``): the weights
redistributed to ``Replicate()``, the input and cache to their batch
placements only, the gradients reduced back onto the stored placements —
ZeRO-3, that plan's own execution.

Mesh axes:
  single-pod   (data=16, model=16)
  multi-pod    (pod=2, data=16, model=16)   # batch shards over (pod, data)
  one card     (data=1, model=1)            # launch.mesh.make_host_mesh
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Optional, Sequence

from repro_torch.configs.base import ArchConfig, PlanConfig


@dataclass(frozen=True)
class MeshAxes:
    batch: tuple[str, ...]      # ("pod","data") or ("data",)
    model: str = "model"


def axis_sizes(mesh: Any) -> dict[str, int]:
    """Mesh dimension name -> its size."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_axes(mesh: Any) -> MeshAxes:
    names = mesh.mesh_dim_names
    if "pod" in names:
        return MeshAxes(batch=("pod", "data"))
    return MeshAxes(batch=("data",))


def _axis_size(mesh: Any, name: str) -> int:
    return axis_sizes(mesh)[name]


def spec_entry(axes: Optional[Sequence[str]]):
    """One spec entry: ``None``, an axis name, or a tuple of >= 2 names."""
    if not axes:
        return None
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else axes


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def n_shards(spec: Sequence, mesh: Any) -> int:
    """Into how many pieces ``spec`` cuts a tensor on ``mesh`` (1: every
    device holds all of it, as on a ``(1, 1)`` mesh)."""
    sizes = axis_sizes(mesh)
    n = 1
    for entry in spec:
        for a in entry_axes(entry):
            n *= sizes[a]
    return n


def to_placements(spec: Sequence, mesh: Any) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` elsewhere.

    A dim split over several mesh axes (``("pod", "data")``) becomes a
    ``Shard(d)`` on each; DTensor orders such shards by mesh dim, which is
    jax's major-to-minor order only when the spec names the axes in mesh
    order, so any other order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} of dim {d} names mesh "
                             f"axes out of the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {tuple(spec)!r}")
            out[i] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class ShardingRules:
    """Resolved logical-axis → mesh-axis mapping for (arch, mesh, plan)."""

    rules: dict[str, Optional[tuple[str, ...]]]
    mesh: Any                   # torch.distributed.device_mesh.DeviceMesh

    def spec(self, *names: Optional[str]) -> tuple:
        out = []
        used: set[str] = set()
        for n in names:
            axes = self.rules.get(n) if n is not None else None
            if axes:
                axes = tuple(a for a in axes if a not in used)
            if axes:
                used.update(axes)
                out.append(spec_entry(axes))
            else:
                out.append(None)
        return tuple(out)

    def placements(self, *names: Optional[str]) -> tuple:
        """The DTensor placements of ``spec(*names)``, one per mesh dim."""
        return to_placements(self.spec(*names), self.mesh)


def head_strategy(cfg: ArchConfig, tp: int) -> str:
    """Pick which head axis carries TP (the reference's divisibility
    table).

    'kv'    — shard the kv-head axis (grouped einsum, kv stays sharded)
    'group' — shard the q-per-kv group axis (kv replicated along TP)
    'flat'  — shard flattened q heads (padded), kv replicated
    """
    if cfg.n_heads == 0:
        return "none"
    if cfg.n_kv_heads % tp == 0:
        return "kv"
    if cfg.q_per_kv % tp == 0:
        return "group"
    return "flat"


def make_rules(cfg: ArchConfig, mesh: Any, plan: PlanConfig) -> ShardingRules:
    ax = mesh_axes(mesh)
    if not plan.use_tp:
        # pure data parallel: the model axis joins batch sharding; weights
        # replicate across 'model' (ZeRO still shards them over the full
        # batch product when fsdp is on)
        batch = ax.batch + ("model",)
        fsdp = batch if plan.fsdp else None
        rules: dict[str, Optional[tuple[str, ...]]] = {
            "batch": batch,
            "seq": None, "seq_sharded": None,
            "act_embed": None, "act_ff": None, "act_heads": None,
            "act_kv_heads": None, "act_group": None, "act_experts": None,
            "act_inner": None,
            "embed": fsdp, "vocab": None, "ff": None, "heads": None,
            "kv_heads": None, "group": None, "experts": None,
            "expert_ff": None, "inner": None, "conv_k": None, "stack": None,
            "head_dim": None,
            "cache_batch": batch, "cache_seq": None, "cache_kv_heads": None,
        }
        return ShardingRules(rules=rules, mesh=mesh)

    tp = _axis_size(mesh, "model")
    batch = ax.batch
    model = ("model",)
    fsdp: Optional[tuple[str, ...]] = batch if plan.fsdp else None

    hs = head_strategy(cfg, tp)
    rules: dict[str, Optional[tuple[str, ...]]] = {
        # activations
        "batch": batch,
        "seq": None,
        "seq_sharded": model if plan.seq_shard else None,   # SP residual stream
        "act_embed": None,
        "act_ff": model,
        "act_heads": model if hs == "flat" else None,
        "act_kv_heads": model if hs == "kv" else None,
        "act_group": model if hs == "group" else None,
        "act_experts": model if plan.shard_moe_experts else None,
        "act_inner": model,            # mamba2 / rglru inner width
        # weights: 2D (fsdp × tensor) sharding
        "embed": fsdp,                 # d_model rows of big matrices
        "vocab": model,                # vocab columns (uneven: legalised)
        "ff": model,
        "heads": model if hs in ("flat",) else None,
        "kv_heads": model if hs == "kv" else None,
        "group": model if hs == "group" else None,
        "experts": model if plan.shard_moe_experts else None,
        "expert_ff": None,             # expert d_ff stays local under EP
        "inner": model,
        "conv_k": None,
        "head_dim": None,
        "stack": None,                 # stacked-layer leading axis
        # kv-cache storage
        "cache_batch": batch,
        "cache_seq": model if hs != "kv" else None,   # seq-shard cache when heads can't take TP
        "cache_kv_heads": model if hs == "kv" else None,
    }
    return ShardingRules(rules=rules, mesh=mesh)


# Convenience wrappers -------------------------------------------------------


def logical(rules: ShardingRules, names: Sequence[Optional[str]]) -> tuple:
    """The placements of logical ``names`` (a ``NamedSharding``'s
    counterpart on a ``DeviceMesh``)."""
    return rules.placements(*names)


def spec_for(rules: ShardingRules, names: Sequence[Optional[str]]) -> tuple:
    return rules.spec(*names)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mixed_inputs(x):
    """A context in which plain tensors count as replicated beside the
    ``DTensor`` ``x`` (nothing when ``x`` is plain): torch's
    ``implicit_replication``, which nests (torch's own resets the switch
    to off when an inner block ends)."""
    if not is_dtensor(x):
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    from torch.distributed.tensor import DTensor
    d = DTensor._op_dispatcher
    before = d._allow_implicit_replication
    d._allow_implicit_replication = True
    try:
        yield
    finally:
        d._allow_implicit_replication = before


def replicate(x):
    """A ``DTensor`` redistributed to ``Replicate()`` on every mesh dim (a
    ``Partial`` is reduced first, never read as it is); anything else
    unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def batch_only(x, rules: ShardingRules, name: str = "batch"):
    """A ``DTensor`` redistributed so that only its first dim stays
    sharded, over the axes the rules give logical ``name`` (dropped when
    they do not divide it); a 0-d tensor is replicated."""
    if not is_dtensor(x):
        return x
    if x.ndim == 0:
        return replicate(x)
    return constrain(x, rules, name, *([None] * (x.ndim - 1)))


class _LayerView:
    """A layer's parameter dicts, read as ``apply_layer`` reads a ``Layer``
    (``kind`` and one dict per sub-block)."""

    def __init__(self, kind: str, blocks: dict):
        self.kind = kind
        for k, v in blocks.items():
            setattr(self, k, v)


#: a ``Layer``'s sub-blocks
LAYER_BLOCKS = ("norm1", "mixer", "norm2", "mlp", "moe")


def layer_operands(p, x, cache, rules: ShardingRules):
    """What one layer computes on when its parameters are ``DTensor``s and
    the rules split no product (a plan without ``use_tp``): a view of the
    layer with every weight replicated, the input ``x`` with
    only its batch dim sharded, and the cache's entries likewise (``kpos``
    replicated).  Returns ``(layer, x, cache)``; ``write_back`` stores the
    cache that the layer updated into the original's placements."""
    blocks = {name: {k: replicate(v) for k, v in getattr(p, name).items()}
              for name in LAYER_BLOCKS if hasattr(p, name)}
    local = None
    if cache is not None:
        local = {k: replicate(t) if k == "kpos"
                 else batch_only(t, rules, "cache_batch")
                 for k, t in cache.items()}
    return _LayerView(p.kind, blocks), batch_only(x, rules), local


def write_back(cache, local) -> None:
    """Copy a layer's updated cache ``local`` into ``cache``'s own
    placements (nothing to do for an entry that is ``cache``'s tensor)."""
    if cache is None:
        return
    for k, t in cache.items():
        if local[k] is not t:
            t.copy_(local[k].redistribute(t.device_mesh, t.placements))


def constrain(x, rules: ShardingRules, *names: Optional[str]):
    """Redistribute a ``DTensor`` to the placements of logical ``names``,
    dropping axes that do not divide the dimension evenly.  A plain tensor
    lies on no mesh and comes back unchanged (the reference's constraint
    is a no-op off-mesh).  A redistribute that fails raises: the
    reference swallows ``ValueError``/``RuntimeError`` there and runs on
    unconstrained, which would hide a plan that cannot be laid out."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = rules.spec(*names)
    sizes = axis_sizes(rules.mesh)
    legal = []
    for dim, part in zip(x.shape, tuple(spec) + (None,) * x.ndim):
        if part is None:
            legal.append(None)
            continue
        k = 1
        for a in entry_axes(part):
            k *= sizes[a]
        legal.append(part if dim % k == 0 else None)
    return x.redistribute(rules.mesh, to_placements(legal, rules.mesh))

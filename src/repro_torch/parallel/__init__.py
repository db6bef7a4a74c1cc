"""Sharding on a torch ``DeviceMesh`` (counterpart of ``repro.parallel``)."""
from repro_torch.parallel.sharding import (  # noqa: F401
    MeshAxes,
    ShardingRules,
    make_rules,
    logical,
    spec_for,
)

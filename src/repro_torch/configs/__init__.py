"""Architecture registry of the port (counterpart of ``repro.configs``).

Importing this package registers the archs the port runs: ``qwen2-7b``
(published config + reduced smoke config) and the tiny test/example models.
The other archs of ``repro.configs`` need model families that are not
ported yet (see ROADMAP.md).
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    MoEConfig,
    PlanConfig,
    ShapeSpec,
    SHAPES,
    get_config,
    list_archs,
)

# registration side effects
from repro_torch.configs import qwen2_7b, tiny  # noqa: F401,E402

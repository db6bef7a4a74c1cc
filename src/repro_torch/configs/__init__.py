"""Architecture registry of the port (counterpart of ``repro.configs``).

Importing this package registers the archs the port runs, each with its
published config and a reduced smoke config: ``qwen2-7b`` (dense),
``mamba2-1.3b`` (ssm) and ``recurrentgemma-9b`` (hybrid), plus the tiny
test/example models.  The other archs of ``repro.configs`` need MoE
layers or front ends that are not ported yet (see ROADMAP.md).
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    MoEConfig,
    PlanConfig,
    ShapeSpec,
    SHAPES,
    CARD_SHAPES,
    get_config,
    get_shape,
    list_archs,
)

# registration side effects
from repro_torch.configs import (  # noqa: F401,E402
    mamba2_1p3b,
    qwen2_7b,
    recurrentgemma_9b,
    tiny,
)

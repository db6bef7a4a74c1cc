"""Architecture registry of the port (counterpart of ``repro.configs``).

Importing this package registers every arch of ``repro.configs``, each
with its published config and a reduced smoke config: dense, MoE, SSM,
hybrid, audio (encoder) and vision families, plus the tiny test/example
models.
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
    granite_20b,
    granite_moe_1b_a400m,
    hubert_xlarge,
    internvl2_76b,
    llama3_405b,
    mamba2_1p3b,
    moonshot_v1_16b_a3b,
    qwen2_7b,
    recurrentgemma_9b,
    stablelm_12b,
    tiny,
)

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    RunConfig,
    ShapeConfig,
    SHAPES,
    SUBQUADRATIC_ARCHS,
    shape_applicable,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS,
    all_configs,
    get_config,
    get_smoke_config,
)

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointInfo,
    CheckpointManager,
    CKPT_CONTAINER,
)

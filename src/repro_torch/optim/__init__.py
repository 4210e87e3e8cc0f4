from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from repro_torch.optim.compression import (  # noqa: F401
    compress_grads,
    init_error_feedback,
)

"""The model stack of the port (serving path): recurrentgemma's RG-LRU and
local-attention blocks, global attention and mamba2's SSD block, over
B5, B6 and B7."""
from repro_torch.models.model import (  # noqa: F401
    count_params_analytic,
    decode_step,
    init_decode_state,
    init_params,
    prefill,
)

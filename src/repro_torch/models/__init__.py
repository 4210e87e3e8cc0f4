"""The model stack of the port: recurrentgemma's RG-LRU and
local-attention blocks, global attention, mamba2's SSD block, and the MoE
family's MoE blocks, MLA and multi-token prediction; over B5, B6 and
B7."""
from repro_torch.models.model import (  # noqa: F401
    count_params_analytic,
    decode_step,
    init_decode_state,
    init_params,
    prefill,
)

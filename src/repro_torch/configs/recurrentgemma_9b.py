"""recurrentgemma-9b — hybrid RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import LOCAL_ATTN, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,               # pattern (rglru, rglru, local) x12 + 2 remainder
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,              # MQA on the local-attention layers
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    embed_scale=True,
    attn_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    local_window=2048,
    lru_width=4096,
    ssm_conv=4,                # temporal conv width in the recurrent block
)

SMOKE = CONFIG.scaled(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256, local_window=8, lru_width=64,
)

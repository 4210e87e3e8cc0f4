"""gemma2-27b — dense, alternating local/global attention, logit softcaps.

[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    act="gelu",
    sandwich_norm=True,
    embed_scale=True,
    attn_pattern=(LOCAL_ATTN, GLOBAL_ATTN),
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    # gemma2-27b scales queries by 1/sqrt(d_model/n_heads)=1/sqrt(144)
    query_scale=144.0 ** -0.5,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, local_window=8, query_scale=16.0 ** -0.5,
)

"""chatglm3-6b — dense, 2d RoPE (half-dim), GQA kv=2, QKV bias.

[arXiv:2406.12793; hf]
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    head_dim=128,
    qkv_bias=True,
    act="silu",
    rope_fraction=0.5,   # ChatGLM's 2d rope: rotate only half the head dims
    attn_pattern=(GLOBAL_ATTN,),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
)

"""llama-3.2-vision-90b — VLM, gated cross-attn image layers every 5th layer.

Vision frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import CROSS_ATTN, GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    act="silu",
    rope_theta=500_000.0,
    cross_attn_period=5,
    n_image_tokens=1601,       # 1 tile x (1600 patches + cls)
    attn_pattern=(GLOBAL_ATTN, GLOBAL_ATTN, GLOBAL_ATTN, GLOBAL_ATTN, CROSS_ATTN),
)

SMOKE = CONFIG.scaled(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, n_image_tokens=16,
)

"""mamba2-130m — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import SSD, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=0,
    act="silu",
    attn_pattern=(SSD,),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, vocab_size=256, ssm_state=16, ssm_headdim=16,
    ssm_chunk=16,
)

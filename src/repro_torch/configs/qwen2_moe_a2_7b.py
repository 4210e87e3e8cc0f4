"""qwen2-moe-a2.7b — MoE, 60 routed top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                 # routed expert hidden dim (per assignment)
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    act="silu",
    n_experts=60,
    top_k=4,
    d_expert=1408,
    n_shared_experts=4,
    d_shared_expert=5632,      # 4 shared experts fused: 4 x 1408
    shared_expert_gate=True,
    router_type="softmax",
    attn_pattern=(GLOBAL_ATTN,),
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=32, d_expert=32, d_shared_expert=128, n_experts=8, top_k=2,
    vocab_size=256,
)

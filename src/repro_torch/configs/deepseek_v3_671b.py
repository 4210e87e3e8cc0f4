"""deepseek-v3-671b — MoE 256 routed top-8 + 1 shared, MLA, MTP.

[arXiv:2412.19437; hf]
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,            # MLA: per-head KV derived from a shared latent
    d_ff=2048,                 # routed expert hidden dim
    vocab_size=129280,
    act="silu",
    n_experts=256,
    top_k=8,
    d_expert=2048,
    n_shared_experts=1,
    d_shared_expert=2048,
    n_dense_layers=3,
    dense_d_ff=18432,
    router_type="sigmoid",
    router_aux_free_bias=True,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=192,              # qk_nope + qk_rope
    mtp_depth=1,
    attn_pattern=(GLOBAL_ATTN,),
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, d_expert=32, d_shared_expert=32, dense_d_ff=128,
    n_experts=8, top_k=2, n_dense_layers=1, vocab_size=256,
    q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, head_dim=24, mtp_depth=1,
)

"""whisper-large-v3 — encoder-decoder audio backbone, conv frontend STUB.

The modality frontend is a stub: ``input_specs()`` provides precomputed
1500-frame embeddings (30 s of audio after the conv stack).
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,               # decoder layers (backbone spec)
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    qkv_bias=True,
    act="gelu",
    is_encoder_decoder=True,
    encoder_seq=1500,
    pos_embedding="learned",
    attn_pattern=(GLOBAL_ATTN,),
)

SMOKE = CONFIG.scaled(
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=256, encoder_seq=16,
)

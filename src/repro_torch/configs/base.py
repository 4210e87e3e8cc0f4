"""Model / run configuration system.

One ``ModelConfig`` dataclass covers every assigned architecture family
(dense / moe / audio / vlm / hybrid / ssm).  Architectures are registered in
``repro_torch.configs.registry`` and selected with ``--arch <id>`` in the
launchers.  ``ShapeConfig`` describes the assigned input-shape cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# Layer kinds that can appear in an architecture's repeating pattern.
GLOBAL_ATTN = "global"      # full causal self attention
LOCAL_ATTN = "local"        # sliding-window causal self attention
CROSS_ATTN = "cross"        # self attention + gated cross attention (vlm)
RGLRU = "rglru"             # RG-LRU recurrent block (RecurrentGemma)
SSD = "ssd"                 # Mamba2 state-space-dual block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- norms / activations -------------------------------------------------
    act: str = "silu"                # silu | gelu
    norm_eps: float = 1e-6
    sandwich_norm: bool = False      # gemma2: pre+post norms around each block
    embed_scale: bool = False        # gemma-style sqrt(d_model) embed scaling

    # --- attention ------------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # chatglm applies rope to half the dims
    attn_pattern: Tuple[str, ...] = (GLOBAL_ATTN,)
    local_window: int = 0
    attn_softcap: float = 0.0        # gemma2 logit soft-capping
    final_softcap: float = 0.0       # gemma2 final-logit soft-capping
    query_scale: Optional[float] = None  # overrides 1/sqrt(head_dim)
    tie_embeddings: bool = False

    # --- MoE -------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    d_shared_expert: int = 0
    n_dense_layers: int = 0          # deepseek: first-k layers stay dense
    dense_d_ff: int = 0              # d_ff of those dense layers
    shared_expert_gate: bool = False # qwen2-moe sigmoid gate on shared expert
    router_type: str = "softmax"     # softmax | sigmoid(deepseek)
    router_aux_free_bias: bool = False  # deepseek aux-loss-free balancing bias
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- MLA (deepseek) ---------------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- encoder-decoder (whisper) -----------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame embeddings (stub frontend)
    pos_embedding: str = "rope"      # rope | learned | none

    # --- vlm ----------------------------------------------------------------------
    cross_attn_period: int = 0       # every k-th layer is a cross-attn layer
    n_image_tokens: int = 0          # patch embeddings from the stub frontend

    # --- ssm (mamba2) ----------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- rglru (recurrentgemma) ---------------------------------------------------
    lru_width: int = 0

    # --- mtp (deepseek multi-token prediction) -----------------------------------
    mtp_depth: int = 0

    # --- tensor-parallel padding (set by apply_tp_padding, not by hand) ----------
    # When a dimension (heads / vocab) does not divide the model-parallel
    # degree, we pad it: extra heads have zero q/o weights (mathematically a
    # no-op), extra vocab rows are masked out of the loss/sampling.
    real_n_heads: int = 0              # 0 -> == n_heads (no padding)
    real_n_kv_heads: int = 0
    real_vocab_size: int = 0

    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived quantities ---------------------------------------------------

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def pattern_period(self) -> int:
        return len(self.attn_pattern)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kind list (length n_layers) for the decoder."""
        p = self.attn_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (matches init_params; used by roofline)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)

    def scaled(self, **overrides) -> "ModelConfig":
        """Return a copy with overrides (used for reduced smoke configs)."""
        return dataclasses.replace(self, **overrides)

    # effective (possibly padded) dims used for parameter shapes
    @property
    def vocab_real(self) -> int:
        return self.real_vocab_size or self.vocab_size

    @property
    def n_heads_real(self) -> int:
        return self.real_n_heads or self.n_heads

    @property
    def n_kv_heads_real(self) -> int:
        return self.real_n_kv_heads or self.n_kv_heads


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def apply_tp_padding(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Make head/vocab dims divisible by the TP degree, function-preserving.

    * GQA with kv < tp: each KV head is physically replicated
      ``tp/gcd(kv, tp)`` times and q heads are re-laid-out so every padded
      q slot keeps its original KV group (see models.attention.head_maps);
      surplus q slots get zero q/o weights (exact no-op).  This is the
      standard KV-replication transform used for tensor-parallel GQA
      serving; at init it computes the identical function (training unties
      the replicas — recorded in DESIGN.md).
    * MHA with heads % tp != 0 (whisper, 20 heads): q and kv pad together
      to the next multiple; padded heads are zero q/o no-ops.
    * vocab % tp != 0: table rows pad; padded logits are masked from
      loss/sampling.
    """
    if tp <= 1:
        return cfg
    over = {}
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if h and kv and (h % tp or kv % tp) and not cfg.use_mla:
        if kv >= tp or kv == h:
            # MHA-ish: pad both together
            hp = _round_up(h, tp)
            over.update(n_heads=hp, real_n_heads=h,
                        n_kv_heads=_round_up(kv, tp) if kv % tp else kv)
            if kv % tp:
                over["real_n_kv_heads"] = kv
        else:
            rep = tp // _gcd(kv, tp)
            kvp = kv * rep
            g = h // kv                       # q heads per kv group
            gp = -(-g // rep)                 # padded group size per replica
            over.update(n_heads=kvp * gp, n_kv_heads=kvp,
                        real_n_heads=h, real_n_kv_heads=kv)
    elif h and h % tp:
        over.update(n_heads=_round_up(h, tp), real_n_heads=h)
    if cfg.vocab_size % tp:
        over["vocab_size"] = _round_up(cfg.vocab_size, tp)
        over["real_vocab_size"] = cfg.vocab_size
    return cfg.scaled(**over) if over else cfg


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# Archs with sub-quadratic sequence mixing that run the 500k-decode cell.
SUBQUADRATIC_ARCHS = ("mamba2-130m", "recurrentgemma-9b")


def shape_applicable(arch_name: str, shape: ShapeConfig, cfg: ModelConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs; returns (ok, reason_if_skip)."""
    if shape.name == "long_500k" and arch_name not in SUBQUADRATIC_ARCHS:
        return False, "full-attention arch: 500k decode requires sub-quadratic mixing (DESIGN.md)"
    return True, ""


@dataclass(frozen=True)
class RunConfig:
    """Training/serving run options consumed by the launchers."""

    arch: str = "qwen2.5-32b"
    shape: str = "train_4k"
    multi_pod: bool = False
    fsdp: bool = True                 # ZeRO-3 parameter sharding over data axis
    remat: str = "dots"               # none | dots | full
    scan_layers: bool = True
    sequence_parallel: bool = False   # SP hillclimb knob
    grad_compression: str = "none"    # none | int8
    microbatch: int = 0               # 0 -> no gradient accumulation
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 300
    seed: int = 0
    checkpoint_strategy: str = "stream"   # collective | window | stream
    checkpoint_every: int = 100
    log_every: int = 10

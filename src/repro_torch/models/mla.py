"""Multi-head Latent Attention of DeepSeek-V3 (the port of
``repro.models.mla``).

Train and prefill expand the compressed KV latent per head (the standard
form) and run the dense or chunked attention of ``models.attention``
with the MLA scale; the q/k heads (nope + rope) are wider than the v
heads, a shape B5 does not take, and the reference runs no kernel here
either.  Decode is the weight-absorbed form: the queries are projected
into the latent space so attention reads the (b, W, kv_lora_rank)
latent cache directly; a token costs kv_lora_rank + qk_rope_head_dim
cache entries instead of n_heads * (qk_head_dim + v_head_dim).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.attention import (CHUNKED_THRESHOLD, NEG_INF,
                                          attend_chunked, attend_dense)
from repro_torch.models.common import apply_rope, dense_init


def init_mla(gen, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "wq_a": dense_init(gen, (d, qr), **kw),
        "q_norm": torch.ones((qr,), **kw),
        "wq_b": dense_init(gen, (qr, h, dn + dr), **kw),
        "wkv_a": dense_init(gen, (d, kr + dr), **kw),
        "kv_norm": torch.ones((kr,), **kw),
        "wkv_b": dense_init(gen, (kr, h, dn + dv), **kw),
        "wo": dense_init(gen, (h, dv, d), in_axis=1, **kw),
    }


def _scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(b, s, r) x (r, h, k) -> (b, s, h, k)."""
    w = w.to(x.dtype)
    return torch.matmul(x, w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], w.shape[1], w.shape[2])


def _queries(p: Dict, x: torch.Tensor, positions: torch.Tensor,
             cfg: ModelConfig):
    """-> q_nope (b, s, h, dn), q_pe (b, s, h, dr)."""
    q_lat = torch.matmul(x, p["wq_a"].to(x.dtype))
    q_lat = common.rms_norm(q_lat, p["q_norm"], cfg.norm_eps)
    q = common.shard_heads(_heads(q_lat, p["wq_b"]))
    dn = cfg.qk_nope_head_dim
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _latent_kv(p: Dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig):
    """-> c_kv (b, s, kr) normalised latent, k_pe (b, s, dr) the rope key
    shared by every head."""
    kv = torch.matmul(x, p["wkv_a"].to(x.dtype))
    kr = cfg.kv_lora_rank
    c_kv = common.rms_norm(kv[..., :kr], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(kv[..., kr:][:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def mla_attention(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence causal MLA (expanded form).  x: (b, s, d)."""
    s = x.shape[1]
    dn = cfg.qk_nope_head_dim
    q_nope, q_pe = _queries(p, x, positions, cfg)
    c_kv, k_pe = _latent_kv(p, x, positions, cfg)
    kv = _heads(c_kv, p["wkv_b"])
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        *k_nope.shape[:3], cfg.qk_rope_head_dim)], dim=-1)
    pos = positions[0] if positions.dim() == 2 else positions
    # the GQA machinery with a per-call scale override
    scfg = cfg.scaled(query_scale=_scale(cfg), attn_softcap=0.0)
    if s >= CHUNKED_THRESHOLD:
        out = attend_chunked(q, k, v, pos, pos, scfg, causal=True, window=0)
    else:
        out = attend_dense(q, k, v, pos[:, None] >= pos[None, :], scfg)
    out = common.shard_heads(out)
    wo = p["wo"].to(x.dtype)
    return torch.matmul(out.reshape(*out.shape[:2], -1),
                        wo.reshape(-1, wo.shape[-1]))


# --------------------------------------------------------------------------
# Latent cache: prefill + absorbed decode
# --------------------------------------------------------------------------

def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> Dict:
    """Append-only latent cache: slot i holds position i (-1 = empty)."""
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "kpe": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                           dtype=dtype, device=device),
        "pos": torch.full((max_len,), -1, dtype=torch.int32, device=device),
    }


def mla_prefill(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    out = mla_attention(p, x, positions, cfg)
    c_kv, k_pe = _latent_kv(p, x, positions, cfg)
    pos = positions[0] if positions.dim() == 2 else positions
    s = x.shape[1]
    cache = {k: v.clone() for k, v in cache.items()}
    cache["ckv"][:, :s] = c_kv.to(cache["ckv"].dtype)
    cache["kpe"][:, :s] = k_pe.to(cache["kpe"].dtype)
    cache["pos"][:s] = pos.to(torch.int32)
    return out, cache


def mla_decode(p: Dict, x: torch.Tensor, position: int, cfg: ModelConfig,
               cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Absorbed single-token decode against the latent cache (written in
    place, as the port's attention decode).  x: (b, 1, d)."""
    dn = cfg.qk_nope_head_dim
    posb = torch.full((1, 1), position, dtype=torch.int32, device=x.device)
    q_nope, q_pe = _queries(p, x, posb, cfg)               # (b, 1, h, *)
    c_new, kpe_new = _latent_kv(p, x, posb, cfg)           # (b, 1, kr|dr)

    # append-only; a position past the end overwrites the last slot, as
    # the reference's clamped dynamic_update_slice does
    slot = min(position, cache["ckv"].shape[1] - 1)
    cache["ckv"][:, slot] = c_new[:, 0].to(cache["ckv"].dtype)
    cache["kpe"][:, slot] = kpe_new[:, 0].to(cache["kpe"].dtype)
    cache["pos"][slot] = position

    wkv_b = p["wkv_b"].to(x.dtype)                         # (kr, h, dn+dv)
    wk, wv = wkv_b[..., :dn], wkv_b[..., dn:]
    # absorb W_UK into the query: (b,1,h,dn) x (kr,h,dn) -> (b,1,h,kr)
    q_abs = torch.einsum("bshk,rhk->bshr", q_nope, wk)
    ckv = cache["ckv"].to(x.dtype)                         # (b, W, kr)
    kpe = cache["kpe"].to(x.dtype)                         # (b, W, dr)
    logits = (torch.einsum("bshr,bwr->bshw", q_abs, ckv) +
              torch.einsum("bshk,bwk->bshw", q_pe, kpe))   # (b, 1, h, W)
    logits = logits.float() * _scale(cfg)
    valid = (cache["pos"] >= 0) & (cache["pos"] <= position)
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    lat = torch.einsum("bshw,bwr->bshr", probs, ckv)        # (b, 1, h, kr)
    out = common.shard_heads(torch.einsum("bshr,rhv->bshv", lat, wv))
    wo = p["wo"].to(x.dtype)
    out = torch.matmul(out.reshape(*out.shape[:2], -1),
                       wo.reshape(-1, wo.shape[-1]))
    return out, cache

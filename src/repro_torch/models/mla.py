"""Multi-head Latent Attention of DeepSeek-V3 (the port of
``repro.models.mla``).

Train and prefill expand the compressed KV latent per head (the standard
form).  Train runs the dense or chunked attention of
``models.attention`` with the MLA scale.  Prefill on the card takes B5
(``kernels.attention``): MLA's q/k heads (nope + rope, 192 wide) and v
heads (128) are wider and narrower than each other, a shape B5 does not
take, so ``attend_kernel`` lays them zero-padded to B5's head dim 256
(a zero column adds nothing to q.k and gives a zero output column, which
is sliced off) and no (heads, s, s) score tensor is built; on the CPU,
or with ``use_kernels=False``, prefill runs the plain attention as train
does.  The prefill computes the latent once and writes the cache in
place.  Decode is the weight-absorbed form: the queries are projected
into the latent space so attention reads the (b, W, kv_lora_rank)
latent cache directly; a token costs kv_lora_rank + qk_rope_head_dim
cache entries instead of n_heads * (qk_head_dim + v_head_dim).

The rope heads take YaRN's frequencies where the configuration sets
``yarn_factor`` (DeepSeek-V3: 40 from 4,096 positions), and the softmax
scale 1/sqrt(qk_head_dim) is then multiplied by YaRN's mscale squared
(``mscale_all_dim``'s, as DeepSeek-V3's modelling code does; its
cos/sin factor mscale/mscale_all_dim is 1 where the two are equal, the
published case, and another ratio is refused).

Each MLA call is an ``mla.block`` span of ``repro_torch.trace`` and the
prefill's attention core (q, k, v in, the heads' outputs out) an
``mla.attention`` span, both timed by CUDA events while tracing is on.
A prefill counts ``mla.prefill_layers`` and, where it took B5,
``mla.prefill_kernel_layers``; an absorbed decode step counts
``mla.decode_slots_read`` (the latent slots it reads: every row's whole
cache) and ``mla.decode_slots_valid`` (those holding a position up to
the step's), on the device.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention import flash_attention_kernel
from repro_torch.models import common
from repro_torch.models.attention import (CHUNKED_THRESHOLD, NEG_INF,
                                          attend_chunked, attend_dense)
from repro_torch.models.common import (apply_rope, dense_init,
                                       rope_inv_freq, yarn_mscale)

# B5's head dim that holds MLA's q/k (nope + rope) and v heads, padded
KERNEL_HEAD_DIM = 256


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
    """The softmax scale: 1/sqrt(qk_head_dim), times YaRN's mscale
    squared where YaRN is on."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    if not cfg.yarn_factor:
        return scale
    m_all = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) \
        if cfg.yarn_mscale_all_dim else 1.0
    if yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) != m_all:
        raise NotImplementedError(
            f"{cfg.name}: YaRN's cos/sin factor mscale / mscale_all_dim "
            f"({cfg.yarn_mscale} / {cfg.yarn_mscale_all_dim}) is not 1, "
            "which the port does not apply")
    return scale * m_all * m_all


def _rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    """RoPE (YaRN's frequencies where configured) on x (..., s, heads,
    qk_rope_head_dim)."""
    return apply_rope(x, positions, cfg.rope_theta,
                      inv_freq=rope_inv_freq(cfg, x.shape[-1], x.device))


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
    return q[..., :dn], _rope(q[..., dn:], positions, cfg)


def _latent_kv(p: Dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig):
    """-> c_kv (b, s, kr) normalised latent, k_pe (b, s, dr) the rope key
    shared by every head."""
    kv = torch.matmul(x, p["wkv_a"].to(x.dtype))
    kr = cfg.kv_lora_rank
    c_kv = common.rms_norm(kv[..., :kr], p["kv_norm"], cfg.norm_eps)
    k_pe = _rope(kv[..., kr:][:, :, None, :], positions, cfg)[:, :, 0, :]
    return c_kv, k_pe


def attend_kernel(q_nope: torch.Tensor, q_pe: torch.Tensor,
                  k_nope: torch.Tensor, k_pe: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Causal MLA attention of a sequence from position 0 through B5 at
    head dim 256: q (nope, rope) and k (nope, the rope key shared by every
    head) and v laid zero-padded in B5's (b, h, s, 256) layout.
    q_nope, k_nope (b, s, h, dn); q_pe (b, s, h, dr); k_pe (b, s, dr);
    v (b, s, h, dv) -> (b, s, h, dv).  On a CPU tensor B5's plain version
    runs (which builds the scores).  Heads wider than B5's head dim are
    refused."""
    b, s, h, dn = q_nope.shape
    dr, dv, hd = q_pe.shape[-1], v.shape[-1], KERNEL_HEAD_DIM
    if dn + dr > hd or dv > hd:
        raise ValueError(f"MLA's q/k heads ({dn} + {dr}) and v heads ({dv}) "
                         f"must fit B5's head dim {hd}")
    q = q_nope.new_zeros((b, h, s, hd))
    q[..., :dn] = q_nope.transpose(1, 2)
    q[..., dn:dn + dr] = q_pe.transpose(1, 2)
    k = k_nope.new_zeros((b, h, s, hd))
    k[..., :dn] = k_nope.transpose(1, 2)
    k[..., dn:dn + dr] = k_pe[:, None]
    vp = v.new_zeros((b, h, s, hd))
    vp[..., :dv] = v.transpose(1, 2)
    out = flash_attention_kernel(q, k, vp, scale=scale, causal=True)
    return out[..., :dv].transpose(1, 2)


def _attend_plain(q_nope, q_pe, k_nope, k_pe, v, positions,
                  cfg: ModelConfig) -> torch.Tensor:
    """The dense (or, at CHUNKED_THRESHOLD tokens, chunked) causal
    attention over the expanded heads -> (b, s, h, dv)."""
    s = q_nope.shape[1]
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        *k_nope.shape[:3], cfg.qk_rope_head_dim)], dim=-1)
    pos = positions[0] if positions.dim() == 2 else positions
    # the GQA machinery with a per-call scale override
    scfg = cfg.scaled(query_scale=_scale(cfg), attn_softcap=0.0)
    if s >= CHUNKED_THRESHOLD:
        return attend_chunked(q, k, v, pos, pos, scfg, causal=True, window=0)
    return attend_dense(q, k, v, pos[:, None] >= pos[None, :], scfg)


def _expanded(p: Dict, x: torch.Tensor, q_nope, q_pe, c_kv, k_pe,
              positions: torch.Tensor, cfg: ModelConfig, *,
              kernel: bool) -> torch.Tensor:
    """The expanded form's attention and output projection -> (b, s, d).
    ``kernel``: through ``attend_kernel`` (positions 0..s-1, as
    ``model.prefill`` gives them), else the plain attention."""
    kv = _heads(c_kv, p["wkv_b"])
    dn = cfg.qk_nope_head_dim
    k_nope, v = kv[..., :dn], kv[..., dn:]
    with trace.span("mla.attention", device=True):
        if kernel:
            trace.count("mla.prefill_kernel_layers")
            out = attend_kernel(q_nope, q_pe, k_nope, k_pe, v, _scale(cfg))
        else:
            out = _attend_plain(q_nope, q_pe, k_nope, k_pe, v, positions,
                                cfg)
    out = common.shard_heads(out)
    wo = p["wo"].to(x.dtype)
    return torch.matmul(out.reshape(*out.shape[:2], -1),
                        wo.reshape(-1, wo.shape[-1]))


def mla_attention(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence causal MLA (expanded form, plain attention).
    x: (b, s, d)."""
    with trace.span("mla.block", device=True):
        q_nope, q_pe = _queries(p, x, positions, cfg)
        c_kv, k_pe = _latent_kv(p, x, positions, cfg)
        return _expanded(p, x, q_nope, q_pe, c_kv, k_pe, positions, cfg,
                         kernel=False)


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
                cfg: ModelConfig, cache: Dict, *, use_kernels: bool = True
                ) -> Tuple[torch.Tensor, Dict]:
    """The prompt's causal MLA (from position 0), its latent written into
    the cache in place (every slot past the prompt marked empty).
    ``use_kernels``: B5 on the card (``attend_kernel``); the CPU runs
    the plain attention."""
    with trace.span("mla.block", device=True):
        q_nope, q_pe = _queries(p, x, positions, cfg)
        c_kv, k_pe = _latent_kv(p, x, positions, cfg)
        trace.count("mla.prefill_layers")
        out = _expanded(p, x, q_nope, q_pe, c_kv, k_pe, positions, cfg,
                        kernel=use_kernels and q_nope.is_cuda)
        pos = positions[0] if positions.dim() == 2 else positions
        s = x.shape[1]
        cache["ckv"][:, :s] = c_kv.to(cache["ckv"].dtype)
        cache["kpe"][:, :s] = k_pe.to(cache["kpe"].dtype)
        cache["pos"][:s] = pos.to(torch.int32)
        cache["pos"][s:] = -1          # what an earlier request left
        return out, cache


def mla_decode(p: Dict, x: torch.Tensor, position: int, cfg: ModelConfig,
               cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """Absorbed single-token decode against the latent cache (written in
    place, as the port's attention decode).  x: (b, 1, d)."""
    with trace.span("mla.block", device=True):
        return _decode(p, x, position, cfg, cache)


def _decode(p: Dict, x: torch.Tensor, position: int, cfg: ModelConfig,
            cache: Dict) -> Tuple[torch.Tensor, Dict]:
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
    if type(valid) is torch.Tensor:
        rows = x.shape[0]
        trace.count_device("mla.decode_slots_read", rows * valid.numel(),
                           x.device)
        trace.count_device("mla.decode_slots_valid", valid.sum() * rows,
                           x.device)
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    lat = torch.einsum("bshw,bwr->bshr", probs, ckv)        # (b, 1, h, kr)
    out = common.shard_heads(torch.einsum("bshr,rhv->bshv", lat, wv))
    wo = p["wo"].to(x.dtype)
    out = torch.matmul(out.reshape(*out.shape[:2], -1),
                       wo.reshape(-1, wo.shape[-1]))
    return out, cache

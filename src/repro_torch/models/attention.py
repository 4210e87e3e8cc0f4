"""Grouped-query attention: global / sliding-window self attention with
ring-buffer KV caches (the port of ``repro.models.attention``).

Three execution paths with identical semantics, as in the reference:
  * ``attend_dense``    — materialised scores; short sequences and decode.
  * ``attend_chunked``  — online softmax over KV chunks; long sequences.
  * flash attention     — ``repro_torch.kernels.flash_attention`` (B5): the
                          hand-written CUDA kernel on the card, its plain
                          version on the CPU.  Prefill takes it unless the
                          caller passes ``use_kernels=False``.

Caches are fixed-size ring buffers: ``k/v`` of length ``W`` plus a ``pos``
vector holding the absolute position stored in each slot (-1 = empty).
For global attention W = max_len; for sliding-window layers W = window.
Unlike the reference, decode writes its slot in place (the port's caches
are not shared), which saves a copy of the cache per token.

Cross attention (vision, encoder-decoder) waits for its slice (ROADMAP A11).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.attention import flash_attention
from repro_torch.models.common import apply_rope, dense_init, softcap

NEG_INF = -2.0e38  # fp32-safe mask value

# sequences at or above this length use the chunked path
CHUNKED_THRESHOLD = 8192


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def head_maps(cfg: ModelConfig):
    """TP head-padding maps: (q_slot -> real q idx or -1, kv_slot -> real kv).

    See configs.base.apply_tp_padding: padded q slots are laid out so that
    slot j's padded KV group (j // (n_heads/n_kv)) replicates the original
    head's real KV group — function-preserving GQA KV replication.
    """
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hr, kvr = cfg.n_heads_real, cfg.n_kv_heads_real
    if h == hr and kv == kvr:
        return list(range(h)), list(range(kv))
    if kvr == kv:
        return [i if i < hr else -1 for i in range(h)], list(range(kv))
    if kvr == hr:
        qmap = [i if i < hr else -1 for i in range(h)]
        kvmap = [i if i < kvr else 0 for i in range(kv)]
        return qmap, kvmap
    rep = kv // kvr
    g_real = hr // kvr
    slots_per_kv_group = h // kvr
    qmap = [-1] * h
    for k in range(kvr):
        for i0 in range(g_real):
            qmap[k * slots_per_kv_group + i0] = k * g_real + i0
    kvmap = [c // rep for c in range(kv)]
    return qmap, kvmap


def _place_heads(w_real: torch.Tensor, qmap, axis: int) -> torch.Tensor:
    """Scatter real head slices into the padded layout (zeros elsewhere)."""
    parts = [torch.zeros_like(w_real.select(axis, 0)) if j < 0
             else w_real.select(axis, j) for j in qmap]
    return torch.stack(parts, dim=axis)


def init_attention(gen, cfg: ModelConfig, *, dtype=torch.float32,
                   device=None) -> Dict:
    """QKVO projections (+ optional biases)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hr, kvr = cfg.n_heads_real, cfg.n_kv_heads_real
    kw = dict(dtype=dtype, device=device)
    wq = dense_init(gen, (d, hr, hd), **kw)
    wk = dense_init(gen, (d, kvr, hd), **kw)
    wv = dense_init(gen, (d, kvr, hd), **kw)
    wo = dense_init(gen, (hr, hd, d), in_axis=1, **kw)
    if (h, kv) != (hr, kvr):
        qmap, kvmap = head_maps(cfg)
        wq = _place_heads(wq, qmap, axis=1)
        wo = _place_heads(wo, qmap, axis=0)
        wk = _place_heads(wk, kvmap, axis=1)
        wv = _place_heads(wv, kvmap, axis=1)
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), **kw)
        p["bk"] = torch.zeros((kv, hd), **kw)
        p["bv"] = torch.zeros((kv, hd), **kw)
    return p


# --------------------------------------------------------------------------
# Core attention math
# --------------------------------------------------------------------------

def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, kv, hd) -> (b, s, h, hd) by repeating each kv group."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=2)


def _scale(cfg: ModelConfig) -> float:
    if cfg.query_scale is not None:
        return cfg.query_scale
    return 1.0 / math.sqrt(cfg.head_dim)


def attend_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q: (b, sq, h, hd); k/v: (b, sk, kv, hd); mask: (b?, sq, sk) bool.

    Query heads read their kv group through a grouped product (head h
    uses kv h // (h / kv)), so K and V are never copied per head."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    logits = torch.einsum("bqcgd,bkcd->bcgqk", qg.float(), k.float())
    logits = logits * _scale(cfg)
    logits = softcap(logits, cfg.attn_softcap)
    if mask.dim() == 3:
        mask = mask[:, None, None]        # (b, 1, 1, sq, sk)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bcgqk,bkcd->bqcgd", probs, v.to(q.dtype))
    return out.reshape(b, sq, h, v.shape[-1])


def attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, k_pos: torch.Tensor,
                   cfg: ModelConfig, *, causal: bool, window: int,
                   chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks (memory O(sq * chunk)).

    q_pos: (sq,) absolute positions of queries; k_pos: (sk,) of keys
    (-1 marks an empty cache slot).  Semantics identical to attend_dense
    with the mask built from positions.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    vd = v.shape[-1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = _scale(cfg)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, vd), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        kc, vc, kp = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], \
            k_pos[c0:c0 + chunk]
        if kp.shape[0] < chunk:          # the reference pads the last chunk
            pad = chunk - kp.shape[0]
            kc = torch.nn.functional.pad(kc, (0, 0, 0, 0, 0, pad))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, 0, 0, pad))
            kp = torch.nn.functional.pad(kp, (0, pad), value=-1)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              kc.float()) * scale
        logits = softcap(logits, cfg.attn_softcap)
        valid = kp[None, :] >= 0
        if causal:
            valid = valid & (kp[None, :] <= q_pos[:, None])
        if window > 0:
            valid = valid & (kp[None, :] > q_pos[:, None] - window)
        logits = torch.where(valid[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vc).float()
        m = m_new
    out = acc / l.clamp_min(1e-37)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


# --------------------------------------------------------------------------
# Layer-level forward (full sequence)
# --------------------------------------------------------------------------

def _project_qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig):
    def proj(w):
        w = w.to(x.dtype)
        return torch.matmul(x, w.reshape(w.shape[0], -1)).reshape(
            *x.shape[:-1], w.shape[1], w.shape[2])
    q, k, v = proj(p["wq"]), proj(p["wk"]), proj(p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _out_proj(p: Dict, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    wo = p["wo"].to(x.dtype)
    return torch.matmul(out.reshape(*out.shape[:2], -1),
                        wo.reshape(-1, wo.shape[-1]))


def _attend(q, k, v, pos, cfg: ModelConfig, window: int,
            use_kernels: bool) -> torch.Tensor:
    """Causal self attention of a full sequence at positions ``pos``."""
    s = q.shape[1]
    if use_kernels:
        # B5 takes positions as indices: the prompt must start at 0
        if not torch.equal(pos, torch.arange(s, device=pos.device,
                                             dtype=pos.dtype)):
            raise ValueError("the flash-attention path needs positions "
                             "0..s-1 (prefill starts at position 0)")
        return flash_attention(q, k, v, scale=_scale(cfg), causal=True,
                               window=window, softcap=cfg.attn_softcap)
    if s >= CHUNKED_THRESHOLD:
        return attend_chunked(q, k, v, pos, pos, cfg, causal=True,
                              window=window)
    mask = pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    return attend_dense(q, k, v, mask, cfg)


def self_attention(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, *, window: int = 0,
                   use_rope: bool = True,
                   use_kernels: bool = True) -> torch.Tensor:
    """Causal self attention over a full sequence.  x: (b, s, d)."""
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope and cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    pos = positions[0] if positions.dim() == 2 else positions
    out = _attend(q, k, v, pos, cfg, window, use_kernels)
    return _out_proj(p, out, x)


# --------------------------------------------------------------------------
# KV cache (ring buffer) — prefill & decode
# --------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind == "local" and cfg.local_window:
        return min(cfg.local_window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, kind: str,
               dtype=torch.bfloat16, device=None) -> Dict:
    w = cache_len(cfg, kind, max_len)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, w, kv, hd), dtype=dtype, device=device),
        "pos": torch.full((w,), -1, dtype=torch.int32, device=device),
    }


def prefill_attention(p: Dict, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, cache: Dict, *, window: int = 0,
                      use_kernels: bool = True
                      ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence attention that also fills the ring cache."""
    s = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    pos = positions[0] if positions.dim() == 2 else positions
    out = _out_proj(p, _attend(q, k, v, pos, cfg, window, use_kernels), x)

    w = cache["k"].shape[1]
    if s >= w:
        # keep the last w entries, laid out by the ring invariant
        # slot(p) = p % w so later decode writes evict the oldest entry
        shift = (s - w) % w
        cache = {
            "k": torch.roll(k[:, s - w:], shift, 1).to(cache["k"].dtype),
            "v": torch.roll(v[:, s - w:], shift, 1).to(cache["v"].dtype),
            "pos": torch.roll(pos[s - w:], shift, 0).to(torch.int32),
        }
    else:
        cache = dict(cache)
        for name, val in (("k", k), ("v", v)):
            buf = cache[name].clone()
            buf[:, :s] = val.to(buf.dtype)
            cache[name] = buf
        buf = cache["pos"].clone()
        buf[:s] = pos.to(torch.int32)
        cache["pos"] = buf
    return out, cache


def decode_attention(p: Dict, x: torch.Tensor, position: int,
                     cfg: ModelConfig, cache: Dict, *, window: int = 0
                     ) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode step against the ring cache (written in place).

    x: (b, 1, d); position: int (same step for the whole batch — the
    serving model runs synchronous batched decode).
    """
    q, k, v = _project_qkv(p, x, cfg)
    if cfg.pos_embedding == "rope":
        posb = torch.full((1, 1), position, dtype=torch.int32,
                          device=x.device)
        q = apply_rope(q, posb, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, posb, cfg.rope_theta, cfg.rope_fraction)

    w = cache["k"].shape[1]
    slot = position % w
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = position
    pos_cache = cache["pos"]

    valid = (pos_cache >= 0) & (pos_cache <= position)
    if window > 0:
        valid &= pos_cache > position - window
    out = attend_dense(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                       valid[None, :], cfg)
    return _out_proj(p, out, x), cache

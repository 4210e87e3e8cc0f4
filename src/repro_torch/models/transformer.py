"""Decoder stacks over the block zoo (the port of
``repro.models.transformer``), for the kinds the port serves: global and
local (sliding-window) attention, the RG-LRU block and the Mamba2 SSD
block, in modes prefill and decode.

The reference groups layers into repetitions of the architecture's
``attn_pattern`` and scans them over stacked parameters ("scan" layout);
PyTorch runs eagerly, so the port keeps one parameter dict per layer in a
list and walks it with a Python loop.  ``stack_plan`` still splits the
layers into (prefix, reps x pattern, extra), so the reference's
parameters map onto the port's one for one (``models.convert``).

Not ported yet, each raising NotImplementedError that names its ROADMAP
item: the cross and encoder/encdec kinds, MLA, MoE and the audio
family's LayerNorm MLP (A11); the train mode (A12).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import (GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD,
                                      ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import common, rglru, ssm
from repro_torch.models.common import dense_init

PORTED_KINDS = (GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD)


def not_ported(what: str, item: str = "A11"):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP {item})")


def check_config(cfg: ModelConfig):
    """Raise for a configuration this slice cannot run."""
    bad = sorted(set(cfg.attn_pattern) - set(PORTED_KINDS))
    if bad:
        raise not_ported(f"block kind(s) {bad} ({cfg.name})")
    if cfg.is_moe:
        raise not_ported(f"MoE ({cfg.name})")
    if cfg.use_mla:
        raise not_ported(f"MLA ({cfg.name})")
    if cfg.is_encoder_decoder or cfg.cross_attn_period:
        raise not_ported(f"encoder-decoder / cross attention ({cfg.name})")
    if cfg.family == "audio":
        raise not_ported(f"the LayerNorm MLP of the audio family ({cfg.name})")
    if cfg.mtp_depth:
        raise not_ported(f"multi-token prediction ({cfg.name})")
    if cfg.pos_embedding not in ("rope", "none"):
        raise not_ported(f"{cfg.pos_embedding} positions ({cfg.name})")


# --------------------------------------------------------------------------
# Norm / MLP
# --------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, dtype=torch.float32, device=None) -> Dict:
    fill = torch.zeros if cfg.sandwich_norm else torch.ones
    return {"scale": fill((cfg.d_model,), dtype=dtype, device=device)}


def apply_norm(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return common.rms_norm(x, p["scale"], cfg.norm_eps,
                           zero_centered=cfg.sandwich_norm)


def init_mlp(gen, cfg: ModelConfig, d_ff: int, dtype=torch.float32,
             device=None) -> Dict:
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    return {
        "wi_gate": dense_init(gen, (d, d_ff), **kw),
        "wi_up": dense_init(gen, (d, d_ff), **kw),
        "wo": dense_init(gen, (d_ff, d), **kw),
    }


def mlp_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated MLP: act(x W_gate) * (x W_up) W_o."""
    act = common.activation(cfg.act)
    h = act(torch.matmul(x, p["wi_gate"].to(x.dtype)))
    h = h * torch.matmul(x, p["wi_up"].to(x.dtype))
    return torch.matmul(h, p["wo"].to(x.dtype))


# --------------------------------------------------------------------------
# Block init / forward
# --------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, kind: str, dtype=torch.float32,
               device=None) -> Dict:
    kw = dict(dtype=dtype, device=device)
    p: Dict[str, Any] = {"ln1": init_norm(cfg, **kw)}
    if kind in (GLOBAL_ATTN, LOCAL_ATTN):
        p["mixer"] = attn.init_attention(gen, cfg, **kw)
    elif kind == RGLRU:
        p["mixer"] = rglru.init_rglru(gen, cfg, **kw)
    elif kind == SSD:
        p["mixer"] = ssm.init_ssm(gen, cfg, **kw)
    else:
        raise not_ported(f"block kind {kind!r}")
    if kind != SSD:      # mamba2 blocks have no MLP
        p["ln2"] = init_norm(cfg, **kw)
        p["mlp"] = init_mlp(gen, cfg, cfg.d_ff, **kw)
    if cfg.sandwich_norm:
        p["ln1_post"] = init_norm(cfg, **kw)
        if "ln2" in p:
            p["ln2_post"] = init_norm(cfg, **kw)
    return p


def block_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                  mode: str, positions: Optional[torch.Tensor] = None,
                  position: Optional[int] = None,
                  cache: Optional[Dict] = None, use_kernels: bool = True
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One block in mode ``prefill`` or ``decode``.  Returns
    (x, new_cache).  ``use_kernels`` picks B5/B6/B7 for the prefill's
    attention and scans; decode runs plain torch either way."""
    if mode not in ("prefill", "decode"):
        raise not_ported(f"block mode {mode!r}", "A12")
    h = apply_norm(p["ln1"], x, cfg)
    window = cfg.local_window if kind == LOCAL_ATTN else 0
    if kind in (GLOBAL_ATTN, LOCAL_ATTN):
        if mode == "prefill":
            mix, new_cache = attn.prefill_attention(
                p["mixer"], h, positions, cfg, cache, window=window,
                use_kernels=use_kernels)
        else:
            mix, new_cache = attn.decode_attention(
                p["mixer"], h, position, cfg, cache, window=window)
    elif kind == RGLRU:
        if mode == "prefill":
            mix, new_cache = rglru.rglru_prefill(
                p["mixer"], h, cfg, cache, use_kernels=use_kernels)
        else:
            mix, new_cache = rglru.rglru_decode(p["mixer"], h, cfg, cache)
    elif kind == SSD:
        if mode == "prefill":
            mix, new_cache = ssm.ssm_prefill(p["mixer"], h, cfg, cache,
                                             use_kernels=use_kernels)
        else:
            mix, new_cache = ssm.ssm_decode(p["mixer"], h, cfg, cache)
    else:
        raise not_ported(f"block kind {kind!r}")

    if cfg.sandwich_norm:
        mix = apply_norm(p["ln1_post"], mix, cfg)
    x = x + mix
    if kind == SSD:      # no MLP half
        return x, new_cache
    y = mlp_forward(p["mlp"], apply_norm(p["ln2"], x, cfg), cfg)
    if cfg.sandwich_norm:
        y = apply_norm(p["ln2_post"], y, cfg)
    return x + y, new_cache


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> Dict:
    if kind in (GLOBAL_ATTN, LOCAL_ATTN):
        return attn.init_cache(cfg, batch, max_len, kind, dtype, device)
    if kind == RGLRU:
        return rglru.init_rglru_cache(cfg, batch, device=device)
    if kind == SSD:      # f32 whatever dtype, as the reference's
        return ssm.init_ssm_cache(cfg, batch, device=device)
    raise not_ported(f"block kind {kind!r}")


# --------------------------------------------------------------------------
# Stack
# --------------------------------------------------------------------------

def stack_plan(cfg: ModelConfig) -> Tuple[int, int, Tuple[str, ...],
                                          Tuple[str, ...]]:
    """-> (prefix, reps, pattern, extra_kinds), as the reference splits
    n_layers = prefix + reps*|pattern| + |extras|."""
    pattern = cfg.attn_pattern
    period = len(pattern)
    prefix = cfg.n_dense_layers if cfg.is_moe else 0
    body = cfg.n_layers - prefix
    reps = body // period
    extra = tuple(pattern[i % period] for i in range(reps * period, body))
    return prefix, reps, pattern, extra


def stack_kinds(cfg: ModelConfig) -> Dict[str, List[str]]:
    """Block kind of every layer of each part of the stack."""
    prefix, reps, pattern, extra = stack_plan(cfg)
    return {"prefix": [pattern[i % len(pattern)] for i in range(prefix)],
            "unrolled": [pattern[i % len(pattern)]
                         for i in range(reps * len(pattern))],
            "extra": list(extra)}


def init_stack(gen, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> Dict[str, List[Dict]]:
    """One parameter dict per decoder layer: prefix, body, extras."""
    return {part: [init_block(gen, cfg, kind, dtype, device)
                   for kind in kinds]
            for part, kinds in stack_kinds(cfg).items()}


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None
                     ) -> Dict[str, List[Dict]]:
    return {part: [init_block_cache(cfg, kind, batch, max_len, dtype,
                                    device) for kind in kinds]
            for part, kinds in stack_kinds(cfg).items()}


def stack_step(stack: Dict, caches: Dict, x: torch.Tensor,
               cfg: ModelConfig, *, mode: str, positions=None,
               position=None, use_kernels: bool = True
               ) -> Tuple[torch.Tensor, Dict]:
    """The prefill/decode walk over every layer, threading caches."""
    new_caches: Dict[str, List[Dict]] = {}
    for part, kinds in stack_kinds(cfg).items():
        new_caches[part] = []
        for bp, kind, cache in zip(stack[part], kinds, caches[part]):
            x, nc = block_forward(bp, x, cfg, kind, mode=mode,
                                  positions=positions, position=position,
                                  cache=cache, use_kernels=use_kernels)
            new_caches[part].append(nc)
    return x, new_caches

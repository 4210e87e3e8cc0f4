"""Decoder and encoder stacks over the block zoo (the port of
``repro.models.transformer``): global and local (sliding-window)
attention or MLA, the RG-LRU block, the Mamba2 SSD block, whisper's
bidirectional ``encoder`` and self + cross ``encdec`` blocks, and
llama-3.2-vision's gated ``cross`` block, each followed (SSD aside) by
an MLP or a MoE block, in modes train, prefill and decode.  The audio
family uses LayerNorm with a bias and a GELU MLP with biases.

The reference groups layers into repetitions of the architecture's
``attn_pattern`` and scans them over stacked parameters ("scan" layout);
PyTorch runs eagerly, so the port keeps one parameter dict per layer in a
list and walks it with a Python loop.  ``stack_plan`` still splits the
layers into (prefix, reps x pattern, extra), so the reference's
parameters map onto the port's one for one (``models.convert``):
deepseek's dense first layers are the prefix, its MoE layers the body.

``block_forward`` returns (x, aux loss, new cache), the reference's
convention: the aux loss is the MoE router's load-balance loss (0.0 for
the other blocks), which ``stack_forward_train`` sums over layers.
Its ``remat`` ``"dots"`` and ``"full"`` both recompute each whole block
in the backward (``torch.utils.checkpoint``): PyTorch has no counterpart
of XLA's save-the-dots policy, so ``"dots"`` costs the memory of
``"full"`` and gives the same numbers (ROADMAP C14).

The encoder and cross attention see every key, so with ``use_kernels``
their whole-sequence attention takes B5's non-causal route.  A cross
block's cache holds only the memory's K/V, written at prefill: unlike
the reference, ``init_block_cache`` allocates no zero placeholder for
them (whisper's would take 2 GB in f32).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN, LOCAL_ATTN,
                                      RGLRU, SSD, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import common, mla, moe, rglru, ssm
from repro_torch.models.common import dense_init

# internal block kinds beyond the config pattern, the reference's names
ENCODER = "encoder"          # bidirectional self attention (whisper encoder)
ENCDEC = "encdec"            # self + cross attention (whisper decoder)
KINDS = (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN, RGLRU, SSD, ENCODER, ENCDEC)
MEMORY_KINDS = (CROSS_ATTN, ENCDEC)     # the blocks that read the memory
# "learned" positions have no table in the reference and add nothing
# (ROADMAP C21); the reference's decoder "sinusoid" positions are used by
# no config and not ported
POS_EMBEDDINGS = ("rope", "none", "learned")


def not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP {item})")


def check_config(cfg: ModelConfig):
    """Raise for a configuration the port cannot run."""
    bad = sorted(set(cfg.attn_pattern) - set(KINDS))
    if bad:
        raise ValueError(f"unknown block kind(s) {bad} ({cfg.name})")
    if cfg.pos_embedding not in POS_EMBEDDINGS:
        raise ValueError(f"the port takes pos_embedding {POS_EMBEDDINGS}, "
                         f"not {cfg.pos_embedding!r} ({cfg.name})")


def _uses_layernorm(cfg: ModelConfig) -> bool:
    return cfg.family == "audio"


# --------------------------------------------------------------------------
# Norm / MLP
# --------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, dtype=torch.float32, device=None) -> Dict:
    kw = dict(dtype=dtype, device=device)
    if _uses_layernorm(cfg):
        return {"scale": torch.ones((cfg.d_model,), **kw),
                "bias": torch.zeros((cfg.d_model,), **kw)}
    fill = torch.zeros if cfg.sandwich_norm else torch.ones
    return {"scale": fill((cfg.d_model,), **kw)}


def apply_norm(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "bias" in p:
        return common.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return common.rms_norm(x, p["scale"], cfg.norm_eps,
                           zero_centered=cfg.sandwich_norm)


def init_mlp(gen, cfg: ModelConfig, d_ff: int, dtype=torch.float32,
             device=None) -> Dict:
    d = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    if _uses_layernorm(cfg):      # whisper: plain GELU MLP with biases
        return {
            "wi": dense_init(gen, (d, d_ff), **kw),
            "bi": torch.zeros((d_ff,), **kw),
            "wo": dense_init(gen, (d_ff, d), **kw),
            "bo": torch.zeros((d,), **kw),
        }
    return {
        "wi_gate": dense_init(gen, (d, d_ff), **kw),
        "wi_up": dense_init(gen, (d, d_ff), **kw),
        "wo": dense_init(gen, (d_ff, d), **kw),
    }


def mlp_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Gated MLP act(x W_gate) * (x W_up) W_o, or the audio family's
    act(x W_i + b_i) W_o + b_o."""
    act = common.activation(cfg.act)
    if "wi" in p:
        h = act(torch.matmul(x, p["wi"].to(x.dtype)) + p["bi"].to(x.dtype))
        h = common.shard_ff(h)
        return torch.matmul(h, p["wo"].to(x.dtype)) + p["bo"].to(x.dtype)
    h = act(torch.matmul(x, p["wi_gate"].to(x.dtype)))
    h = common.shard_ff(h * torch.matmul(x, p["wi_up"].to(x.dtype)))
    return torch.matmul(h, p["wo"].to(x.dtype))


# --------------------------------------------------------------------------
# Block init / forward
# --------------------------------------------------------------------------

def _layer_dff(cfg: ModelConfig, layer_idx: int) -> Tuple[bool, int]:
    """-> (is_moe_layer, d_ff) for decoder layer ``layer_idx``."""
    if cfg.is_moe and layer_idx >= cfg.n_dense_layers:
        return True, 0
    if cfg.is_moe:
        return False, cfg.dense_d_ff or cfg.d_ff
    return False, cfg.d_ff


def init_block(gen, cfg: ModelConfig, kind: str, layer_idx: int,
               dtype=torch.float32, device=None) -> Dict:
    kw = dict(dtype=dtype, device=device)
    p: Dict[str, Any] = {"ln1": init_norm(cfg, **kw)}
    if kind in (GLOBAL_ATTN, LOCAL_ATTN, ENCODER, ENCDEC) and cfg.use_mla:
        p["mixer"] = mla.init_mla(gen, cfg, **kw)
    elif kind in (GLOBAL_ATTN, LOCAL_ATTN, ENCODER, ENCDEC):
        p["mixer"] = attn.init_attention(gen, cfg, **kw)
    elif kind == CROSS_ATTN:
        p["mixer"] = attn.init_attention(gen, cfg, cross=True, **kw)
        p["mlp_gate"] = torch.zeros((), **kw)
    elif kind == RGLRU:
        p["mixer"] = rglru.init_rglru(gen, cfg, **kw)
    elif kind == SSD:
        p["mixer"] = ssm.init_ssm(gen, cfg, **kw)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if kind == ENCDEC:   # whisper decoder: the cross-attention sub-block
        p["ln_cross"] = init_norm(cfg, **kw)
        p["cross"] = attn.init_attention(gen, cfg, **kw)
    if kind != SSD:      # mamba2 blocks have no MLP
        p["ln2"] = init_norm(cfg, **kw)
        is_moe, dff = _layer_dff(cfg, layer_idx)
        if is_moe:
            p["moe"] = moe.init_moe(gen, cfg, **kw)
        else:
            p["mlp"] = init_mlp(gen, cfg, dff, **kw)
    if cfg.sandwich_norm:
        p["ln1_post"] = init_norm(cfg, **kw)
        if "ln2" in p:
            p["ln2_post"] = init_norm(cfg, **kw)
    return p


def block_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                  mode: str, positions: Optional[torch.Tensor] = None,
                  position: Optional[int] = None,
                  cache: Optional[Dict] = None,
                  memory: Optional[torch.Tensor] = None,
                  use_kernels: bool = True, moe_dense_oracle: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """One block in mode ``train``, ``prefill`` or ``decode``.  Returns
    (x, aux loss, new_cache): the aux loss is an f32 scalar tensor from
    a MoE block and 0.0 from the others (no allocation, no launch per
    block); train keeps no cache (None).  ``memory`` (b, m, d) is what a
    ``cross`` or ``encdec`` block attends to in train and prefill (the
    encoder's output or the image embeddings); decode reads its K/V from
    the cache.
    ``use_kernels`` picks B5/B6/B7 for the attention and scans of train
    and prefill (on the card they carry their gradients:
    ``kernels.grad``) and B5 for MLA's prefill; decode and MLA's train
    run plain torch either way.
    ``moe_dense_oracle`` runs a MoE layer as ``moe.moe_block_dense``."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown block mode {mode!r}")
    aux = 0.0
    h = apply_norm(p["ln1"], x, cfg)
    window = cfg.local_window if kind == LOCAL_ATTN else 0
    whole = use_kernels and mode != "decode"   # B5 on whole sequences
    new_cache = None
    if kind in (GLOBAL_ATTN, LOCAL_ATTN) and cfg.use_mla:
        if mode == "train":
            mix = mla.mla_attention(p["mixer"], h, positions, cfg)
        elif mode == "prefill":
            mix, new_cache = mla.mla_prefill(p["mixer"], h, positions, cfg,
                                             cache, use_kernels=use_kernels)
        else:
            mix, new_cache = mla.mla_decode(p["mixer"], h, position, cfg,
                                            cache)
    elif kind in (GLOBAL_ATTN, LOCAL_ATTN, ENCDEC):
        # ENCDEC's self attention: causal, never rotary (the reference
        # turns rope off in train and whisper has no rope anyway)
        if mode == "train":
            mix = attn.self_attention(p["mixer"], h, positions, cfg,
                                      window=window, use_rope=kind != ENCDEC,
                                      use_kernels=use_kernels)
        elif mode == "prefill":
            mix, new_cache = attn.prefill_attention(
                p["mixer"], h, positions, cfg, cache, window=window,
                use_kernels=use_kernels)
        else:
            mix, new_cache = attn.decode_attention(
                p["mixer"], h, position, cfg, cache, window=window)
    elif kind == ENCODER:
        # bidirectional: every frame sees every frame (``_encode`` runs
        # the encoder's stack in train mode)
        q, k, v = attn._project_qkv(p["mixer"], h, cfg)
        mix = attn._out_proj(p["mixer"], attn.attend_unmasked(
            q, k, v, cfg, use_kernels=whole), x)
    elif kind == CROSS_ATTN:
        mix, new_cache = _cross(p["mixer"], h, memory, cfg, mode, cache,
                                gated=True, use_kernels=whole)
    elif kind == RGLRU:
        if mode == "train":
            mix, _, _ = rglru.rglru_block(p["mixer"], h, cfg,
                                          use_kernels=use_kernels)
        elif mode == "prefill":
            mix, new_cache = rglru.rglru_prefill(
                p["mixer"], h, cfg, cache, use_kernels=use_kernels)
        else:
            mix, new_cache = rglru.rglru_decode(p["mixer"], h, cfg, cache)
    elif kind == SSD:
        if mode == "train":
            mix = ssm.ssm_block(p["mixer"], h, cfg, use_kernels=use_kernels)
        elif mode == "prefill":
            mix, new_cache = ssm.ssm_prefill(p["mixer"], h, cfg, cache,
                                             use_kernels=use_kernels)
        else:
            mix, new_cache = ssm.ssm_decode(p["mixer"], h, cfg, cache)
    else:
        raise ValueError(f"unknown block kind {kind!r}")

    if cfg.sandwich_norm:
        mix = apply_norm(p["ln1_post"], mix, cfg)
    x = common.shard_batch_seq(x + mix)
    if kind == ENCDEC:   # whisper decoder: cross attention to the encoder
        hc = apply_norm(p["ln_cross"], x, cfg)
        cx, xkv = _cross(p["cross"], hc, memory, cfg, mode, cache,
                         gated=False, use_kernels=whole)
        x = x + cx
        if mode == "prefill":
            new_cache.update(xkv)
    if kind == SSD:      # no MLP half
        return x, aux, new_cache
    h2 = apply_norm(p["ln2"], x, cfg)
    if "moe" in p:
        fn = moe.moe_block_dense if moe_dense_oracle else moe.moe_block
        y, aux = fn(p["moe"], h2, cfg)
    else:
        y = mlp_forward(p["mlp"], h2, cfg)
    if kind == CROSS_ATTN:
        y = torch.tanh(p["mlp_gate"].to(x.dtype)) * y
    if cfg.sandwich_norm:
        y = apply_norm(p["ln2_post"], y, cfg)
    return common.shard_batch_seq(x + y), aux, new_cache


def _cross(p: Dict, h: torch.Tensor, memory: Optional[torch.Tensor],
           cfg: ModelConfig, mode: str, cache: Optional[Dict], *,
           gated: bool, use_kernels: bool
           ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Cross attention of a ``cross`` or ``encdec`` block -> (out, cache
    update).  Train and prefill project the memory's K/V once (prefill
    keeps them as the cache's ``xk``/``xv`` in the compute dtype, the
    reference's values: it projects them a second time for the cache);
    decode reads them back and returns the cache as it came."""
    if mode == "decode":
        kv = (cache["xk"].to(h.dtype), cache["xv"].to(h.dtype))
        return attn.cross_attention(p, h, None, cfg, gated=gated,
                                    kv_override=kv), cache
    if memory is None:
        raise ValueError(f"a cross-attention block needs the memory (the "
                         f"encoder's frames or the image embeddings) in "
                         f"{mode}")
    kv = attn.cross_kv(p, memory, cfg, h.dtype)
    out = attn.cross_attention(p, h, memory, cfg, gated=gated,
                               kv_override=kv, use_kernels=use_kernels)
    return out, (None if mode == "train" else {"xk": kv[0], "xv": kv[1]})


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> Dict:
    if kind in (GLOBAL_ATTN, ENCDEC) and cfg.use_mla:
        return mla.init_mla_cache(cfg, batch, max_len, dtype, device)
    if kind in (GLOBAL_ATTN, LOCAL_ATTN, ENCDEC):  # ENCDEC: + xk/xv later
        return attn.init_cache(cfg, batch, max_len,
                               LOCAL_ATTN if kind == LOCAL_ATTN
                               else GLOBAL_ATTN, dtype, device)
    if kind == CROSS_ATTN:   # xk/xv written at prefill
        return {}
    if kind == RGLRU:
        return rglru.init_rglru_cache(cfg, batch, device=device)
    if kind == SSD:      # f32 whatever dtype, as the reference's
        return ssm.init_ssm_cache(cfg, batch, device=device)
    raise ValueError(f"unknown block kind {kind!r}")


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
    """Block kind of every layer of each part of the stack, in layer
    order (prefix, then the body, then the extras)."""
    prefix, reps, pattern, extra = stack_plan(cfg)
    return {"prefix": [pattern[i % len(pattern)] for i in range(prefix)],
            "unrolled": [pattern[i % len(pattern)]
                         for i in range(reps * len(pattern))],
            "extra": list(extra)}


def init_stack(gen, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> Dict[str, List[Dict]]:
    """One parameter dict per decoder layer: prefix, body, extras."""
    out: Dict[str, List[Dict]] = {}
    layer = 0
    for part, kinds in stack_kinds(cfg).items():
        out[part] = []
        for kind in kinds:
            out[part].append(init_block(gen, cfg, kind, layer, dtype,
                                        device))
            layer += 1
    return out


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None
                     ) -> Dict[str, List[Dict]]:
    return {part: [init_block_cache(cfg, kind, batch, max_len, dtype,
                                    device) for kind in kinds]
            for part, kinds in stack_kinds(cfg).items()}


def reads_memory(cfg: ModelConfig) -> bool:
    """Whether a block of the stack attends to a memory (a ``cross`` or
    ``encdec`` block)."""
    return any(k in MEMORY_KINDS for ks in stack_kinds(cfg).values()
               for k in ks)


def stack_forward_train(stack: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                        positions: torch.Tensor,
                        memory: Optional[torch.Tensor] = None,
                        remat: str = "none", use_kernels: bool = True,
                        moe_dense_oracle: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence walk over every layer -> (x, aux loss summed
    over the layers).  ``remat`` other than ``"none"`` recomputes each
    block in the backward (see the module's docstring)."""
    if remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat policy {remat!r}")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for part, kinds in stack_kinds(cfg).items():
        for bp, kind in zip(stack[part], kinds):
            def block(x, bp=bp, kind=kind):
                return block_forward(bp, x, cfg, kind, mode="train",
                                     positions=positions, memory=memory,
                                     use_kernels=use_kernels,
                                     moe_dense_oracle=moe_dense_oracle)[:2]
            x, aux = (block(x) if remat == "none"
                      else checkpoint(block, x, use_reentrant=False))
            aux_total = aux_total + aux
    return x, aux_total


def stack_step(stack: Dict, caches: Dict, x: torch.Tensor,
               cfg: ModelConfig, *, mode: str, positions=None,
               position=None, memory: Optional[torch.Tensor] = None,
               use_kernels: bool = True) -> Tuple[torch.Tensor, Dict]:
    """The prefill/decode walk over every layer, threading caches (the
    aux loss is dropped, as the reference drops it)."""
    new_caches: Dict[str, List[Dict]] = {}
    for part, kinds in stack_kinds(cfg).items():
        new_caches[part] = []
        for bp, kind, cache in zip(stack[part], kinds, caches[part]):
            x, _, nc = block_forward(bp, x, cfg, kind, mode=mode,
                                     positions=positions, position=position,
                                     cache=cache, memory=memory,
                                     use_kernels=use_kernels)
            new_caches[part].append(nc)
    return x, new_caches


# --------------------------------------------------------------------------
# Positional embeddings (whisper)
# --------------------------------------------------------------------------

def sinusoid_positions(length: int, d_model: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """(length, d_model) table: sin of the angles, then cos, computed in
    f32 and cast to ``dtype`` (whisper's encoder adds it to the frames)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / max(d_model // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)

"""Model facade for serving (the port of ``repro.models.model``):

  init_params(cfg, seed=0, device=None)        -> param tree
  init_decode_state(cfg, batch, max_len, ...)  -> cache tree
  prefill(params, batch, cfg, cache)           -> (last-token logits, cache)
  decode_step(params, token, position, cfg, cache) -> (logits, cache)
  count_params_analytic(cfg)                   -> int

Parameters are nested dicts of tensors (``transformer`` holds one dict
per layer).  ``init_params`` draws every weight on the target device from
one seeded ``torch.Generator``: a 9.6 B-parameter model never passes
through host memory.  The numbers differ from the reference's
``jax.random`` draws; ``models.convert.params_from_jax`` carries the
reference's own parameters over where the two must agree.

Training (``forward_train``, ``loss_fn``) waits for its slice (ROADMAP A12).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common
from repro_torch.models.common import dense_init, embed_init
from repro_torch.models.transformer import (apply_norm, check_config,
                                            init_norm, init_stack,
                                            init_stack_cache, stack_step)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def _init(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    check_config(cfg)
    kw = dict(dtype=dtype, device=device)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), **kw),
        "decoder": init_stack(gen, cfg, **kw),
        "ln_f": init_norm(cfg, **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       **kw)
    return params


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None,
                dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters drawn on ``device`` (default ``cuda``) from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _init(gen, cfg, dtype, dev)


def count_params_analytic(cfg: ModelConfig, active_only: bool = False,
                          exclude_embed: bool = False) -> int:
    """Parameter count from the port's own init on the ``meta`` device
    (shapes only; nothing is allocated)."""
    params = _init(None, cfg, torch.float32, torch.device("meta"))
    total = sum(t.numel() for t in leaves(params))
    if exclude_embed:
        total -= cfg.vocab_size * cfg.d_model
    return total


def leaves(tree):
    """Every tensor of a parameter or cache tree."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        for v in tree:
            yield from leaves(v)


# --------------------------------------------------------------------------
# Shared pieces
# --------------------------------------------------------------------------

def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           cdt: torch.dtype) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt,
                             device=x.device)
    return x


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm -> head -> softcap -> pad-vocab mask.  f32 out."""
    h = apply_norm(params["ln_f"], x, cfg)
    if cfg.tie_embeddings:
        logits = torch.matmul(h, params["embed"].to(h.dtype).t())
    else:
        logits = torch.matmul(h, params["lm_head"].to(h.dtype))
    logits = common.softcap(logits.float(), cfg.final_softcap)
    if cfg.vocab_real != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_size, device=logits.device) \
            >= cfg.vocab_real
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _check_batch(batch: Dict):
    extra = sorted(set(batch) - {"tokens"})
    if extra:
        raise NotImplementedError(
            f"batch inputs {extra} (encoder frames / image embeddings) wait "
            f"for the encoder-decoder and vision slices (ROADMAP A11)")


# --------------------------------------------------------------------------
# Serving: prefill + decode
# --------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      dtype=torch.bfloat16, device: DeviceLike = None
                      ) -> Dict:
    return init_stack_cache(cfg, batch, max_len, dtype,
                            resolve_device(device))


def prefill(params, batch: Dict, cfg: ModelConfig, cache: Dict, *,
            use_kernels: bool = True) -> Tuple[torch.Tensor, Dict]:
    """Process the prompt from position 0; returns (last-token logits
    f32 (b, vocab), filled cache).  ``use_kernels`` runs the attention
    and the scans through B5, B6 and B7 (their plain versions on the
    CPU); False takes the reference's dense/chunked attention, log-depth
    scan and chunked SSD instead."""
    _check_batch(batch)
    tokens = torch.as_tensor(batch["tokens"])
    b, s = tokens.shape
    dev = params["embed"].device
    x = _embed(params, tokens.to(dev), cfg, compute_dtype(cfg))
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None] \
        .expand(b, s)
    x, cache = stack_step(params["decoder"], cache, x, cfg, mode="prefill",
                          positions=positions, use_kernels=use_kernels)
    return _logits(params, x[:, -1:], cfg)[:, 0], cache


def decode_step(params, token: torch.Tensor, position: int,
                cfg: ModelConfig, cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token for the whole batch.  token: (b, 1) ints; position: the
    absolute position of that token.  Plain torch (no kernel), as in the
    reference."""
    x = _embed(params, token.to(params["embed"].device), cfg,
               compute_dtype(cfg))
    x, cache = stack_step(params["decoder"], cache, x, cfg, mode="decode",
                          position=int(position))
    return _logits(params, x, cfg)[:, 0], cache

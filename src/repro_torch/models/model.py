"""Model facade (the port of ``repro.models.model``):

  init_params(cfg, seed=0, device=None)        -> param tree
  forward_train(params, batch, cfg)            -> (logits, aux, hidden)
  loss_fn(params, batch, cfg)                  -> (loss, metrics: ce, aux,
                                                  mtp where the model has
                                                  it, tokens, loss)
  make_batch(seed, cfg, batch, seq)            -> numpy tokens/labels
                                                  (+ frames / image_embeds)
  init_decode_state(cfg, batch, max_len, ...)  -> cache tree
  prefill(params, batch, cfg, cache)           -> (last-token logits, cache)
  decode_step(params, token, position, cfg, cache) -> (logits, cache)
  count_params_analytic(cfg, active_only)      -> int

Parameters are nested dicts of tensors (``transformer`` holds one dict
per layer).  ``init_params`` draws every weight on the target device from
one seeded ``torch.Generator``: a 9.6 B-parameter model never passes
through host memory.  The numbers differ from the reference's
``jax.random`` draws; ``models.convert.params_from_jax`` carries the
reference's own parameters over where the two must agree.

Batches are dicts of (batch, seq) token ids, numpy arrays or tensors,
plus whisper's ``frames`` (batch, encoder_seq, d) or llama-3.2-vision's
``image_embeds`` (batch, n_image_tokens, d): the stub frontends'
precomputed embeddings, the memory that cross attention reads.  Each
entry point moves them to the parameters' device.  The memory is
computed only where a block of the stack reads it: whisper's decoder as
configured is plain ``global`` blocks, so its prefill never runs the
encoder, which gives the reference's jitted logits (XLA drops the
encoder there as dead code; ROADMAP C20).  ``_encode`` runs it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common
from repro_torch.models.common import dense_init, embed_init
from repro_torch.models.transformer import (ENCODER, apply_norm,
                                            block_forward, check_config,
                                            init_block, init_norm,
                                            init_stack, init_stack_cache,
                                            reads_memory, sinusoid_positions,
                                            stack_step, stack_forward_train)
from repro_torch.tree import leaves

MTP_LOSS_WEIGHT = 0.3


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """Whisper's encoder: ``n_encoder_layers`` bidirectional blocks."""
    return cfg.scaled(n_layers=cfg.n_encoder_layers,
                      attn_pattern=(ENCODER,), n_experts=0,
                      n_dense_layers=0, is_encoder_decoder=False)


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
    if cfg.is_encoder_decoder:
        ecfg = _encoder_cfg(cfg)
        params["encoder"] = {"stack": init_stack(gen, ecfg, **kw),
                             "ln_f": init_norm(ecfg, **kw)}
    if cfg.mtp_depth > 0:
        # DeepSeek multi-token prediction: its block is layer n_layers
        params["mtp"] = {
            "proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model), **kw),
            "norm_h": init_norm(cfg, **kw),
            "norm_e": init_norm(cfg, **kw),
            "block": init_block(gen, cfg, cfg.attn_pattern[0], cfg.n_layers,
                                **kw),
            "ln_f": init_norm(cfg, **kw),
        }
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


def params_like(cfg: ModelConfig, dtype=torch.float32) -> Dict[str, Any]:
    """The parameter tree on the ``meta`` device: shapes and dtypes only,
    nothing allocated (a checkpoint restore's ``like``)."""
    return _init(None, cfg, dtype, torch.device("meta"))


def count_params_analytic(cfg: ModelConfig, active_only: bool = False,
                          exclude_embed: bool = False) -> int:
    """Parameter count from the port's own init on the ``meta`` device;
    ``active_only`` leaves out the routed experts a token does not use
    (E - k of them in every MoE layer, the MTP block's included)."""
    total = sum(t.numel() for t in leaves(params_like(cfg)))
    if exclude_embed:
        total -= cfg.vocab_size * cfg.d_model
    if active_only and cfg.is_moe:
        n_moe = cfg.n_layers - cfg.n_dense_layers + (1 if cfg.mtp_depth
                                                     else 0)
        per_expert = 3 * cfg.d_model * cfg.d_expert
        total -= n_moe * per_expert * (cfg.n_experts - cfg.top_k)
    return total


# --------------------------------------------------------------------------
# Shared pieces
# --------------------------------------------------------------------------

def _embed(params, tokens: torch.Tensor, cfg: ModelConfig,
           cdt: torch.dtype) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cdt)
    if cfg.embed_scale:
        # a fill on the device (no copy from the host: capturable)
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=cdt,
                           device=x.device)
    return common.shard_batch_seq(x)


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final norm -> head -> softcap -> pad-vocab mask.  f32 out."""
    h = apply_norm(params["ln_f"], x, cfg)
    if cfg.tie_embeddings:
        logits = torch.matmul(h, params["embed"].to(h.dtype).t())
    else:
        logits = torch.matmul(h, params["lm_head"].to(h.dtype))
    logits = common.softcap(common.shard_vocab(logits).float(),
                            cfg.final_softcap)
    if cfg.vocab_real != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_size, device=logits.device) \
            >= cfg.vocab_real
        logits = logits.masked_fill(pad, -1e30)
    return logits


def _encode(params, frames, cfg: ModelConfig, *,
            use_kernels: bool = True) -> torch.Tensor:
    """Whisper's encoder over the stub frontend's frame embeddings (b,
    frames, d) -> (b, frames, d) in the compute dtype; ``use_kernels``
    runs its attention through B5 (non-causal)."""
    ecfg = _encoder_cfg(cfg)
    dev = params["embed"].device
    x = torch.as_tensor(frames).to(dev, compute_dtype(cfg))
    x = x + sinusoid_positions(x.shape[1], cfg.d_model, x.dtype, dev)[None]
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=dev)[None]
    x, _ = stack_forward_train(params["encoder"]["stack"], x, ecfg,
                               positions=positions, use_kernels=use_kernels)
    return apply_norm(params["encoder"]["ln_f"], x, ecfg)


def _memory(params, batch: Dict, cfg: ModelConfig, use_kernels: bool):
    """What the cross-attention blocks read: the encoder's output over
    ``frames`` or the ``image_embeds``; None where no block reads one."""
    if not reads_memory(cfg):
        return None
    key = "frames" if cfg.is_encoder_decoder else "image_embeds"
    if key not in batch:
        raise ValueError(f"{cfg.name} attends to a memory: the batch needs "
                         f"{key!r}")
    if cfg.is_encoder_decoder:
        return _encode(params, batch[key], cfg, use_kernels=use_kernels)
    return torch.as_tensor(batch[key]).to(params["embed"].device,
                                          compute_dtype(cfg))


def _tokens(batch: Dict, key: str, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(batch[key]).to(dev, torch.long)


# --------------------------------------------------------------------------
# Train forward + loss
# --------------------------------------------------------------------------

def forward_train(params, batch: Dict, cfg: ModelConfig, *,
                  remat: str = "none", use_kernels: bool = True,
                  moe_dense_oracle: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (logits f32 (b, s, vocab), aux loss, final hidden).
    ``use_kernels`` runs the attention and the scans through B5, B6 and
    B7 (their plain versions on the CPU), with gradients on the card
    through ``kernels.grad``; False takes the reference's dense
    attention, log-depth scan and chunked SSD.  ``moe_dense_oracle``
    runs every MoE layer through the dense oracle."""
    dev = params["embed"].device
    tokens = _tokens(batch, "tokens", dev)
    b, s = tokens.shape
    x = _embed(params, tokens, cfg, compute_dtype(cfg))
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None] \
        .expand(b, s)
    x, aux = stack_forward_train(params["decoder"], x, cfg,
                                 positions=positions,
                                 memory=_memory(params, batch, cfg,
                                                use_kernels),
                                 remat=remat, use_kernels=use_kernels,
                                 moe_dense_oracle=moe_dense_oracle)
    return _logits(params, x, cfg), aux, x


def _ce(logits: torch.Tensor, labels: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked token cross entropy; labels < 0 are ignored."""
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = mask.sum().clamp_min(1.0)
    return (nll * mask).sum() / denom, denom


def _mtp_loss(params, batch: Dict, cfg: ModelConfig, hidden: torch.Tensor,
              use_kernels: bool) -> torch.Tensor:
    """DeepSeek multi-token prediction: predict token t+2 from the
    normed hidden state at t joined with the embedding of token t+1."""
    dev = hidden.device
    tokens = _tokens(batch, "tokens", dev)
    b, s = tokens.shape
    p = params["mtp"]
    h = apply_norm(p["norm_h"], hidden[:, :-1], cfg)
    e = apply_norm(p["norm_e"], _embed(params, tokens[:, 1:], cfg,
                                       hidden.dtype), cfg)
    merged = torch.matmul(torch.cat([h, e], dim=-1),
                          p["proj"].to(hidden.dtype))
    positions = torch.arange(s - 1, dtype=torch.int32, device=dev)[None] \
        .expand(b, s - 1)
    merged, _, _ = block_forward(p["block"], merged, cfg,
                                 cfg.attn_pattern[0], mode="train",
                                 positions=positions,
                                 use_kernels=use_kernels)
    logits = _logits({**params, "ln_f": p["ln_f"]}, merged, cfg)
    # the label at position t+1 is token t+2
    loss, _ = _ce(logits, _tokens(batch, "labels", dev)[:, 1:])
    return loss


def loss_fn(params, batch: Dict, cfg: ModelConfig, *, remat: str = "none",
            use_kernels: bool = True) -> Tuple[torch.Tensor, Dict]:
    """-> (loss, {"ce", "aux", "tokens", "loss"} + "mtp" where the model
    predicts two tokens), the reference's: ce + router_aux_coef * aux
    + MTP_LOSS_WEIGHT * mtp."""
    logits, aux, hidden = forward_train(params, batch, cfg, remat=remat,
                                        use_kernels=use_kernels)
    ce, n_tok = _ce(logits, _tokens(batch, "labels", logits.device))
    loss = ce + cfg.router_aux_coef * aux
    metrics = {"ce": ce, "aux": aux, "tokens": n_tok}
    if cfg.mtp_depth > 0:
        mtp = _mtp_loss(params, batch, cfg, hidden, use_kernels)
        loss = loss + MTP_LOSS_WEIGHT * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = loss
    return loss, metrics


def make_batch(seed: int, cfg: ModelConfig, batch: int, seq: int
               ) -> Dict[str, np.ndarray]:
    """A random training batch from a numpy seed: tokens uniform over the
    real vocabulary, labels the next token (-1 at the end), and for
    whisper ``frames`` (batch, encoder_seq, d), for llama-3.2-vision
    ``image_embeds`` (batch, n_image_tokens, d), standard normal in f32.
    The reference draws from a ``jax.random`` key, so the two differ."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_real, (batch, seq)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -1, np.int32)],
                            axis=1)
    out = {"tokens": toks, "labels": labels}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.cross_attn_period:
        out["image_embeds"] = rng.standard_normal(
            (batch, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


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
    tokens = torch.as_tensor(batch["tokens"])
    b, s = tokens.shape
    dev = params["embed"].device
    x = _embed(params, tokens.to(dev), cfg, compute_dtype(cfg))
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None] \
        .expand(b, s)
    x, cache = stack_step(params["decoder"], cache, x, cfg, mode="prefill",
                          positions=positions,
                          memory=_memory(params, batch, cfg, use_kernels),
                          use_kernels=use_kernels)
    return _logits(params, x[:, -1:], cfg)[:, 0], cache


def decode_step(params, token: torch.Tensor,
                position: Union[int, torch.Tensor], cfg: ModelConfig,
                cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One token for the whole batch.  token: (b, 1) ints; position: the
    absolute position of that token, an int or a 0-d integer tensor on
    the device (attention reads it there, so a CUDA graph of one step
    serves every position; MLA takes an int).  Plain torch (no kernel),
    as in the reference."""
    x = _embed(params, token.to(params["embed"].device), cfg,
               compute_dtype(cfg))
    if not torch.is_tensor(position):
        position = int(position)
    x, cache = stack_step(params["decoder"], cache, x, cfg, mode="decode",
                          position=position)
    return _logits(params, x, cfg)[:, 0], cache

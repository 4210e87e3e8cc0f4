"""Shared model building blocks: norms, activations, RoPE, init.

Functional like the reference: parameters are plain nested dicts of
tensors, layers are functions.  The reference's activation-sharding
helpers (``shard_*``) are identities in one process and have no
counterpart here.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# Norms / activations
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, *,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm in f32 with cast back (gemma uses zero-centered scale)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    w = scale.float()
    if zero_centered:
        w = 1.0 + w
    return (y * w).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``: the tanh form, not torch's
    default erf form."""
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return gelu_tanh
    raise ValueError(f"unknown activation {name!r}")


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, fraction: float = 1.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension (f32)."""
    rot_dim = int(head_dim * fraction)
    rot_dim -= rot_dim % 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=device) / rot_dim
    return 1.0 / (theta ** exponent)       # (rot_dim // 2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """Apply rotary embedding (half-split rotation).

    x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    With fraction < 1 only the leading ``fraction`` of head_dim is rotated
    (ChatGLM 2d-RoPE).
    """
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, theta, fraction, x.device)
    rot_dim = inv_freq.shape[0] * 2
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]

    angles = positions[..., None].float() * inv_freq   # (..., seq, rot/2)
    cos = torch.cos(angles)[..., None, :]               # broadcast over heads
    sin = torch.sin(angles)[..., None, :]

    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    rotated = torch.cat([out1, out2], dim=-1).to(x.dtype)
    if rot_dim == head_dim:
        return rotated
    return torch.cat([rotated, x_pass], dim=-1)


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------

def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int],
               in_axis: int = 0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (within ±2σ, σ = fan_in^-0.5), drawn
    in f32 from ``gen`` on ``device``.  On the ``meta`` device nothing is
    drawn (shapes only)."""
    t = _empty(shape, torch.float32, device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(shape[in_axis] ** -0.5)
    return t.to(dtype)


def embed_init(gen: Optional[torch.Generator], shape: Sequence[int],
               dtype=torch.float32, device=None) -> torch.Tensor:
    # fan-in scale keeps tied-embedding logits O(1); archs with
    # embed_scale (gemma) recover O(1) inputs via the sqrt(d) multiplier.
    t = _empty(shape, torch.float32, device)
    if t.device.type != "meta":
        torch.nn.init.normal_(t, 0.0, shape[-1] ** -0.5, generator=gen)
    return t.to(dtype)

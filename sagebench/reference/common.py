"""Pieces the plain references share: the precision of their products,
norms, RoPE, cross entropy and AdamW.

Everything is plain PyTorch in float32.  Products go through ``mm`` and
``einsum``: with ``tf32`` their operands are first rounded to TF32's 10
mantissa bits (round to nearest even), which is what a float32 GEMM on the
card's tensor cores does with TF32 allowed.  That rounding is the control
of every cell: the precision one step below the configurations' float32.
It is emulated, so the control reads the same on the CPU and on the card.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F


def exact_f32():
    """Keep the card's float32 products in float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even.
    The gradient passes through unchanged, so the backward's products
    read the rounded values that the forward saved."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    r = i.view(torch.float32)
    return x + (r - x.detach()) if x.requires_grad else r


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a, b)


def einsum(eq: str, *ops: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        ops = tuple(round_tf32(o) for o in ops)
    return torch.einsum(eq, *ops)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, the two halves of each head rotated together.
    x: (..., s, heads, hd); pos: (s,) positions."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = pos.float()[:, None] * inv                       # (s, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token cross entropy over every label (none is masked here)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def lr_at(step: int, opt: Dict) -> float:
    """Linear warm-up, then cosine decay to a tenth of the peak rate."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
            1.0)
    return opt["lr"] * warm * (0.1 + 0.45 * (1.0 + math.cos(math.pi * t)))


@torch.no_grad()
def adamw_step(params: List[torch.Tensor], grads: List[torch.Tensor],
               m: List[torch.Tensor], v: List[torch.Tensor], step: int,
               opt: Dict) -> List[torch.Tensor]:
    """One AdamW step in place on ``params`` (step counts from 1): the
    gradient clipped to a global norm of ``opt["clip"]``, weight decay on
    tensors of two or more dimensions.  Returns the clipped gradients."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
    scale = min(opt["clip"] / max(float(norm), 1e-9), 1.0)
    b1, b2, eps = opt["beta1"], opt["beta2"], 1e-8
    lr = lr_at(step, opt)
    clipped = []
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g * scale
        clipped.append(g)
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (mi / (1 - b1 ** step)) / (
            torch.sqrt(vi / (1 - b2 ** step)) + eps)
        if p.dim() >= 2:
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
    return clipped

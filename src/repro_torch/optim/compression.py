"""Gradient compression with error feedback (the port of
``repro.optim.compression``): int8 stochastic rounding with a per-tensor
scale, the residual carried to the next step.

The stochastic-rounding noise is uniform on [-0.5, 0.5), drawn from the
``torch.Generator`` the caller passes; the reference draws it from
``jax.random``, so the two give other bits from one seed.  ``_noise``
(tests only) takes the uniforms instead, one tensor per leaf, so that a
test can hand both packages the same noise.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def _quantize_int8(x: torch.Tensor, noise: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def compress_grads(grads, error: Any,
                   generator: Optional[torch.Generator] = None, *,
                   _noise: Optional[Sequence[torch.Tensor]] = None
                   ) -> Tuple[Any, Any, torch.Tensor]:
    """-> (decompressed grads, new error feedback, compression ratio)."""
    flat = leaves(grads)
    errs = leaves(error)
    outs, new_err = [], []
    raw_bits = comp_bits = 0
    for i, (g, e) in enumerate(zip(flat, errs)):
        g32 = g.float() + e
        noise = (_noise[i] if _noise is not None else
                 torch.rand(g32.shape, generator=generator,
                            device=g32.device) - 0.5)
        q, scale = _quantize_int8(g32, noise.to(g32.device))
        deq = _dequantize(q, scale)
        outs.append(deq.to(g.dtype))
        new_err.append(g32 - deq)
        raw_bits += g.numel() * 32
        comp_bits += g.numel() * 8 + 32
    ratio = torch.tensor(raw_bits / max(comp_bits, 1), dtype=torch.float32)
    return unflatten(grads, outs), unflatten(grads, new_err), ratio

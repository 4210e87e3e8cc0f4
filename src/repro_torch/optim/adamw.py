"""AdamW with f32 moments, global-norm clipping and a cosine schedule
(the port of ``repro.optim.adamw``).

The arithmetic is the reference's, in f32: the learning rate from an f32
step, bias corrections ``1 - b ** step`` in f32, then per leaf
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g², Δ = m̂ / (√v̂ + eps)
(+ weight decay on leaves of two or more dimensions), p = p - lr Δ.
Unlike the reference, whose arrays are immutable, the update is made in
place (``torch._foreach_*`` under ``no_grad``): parameters, m and v keep
their storage, and ``adamw_update`` returns the same tuple as the
reference with those tensors in it.  A caller that keeps the old values
(an asynchronous checkpoint) copies them first.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: Any                   # f32 tree like params
    v: Any


def init_opt_state(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32,
                         device=leaves(params)[0].device),
        m=tree_map(zeros, params), v=tree_map(zeros, params))


def lr_schedule(step: torch.Tensor, run: RunConfig) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10%, in f32 from the step."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(run.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - run.warmup_steps) /
                    max(run.total_steps - run.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * t))
    return run.learning_rate * warm * cos


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    norms = torch._foreach_norm([g.float() for g in leaves(tree)])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads, max_norm: float):
    """-> (f32 grads scaled to at most ``max_norm``, the norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _decay_mask(params):
    """True where weight decay applies (>=2D weights)."""
    return tree_map(lambda p: p.dim() >= 2, params)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, run: RunConfig
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place; -> (params, state, {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
    step = state.step + 1
    lr = lr_schedule(step, run)
    b1, b2, eps = run.beta1, run.beta2, 1e-8
    # one read of the three f32 scalars: the foreach ops take numbers
    bc1 = float(1.0 - b1 ** step.float())
    bc2 = float(1.0 - b2 ** step.float())
    lr_f = float(lr)

    p, g = leaves(params), leaves(grads)
    m, v = leaves(state.m), leaves(state.v)
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - b2))
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    delta = torch._foreach_div(m, bc1)
    torch._foreach_div_(delta, denom)
    del denom
    wd = [i for i, d in enumerate(leaves(_decay_mask(params))) if d]
    if wd:
        torch._foreach_add_([delta[i] for i in wd], torch._foreach_mul(
            [p[i].float() for i in wd], run.weight_decay))
    torch._foreach_mul_(delta, lr_f)
    for t, d in zip(p, delta):          # p - lr Δ in f32, then p's dtype
        if t.dtype == torch.float32:
            t.sub_(d)
        else:
            t.copy_(t.float() - d)
    state.step.copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}

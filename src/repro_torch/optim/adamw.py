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
    def zeros(p):       # a DTensor's moments take its placements
        return torch.zeros_like(p, dtype=torch.float32)
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


# leaves updated together: their f32 temporaries (the scaled gradient,
# g², the denominators, the step) stay within about this many bytes
GROUP_BYTES = 1 << 30


def _groups(tensors):
    """Index lists of consecutive leaves of at most ``GROUP_BYTES`` of
    f32 each (a larger leaf alone)."""
    out, cur, size = [], [], 0
    for i, t in enumerate(tensors):
        n = t.numel() * 4
        if cur and size + n > GROUP_BYTES:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    return out + [cur] if cur else out


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, run: RunConfig
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place; -> (params, state, {"grad_norm", "lr"}).
    The leaves go through the ``_foreach`` ops in groups
    (``GROUP_BYTES``), so the temporaries never hold a second copy of
    every gradient (a 2.5 B-parameter model's 10 GB); each element's
    arithmetic is that of one group of all leaves."""
    gnorm = global_norm(grads)
    scale = torch.clamp(run.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)                 # clip_by_global_norm's
    step = state.step + 1
    lr = lr_schedule(step, run)
    b1, b2, eps = run.beta1, run.beta2, 1e-8
    # one read of the three f32 scalars: the foreach ops take numbers
    bc1 = float(1.0 - b1 ** step.float())
    bc2 = float(1.0 - b2 ** step.float())
    lr_f = float(lr)

    p_all, g_all = leaves(params), leaves(grads)
    m_all, v_all = leaves(state.m), leaves(state.v)
    decays = leaves(_decay_mask(params))
    for idx in _groups(p_all):
        p = [p_all[i] for i in idx]
        g = [g_all[i].float() * scale for i in idx]
        m, v = [m_all[i] for i in idx], [v_all[i] for i in idx]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                                  1 - b2))
        del g
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        delta = torch._foreach_div(m, bc1)
        torch._foreach_div_(delta, denom)
        del denom
        wd = [j for j, i in enumerate(idx) if decays[i]]
        if wd:
            torch._foreach_add_([delta[j] for j in wd], torch._foreach_mul(
                [p[j].float() for j in wd], run.weight_decay))
        torch._foreach_mul_(delta, lr_f)
        for t, d in zip(p, delta):      # p - lr Δ in f32, then p's dtype
            if t.dtype == torch.float32:
                t.sub_(d)
            else:
                t.copy_(t.float() - d)
    state.step.copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}

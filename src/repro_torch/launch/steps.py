"""Train / prefill / decode / eval steps used by the launchers (the port
of ``repro.launch.steps``).  PyTorch runs them eagerly: nothing is
compiled.

Gradients are ``torch.autograd.grad`` of ``loss_fn`` over every
parameter leaf, each set ``requires_grad_(True)``; on the card the model
kernels carry their gradients (``kernels.grad``).  With ``microbatch``
n > 1 the batch is split into n along its first axis and the f32
gradients are averaged, as the reference's scan does.

On a mesh the parameters, the optimizer state and the batch are
``DTensor``s (``distributed.sharding``) and the same code runs on them;
each gradient is redistributed to its parameter's placements before the
update.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch import trace
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as mdl
from repro_torch.models.common import on_replicas
from repro_torch.optim import AdamWState, adamw_update
from repro_torch.tree import leaves, unflatten


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` parameter's gradient on that parameter's placements
    (autograd leaves ``Partial`` sums where the batch was split)."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_grad_fn(cfg: ModelConfig, run: RunConfig):
    """(params, batch) -> (grads, metrics): the gradient of ``loss_fn``,
    averaged over ``run.microbatch`` microbatches when that is above 1."""

    def compute_grads(params, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        with trace.span("train.forward"):
            loss, metrics = mdl.loss_fn(params, batch, cfg, remat=run.remat,
                                        use_kernels=True)
        # deepseek's router bias only selects experts: no gradient reaches
        # it, and its zeros are the reference's.  Autograd's device thread
        # puts the kernels' recompute (grad.recompute) under this span
        with trace.span("train.backward", device=True, lend=True):
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
        grads = [_placed_like(g, p) for g, p in zip(grads, flat)]
        return unflatten(params, grads), {k: v.detach()
                                          for k, v in metrics.items()}

    def accum_grads(params, batch):
        n = run.microbatch
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves(params)]
        ms = []
        for i in range(n):
            mb = {k: v[i * (len(v) // n):(i + 1) * (len(v) // n)]
                  for k, v in batch.items()}
            grads, metrics = compute_grads(params, mb)
            for a, g in zip(acc, leaves(grads)):
                a.add_(g.float() / n)
            ms.append(metrics)
        return unflatten(params, acc), {
            k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

    return accum_grads if run.microbatch > 1 else compute_grads


def make_train_step(cfg: ModelConfig, run: RunConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics).
    The parameters and the optimizer state are updated in place."""
    grad_fn = make_grad_fn(cfg, run)

    def train_step(params, opt_state: AdamWState, batch: Dict):
        grads, metrics = grad_fn(params, batch)
        params, opt_state, om = adamw_update(params, grads, opt_state, run)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """(params, batch, cache) -> (last-token logits, cache)."""

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return mdl.prefill(params, batch, cfg, cache, use_kernels=True)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(params, cache, token, position) -> (next_token, cache): one new
    token for the whole batch against a filled KV/state cache."""

    def greedy(logits):
        return logits.argmax(-1).to(torch.int32)[:, None]

    @torch.no_grad()
    def serve_step(params, cache, token, position):
        logits, cache = mdl.decode_step(params, token, position, cfg, cache)
        # on a mesh the argmax runs on whole logits: DTensor's argmax over
        # a split vocab fails on one row (on_replicas)
        return on_replicas(greedy, logits), cache

    return serve_step


def make_eval_step(cfg: ModelConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = mdl.loss_fn(params, batch, cfg, use_kernels=True)
        return metrics

    return eval_step

"""Pipeline parallelism: GPipe-style microbatched execution over a mesh
axis (the port of ``repro.distributed.pipeline``).

A stack of layer repetitions (reps, ...) is split into S contiguous
stages over the ``stage`` mesh axis, one stage a rank, and M
microbatches stream through them.  Steady-state schedule (fill + M +
drain slots):

    slot t: stage s runs microbatch (t - s) if 0 <= t - s < M
    activations move s -> s+1 between slots (a collective permute)

As in the reference, every stage runs in every slot and an inactive
slot's result is masked (``torch.where``), so an inactive slot's
gradient is zeros, not missing.  The permute is a
``torch.autograd.Function`` over ``dist.batch_isend_irecv`` whose
backward permutes the other way: differentiating ``pipeline_forward``
gives the GPipe backward.  The last stage's outputs are summed over the
stage axis so that every rank returns the whole result; each rank then
holds the same loss, so that sum's backward hands each rank the
cotangent as it is (``torch.distributed.nn``'s all-reduce would sum it
over the ranks, S times too much).  Bubble fraction is (S-1)/(M+S-1).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.tree import leaves, tree_map


def split_stages(stacked_params, n_stages: int):
    """(reps, ...) tree -> (S, reps/S, ...) tree."""

    def reshape(x):
        reps = x.shape[0]
        if reps % n_stages:
            raise ValueError(f"{reps} reps across {n_stages} stages")
        return x.reshape(n_stages, reps // n_stages, *x.shape[1:])

    return tree_map(reshape, stacked_params)


class _Permute(torch.autograd.Function):
    """Send to the next stage and receive from the previous one (shift
    +1 around the ring); the backward shifts -1."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -ctx.shift), None, None


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), group=group,
                      group_peer=(me + shift) % n),
           dist.P2POp(dist.irecv, out, group=group,
                      group_peer=(me - shift) % n)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _SumReplicated(torch.autograd.Function):
    """All-reduce (sum) into an output every rank holds whole; every rank
    computes the same loss from it, so the backward passes its cotangent
    through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_forward(stage_fn: Callable, staged_params, x: torch.Tensor, *,
                     mesh, axis: str = "stage",
                     n_microbatches: int) -> torch.Tensor:
    """Run x through all stages with microbatch pipelining.

    stage_fn(params_one_rep, x) -> x  (applied rep by rep inside a stage)
    staged_params: tree with leading dims (S, reps_per_stage, ...): whole
    tensors that every rank holds (each rank reads its stage's slice), or
    ``DTensor``s sharded on dim 0 over ``axis``.
    x: (batch, ...) with batch % n_microbatches == 0, the same on every
    rank.  Returns the whole (batch, ...) result on every rank.
    """
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    sidx = dist.get_rank(group)
    m = n_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    micro = x.reshape(m, b // m, *x.shape[1:])

    def mine(p):
        return p.to_local()[0] if isinstance(p, DTensor) else p[sidx]
    params_here = tree_map(mine, staged_params)
    reps = leaves(params_here)[0].shape[0]

    def run_stage(xm):
        for r in range(reps):
            xm = stage_fn(tree_map(lambda p: p[r], params_here), xm)
        return xm

    state = torch.zeros_like(micro[0])
    outputs = [torch.zeros_like(micro[0]) for _ in range(m)]
    for t in range(m + n_stages - 1):
        # stage 0 ingests microbatch t; the others use the permuted state
        my_in = micro[min(max(t, 0), m - 1)] if sidx == 0 else state
        active = torch.tensor(0 <= t - sidx < m, device=x.device)
        out = torch.where(active, run_stage(my_in), state)
        # the last stage records finished microbatch (t - S + 1)
        done = min(max(t - n_stages + 1, 0), m - 1)
        record = torch.tensor(sidx == n_stages - 1 and 0 <= t - sidx < m,
                              device=x.device)
        outputs[done] = torch.where(record, out, outputs[done])
        # shift activations to the next stage
        state = _Permute.apply(out, group, 1)
    # only the last stage recorded non-zero outputs
    whole = _SumReplicated.apply(torch.stack(outputs), group)
    return whole.reshape(b, *x.shape[1:])

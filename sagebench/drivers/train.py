"""Training cells: ``Trainer.step`` fed by ``TokenLoader`` from Clovis.

Set-up writes the mix's corpus (drawn from the seed) into the trainer's
Clovis, draws the weights, and runs the checked steps and the warm-up
steps through the window's own call and feed.  The window then runs step
after step until ``--seconds`` have passed and the last step has ended.
After the window one more step goes through the same call and feed.

The check follows three stretches of steps with the reference, each from
a copy of the training state taken before it, on the rows that the
loader's rule takes from the corpus for those steps:

- the set-up's checked steps, from the weights drawn from the seed and
  AdamW's zero moments: the reference starts from nothing the program
  made;
- the window's first ``checked_steps`` steps, from the program's state
  as the window opens (copied before it);
- the step after the window, from the program's state as the window
  closes: a fault that sets in after some steps shows here.

The last two follow the program from its own state (its parameters, its
moments and its step count); the first checks the start on its own.
For each stretch, ``loss_gap`` is the largest relative gap of a step's
loss; ``grad_gap`` the worst leaf's gap between the norms of the first
gradient as the optimizer got it (worked out from AdamW's first moment
before and after the stretch's first step) and the reference's clipped
gradient; ``change_gap`` the median leaf's gap between the norms of the
parameters' change over the stretch, over the leaves whose reference
gradient is not nought to rounding (at least ``MOVING`` of the median
leaf's): a worst leaf's change swings with the sign that AdamW gives an
element whose gradient is nought to rounding, so the median is the
steady reading.  A gap is taken against the reference's norm of that
leaf or of the median leaf, whichever is larger.  Each number is the
worst over the stretches.  ``batch_mismatch`` counts the batches of
every step that differ from the rows the rule takes from the corpus.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from sagebench import traffic
from sagebench.devtrace import DeviceTrace
from sagebench.harness import Record
from sagebench.probes import Probes, span
from sagebench.weights import clone_tree, leaf_list, make_params

MOVING = 1e-3


def expected_batch(shards: List[np.ndarray], seed: int, step: int,
                   batch: int, seq: int) -> Dict[str, np.ndarray]:
    """The rows the loader's rule takes for ``step``: from a generator
    seeded with seed + step, a shard and an offset in it, until
    batch x (seq + 1) tokens are taken; tokens and next-token labels."""
    need = batch * (seq + 1)
    rng = np.random.default_rng(seed + step)
    out = np.empty(need, np.int32)
    got = 0
    while got < need:
        arr = shards[rng.integers(len(shards))]
        take = min(need - got, arr.size)
        off = int(rng.integers(max(arr.size - take, 1)))
        out[got:got + take] = arr[off:off + take]
        got += take
    rows = out.reshape(batch, seq + 1)
    return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def _state(params, opt_state) -> Dict:
    """A copy of the training state: the parameters, AdamW's moments and
    its step count (a stretch from the drawn weights has the moments
    None: zero)."""
    return {"params": clone_tree(params), "m": clone_tree(opt_state.m),
            "v": clone_tree(opt_state.v), "step": int(opt_state.step)}


def _stretch(start: Dict, first: int, losses: List, m_first, params_end,
             beta1: float) -> Dict:
    """The program's readings over a stretch of ``len(losses)`` steps
    from ``start``, whose first step took batch ``first``: each step's
    loss, each leaf's first gradient (from the first moment before and
    after the first step, ``m_first``) and each leaf's change."""
    m0 = dict(leaf_list(start["m"])) if start["m"] is not None else {}
    p0 = dict(leaf_list(start["params"]))
    grads = {}
    for n, m in leaf_list(m_first):
        g = m - beta1 * m0[n] if n in m0 else m
        grads[n] = float(g.norm()) / (1 - beta1)
    return {"start": start, "first": first,
            "losses": [float(x) for x in losses], "grad_norms": grads,
            "change_norms": {n: float((p.detach() - p0[n]).norm())
                             for n, p in leaf_list(params_end)}}


def measure(ctx) -> Record:
    from repro_torch import _ext
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import layouts
    from repro_torch.data.pipeline import CORPUS_CONTAINER, TokenLoader
    from repro_torch.launch import steps
    from repro_torch.launch.train import Trainer
    from repro_torch.models import model as mdl
    from repro_torch.optim import init_opt_state

    cell, mix, seed = ctx.cell, ctx.cell.traffic, ctx.seed
    opt = mix["optimizer"]
    b, s, k = mix["batch"], mix["seq"], mix["checked_steps"]
    rec = Record(cell)
    cfg = cell.port_config()
    run = RunConfig(arch=cfg.name, remat=mix["remat"],
                    learning_rate=opt["lr"], weight_decay=opt["weight_decay"],
                    beta1=opt["beta1"], beta2=opt["beta2"],
                    grad_clip=opt["clip"], warmup_steps=opt["warmup_steps"],
                    total_steps=opt["total_steps"],
                    checkpoint_every=1 << 30)
    trainer = Trainer(cfg, run, ctx.root / "train", device=ctx.device)
    shards = traffic.corpus(seed, cell.model["vocab_size"],
                            mix["corpus_shards"], mix["shard_tokens"])
    for j, toks in enumerate(shards):
        trainer.clovis.put_array(f"corpus/shard{j:04d}", toks,
                                 container=CORPUS_CONTAINER,
                                 layout=layouts.DEFAULT_LAYOUTS["data"])
    params = make_params(mdl.params_like(cfg), seed, ctx.device)
    opt_state = init_opt_state(params)
    loader = TokenLoader(trainer.clovis, batch=b, seq=s, seed=seed)
    batches: List[Dict] = []
    rec.follow = []

    def one_step():
        nonlocal params, opt_state
        batches.append(next(loader))
        params, opt_state, met = trainer.step(params, opt_state,
                                              batches[-1])
        return met["loss"]

    try:
        start = {"params": clone_tree(params), "m": None, "v": None,
                 "step": 0}
        losses = [one_step()]
        m_first = clone_tree(opt_state.m)
        losses += [one_step() for _ in range(k - 1)]
        rec.follow.append(_stretch(start, 0, losses, m_first, params,
                                   opt["beta1"]))
        for _ in range(mix["warmup_steps"]):
            one_step()

        start = _state(params, opt_state)
        first = len(batches)
        losses: List[torch.Tensor] = []   # on the device: no sync a step
        m_first: Optional[Dict] = None
        params_k = None
        probes = Probes(ctx.device) if ctx.trace else None
        dtrace = DeviceTrace(ctx.trace, mix["trace_units"], "train.step")
        with probes or contextlib.nullcontext():
            if probes:
                probes.wrap(mdl, "loss_fn", "train.forward")
                probes.wrap(steps, "adamw_update", "train.optimizer")
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            t0 = time.perf_counter()
            rec.setup_s = t0 - ctx.t_start
            t_end = t0
            before = dict(_ext.LAUNCHES)
            while t_end - t0 < ctx.seconds:
                dtrace.begin()
                with span("train.step"):
                    ts = time.perf_counter()
                    with span("train.loader"):
                        batches.append(next(loader))
                    waited = time.perf_counter() - ts
                    params, opt_state, met = trainer.step(params, opt_state,
                                                          batches[-1])
                    t_end = time.perf_counter()
                if len(losses) < k:       # the stretch the check follows
                    losses.append(met["loss"])
                    if len(losses) == 1:
                        m_first = clone_tree(opt_state.m)
                    if len(losses) == k:
                        params_k = clone_tree(params)
                if dtrace.unit_done():
                    rec.launches = {n: v - before[n]
                                    for n, v in _ext.LAUNCHES.items()}
                rec.units.append({"tokens": b * s, "wall_s": t_end - ts,
                                  "loader_wait_s": waited})
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            t_end = time.perf_counter()
            if dtrace.prof is not None:
                dtrace.end()
                rec.launches = {n: v - before[n]
                                for n, v in _ext.LAUNCHES.items()}
            if probes:
                done = probes.mark()
                fwd = probes.ms("train.forward", {}, done)
                back = probes.gaps_ms("train.forward", "train.optimizer",
                                      {}, done)
                for u, f, g in zip(rec.units, fwd, back):
                    u["forward_ms"], u["backward_ms"] = f, g
        rec.window_s = t_end - t0
        rec.traced = dtrace.traced
        rec.trace = dtrace.read()
        if ctx.device.type == "cuda":
            rec.memory_peak_bytes = torch.cuda.max_memory_allocated(
                ctx.device)
        rec.follow.append(_stretch(
            start, first, losses, m_first,
            params if params_k is None else params_k, opt["beta1"]))
        del m_first, params_k

        start = _state(params, opt_state)
        first = len(batches)
        losses = [one_step()]
        rec.follow.append(_stretch(start, first, losses, opt_state.m,
                                   params, opt["beta1"]))
    finally:
        loader.close()
        trainer.ckpt.close()
    rec.shards = shards
    rec.batches = batches
    del params, opt_state, trainer
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _gaps(got: Dict[str, float], want: Dict[str, float], names
          ) -> List[float]:
    """Each leaf's gap of norms, against the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    scale = float(np.median(list(want.values())))
    return [abs(got[n] - want[n]) / max(want[n], scale) for n in names]


def reference_steps(ctx, rec: Record, stretch: Dict, tf32: bool) -> Dict:
    """The reference's losses, first clipped gradient norms and change
    norms over ``stretch``, from a copy of its start."""
    from sagebench.reference.common import adamw_step
    mix, seed, m = ctx.cell.traffic, ctx.seed, ctx.cell.model
    ref = ctx.cell.reference()
    start = stretch["start"]
    tree = clone_tree(start["params"])
    named = leaf_list(tree)
    flat = [t.requires_grad_(True) for _, t in named]
    begin = [t.detach().clone() for t in flat]

    def moments(tree_or_none):
        if tree_or_none is None:
            return [torch.zeros_like(t) for t in flat]
        by_name = dict(leaf_list(tree_or_none))
        return [by_name[n].clone() for n, _ in named]
    mom, var = moments(start["m"]), moments(start["v"])
    out = {"losses": []}
    for j in range(len(stretch["losses"])):
        rows = expected_batch(rec.shards, seed, stretch["first"] + j,
                              mix["batch"], mix["seq"])
        batch = {n: torch.as_tensor(v, device=ctx.device)
                 for n, v in rows.items()}
        loss = ref.loss(tree, batch, m, tf32)
        grads = torch.autograd.grad(loss, flat)
        clipped = adamw_step(flat, grads, mom, var, start["step"] + j + 1,
                             mix["optimizer"])
        out["losses"].append(float(loss.detach()))
        if j == 0:
            out["grad_norms"] = {n: float(g.norm())
                                 for (n, _), g in zip(named, clipped)}
        del loss, grads, clipped
    out["change_norms"] = {n: float((p.detach() - q).norm())
                           for (n, _), p, q in zip(named, flat, begin)}
    return out


def compare(got: Dict, want: Dict) -> Dict[str, float]:
    """One stretch's readings: the program's (``got``) or the control's
    against the reference's (``want``)."""
    g = want["grad_norms"]
    floor = MOVING * float(np.median(list(g.values())))
    return {
        "loss_gap": max(abs(a - w) / abs(w)
                        for a, w in zip(got["losses"], want["losses"])),
        "grad_gap": max(_gaps(got["grad_norms"], g, g)),
        "change_gap": float(np.median(_gaps(
            got["change_norms"], want["change_norms"],
            [n for n, x in g.items() if x >= floor]))),
    }


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    return {n: max(r[n] for r in readings) for n in readings[0]}


def check(ctx, rec: Record) -> Dict[str, Dict]:
    mix = ctx.cell.traffic
    bad = 0
    for j, got in enumerate(rec.batches):
        want = expected_batch(rec.shards, ctx.seed, j, mix["batch"],
                              mix["seq"])
        bad += any(not np.array_equal(got[n], want[n]) for n in want)
    readings = worst([compare(st, reference_steps(ctx, rec, st, False))
                      for st in rec.follow])
    readings["batch_mismatch"] = float(bad)
    return {n: {"value": v, "limit": ctx.cell.limits[n]}
            for n, v in readings.items()}

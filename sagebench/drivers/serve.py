"""Serving cells: an open loop of requests to ``Server.generate``.

Set-up draws the weights, builds the Server with its token log to Clovis
and serves the mix's shortest and longest prompts once.  The window then
offers requests on the mix's schedule (``traffic.request``: the first at
the window's start, each later one a drawn gap after the one before),
whether or not the earlier ones have finished.  The Server serves one
call at a time and takes a batch of prompts of one length, so the
requests wait in one queue and are served oldest first, one a call.  The
window runs until ``--seconds`` have passed and ends when the request
then being served returns.  A request's time to first token runs from its
arrival to the end of its prefill (the call's end less the Server's
``decode_s``), its wait in the queue included.  Each request keeps its
logits (``keep_logits``), the f32 logits that chose each served token.

The check takes a sample of the window's requests drawn from the seed,
the longest prompt among them, and runs the reference over each prompt
and its served tokens: ``logit_err`` is the largest gap between the
program's and the reference's logits at a served position, as a share of
that position's largest |reference logit|; ``token_gap`` the widest gap
by which a served token's reference logit lies below the reference's
best; ``token_log`` the rows of the Server's token log in Clovis that
differ from the tokens it returned (each call in order).
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List

import numpy as np
import torch

from sagebench import traffic
from sagebench.devtrace import DeviceTrace
from sagebench.harness import Record
from sagebench.probes import Probes, span
from sagebench.weights import make_params


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(ctx) -> Record:
    from repro_torch import _ext
    from repro_torch.launch.serve import Server
    from repro_torch.models import model as mdl

    cell, mix, seed = ctx.cell, ctx.cell.traffic, ctx.seed
    vocab, gen = cell.model["vocab_size"], mix["gen"]
    table = (traffic.lengths(mix), traffic.gaps(mix))
    rec = Record(cell)
    cfg = cell.port_config()
    params = make_params(mdl.params_like(cfg), seed, ctx.device)
    srv = Server(cfg, ctx.root / "serve", device=ctx.device, params=params,
                 max_len=max(table[0]) + gen, log_tokens=True)
    calls: List[np.ndarray] = []           # every call's tokens, in order
    for p in traffic.warmup(mix, vocab, seed):
        calls.append(srv.generate(p, gen)[0])
    probes = Probes(ctx.device) if ctx.trace else None
    dtrace = DeviceTrace(ctx.trace, mix["trace_units"], "serve.request")
    marks = []
    with probes or contextlib.nullcontext():
        if probes:
            probes.wrap(mdl, "prefill", "model.prefill")
            probes.wrap(mdl, "decode_step", "model.decode_step")
        _sync(ctx.device)
        t0 = time.perf_counter()
        rec.setup_s = t0 - ctx.t_start
        before = dict(_ext.LAUNCHES)
        i, arrival, t_end = 0, 0.0, t0
        while t_end - t0 < ctx.seconds:
            length, gap = traffic.request(mix, seed, i, table)
            arrival += gap if i else 0.0
            prompts = traffic.prompts(vocab, seed, i, length)
            wait = t0 + arrival - time.perf_counter()
            if wait > 0:
                with span("serve.idle"):
                    time.sleep(wait)
            dtrace.begin()
            mark = probes.mark() if probes else None
            with span("serve.request"):
                ts = time.perf_counter()
                out, st = srv.generate(prompts, gen, keep_logits=True)
                t_end = time.perf_counter()
            marks.append((mark, probes.mark() if probes else None))
            if dtrace.unit_done():
                rec.launches = {k: v - before[k]
                                for k, v in _ext.LAUNCHES.items()}
            calls.append(out)
            rec.units.append({
                "batch": prompts.shape[0], "prompt_len": length, "gen": gen,
                "wall_s": t_end - ts,
                "ttft_s": t_end - st["decode_s"] - (t0 + arrival),
                "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
                "prompts": prompts, "served": out, "logits": st["logits"]})
            i += 1
        if dtrace.prof is not None:
            dtrace.end()
            rec.launches = {k: v - before[k]
                            for k, v in _ext.LAUNCHES.items()}
        _sync(ctx.device)
    rec.window_s = t_end - t0
    rec.traced = dtrace.traced
    rec.trace = dtrace.read()
    if ctx.device.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(ctx.device)
    srv.close()
    log = np.frombuffer(srv.clovis.get("stream/tokens"), np.int32)
    want = np.concatenate([c.T for c in calls]).reshape(-1)
    if log.size == want.size:
        rec.token_log_rows = int((log != want).sum())
    else:
        rec.token_log_rows = abs(log.size - want.size) + 1
    del srv
    rec.params = params
    rec.sample = sample(rec, seed, mix)
    for j, u in enumerate(rec.units):
        if j not in rec.sample:
            u["logits"] = None
    return rec


def sample(rec: Record, seed: int, mix: Dict) -> List[int]:
    """The requests the check compares: the first with the longest
    prompt, and others drawn from the seed, ``checked_tokens`` served
    tokens in all."""
    n = math.ceil(mix["checked_tokens"] / mix["gen"])
    lens = [u["prompt_len"] for u in rec.units]
    longest = lens.index(max(lens))
    others = [j for j in range(len(lens)) if j != longest]
    rng = np.random.default_rng([seed, 3])
    pick = rng.choice(others, size=min(n - 1, len(others)), replace=False)
    return [longest] + sorted(int(j) for j in pick)


def reference_readings(ref, params, m: Dict, prompts: np.ndarray,
                       served: np.ndarray, device: torch.device,
                       tf32: bool):
    """The reference's logits (b, gen, vocab) at the served positions."""
    p = torch.as_tensor(prompts, device=device)
    s = torch.as_tensor(served, device=device)
    h = ref.serve_hidden(params, p, s, m, tf32)
    return ref.head(params, h[:, p.shape[1] - 1:], m, tf32)


def compare(got: torch.Tensor, want: torch.Tensor, served: torch.Tensor
            ) -> Dict[str, float]:
    """got, want (b, gen, vocab); served (b, gen)."""
    err = (got - want).abs().amax(-1) / want.abs().amax(-1)
    chosen = want.gather(-1, served[..., None].long())[..., 0]
    return {"logit_err": float(err.max()),
            "token_gap": float((want.amax(-1) - chosen).max())}


@torch.no_grad()
def check(ctx, rec: Record) -> Dict[str, Dict]:
    cell = ctx.cell
    ref, m = cell.reference(), cell.model
    worst = {"logit_err": 0.0, "token_gap": 0.0}
    for j in rec.sample:
        u = rec.units[j]
        want = reference_readings(ref, rec.params, m, u["prompts"],
                                  u["served"], ctx.device, False)
        got = torch.stack(u["logits"][:u["gen"]], dim=1)
        served = torch.as_tensor(u["served"], device=ctx.device)
        for k, v in compare(got, want, served).items():
            worst[k] = max(worst[k], v)
    worst["token_log"] = float(rec.token_log_rows)
    return {k: {"value": v, "limit": cell.limits[k]}
            for k, v in worst.items()}

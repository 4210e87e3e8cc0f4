"""Plain reference of Mamba-2 (arXiv:2405.21060): the model of
``configs/mamba2-130m.json``, written from the paper in float32.

A block is x + mixer(rms_norm(x)); the mixer projects to (z, xBC, dt),
runs a causal depthwise convolution and SiLU over xBC, the SSD scan
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t + D x_t, gates y
by SiLU(z) under an RMS norm, and projects back.  The head is the tied
embedding.  The scan is the paper's chunked form: decays inside a chunk
from float64 cumulative sums, chunk states carried from one chunk to the
next, so any length and chunk give the same function.

Weights are read from the benchmark's parameter tree by name: ``embed``,
``ln_f/scale``, and per block ``ln1/scale`` and ``mixer/{in_proj, conv_w,
conv_b, a_log, dt_bias, d_skip, norm, out_proj}``.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sagebench.reference.common import (cross_entropy, einsum, mm,
                                        rms_norm)


def blocks(params: Dict) -> List[Dict]:
    dec = params["decoder"]
    return [b for part in ("prefix", "unrolled", "extra")
            for b in dec.get(part, [])]


def ssd(x, dt, A, B, C, chunk: int, tf32: bool):
    """x (b, s, h, p), dt (b, s, h), A (h,) negative, B and C (b, s, g, n)
    -> y (b, s, h, p)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = -s % chunk
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    c = x.shape[1] // chunk
    head_group = torch.arange(h, device=x.device) // (h // g)
    xc = x.reshape(b, c, chunk, h, p)
    dtc = dt.reshape(b, c, chunk, h)
    Bh = B.reshape(b, c, chunk, g, n)[:, :, :, head_group]
    Ch = C.reshape(b, c, chunk, g, n)[:, :, :, head_group]
    cs = torch.cumsum((dtc * A).double(), dim=2)           # (b, c, l, h)
    seg = cs[:, :, :, None] - cs[:, :, None]                # (b, c, l, s, h)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    decay = torch.exp(seg.masked_fill(~causal, float("-inf"))).float()
    del seg
    scores = einsum("bclhn,bcshn->bclsh", Ch, Bh, tf32=tf32)
    w = scores * decay * dtc[:, :, None]
    y = einsum("bclsh,bcshp->bclhp", w, xc, tf32=tf32)
    del w, scores, decay
    to_end = torch.exp(cs[:, :, -1:] - cs).float() * dtc   # (b, c, l, h)
    states = einsum("bclhn,bclhp->bchpn", Bh * to_end[..., None], xc,
                    tf32=tf32)
    chunk_decay = torch.exp(cs[:, :, -1]).float()           # (b, c, h)
    carry = torch.zeros_like(states[:, 0])
    entering = []
    for i in range(c):
        entering.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev = torch.stack(entering, dim=1)                     # (b, c, h, p, n)
    y = y + einsum("bclhn,bchpn->bclhp", Ch, prev, tf32=tf32) \
        * torch.exp(cs).float()[..., None]
    return y.reshape(b, c * chunk, h, p)[:, :s]


def mixer(p: Dict, x: torch.Tensor, m: Dict, tf32: bool) -> torch.Tensor:
    b, s, _ = x.shape
    di = m["ssm_expand"] * m["d_model"]
    heads = di // m["ssm_headdim"]
    g, n = m["ssm_ngroups"], m["ssm_state"]
    zxbcdt = mm(x, p["in_proj"], tf32)
    z, xbc, dt = zxbcdt.split([di, di + 2 * g * n, heads], dim=-1)
    k = p["conv_w"].shape[0]
    xpad = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(xpad[:, i:i + s] * p["conv_w"][i] for i in range(k))
    xbc = F.silu(conv + p["conv_b"])
    xs = xbc[..., :di].reshape(b, s, heads, m["ssm_headdim"])
    B = xbc[..., di:di + g * n].reshape(b, s, g, n)
    C = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt + p["dt_bias"])
    y = ssd(xs, dt, -torch.exp(p["a_log"]), B, C, m["ssm_chunk"], tf32)
    y = (y + xs * p["d_skip"][:, None]).reshape(b, s, di)
    y = rms_norm(y * F.silu(z), p["norm"], m["norm_eps"])
    return mm(y, p["out_proj"], tf32)


def hidden(params: Dict, tokens: torch.Tensor, m: Dict, tf32: bool, *,
           recompute: bool = False) -> torch.Tensor:
    """Final normed hidden states (b, s, d) of ``tokens`` (b, s).
    ``recompute`` keeps only each block's input for the backward."""
    x = params["embed"][tokens.long()]
    for blk in blocks(params):
        def block(x, blk=blk):
            return x + mixer(blk["mixer"],
                             rms_norm(x, blk["ln1"]["scale"], m["norm_eps"]),
                             m, tf32)
        x = checkpoint(block, x, use_reentrant=False) if recompute \
            else block(x)
    return rms_norm(x, params["ln_f"]["scale"], m["norm_eps"])


def head(params: Dict, h: torch.Tensor, m: Dict, tf32: bool
         ) -> torch.Tensor:
    w = params["embed"].t() if m["tie_embeddings"] else params["lm_head"]
    return mm(h, w, tf32)


def loss(params: Dict, batch: Dict, m: Dict, tf32: bool) -> torch.Tensor:
    """The training loss: mean cross entropy of the next token."""
    h = hidden(params, batch["tokens"], m, tf32, recompute=True)
    return cross_entropy(head(params, h, m, tf32), batch["labels"])


@torch.no_grad()
def serve_hidden(params: Dict, prompts: torch.Tensor, served: torch.Tensor,
                 m: Dict, tf32: bool) -> torch.Tensor:
    """Final normed hidden states (b, L + gen - 1, d) of the prompts (b,
    L) followed by the served tokens (b, gen) but the last, one forward
    pass a row: position L - 1 + i chose served token i."""
    seq = torch.cat([prompts, served[:, :-1]], dim=1)
    return torch.cat([hidden(params, row[None], m, tf32) for row in seq])


def layer_flops_per_token(m: Dict) -> int:
    """A block's operations on one token: the two projections, the
    convolution and the scan's recurrence (``counts.ssd_flops``)."""
    d, di = m["d_model"], m["ssm_expand"] * m["d_model"]
    heads = di // m["ssm_headdim"]
    gn = m["ssm_ngroups"] * m["ssm_state"]
    proj = 2 * d * (2 * di + 2 * gn + heads) + 2 * di * d
    conv = 2 * m["ssm_conv"] * (di + 2 * gn)
    scan = heads * (2 * m["ssm_state"] + 2 * m["ssm_headdim"]
                    + 4 * m["ssm_state"] * m["ssm_headdim"])
    return proj + conv + scan


def model_flops(m: Dict, rows: int, prompt_len: int, gen: int = 0,
                train: bool = False) -> int:
    """The model's operations: a training step over rows x prompt_len
    tokens (forward and backward: 3 x the forward, a logit per token), or
    a request's prefill of rows x prompt_len and ``gen`` decode steps (a
    logit row from the prefill and from each step)."""
    head = 2 * m["d_model"] * m["vocab_size"]
    body = m["n_layers"] * layer_flops_per_token(m)
    if train:
        return 3 * rows * prompt_len * (body + head)
    return rows * ((prompt_len + gen) * body + (1 + gen) * head)

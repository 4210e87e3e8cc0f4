"""Plain reference of Qwen1.5-MoE (Qwen2-MoE): the model of
``configs/qwen2-moe-a2.7b.json``, written from its published
configuration in float32.

A block is x + attention(rms_norm(x)), then x + moe(rms_norm(x)).
Attention is causal multi-head attention with a bias on q, k and v and
rotary embeddings (the two halves of each head rotated together); keys
and values are shared by groups of query heads where ``n_kv_heads`` is
smaller.  The MoE block adds a shared expert, its output scaled by a
sigmoid gate, to the routed experts' weighted outputs; every expert is a
SiLU-gated MLP.  The head is an untied projection.

Routing is the program's, and departs from the published model in three
ways:

* Capacity.  Each expert keeps at most C = round(gs k 1.25 / E) tokens
  of a group of gs tokens (Python's round, at least 1 and at most gs),
  those with the highest gate, equal gates to the lower position; the
  others lose that expert's output.  The published model drops nothing.
* Groups.  The prompt's positions form one group, as the program's
  prefill routes them; each served position is a group of its own, as
  its decode step routes a batch of one, so no served position is
  dropped.
* Ties.  The top k experts of a token are those with the highest gate,
  equal gates to the lower expert index.

The gates are the softmax of the router's logits; the selected ones are
renormalised to sum to one only where ``norm_topk_prob`` is true
(Qwen1.5-MoE publishes false).

Everything is computed in blocks that fit beside the weights on one
card: attention a block of queries at a time, the experts one at a time
on the tokens they keep.

Weights are read from the benchmark's parameter tree by name: ``embed``,
``lm_head``, ``ln_f/scale``, and per block ``ln1/scale``, ``ln2/scale``,
``mixer/{wq, wk, wv, wo, bq, bk, bv}`` and ``moe/{router, w_gate, w_up,
w_down, ws_gate, ws_up, ws_down, shared_gate}``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from sagebench.reference.common import einsum, mm, rms_norm, rope

Q_BLOCK = 1024          # queries a block of attention
CAPACITY_FACTOR = 1.25


def blocks(params: Dict) -> List[Dict]:
    dec = params["decoder"]
    return [b for part in ("prefix", "unrolled", "extra")
            for b in dec.get(part, [])]


def attention(p: Dict, x: torch.Tensor, m: Dict, tf32: bool
              ) -> torch.Tensor:
    """Causal self attention over one row.  x: (s, d) -> (s, d)."""
    s, d = x.shape
    h, kvh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = mm(x, p["wq"].reshape(d, h * hd), tf32).reshape(s, h, hd) + p["bq"]
    k = mm(x, p["wk"].reshape(d, kvh * hd), tf32).reshape(s, kvh, hd) \
        + p["bk"]
    v = mm(x, p["wv"].reshape(d, kvh * hd), tf32).reshape(s, kvh, hd) \
        + p["bv"]
    pos = torch.arange(s, device=x.device)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    k = k.repeat_interleave(h // kvh, dim=1)
    v = v.repeat_interleave(h // kvh, dim=1)
    out = torch.empty_like(q)
    for a in range(0, s, Q_BLOCK):
        e = min(s, a + Q_BLOCK)
        sc = einsum("qhd,khd->hqk", q[a:e], k[:e], tf32=tf32) / math.sqrt(hd)
        sc = sc.masked_fill(pos[None, a:e, None] < pos[None, None, :e],
                            float("-inf"))
        out[a:e] = einsum("hqk,khd->qhd", torch.softmax(sc, dim=-1), v[:e],
                          tf32=tf32)
    return mm(out.reshape(s, h * hd), p["wo"].reshape(h * hd, d), tf32)


def expert(w_gate, w_up, w_down, x: torch.Tensor, tf32: bool
           ) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate, tf32)) * mm(x, w_up, tf32), w_down, tf32)


def kept_mask(gates: torch.Tensor, chosen: torch.Tensor,
              groups: List[Tuple[int, int]], k: int) -> torch.Tensor:
    """(s, E) bool: the token keeps the expert it chose.  In each group
    [a, b) an expert keeps its C highest gates, equal gates to the lower
    position."""
    e = gates.shape[1]
    kept = chosen.clone()
    for a, b in groups:
        gs = b - a
        cap = min(max(1, round(gs * k * CAPACITY_FACTOR / e)), gs)
        if chosen[a:b].sum(0).max() <= cap:
            continue
        prio = torch.where(chosen[a:b], gates[a:b], float("-inf")).t()
        order = torch.sort(prio, dim=1, descending=True, stable=True).indices
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(gs, device=gates.device)
                      .expand(e, gs))
        kept[a:b] &= (rank < cap).t()
    return kept


def moe(p: Dict, x: torch.Tensor, m: Dict, groups: List[Tuple[int, int]],
        tf32: bool) -> torch.Tensor:
    """The MoE block over one row.  x: (s, d) -> (s, d)."""
    k = m["top_k"]
    gates = torch.softmax(mm(x, p["router"], tf32), dim=-1)       # (s, E)
    top = torch.sort(gates, dim=-1, descending=True,
                     stable=True).indices[:, :k]
    chosen = torch.zeros_like(gates, dtype=torch.bool).scatter_(1, top, True)
    weight = torch.where(chosen, gates, 0.0)
    if m.get("norm_topk_prob", True):
        weight = weight / weight.sum(-1, keepdim=True)
    kept = kept_mask(gates, chosen, groups, k)
    out = torch.zeros_like(x)
    for j in range(gates.shape[1]):
        idx = kept[:, j].nonzero()[:, 0]
        if idx.numel():
            y = expert(p["w_gate"][j], p["w_up"][j], p["w_down"][j], x[idx],
                       tf32)
            out.index_add_(0, idx, y * weight[idx, j, None])
    shared = expert(p["ws_gate"], p["ws_up"], p["ws_down"], x, tf32)
    return out + shared * torch.sigmoid(mm(x, p["shared_gate"], tf32))


def hidden(params: Dict, tokens: torch.Tensor, m: Dict,
           groups: List[Tuple[int, int]], tf32: bool) -> torch.Tensor:
    """Final normed hidden states (s, d) of one row of ``tokens`` (s,)."""
    x = params["embed"][tokens.long()]
    eps = m["norm_eps"]
    for blk in blocks(params):
        x = x + attention(blk["mixer"], rms_norm(x, blk["ln1"]["scale"], eps),
                          m, tf32)
        x = x + moe(blk["moe"], rms_norm(x, blk["ln2"]["scale"], eps), m,
                    groups, tf32)
    return rms_norm(x, params["ln_f"]["scale"], eps)


def head(params: Dict, h: torch.Tensor, m: Dict, tf32: bool
         ) -> torch.Tensor:
    w = params["embed"].t() if m.get("tie_embeddings") else params["lm_head"]
    return mm(h, w, tf32)


@torch.no_grad()
def serve_hidden(params: Dict, prompts: torch.Tensor, served: torch.Tensor,
                 m: Dict, tf32: bool) -> torch.Tensor:
    """Final normed hidden states (b, L + gen - 1, d) of the prompts (b,
    L) followed by the served tokens (b, gen) but the last, one forward
    pass a row: position L - 1 + i chose served token i.  The prompt is
    one capacity group, each served position one of its own."""
    L = prompts.shape[1]
    seq = torch.cat([prompts, served[:, :-1]], dim=1)
    groups = [(0, L)] + [(i, i + 1) for i in range(L, seq.shape[1])]
    return torch.stack([hidden(params, row, m, groups, tf32) for row in seq])


def layer_flops_per_token(m: Dict) -> int:
    """A block's operations on one token, attention's scores aside: the
    q/k/v/o projections, the router, the k routed experts and the
    shared expert with its gate."""
    d, hd = m["d_model"], m["head_dim"]
    q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    proj = 2 * d * (2 * q + 2 * kv)
    router = 2 * d * m["n_experts"]
    routed = m["top_k"] * 2 * 3 * d * m["d_expert"]
    shared = 2 * 3 * d * m["d_shared_expert"] + 2 * d
    return proj + router + routed + shared


def attention_flops(m: Dict, first: int, last: int) -> int:
    """Scores and weighted values of the queries at positions first ..
    last - 1, each over the keys up to its own: 4 h hd a key."""
    keys = (last * (last + 1) - first * (first + 1)) // 2
    return m["n_layers"] * 4 * m["n_heads"] * m["head_dim"] * keys


def model_flops(m: Dict, rows: int, prompt_len: int, gen: int = 0,
                train: bool = False) -> int:
    """The model's operations on a request: rows x prompt_len prompt
    tokens and ``gen`` decode steps (a logit row from the prefill and
    from each step), or a training step over rows x prompt_len tokens
    (3 x the forward)."""
    head_ = 2 * m["d_model"] * m["vocab_size"]
    body = m["n_layers"] * layer_flops_per_token(m)
    if train:
        return 3 * rows * (prompt_len * (body + head_)
                           + attention_flops(m, 0, prompt_len))
    return rows * ((prompt_len + gen) * body + (1 + gen) * head_
                   + attention_flops(m, 0, prompt_len + gen))

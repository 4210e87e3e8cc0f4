"""Plain reference of DeepSeek-V3: the model of
``configs/deepseek-v3-ep32.json``, written from its published
configuration and DeepSeek's inference code (``inference/model.py``) in
float32.

A block is x + mla(rms_norm(x)), then x + ffn(rms_norm(x)); the first
``n_dense_layers`` blocks take a dense SiLU-gated MLP, the others the MoE.
The head is an untied projection after a final RMSNorm.

**Multi-head latent attention** (arXiv:2412.19437 section 2.1.1), in its
expanded form: q = W_qb rms_norm(W_qa x) per head, split into a part
without position (``qk_nope_head_dim``) and a rotary part
(``qk_rope_head_dim``); the KV latent c = rms_norm(the first
``kv_lora_rank`` of W_kva x) and one rotary key shared by every head (the
rest of W_kva x); per head k = [W_kb c, the shared rotary key] and
v = W_vb c.  Causal softmax attention with the scale 1/sqrt(nope + rope)
times YaRN's mscale squared, then the output projection.

**YaRN** (arXiv:2309.00071; DeepSeek's ``precompute_freqs_cis``): the
rotary frequencies base^(-2i/d) of the rope dims are divided by
``yarn_factor`` below the correction range (the dims that turn fewer
than ``yarn_beta_slow`` times over ``yarn_original_max_position``
positions), kept above it (more than ``yarn_beta_fast`` turns) and
blended linearly within it; mscale = 0.1 mscale_all_dim ln(factor) + 1.

**The MoE** (``Gate`` and ``MoE``): sigmoid scores of the router's E
experts; the scores plus the balancing bias choose, limited to the
``topk_group`` best of ``n_group`` groups of consecutive experts, each
group scored by the sum of its two highest biased scores; the top
``top_k`` of what remains are the token's experts; their gates are the
unbiased scores renormalised to sum to one and scaled by
``routed_scaling_factor``.  Every expert, and the shared expert added to
every token, is a SiLU-gated MLP.

Departures from the published model, the program's as well:

* The expert share (EP32).  The router scores all ``router_experts``
  experts; only the ``n_experts`` from ``first_expert`` on are held, and
  the block returns their part of the routed sum plus the shared expert:
  the absent experts' part is left out.
* Capacity.  Each held expert keeps at most C = round(gs k cf / E) tokens
  of a group of gs tokens (E the router's experts; Python's round, at
  least 1 and at most gs), those with the highest biased score, equal
  scores to the lower position; the others lose that expert's output.
  The prompt's positions form one group and each served position one of
  its own (a decode step routes a batch of one).  The published model
  drops nothing.
* Ties.  Equal scores go to the lower expert or group index.
* Rotary pairs.  The rope dims rotate as two halves (i with i + d/2)
  where DeepSeek's code rotates interleaved pairs: with random weights a
  fixed permutation of the rope columns of W_qb and W_kva.
* Precision.  float32 throughout; the published checkpoint is FP8.

Everything is computed in blocks that fit beside the weights on one
card: attention a block of queries at a time, the experts one at a time
on the tokens they keep.

Weights are read from the benchmark's parameter tree by name: ``embed``,
``lm_head``, ``ln_f/scale``, and per block ``ln1/scale``, ``ln2/scale``,
``mixer/{wq_a, q_norm, wq_b, wkv_a, kv_norm, wkv_b, wo}`` and either
``mlp/{wi_gate, wi_up, wo}`` or ``moe/{router, router_bias, w_gate,
w_up, w_down, ws_gate, ws_up, ws_down}``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from sagebench.reference.common import einsum, mm, rms_norm

Q_BLOCK = 256           # queries a block of attention (128 heads wide)


def blocks(params: Dict) -> List[Dict]:
    dec = params["decoder"]
    return [b for part in ("prefix", "unrolled", "extra")
            for b in dec.get(part, [])]


# ---------------------------------------------------------------------------
# YaRN rotary embedding and the softmax scale
# ---------------------------------------------------------------------------

def inv_freq(m: Dict, dim: int, device) -> torch.Tensor:
    """The rotary dims' inverse frequencies, YaRN's where it is on."""
    theta = m["rope_theta"]
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim)
    factor = m.get("yarn_factor", 0.0)
    if not factor:
        return inv
    orig = m["yarn_original_max_position"]

    def turns_dim(turns: float) -> float:
        return dim * math.log(orig / (turns * 2 * math.pi)) / (
            2 * math.log(theta))
    low = max(math.floor(turns_dim(m["yarn_beta_fast"])), 0)
    high = min(math.ceil(turns_dim(m["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    smooth = 1 - ramp
    return inv / factor * (1 - smooth) + inv * smooth


def rope(x: torch.Tensor, pos: torch.Tensor, inv: torch.Tensor
         ) -> torch.Tensor:
    """x (s, heads, d) rotated as two halves at positions pos (s,)."""
    ang = pos.float()[:, None] * inv                       # (s, d/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_scale(m: Dict) -> float:
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    factor = m.get("yarn_factor", 0.0)
    if factor > 1 and m.get("yarn_mscale_all_dim", 0.0):
        ms = 0.1 * m["yarn_mscale_all_dim"] * math.log(factor) + 1.0
        scale *= ms * ms
    return scale


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def attention(p: Dict, x: torch.Tensor, m: Dict, tf32: bool
              ) -> torch.Tensor:
    """Causal MLA over one row.  x: (s, d) -> (s, d)."""
    s, d = x.shape
    h, eps = m["n_heads"], m["norm_eps"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"]
    qr, kr = m["q_lora_rank"], m["kv_lora_rank"]
    pos = torch.arange(s, device=x.device)
    inv = inv_freq(m, dr, x.device)
    q = rms_norm(mm(x, p["wq_a"], tf32), p["q_norm"], eps)
    q = mm(q, p["wq_b"].reshape(qr, h * (dn + dr)), tf32).reshape(
        s, h, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], pos, inv)], dim=-1)
    kv = mm(x, p["wkv_a"], tf32)
    c = rms_norm(kv[:, :kr], p["kv_norm"], eps)
    k_pe = rope(kv[:, None, kr:], pos, inv)                # (s, 1, dr)
    kv = mm(c, p["wkv_b"].reshape(kr, h * (dn + dv)), tf32).reshape(
        s, h, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe.expand(s, h, dr)], dim=-1)
    v = kv[..., dn:]
    scale = softmax_scale(m)
    out = torch.empty((s, h, dv), device=x.device)
    for a in range(0, s, Q_BLOCK):
        e = min(s, a + Q_BLOCK)
        sc = einsum("qhd,khd->hqk", q[a:e], k[:e], tf32=tf32) * scale
        sc = sc.masked_fill(pos[None, a:e, None] < pos[None, None, :e],
                            float("-inf"))
        out[a:e] = einsum("hqk,khd->qhd", torch.softmax(sc, dim=-1), v[:e],
                          tf32=tf32)
    return mm(out.reshape(s, h * dv), p["wo"].reshape(h * dv, d), tf32)


# ---------------------------------------------------------------------------
# The feed-forwards
# ---------------------------------------------------------------------------

def expert(w_gate, w_up, w_down, x: torch.Tensor, tf32: bool
           ) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate, tf32)) * mm(x, w_up, tf32), w_down, tf32)


def gate(p: Dict, x: torch.Tensor, m: Dict, tf32: bool
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DeepSeek's ``Gate`` over the router's E experts: x (s, d) -> (the
    chosen experts (s, k), their gates (s, k), the biased scores (s, E))."""
    scores = torch.sigmoid(mm(x, p["router"], tf32))
    biased = scores + p["router_bias"]
    s, e = biased.shape
    pick = biased
    g = m.get("n_group", 1)
    if g > 1:
        grouped = biased.reshape(s, g, e // g)
        top2 = torch.sort(grouped, dim=-1, descending=True).values[..., :2]
        best = torch.sort(top2.sum(-1), dim=-1, descending=True,
                          stable=True).indices[:, :m["topk_group"]]
        keep = torch.zeros((s, g), dtype=torch.bool, device=x.device)
        keep.scatter_(1, best, True)
        pick = grouped.masked_fill(~keep[..., None], float("-inf")) \
            .reshape(s, e)
    chosen = torch.sort(pick, dim=-1, descending=True,
                        stable=True).indices[:, :m["top_k"]]
    w = scores.gather(1, chosen)
    w = w / w.sum(-1, keepdim=True) * m.get("routed_scaling_factor", 1.0)
    return chosen, w, biased


def kept_mask(prio: torch.Tensor, chosen: torch.Tensor,
              groups: List[Tuple[int, int]], k: int, e: int,
              cf: float) -> torch.Tensor:
    """(s, n) bool over the held experts: the token keeps the expert it
    chose.  In each group [a, b) an expert keeps its C highest
    priorities, equal ones to the lower position; C counts the router's
    e experts."""
    n = chosen.shape[1]
    kept = chosen.clone()
    for a, b in groups:
        gs = b - a
        cap = min(max(1, round(gs * k * cf / e)), gs)
        if chosen[a:b].sum(0).max() <= cap:
            continue
        pr = torch.where(chosen[a:b], prio[a:b], float("-inf")).t()
        order = torch.sort(pr, dim=1, descending=True, stable=True).indices
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(gs, device=prio.device)
                      .expand(n, gs))
        kept[a:b] &= (rank < cap).t()
    return kept


def moe(p: Dict, x: torch.Tensor, m: Dict, groups: List[Tuple[int, int]],
        tf32: bool) -> torch.Tensor:
    """The held experts' part of the MoE block over one row, plus the
    shared expert.  x: (s, d) -> (s, d)."""
    s = x.shape[0]
    e = m.get("router_experts") or m["n_experts"]
    first, n = m.get("first_expert", 0), m["n_experts"]
    chosen, w, biased = gate(p, x, m, tf32)
    weight = torch.zeros((s, e), device=x.device).scatter_(1, chosen, w)
    mask = torch.zeros((s, e), dtype=torch.bool,
                       device=x.device).scatter_(1, chosen, True)
    held = slice(first, first + n)
    kept = kept_mask(biased[:, held], mask[:, held], groups, m["top_k"], e,
                     m["moe_capacity_factor"])
    out = torch.zeros_like(x)
    for j in range(n):
        idx = kept[:, j].nonzero()[:, 0]
        if idx.numel():
            y = expert(p["w_gate"][j], p["w_up"][j], p["w_down"][j], x[idx],
                       tf32)
            out.index_add_(0, idx, y * weight[idx, first + j, None])
    return out + expert(p["ws_gate"], p["ws_up"], p["ws_down"], x, tf32)


def mlp(p: Dict, x: torch.Tensor, tf32: bool) -> torch.Tensor:
    return expert(p["wi_gate"], p["wi_up"], p["wo"], x, tf32)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def hidden(params: Dict, tokens: torch.Tensor, m: Dict,
           groups: List[Tuple[int, int]], tf32: bool) -> torch.Tensor:
    """Final normed hidden states (s, d) of one row of ``tokens`` (s,)."""
    x = params["embed"][tokens.long()]
    eps = m["norm_eps"]
    for blk in blocks(params):
        x = x + attention(blk["mixer"], rms_norm(x, blk["ln1"]["scale"], eps),
                          m, tf32)
        h = rms_norm(x, blk["ln2"]["scale"], eps)
        x = x + (moe(blk["moe"], h, m, groups, tf32) if "moe" in blk
                 else mlp(blk["mlp"], h, tf32))
    return rms_norm(x, params["ln_f"]["scale"], eps)


def head(params: Dict, h: torch.Tensor, m: Dict, tf32: bool
         ) -> torch.Tensor:
    return mm(h, params["lm_head"], tf32)


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


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------

def mla_flops_per_token(m: Dict) -> int:
    """MLA's projections on one token: W_qa, W_qb, W_kva, W_kvb, W_o."""
    d, h = m["d_model"], m["n_heads"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"]
    qr, kr = m["q_lora_rank"], m["kv_lora_rank"]
    return 2 * (d * qr + qr * h * (dn + dr) + d * (kr + dr)
                + kr * h * (dn + dv) + h * dv * d)


def moe_flops_per_token(m: Dict) -> int:
    """The router, the held experts' expected share of a token's k
    routed experts (k x held / E of them), and the shared expert."""
    d, f = m["d_model"], m["d_expert"]
    e = m.get("router_experts") or m["n_experts"]
    routed = m["top_k"] * m["n_experts"] * 6 * d * f // e
    return 2 * d * e + routed + 6 * d * m["d_shared_expert"]


def layer_flops_per_token(m: Dict) -> int:
    """The stack's operations on one token, attention's scores aside,
    summed over its layers."""
    dense = m["n_dense_layers"]
    return (m["n_layers"] * mla_flops_per_token(m)
            + dense * 6 * m["d_model"] * m["dense_d_ff"]
            + (m["n_layers"] - dense) * moe_flops_per_token(m))


def attention_flops(m: Dict, first: int, last: int) -> int:
    """Scores and weighted values of the queries at positions first ..
    last - 1, each over the keys up to its own: 2 h (qk + v) a key."""
    keys = (last * (last + 1) - first * (first + 1)) // 2
    per_key = 2 * m["n_heads"] * (m["qk_nope_head_dim"]
                                  + m["qk_rope_head_dim"] + m["v_head_dim"])
    return m["n_layers"] * per_key * keys


def model_flops(m: Dict, rows: int, prompt_len: int, gen: int = 0,
                train: bool = False) -> int:
    """The model's operations on a request: rows x prompt_len prompt
    tokens and ``gen`` decode steps (a logit row from the prefill and
    from each step), or a training step over rows x prompt_len tokens
    (3 x the forward)."""
    head_ = 2 * m["d_model"] * m["vocab_size"]
    body = layer_flops_per_token(m)
    if train:
        return 3 * rows * (prompt_len * (body + head_)
                           + attention_flops(m, 0, prompt_len))
    return rows * ((prompt_len + gen) * body + (1 + gen) * head_
                   + attention_flops(m, 0, prompt_len + gen))

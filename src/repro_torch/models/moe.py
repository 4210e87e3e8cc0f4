"""Mixture-of-Experts block (the port of ``repro.models.moe``):
capacity-gather dispatch, softmax and sigmoid routers, the dense oracle
and the aux-loss-free bias update.

Dispatch is gather-based, as in the reference: per expert the top-C
tokens by router priority are gathered, run through grouped expert
products (``torch.bmm`` over the expert axis) and combined back.  Tokens
over capacity are dropped; capacity_factor = E/k makes the dispatch
lossless, and then ``moe_block`` equals ``moe_block_dense``.  Tokens are
grouped per batch row when the sequence is longer than one token, and a
single-token decode step routes the whole batch as one group.

Two choices differ from the reference's arithmetic and keep the card's
results the same from run to run:

* Top-k selection (of experts per token, of tokens per expert) is a
  stable descending sort, so equal scores go to the lower index first,
  as ``jax.lax.top_k`` orders them; ``torch.topk`` promises no order
  among ties on CUDA.
* The combine gathers each token's (at most k) kept expert outputs and
  adds them in ascending expert order, one add at a time, where the
  reference scatter-adds.  An atomic scatter-add on the card would add
  in the order its atomics land and change the bits from run to run.

Routers: softmax (qwen2-moe, with the load-balance aux loss) and sigmoid
with the aux-loss-free bias (deepseek-v3: the bias changes only which
experts are selected; the gates are the raw sigmoid scores).  The
selected gates are renormalised to sum to one unless the configuration
sets ``norm_topk_prob`` false (Qwen1.5-MoE publishes false; the
reference always renormalises).

Each ``moe_block`` call is a ``moe.block`` span of ``repro_torch.trace``
and its expert products a ``moe.experts`` span, both timed by CUDA
events on the card while tracing is on (not inside a CUDA graph's
capture); it counts ``moe.assignments_routed`` (tokens x k) and
``moe.assignments_dropped`` (those over an expert's capacity) with
``trace.count_device``, on the device, so a graphed decode step counts
too and nothing waits for the count.

On a mesh (activation rules on, ``models.common.axis_rules``) the
dispatch tensors shard E over the expert axis (expert parallelism) and
their rows over the batch axes the expert axis leaves free, as the
reference's ``_shard_dispatch`` does.  Three steps have no ``DTensor``
sharding rule and run on whole replicated copies
(``common.on_replicas``), each rank computing the same result: the
routing (``_route``: the stable sorts of ``topk_indices``, the mask's
``scatter_``, the slot ``gather``s), the slot gather of ``_dispatch``
and the per-token gather of ``_combine``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import activation, dense_init, on_replicas


def init_moe(gen, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> Dict:
    """Router (always f32), experts (E, d, f) / (E, f, d) with fan-in on
    axis 1, the aux-free bias and the shared experts with their gate."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": dense_init(gen, (d, e), device=device),
        "w_gate": dense_init(gen, (e, d, f), in_axis=1, **kw),
        "w_up": dense_init(gen, (e, d, f), in_axis=1, **kw),
        "w_down": dense_init(gen, (e, f, d), in_axis=1, **kw),
    }
    if cfg.router_aux_free_bias:
        p["router_bias"] = torch.zeros((e,), dtype=torch.float32,
                                       device=device)
    if cfg.n_shared_experts:
        fs = cfg.d_shared_expert
        p["ws_gate"] = dense_init(gen, (d, fs), **kw)
        p["ws_up"] = dense_init(gen, (d, fs), **kw)
        p["ws_down"] = dense_init(gen, (fs, d), **kw)
        if cfg.shared_expert_gate:
            p["shared_gate"] = dense_init(gen, (d, 1), **kw)
    return p


def router_scores(p: Dict, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (gates (..., E) f32, selection scores (..., E), logits)."""
    logits = torch.matmul(x.float(), p["router"])
    if cfg.router_type == "sigmoid":
        gates = torch.sigmoid(logits)
        sel = gates + p["router_bias"] if "router_bias" in p else gates
    else:
        gates = torch.softmax(logits, dim=-1)
        sel = gates
    return gates, sel, logits


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, largest first and
    equal values lower index first (``jax.lax.top_k``'s order)."""
    return torch.sort(x.detach(), dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _mask_of(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    mask = torch.zeros(like.shape, dtype=torch.bool, device=like.device)
    return mask.scatter_(-1, idx, True)


def _topk_mask(sel: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the per-token top-k experts.  sel: (..., E)."""
    return _mask_of(topk_indices(sel, k), sel)


def load_balance_loss(gates: torch.Tensor, topk_mask: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e / k (f32 scalar)."""
    e = gates.shape[-1]
    axes = tuple(range(topk_mask.dim() - 1))
    f = topk_mask.float().mean(dim=axes)
    pr = gates.mean(dim=axes)
    return e * (f * pr).sum() / k


def _normalized_gates(gates: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
    gsel = torch.where(mask, gates, 0.0)
    return gsel / gsel.sum(-1, keepdim=True).clamp_min(1e-9)


def _selected_gates(gates: torch.Tensor, mask: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """The gates of the selected experts (0 elsewhere), renormalised to
    sum to one where ``cfg.norm_topk_prob``."""
    if cfg.norm_topk_prob:
        return _normalized_gates(gates, mask)
    return torch.where(mask, gates, 0.0)


def _shard_dispatch(t: torch.Tensor) -> torch.Tensor:
    """Constrain the (E, G*C, d) dispatch tensors: E -> the expert axis,
    the G-major rows -> the batch axes the expert axis leaves free (the
    reference's (G, E, C, d) constraint in the port's layout).  The
    identity with the rules off."""
    r = common.current_rules()
    if not r.enabled:
        return t
    expert = r.expert if isinstance(r.expert, tuple) else (
        (r.expert,) if r.expert else ())
    batch = tuple(a for a in r.batch if a not in expert) or None
    return common.constrain(t, (r.expert, batch) + (None,) * (t.dim() - 2))


def capacity(cfg: ModelConfig, group_size: int) -> int:
    """Slots per (group, expert): round(gs k cf / E), at least 1 and at
    most the group (Python's round, ties to even, as the reference)."""
    cap = int(max(1, round(group_size * cfg.top_k * cfg.moe_capacity_factor
                           / cfg.n_experts)))
    return min(cap, group_size)


# --------------------------------------------------------------------------
# The capacity-gather block, in the steps the card timing splits
# --------------------------------------------------------------------------

def _route(p: Dict, xg: torch.Tensor, cfg: ModelConfig, cap: int):
    """Router, top-k and the per-expert top-``cap`` token choice.
    xg: (G, S, d) -> (tok_idx (G, E, C), weight (G, E, C) f32 with 0 in
    empty slots, experts (G, S, k) ascending, slot (G, S, k): the slot of
    each of them, -1 where the token was dropped, aux loss)."""
    gates, sel, _ = router_scores(p, xg, cfg)               # (G, S, E)
    top = topk_indices(sel, cfg.top_k)                     # (G, S, k)
    mask = _mask_of(top, sel)
    aux = load_balance_loss(gates, mask, cfg.top_k)
    gates_n = _selected_gates(gates, mask, cfg)

    prio = torch.where(mask, sel.detach(), float("-inf")).transpose(1, 2)
    tok_idx = topk_indices(prio, cap)                      # (G, E, C)
    slot_valid = mask.transpose(1, 2).gather(2, tok_idx)
    weight = gates_n.transpose(1, 2).gather(2, tok_idx) * slot_valid

    # each token's slot in each expert it chose (-1: over capacity)
    slots = torch.arange(cap, device=xg.device).expand_as(tok_idx)
    pos = torch.full(prio.shape, -1, dtype=torch.long, device=xg.device)
    pos.scatter_(2, tok_idx, torch.where(slot_valid, slots, -1))
    experts = top.sort(dim=-1).values
    slot = pos.transpose(1, 2).gather(2, experts)
    return tok_idx, weight, experts, slot, aux


def _dispatch(xg: torch.Tensor, tok_idx: torch.Tensor) -> torch.Tensor:
    """Gather each expert's tokens: (G, S, d), (G, E, C) -> (E, G*C, d)."""
    def gather(xg, tok_idx):
        g, e, c = tok_idx.shape
        gi = torch.arange(g, device=xg.device)[None, :, None]
        xd = xg[gi, tok_idx.transpose(0, 1)]               # (E, G, C, d)
        return xd.reshape(e, g * c, xg.shape[-1])
    return _shard_dispatch(on_replicas(gather, xg, tok_idx))


def _expert_ffn(p: Dict, xd: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """Every expert's gated MLP on its slots: (E, N, d) -> (E, N, d)."""
    act = activation(cfg.act)
    dt = xd.dtype
    h = act(torch.bmm(xd, p["w_gate"].to(dt))) * torch.bmm(
        xd, p["w_up"].to(dt))
    return _shard_dispatch(torch.bmm(h, p["w_down"].to(dt)))


def _combine(yd: torch.Tensor, experts: torch.Tensor, slot: torch.Tensor,
             cap: int) -> torch.Tensor:
    """Sum each token's kept expert outputs in ascending expert order.
    yd: (E, G*C, d) weighted; experts, slot: (G, S, k) -> (G, S, d)."""
    return on_replicas(lambda *a: _combine_local(*a, cap), yd, experts, slot)


def _combine_local(yd: torch.Tensor, experts: torch.Tensor,
                   slot: torch.Tensor, cap: int) -> torch.Tensor:
    g, s, k = experts.shape
    gi = torch.arange(g, device=yd.device)[:, None, None]
    row = (experts * g + gi) * cap + slot.clamp_min(0)      # (G, S, k)
    picked = yd.reshape(-1, yd.shape[-1])[row]              # (G, S, k, d)
    picked = torch.where((slot >= 0)[..., None], picked, 0.0)
    out = picked[:, :, 0]
    for j in range(1, k):
        out = out + picked[:, :, j]
    return out


def _shared_experts(p: Dict, x: torch.Tensor, cfg: ModelConfig
                    ) -> torch.Tensor:
    """The always-on shared experts (+ qwen2-moe's sigmoid gate)."""
    act = activation(cfg.act)
    dt = x.dtype
    hs = act(torch.matmul(x, p["ws_gate"].to(dt))) * torch.matmul(
        x, p["ws_up"].to(dt))
    ys = torch.matmul(common.shard_ff(hs), p["ws_down"].to(dt))
    if cfg.shared_expert_gate:
        ys = ys * torch.sigmoid(torch.matmul(x, p["shared_gate"].to(dt)))
    return ys


def _count_routes(slot: torch.Tensor):
    """Count the call's assignments and those dropped over capacity
    (``slot`` -1), on the device; a ``DTensor`` (a mesh) is not counted."""
    if type(slot) is not torch.Tensor:
        return
    trace.count_device("moe.assignments_routed", slot.numel(), slot.device)
    trace.count_device("moe.assignments_dropped", (slot < 0).sum(),
                       slot.device)


def moe_block(p: Dict, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-gather MoE.  x: (b, s, d) -> (out, aux loss)."""
    with trace.span("moe.block", device=True):
        b, s, d = x.shape
        g, gs = (b, s) if s > 1 else (1, b)
        xg = x.reshape(g, gs, d)
        cap = capacity(cfg, gs)
        names = [k for k in ("router", "router_bias") if k in p]
        tok_idx, weight, experts, slot, aux = on_replicas(
            lambda xg, *w: _route(dict(zip(names, w)), xg, cfg, cap),
            xg, *(p[k] for k in names))
        _count_routes(slot)
        with trace.span("moe.experts", device=True):
            yd = _expert_ffn(p, _dispatch(xg, tok_idx), cfg)
        yd = yd * weight.transpose(0, 1).reshape(
            yd.shape[0], -1, 1).to(x.dtype)
        out = _combine(yd, experts, slot, cap).reshape(b, s, d)
        if cfg.n_shared_experts:
            out = out + _shared_experts(p, x, cfg)
        return out, aux


# --------------------------------------------------------------------------
# Dense oracle (tests): every expert for every token, top-k combined
# --------------------------------------------------------------------------

def moe_block_dense(p: Dict, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compute every expert for every token, combine top-k.  O(E)."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    gates, sel, _ = router_scores(p, xt, cfg)
    mask = _topk_mask(sel, cfg.top_k)
    aux = load_balance_loss(gates, mask, cfg.top_k)
    gates_n = _selected_gates(gates, mask, cfg)

    act = activation(cfg.act)
    dt = x.dtype
    h = act(torch.einsum("nd,edf->enf", xt, p["w_gate"].to(dt))) * \
        torch.einsum("nd,edf->enf", xt, p["w_up"].to(dt))
    y = torch.einsum("enf,efd->end", h, p["w_down"].to(dt))
    out = torch.einsum("end,ne->nd", y, gates_n.to(dt))
    if cfg.n_shared_experts:
        out = out + _shared_experts(p, xt, cfg)
    return out.reshape(b, s, d), aux


def expert_load(p: Dict, x: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """Fraction of tokens routed to each expert (for the bias update)."""
    _, sel, _ = router_scores(p, x.reshape(-1, x.shape[-1]), cfg)
    return _topk_mask(sel, cfg.top_k).float().mean(dim=0)


def update_router_bias(bias: torch.Tensor, load: torch.Tensor,
                       rate: float = 0.001) -> torch.Tensor:
    """DeepSeek aux-loss-free balancing: nudge the bias of under- and
    over-loaded experts.  load: (E,) fraction of tokens routed to each."""
    return bias + rate * torch.sign(load.mean() - load)

"""Mixture-of-Experts block (the port of ``repro.models.moe``):
capacity-gather dispatch, softmax and sigmoid routers, the dense oracle
and the aux-loss-free bias update.

Dispatch is gather-based, as in the reference: per expert the top-C
tokens by router priority are gathered, run through grouped expert
products (``torch.bmm`` over the expert axis) and combined back.  Tokens
over capacity are dropped; capacity_factor = E/k makes the dispatch
lossless, and then ``moe_block`` equals ``moe_block_dense``.  Tokens are
grouped per batch row when the sequence is longer than one token, and a
single-token decode step routes the whole batch as one group.  That step
keeps a few of the E experts at a small capacity, so it reads only the
experts that hold a kept slot (``expert_ffn_decode``: a hand-written
kernel on the card, which finds them there, its plain version on the
CPU) wherever ``slot_skipping`` allows; empty slots then hold zeros where
the batched products leave an unused expert's output.

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
reference always renormalises), then scaled by
``routed_scaling_factor``.  Where ``n_group`` > 1 the selection is
group-limited, as DeepSeek-V3's ``noaux_tc`` gate: the router's experts
fall into ``n_group`` equal groups, each scored by the sum of its two
highest selection scores, and a token picks its top k among the
``topk_group`` best groups only.

**The expert share.**  A layer may hold only some of the experts its
router scores, as one rank of expert parallelism does: it routes every
token over all ``n_router_experts`` and holds the ``n_experts`` from
``first_expert`` on.  The capacity is the whole layer's (C from the
router's width), and the dispatch, the products and the combine cover
the held experts only: the layer returns its own experts' part of the
routed result (what the absent experts add is left out; no exchange
stands in for them), plus the shared experts, which every rank computes
alike.  A layer that holds every expert is the whole layer.

Each ``moe_block`` call is a ``moe.block`` span of ``repro_torch.trace``
and its expert products a ``moe.experts`` span, both timed by CUDA
events on the card while tracing is on (not inside a CUDA graph's
capture); it counts ``moe.assignments_routed`` (the assignments of
tokens to the held experts: tokens x k where every expert is held) and
``moe.assignments_dropped`` (those over an expert's capacity) with
``trace.count_device``, on the device, so a graphed decode step counts
too and nothing waits for the count; a single-token call also counts
``moe.decode_experts`` (E) and ``moe.decode_experts_read`` (the experts
whose weights it read).

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

from typing import Dict, Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.grad import wants_grad
from repro_torch.models import common
from repro_torch.models.common import activation, dense_init, on_replicas


def init_moe(gen, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> Dict:
    """Router (always f32), experts (E, d, f) / (E, f, d) with fan-in on
    axis 1, the aux-free bias and the shared experts with their gate."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": dense_init(gen, (d, cfg.n_router_experts), device=device),
        "w_gate": dense_init(gen, (e, d, f), in_axis=1, **kw),
        "w_up": dense_init(gen, (e, d, f), in_axis=1, **kw),
        "w_down": dense_init(gen, (e, f, d), in_axis=1, **kw),
    }
    if cfg.router_aux_free_bias:
        p["router_bias"] = torch.zeros((cfg.n_router_experts,),
                                       dtype=torch.float32, device=device)
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
    """-> (gates (..., E) f32, selection scores (..., E), logits) over the
    router's E experts."""
    logits = torch.matmul(x.float(), p["router"])
    if cfg.router_type == "sigmoid":
        gates = torch.sigmoid(logits)
        sel = gates + p["router_bias"] if "router_bias" in p else gates
    else:
        gates = torch.softmax(logits, dim=-1)
        sel = gates
    return gates, sel, logits


def group_limited(sel: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The selection scores (..., E) with every expert outside the token's
    ``topk_group`` best groups at -inf (``noaux_tc``): the E experts fall
    into ``n_group`` groups of consecutive ids, each scored by the sum of
    its two highest scores (equal group scores to the lower group).  The
    scores themselves where ``n_group`` is 1."""
    g = cfg.n_group
    if g <= 1:
        return sel
    e = sel.shape[-1]
    if e % g or not 1 <= cfg.topk_group <= g:
        raise ValueError(f"{cfg.name}: {e} experts do not fall into "
                         f"{g} groups of which {cfg.topk_group} are kept")
    grouped = sel.reshape(*sel.shape[:-1], g, e // g)
    top2 = torch.sort(grouped.detach(), dim=-1, descending=True).values
    score = top2[..., :2].sum(-1)                           # (..., g)
    keep = _mask_of(topk_indices(score, cfg.topk_group), score)
    return torch.where(keep[..., None], grouped, float("-inf")).reshape(
        sel.shape)


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
    sum to one where ``cfg.norm_topk_prob``, times
    ``cfg.routed_scaling_factor``."""
    if cfg.norm_topk_prob:
        out = _normalized_gates(gates, mask)
    else:
        out = torch.where(mask, gates, 0.0)
    if cfg.routed_scaling_factor != 1.0:
        out = out * cfg.routed_scaling_factor
    return out


def _select(sel: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (each token's top-k experts (..., k), largest selection score
    first, of the groups it may pick from; their mask (..., E))."""
    top = topk_indices(group_limited(sel, cfg), cfg.top_k)
    return top, _mask_of(top, sel)


def _held(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The held experts' columns (..., n_experts) of a (..., E) tensor
    over the router's experts."""
    return t[..., cfg.first_expert:cfg.first_expert + cfg.n_experts]


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
    """Slots per (group, expert): round(gs k cf / E) over the router's E
    experts, at least 1 and at most the group (Python's round, ties to
    even, as the reference)."""
    cap = int(max(1, round(group_size * cfg.top_k * cfg.moe_capacity_factor
                           / cfg.n_router_experts)))
    return min(cap, group_size)


# --------------------------------------------------------------------------
# The capacity-gather block, in the steps the card timing splits
# --------------------------------------------------------------------------

def _route(p: Dict, xg: torch.Tensor, cfg: ModelConfig, cap: int):
    """Router over all E experts, top-k and, for each of the n held
    experts, its top-``cap`` token choice.  xg: (G, S, d) -> (tok_idx
    (G, n, C), weight (G, n, C) f32 with 0 in empty slots, experts (G, S,
    k): each token's experts ascending, by the router's ids, slot (G, S,
    k): the slot of each of them, -1 where the token was dropped, -2
    where the expert is not held, aux loss)."""
    gates, sel, _ = router_scores(p, xg, cfg)               # (G, S, E)
    top, mask = _select(sel, cfg)                           # (G, S, k)
    aux = load_balance_loss(gates, mask, cfg.top_k)
    gates_n = _held(_selected_gates(gates, mask, cfg), cfg)
    mask, sel = _held(mask, cfg), _held(sel, cfg)           # (G, S, n)

    prio = torch.where(mask, sel.detach(), float("-inf")).transpose(1, 2)
    tok_idx = topk_indices(prio, cap)                      # (G, n, C)
    slot_valid = mask.transpose(1, 2).gather(2, tok_idx)
    weight = gates_n.transpose(1, 2).gather(2, tok_idx) * slot_valid

    # each token's slot in each of the router's experts (-1: over
    # capacity, -2: not held; a layer that holds every expert fills no
    # -2, and an empty fill launches nothing)
    g, n, s = prio.shape
    e, first = cfg.n_router_experts, cfg.first_expert
    slots = torch.arange(cap, device=xg.device).expand_as(tok_idx)
    pos = torch.full((g, e, s), -1, dtype=torch.long, device=xg.device)
    pos.narrow(1, 0, first).fill_(-2)
    pos.narrow(1, first + n, e - first - n).fill_(-2)
    pos.narrow(1, first, n).scatter_(
        2, tok_idx, torch.where(slot_valid, slots, -1))
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


# --------------------------------------------------------------------------
# The single-token step's experts: only those holding a kept slot are read
# --------------------------------------------------------------------------

# Slots per expert up to which a single-token step takes the slot-skipping
# products (``expert_ffn_decode``); above it every expert is likely kept and
# the step keeps the batched products.  The H100 sweep at qwen2-moe's
# widths in f32 (chip_smoke.py [timing], PERF.md) set it: the kernel took
# 0.065 ms against the batched products' 0.79 at batch 1 (C 1, 4 of 60
# experts read), 0.50 against 0.76 at batch 16 (C 1, 41 read), 0.70
# against 0.74 at batch 32 (C 3, 54 read), and lost at batch 64 (C 5,
# every expert read: 0.92 against 0.74).
DECODE_MAX_SLOTS = 3
_DECODE_ACTS = {"silu": 0, "gelu": 1}
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def expert_ffn_decode_plain(xd: torch.Tensor, w_gate: torch.Tensor,
                            w_up: torch.Tensor, w_down: torch.Tensor,
                            valid: torch.Tensor, act: str
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gated MLP of the experts that hold a valid slot, on their slots:
    xd (E, C, d), w_gate/w_up (E, d, f), w_down (E, f, d), valid (E, C)
    bool -> (yd (E, C, d) with zeros in every invalid slot, the number of
    experts read, 0-d int64).  Reads the kept experts' indices on the
    host."""
    kept = valid.any(-1)
    idx = kept.nonzero()[:, 0]
    dt = xd.dtype
    xk = xd[idx]
    fn = activation(act)
    h = fn(torch.bmm(xk, w_gate[idx].to(dt))) * torch.bmm(
        xk, w_up[idx].to(dt))
    yk = torch.bmm(h, w_down[idx].to(dt))
    yd = torch.zeros_like(xd)
    yd[idx] = torch.where(valid[idx][..., None], yk, 0.0)
    return yd, kept.sum()


def expert_ffn_decode(xd: torch.Tensor, w_gate: torch.Tensor,
                      w_up: torch.Tensor, w_down: torch.Tensor,
                      valid: torch.Tensor, act: str,
                      max_kept: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``expert_ffn_decode_plain``'s function.  A CUDA tensor launches
    ``sage_moe_experts_decode`` (``csrc/moe_decode.cu``), which finds the
    kept experts on the card (nothing read to the host, so a CUDA graph
    captures it); a CPU tensor runs the plain version.  ``max_kept``: at
    least the number of experts that hold a valid slot (a single-token
    group: tokens x top_k), E when not given."""
    e, c, d = xd.shape
    if not xd.is_cuda:
        return expert_ffn_decode_plain(xd, w_gate, w_up, w_down, valid, act)
    ws = (w_gate, w_up, w_down)
    if (tuple(w_gate.shape) != (e, d, w_gate.shape[-1])
            or w_up.shape != w_gate.shape
            or tuple(w_down.shape) != (e, w_gate.shape[-1], d)
            or tuple(valid.shape) != (e, c)):
        raise ValueError(f"expert_ffn_decode: xd {tuple(xd.shape)}, weights "
                         f"{[tuple(w.shape) for w in ws]} and valid "
                         f"{tuple(valid.shape)} do not fit (E, C, d), "
                         f"(E, d, f), (E, f, d), (E, C)")
    if xd.dtype not in (torch.float32, torch.bfloat16) or any(
            w.dtype != xd.dtype for w in ws) or valid.dtype != torch.bool:
        raise TypeError("sage_moe_experts_decode takes f32 or bf16 xd and "
                        "weights of its dtype, and a bool valid")
    if act not in _DECODE_ACTS:
        raise ValueError(f"sage_moe_experts_decode has no activation {act!r}")
    if any(t.device != xd.device for t in (*ws, valid)):
        raise ValueError("expert_ffn_decode: every input on xd's device")
    ranks = e if max_kept is None else max(1, min(e, int(max_kept)))
    return _launch_decode(xd.contiguous(), *(w.contiguous() for w in ws),
                          valid.contiguous(), _DECODE_ACTS[act], ranks)


def _launch_decode(xd, w_gate, w_up, w_down, valid, act: int, ranks: int):
    """One call of ``sage_moe_experts_decode`` (two launches) on checked
    CUDA inputs."""
    from repro_torch import _ext
    e, c, d = xd.shape
    f = w_gate.shape[-1]
    h = torch.empty((ranks, c, f), dtype=torch.float32, device=xd.device)
    yd = torch.empty_like(xd)
    kept = torch.empty((), dtype=torch.int64, device=xd.device)
    lib = _ext.library()
    with torch.cuda.device(xd.device):
        err = lib.sage_moe_experts_decode(
            xd.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), valid.data_ptr(), e, c, d, f, ranks, act,
            int(xd.dtype == torch.bfloat16), h.data_ptr(), yd.data_ptr(),
            kept.data_ptr(), torch.cuda.current_stream(xd.device).cuda_stream)
    _ext.check(lib, err, "moe_experts_decode")
    _ext.count_launch("moe_experts_decode")
    return yd, kept


def slot_skipping(p: Dict, xd: torch.Tensor, cfg: ModelConfig) -> bool:
    """Whether a single-token step's dispatched slots xd (E, C, d) take
    ``expert_ffn_decode``: plain tensors on the card or the CPU (not a
    mesh's ``DTensor``, not ``meta``), weights of xd's dtype (f32 or
    bf16), no gradient wanted, an activation the kernel has, and at most
    ``DECODE_MAX_SLOTS`` slots an expert."""
    ws = [p[k] for k in _EXPERT_KEYS]
    return (all(type(t) is torch.Tensor for t in (xd, *ws))
            and xd.device.type in ("cuda", "cpu")
            and all(w.device == xd.device and w.dtype == xd.dtype
                    for w in ws)
            and xd.dtype in (torch.float32, torch.bfloat16)
            and not wants_grad(xd, *ws)
            and cfg.act in _DECODE_ACTS
            and xd.shape[1] <= DECODE_MAX_SLOTS)


def _single_token_experts(p: Dict, xd: torch.Tensor, weight: torch.Tensor,
                          cfg: ModelConfig, tokens: int) -> torch.Tensor:
    """A single-token step's expert products: the kept experts' only where
    ``slot_skipping`` allows, else every expert's.  Counts
    ``moe.decode_experts`` (E) and ``moe.decode_experts_read`` (the
    experts whose weights were read) on the device; a ``DTensor`` is not
    counted."""
    e = xd.shape[0]
    if slot_skipping(p, xd, cfg):
        yd, read = expert_ffn_decode(
            xd, *(p[k] for k in _EXPERT_KEYS), weight[0] != 0, cfg.act,
            max_kept=tokens * cfg.top_k)
    else:
        yd, read = _expert_ffn(p, xd, cfg), e
    if type(xd) is torch.Tensor:
        trace.count_device("moe.decode_experts", e, xd.device)
        trace.count_device("moe.decode_experts_read", read, xd.device)
    return yd


def _combine(yd: torch.Tensor, experts: torch.Tensor, slot: torch.Tensor,
             cap: int, first: int) -> torch.Tensor:
    """Sum each token's kept expert outputs in ascending expert order.
    yd: (n, G*C, d) weighted over the n held experts, the router's
    experts ``first`` on; experts, slot: (G, S, k) -> (G, S, d)."""
    return on_replicas(lambda *a: _combine_local(*a, cap, first), yd,
                       experts, slot)


def _combine_local(yd: torch.Tensor, experts: torch.Tensor,
                   slot: torch.Tensor, cap: int, first: int) -> torch.Tensor:
    g, s, k = experts.shape
    # expert e's rows start at (e - first) G C: the shift rides on gi
    gi = torch.arange(-first * g, (1 - first) * g,
                      device=yd.device)[:, None, None]
    kept = slot >= 0              # not kept: dropped (-1), not held (-2)
    row = torch.where(kept, (experts * g + gi) * cap + slot, 0)
    picked = yd.reshape(-1, yd.shape[-1])[row]              # (G, S, k, d)
    picked = torch.where(kept[..., None], picked, 0.0)
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


def _count_routes(slot: torch.Tensor, cfg: ModelConfig):
    """Count the call's assignments to held experts (``slot`` -1 or
    more) and those of them dropped over capacity (-1), on the device; a
    ``DTensor`` (a mesh) is not counted.  Where the layer holds every
    expert, every assignment is to a held one: the host has that count,
    which keeps two launches a layer out of a graphed decode step."""
    if type(slot) is not torch.Tensor:
        return
    routed = (slot.numel() if cfg.n_experts == cfg.n_router_experts
              else (slot >= -1).sum())
    trace.count_device("moe.assignments_routed", routed, slot.device)
    trace.count_device("moe.assignments_dropped", (slot == -1).sum(),
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
        _count_routes(slot, cfg)
        with trace.span("moe.experts", device=True):
            xd = _dispatch(xg, tok_idx)
            yd = (_single_token_experts(p, xd, weight, cfg, b) if s == 1
                  else _expert_ffn(p, xd, cfg))
        yd = yd * weight.transpose(0, 1).reshape(
            yd.shape[0], -1, 1).to(x.dtype)
        out = _combine(yd, experts, slot, cap,
                       cfg.first_expert).reshape(b, s, d)
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
    _, mask = _select(sel, cfg)
    aux = load_balance_loss(gates, mask, cfg.top_k)
    gates_n = _held(_selected_gates(gates, mask, cfg), cfg)

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
    return _select(sel, cfg)[1].float().mean(dim=0)


def update_router_bias(bias: torch.Tensor, load: torch.Tensor,
                       rate: float = 0.001) -> torch.Tensor:
    """DeepSeek aux-loss-free balancing: nudge the bias of under- and
    over-loaded experts.  load: (E,) fraction of tokens routed to each."""
    return bias + rate * torch.sign(load.mean() - load)

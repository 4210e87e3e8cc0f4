"""DeepSeek-V3's published router, expert share and YaRN in the port,
against direct transcriptions of DeepSeek's inference code
(``inference/model.py``: ``Gate``, ``precompute_freqs_cis`` and MLA's
softmax scale) and against the port's own uncut layer; the default
fields routing qwen2-moe exactly as the port routed it before them; and
MLA's prefill through B5's padded route (its plain version on the CPU)
against the plain attention.

Tolerances: the router's choices and gates are compared exactly (the
same f32 ops on the same scores) but for the renormalising sum, whose
order may differ (1e-6); the share's parts add up to the uncut layer
within f32 rounding of sums taken in another order (1e-5 of the largest
|value|); the padded route adds zero products to each q.k and gives the
same softmax (1e-5)."""
import math

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import common, mla, moe

CPU = torch.device("cpu")
RTOL = 1e-5


def _x(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _moe_cfg(**over):
    """deepseek's SMOKE widths with the published router: 16 experts in
    4 groups, top 4 of them among the best 2 groups, gates x 2.5."""
    base = dict(dtype="float32", n_experts=16, top_k=4, n_group=4,
                topk_group=2, routed_scaling_factor=2.5)
    base.update(over)
    return get_smoke_config("deepseek-v3-671b").scaled(**base)


def _moe_params(cfg, seed=0):
    p = moe.init_moe(torch.Generator().manual_seed(seed), cfg, device=CPU)
    p["router"] = p["router"] * 4.0
    p["router_bias"] = _x(seed + 100, cfg.n_router_experts) * 0.1
    return p


# ---------------------------------------------------------------------------
# the router against DeepSeek's Gate
# ---------------------------------------------------------------------------

def deepseek_gate(x, weight, bias, n_groups, topk_groups, topk, route_scale):
    """DeepSeek-V3's ``Gate.forward`` (sigmoid scores, ``noaux_tc``),
    transcribed: x (n, d), weight (E, d) -> (weights (n, k), indices)."""
    scores = torch.nn.functional.linear(x, weight).sigmoid()
    original_scores = scores
    scores = scores + bias
    if n_groups > 1:
        scores = scores.view(x.size(0), n_groups, -1)
        group_scores = scores.topk(2, dim=-1)[0].sum(dim=-1)
        indices = group_scores.topk(topk_groups, dim=-1)[1]
        mask = scores.new_ones(x.size(0), n_groups,
                               dtype=bool).scatter_(1, indices, False)
        scores = scores.masked_fill_(mask.unsqueeze(-1),
                                     float("-inf")).flatten(1)
    indices = torch.topk(scores, topk, dim=-1)[1]
    weights = original_scores.gather(1, indices)
    weights /= weights.sum(dim=-1, keepdim=True)
    weights *= route_scale
    return weights, indices


def _port_choice(p, x, cfg):
    gates, sel, _ = moe.router_scores(p, x, cfg)
    top, mask = moe._select(sel, cfg)
    return top, moe._selected_gates(gates, mask, cfg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_equals_deepseeks_gate(seed):
    cfg = _moe_cfg()
    p = _moe_params(cfg, seed)
    x = _x(seed, 40, cfg.d_model)
    w, idx = deepseek_gate(x, p["router"].t(), p["router_bias"],
                           cfg.n_group, cfg.topk_group, cfg.top_k,
                           cfg.routed_scaling_factor)
    top, gates = _port_choice(p, x, cfg)
    assert torch.equal(top.sort(-1).values, idx.sort(-1).values)
    got = gates.gather(1, idx)
    assert float((got - w).abs().max()) <= 1e-6 * float(w.abs().max())
    assert torch.allclose(gates.sum(-1), torch.full((40,), 2.5))


def test_an_excluded_group_keeps_out_its_best_expert():
    """Group 0 holds the single highest score but a low second one; the
    two groups whose top-2 sums are larger are kept, so that expert is
    not chosen, by the port as by DeepSeek's gate."""
    cfg = _moe_cfg(top_k=2)
    d, e = cfg.d_model, cfg.n_router_experts
    p = {"router": torch.zeros((d, e)), "router_bias": torch.zeros(e)}
    # scores through the bias alone (sigmoid(0) = 0.5 everywhere)
    bias = torch.full((e,), -0.4)
    bias[0] = 0.45                        # group 0: 0.95 + 0.1 = 1.05
    bias[4:6] = torch.tensor([0.2, 0.2])  # group 1: 0.7 + 0.7 = 1.4
    bias[8:10] = torch.tensor([0.1, 0.1])  # group 2: 0.6 + 0.6 = 1.2
    p["router_bias"] = bias
    x = torch.zeros((3, d))
    _, idx = deepseek_gate(x, p["router"].t(), bias, cfg.n_group,
                           cfg.topk_group, cfg.top_k, 2.5)
    top, _ = _port_choice(p, x, cfg)
    assert 0 not in idx.flatten().tolist()
    assert torch.equal(top.sort(-1).values, idx.sort(-1).values)
    ungrouped = cfg.scaled(n_group=1, topk_group=1)
    assert 0 in _port_choice(p, x, ungrouped)[0].flatten().tolist()


def test_dense_oracle_and_expert_load_route_by_groups():
    cfg = _moe_cfg(moe_capacity_factor=16 / 4)
    p = _moe_params(cfg, 3)
    x = _x(3, 2, 11, cfg.d_model)
    out, _ = moe.moe_block(p, x, cfg)
    want, _ = moe.moe_block_dense(p, x, cfg)
    assert float((out - want).abs().max()) <= RTOL * float(want.abs().max())
    load = moe.expert_load(p, x, cfg)
    _, idx = deepseek_gate(x.reshape(-1, cfg.d_model), p["router"].t(),
                           p["router_bias"], cfg.n_group, cfg.topk_group,
                           cfg.top_k, 2.5)
    want = torch.zeros(16).index_add_(0, idx.flatten(),
                                      torch.ones(idx.numel())) / 22
    assert torch.allclose(load, want)


# ---------------------------------------------------------------------------
# the expert share
# ---------------------------------------------------------------------------

def _share(p, cfg, first, n):
    """The share's parameters and configuration: experts [first, first +
    n) of the whole layer's, the router whole."""
    part = dict(p)
    for k in ("w_gate", "w_up", "w_down"):
        part[k] = p[k][first:first + n]
    return part, cfg.scaled(n_experts=n, router_experts=cfg.n_experts,
                            first_expert=first)


@pytest.mark.parametrize("shares", [4, 2, 8])
@pytest.mark.parametrize("tokens", [(2, 13), (5, 1)])
def test_shares_add_up_to_the_uncut_layer(shares, tokens):
    """At a lossless capacity (E/k) each share's routed part, plus the
    shared expert counted once, adds up to the whole layer, in prefill
    and in a single-token step."""
    cfg = _moe_cfg(moe_capacity_factor=16 / 4)
    p = _moe_params(cfg, 5)
    x = _x(5, *tokens, cfg.d_model)
    whole, _ = moe.moe_block(p, x, cfg)
    shared = moe._shared_experts(p, x, cfg)
    n = cfg.n_experts // shares
    total = shared.clone()
    for j in range(shares):
        part, scfg = _share(p, cfg, j * n, n)
        assert moe.capacity(scfg, 13) == moe.capacity(cfg, 13)
        out, _ = moe.moe_block(part, x, scfg)
        total = total + (out - shared)
    scale = float(whole.abs().max())
    assert float((total - whole).abs().max()) <= RTOL * scale


def test_a_share_counts_only_its_assignments():
    cfg = _moe_cfg(moe_capacity_factor=16 / 4)
    p = _moe_params(cfg, 6)
    x = _x(6, 1, 17, cfg.d_model)
    _, idx = deepseek_gate(x[0], p["router"].t(), p["router_bias"],
                           cfg.n_group, cfg.topk_group, cfg.top_k, 2.5)
    part, scfg = _share(p, cfg, 4, 4)
    trace.drop_device_counts(CPU)
    with trace.unit("test.share") as u:
        moe.moe_block(part, x, scfg)
        trace.settle_device_counts(CPU)
    held = int(((idx >= 4) & (idx < 8)).sum())
    assert u.counts["moe.assignments_routed"] == held
    assert u.counts["moe.assignments_dropped"] == 0


def test_a_lossy_share_counts_the_drops_of_its_experts():
    """Below a lossless capacity the share drops what the whole layer
    drops at its experts (C counted against the router's width), and
    counts those drops only."""
    cfg = _moe_cfg(moe_capacity_factor=0.5)
    p = _moe_params(cfg, 7)
    x = _x(7, 1, 40, cfg.d_model)
    _, _, experts, slot, _ = moe._route(p, x, cfg, moe.capacity(cfg, 40))
    mine = (experts >= 4) & (experts < 8)
    part, scfg = _share(p, cfg, 4, 4)
    trace.drop_device_counts(CPU)
    with trace.unit("test.share") as u:
        moe.moe_block(part, x, scfg)
        trace.settle_device_counts(CPU)
    dropped = int((mine & (slot == -1)).sum())
    assert dropped > 0 and bool((slot[~mine] == -1).any())
    assert u.counts["moe.assignments_routed"] == int(mine.sum())
    assert u.counts["moe.assignments_dropped"] == dropped


# ---------------------------------------------------------------------------
# the default fields: qwen2-moe routes as before
# ---------------------------------------------------------------------------

def _route_before(p, xg, cfg, cap):
    """``moe._route`` as the port had it before the group-limited router,
    the gates' scale and the expert share."""
    gates, sel, _ = moe.router_scores(p, xg, cfg)
    top = moe.topk_indices(sel, cfg.top_k)
    mask = moe._mask_of(top, sel)
    aux = moe.load_balance_loss(gates, mask, cfg.top_k)
    gates_n = (moe._normalized_gates(gates, mask) if cfg.norm_topk_prob
               else torch.where(mask, gates, 0.0))
    prio = torch.where(mask, sel.detach(), float("-inf")).transpose(1, 2)
    tok_idx = moe.topk_indices(prio, cap)
    slot_valid = mask.transpose(1, 2).gather(2, tok_idx)
    weight = gates_n.transpose(1, 2).gather(2, tok_idx) * slot_valid
    slots = torch.arange(cap).expand_as(tok_idx)
    pos = torch.full(prio.shape, -1, dtype=torch.long)
    pos.scatter_(2, tok_idx, torch.where(slot_valid, slots, -1))
    experts = top.sort(dim=-1).values
    slot = pos.transpose(1, 2).gather(2, experts)
    return tok_idx, weight, experts, slot, aux


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("shape", [(1, 40), (3, 9), (1, 1)])
def test_default_fields_route_qwen2_moe_as_before(norm, shape):
    cfg = get_smoke_config("qwen2-moe-a2.7b").scaled(dtype="float32",
                                                     norm_topk_prob=norm)
    assert (cfg.n_group, cfg.routed_scaling_factor, cfg.n_router_experts,
            cfg.first_expert) == (1, 1.0, cfg.n_experts, 0)
    p = moe.init_moe(torch.Generator().manual_seed(7), cfg, device=CPU)
    p["router"] = p["router"] * 8.0
    xg = _x(7, *shape, cfg.d_model)
    cap = moe.capacity(cfg, shape[1])
    for got, want in zip(moe._route(p, xg, cfg, cap),
                         _route_before(p, xg, cfg, cap)):
        assert torch.equal(got, want)


def test_published_config_and_smoke_fields():
    full, smoke = get_config("deepseek-v3-671b"), get_smoke_config(
        "deepseek-v3-671b")
    assert (full.n_group, full.topk_group, full.routed_scaling_factor) == \
        (8, 4, 2.5)
    assert (full.yarn_factor, full.yarn_original_max_position,
            full.yarn_beta_fast, full.yarn_beta_slow) == (40, 4096, 32, 1)
    assert (smoke.n_group, smoke.routed_scaling_factor, smoke.yarn_factor,
            smoke.n_router_experts) == (1, 1.0, 0.0, smoke.n_experts)


# ---------------------------------------------------------------------------
# YaRN and the softmax scale
# ---------------------------------------------------------------------------

def deepseek_freqs(dim, base, factor, original, beta_fast, beta_slow):
    """DeepSeek-V3's ``precompute_freqs_cis`` frequencies, transcribed
    (its seqlen > original_seq_len branch)."""
    def find_correction_dim(num_rotations, dim, base, max_seq_len):
        return dim * math.log(max_seq_len / (num_rotations * 2 * math.pi)) \
            / (2 * math.log(base))

    def find_correction_range(low_rot, high_rot, dim, base, max_seq_len):
        low = math.floor(find_correction_dim(low_rot, dim, base,
                                             max_seq_len))
        high = math.ceil(find_correction_dim(high_rot, dim, base,
                                             max_seq_len))
        return max(low, 0), min(high, dim - 1)

    def linear_ramp_factor(min, max, dim):
        if min == max:
            max += 0.001
        linear_func = (torch.arange(dim, dtype=torch.float32) - min) / (
            max - min)
        return torch.clamp(linear_func, 0, 1)

    freqs = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32)
                            / dim))
    low, high = find_correction_range(beta_fast, beta_slow, dim, base,
                                      original)
    smooth = 1 - linear_ramp_factor(low, high, dim // 2)
    return freqs / factor * (1 - smooth) + freqs * smooth


@pytest.mark.parametrize("dim,original", [(64, 4096), (8, 16), (32, 256)])
def test_yarn_frequencies_follow_the_formula(dim, original):
    got = common.yarn_frequencies(dim, 10000.0, 40.0, original, 32.0, 1.0)
    want = deepseek_freqs(dim, 10000.0, 40.0, original, 32, 1)
    assert torch.equal(got, want)
    plain = common.rope_frequencies(dim, 10000.0)
    if dim == 64:   # published: dims 0-9 kept, 23-31 divided by 40
        assert torch.equal(got[:10], plain[:10])
        assert torch.allclose(got[23:], plain[23:] / 40)


def test_mscale_on_the_softmax_scale():
    cfg = get_config("deepseek-v3-671b")
    m = 0.1 * 1.0 * math.log(40) + 1.0
    assert mla._scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert m * m == pytest.approx(1.8739, abs=1e-4)
    assert mla._scale(cfg.scaled(yarn_factor=0.0)) == 1 / math.sqrt(192)
    with pytest.raises(NotImplementedError):
        mla._scale(cfg.scaled(yarn_mscale=0.707))


def test_yarn_reaches_the_rope_heads_in_prefill_and_decode():
    """The rope heads turn at YaRN's frequencies: prefill's query and
    cached key and a decode step's agree with RoPE at those frequencies,
    and differ from plain RoPE's past the original positions."""
    cfg = get_smoke_config("deepseek-v3-671b").scaled(
        dtype="float32", yarn_factor=40.0, yarn_original_max_position=16,
        yarn_mscale_all_dim=1.0)
    p = mla.init_mla(torch.Generator().manual_seed(1), cfg, device=CPU)
    x = _x(1, 1, 30, cfg.d_model)
    pos = torch.arange(30)[None]
    _, q_pe = mla._queries(p, x, pos, cfg)
    _, plain = mla._queries(p, x, pos, cfg.scaled(yarn_factor=0.0))
    inv = deepseek_freqs(8, 10000.0, 40.0, 16, 32, 1)
    q = torch.matmul(common.rms_norm(torch.matmul(x, p["wq_a"]),
                                     p["q_norm"], cfg.norm_eps),
                     p["wq_b"].reshape(32, -1)).reshape(1, 30, 4, 24)
    want = common.apply_rope(q[..., 16:], pos, 10000.0, inv_freq=inv)
    assert torch.equal(q_pe, want)
    assert float((q_pe - plain)[:, 20:].abs().max()) > 1e-3
    cache = mla.init_mla_cache(cfg, 1, 32, torch.float32, CPU)
    mla.mla_prefill(p, x[:, :29], pos[:, :29], cfg, cache)
    _, k_pe = mla._latent_kv(p, x, pos, cfg)
    assert torch.equal(cache["kpe"][:, :29], k_pe[:, :29])
    mla.mla_decode(p, x[:, 29:], 29, cfg, cache)
    assert torch.allclose(cache["kpe"][:, 29], k_pe[:, 29], atol=1e-6)


# ---------------------------------------------------------------------------
# MLA's prefill: B5's padded route and the latent written once, in place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 7, 33])
def test_padded_route_equals_the_plain_attention(s):
    cfg = get_smoke_config("deepseek-v3-671b").scaled(dtype="float32")
    h, dn, dr, dv = 4, 16, 8, 16
    qn, qp = _x(s, 2, s, h, dn), _x(s + 1, 2, s, h, dr)
    kn, kp, v = _x(s + 2, 2, s, h, dn), _x(s + 3, 2, s, dr), \
        _x(s + 4, 2, s, h, dv)
    pos = torch.arange(s)
    want = mla._attend_plain(qn, qp, kn, kp, v, pos, cfg)
    got = mla.attend_kernel(qn, qp, kn, kp, v, mla._scale(cfg))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= RTOL * float(
        want.abs().max())


@pytest.mark.parametrize("dn,dr,dv", [(200, 64, 128), (128, 64, 257)])
def test_padded_route_refuses_heads_wider_than_b5(dn, dr, dv):
    qn, qp = _x(0, 1, 3, 2, dn), _x(1, 1, 3, 2, dr)
    kn, kp, v = _x(2, 1, 3, 2, dn), _x(3, 1, 3, dr), _x(4, 1, 3, 2, dv)
    with pytest.raises(ValueError, match="head dim 256"):
        mla.attend_kernel(qn, qp, kn, kp, v, 0.1)


def test_prefill_writes_the_cache_in_place_and_counts():
    cfg = get_smoke_config("deepseek-v3-671b").scaled(dtype="float32")
    p = mla.init_mla(torch.Generator().manual_seed(2), cfg, device=CPU)
    x, pos = _x(2, 2, 9, cfg.d_model), torch.arange(9)[None].expand(2, 9)
    cache = mla.init_mla_cache(cfg, 2, 16, torch.float32, CPU)
    cache["pos"].fill_(3)                 # what an earlier request left
    ckv = cache["ckv"]
    with trace.unit("test.drain"):      # counts made outside any unit
        pass
    with trace.unit("test.mla") as u:
        out, got = mla.mla_prefill(p, x, pos, cfg, cache)
    assert got is cache and got["ckv"] is ckv
    c_kv, _ = mla._latent_kv(p, x, pos, cfg)
    assert torch.equal(got["ckv"][:, :9], c_kv)
    assert got["pos"].tolist() == list(range(9)) + [-1] * 7
    assert torch.equal(out, mla.mla_attention(p, x, pos, cfg))
    # the CPU keeps the plain path
    assert u.counts == {"mla.prefill_layers": 1}


def test_decode_counts_the_slots_it_reads():
    cfg = get_smoke_config("deepseek-v3-671b").scaled(dtype="float32")
    p = mla.init_mla(torch.Generator().manual_seed(3), cfg, device=CPU)
    x, pos = _x(3, 2, 5, cfg.d_model), torch.arange(5)[None]
    cache = mla.init_mla_cache(cfg, 2, 12, torch.float32, CPU)
    mla.mla_prefill(p, x, pos, cfg, cache)
    trace.drop_device_counts(CPU)
    with trace.unit("test.mla") as u:
        for i in range(3):
            mla.mla_decode(p, _x(10 + i, 2, 1, cfg.d_model), 5 + i, cfg,
                           cache)
        trace.settle_device_counts(CPU)
    assert u.counts["mla.decode_slots_read"] == 3 * 2 * 12
    assert u.counts["mla.decode_slots_valid"] == 2 * (6 + 7 + 8)

"""The MoE block's unnormalised gates (``norm_topk_prob`` false, as
Qwen1.5-MoE publishes) against a plain oracle, the default still held to
the dense oracle, and its routing counters against a count of the same
routing made on the host."""
import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

CPU = torch.device("cpu")


def _cfg(**kw):
    return get_smoke_config("qwen2-moe-a2.7b").scaled(dtype="float32", **kw)


def _params(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    p = moe.init_moe(g, cfg)
    # the init's router is small: widen it, so that the gates spread
    p["router"] = p["router"] * 8.0
    return p


def _oracle(p, x, cfg):
    """Each token: the sum over its top-k experts (highest gate first,
    equal gates the lower index) of gate x expert, the gates renormalised
    only where ``norm_topk_prob``, plus the gated shared expert."""
    b, s, d = x.shape
    out = torch.zeros(b * s, d)
    for t, xt in enumerate(x.reshape(-1, d)):
        gates = torch.softmax(xt @ p["router"], dim=-1)
        order = sorted(range(cfg.n_experts), key=lambda e: (-float(gates[e]),
                                                             e))
        top = order[:cfg.top_k]
        w = gates[top]
        if cfg.norm_topk_prob:
            w = w / w.sum()
        for e, we in zip(top, w):
            h = torch.nn.functional.silu(xt @ p["w_gate"][e]) \
                * (xt @ p["w_up"][e])
            out[t] += we * (h @ p["w_down"][e])
        hs = torch.nn.functional.silu(xt @ p["ws_gate"]) * (xt @ p["ws_up"])
        out[t] += (hs @ p["ws_down"]) * torch.sigmoid(xt @ p["shared_gate"])
    return out.reshape(b, s, d)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("b,s", [(2, 9), (3, 1)])
def test_gates_against_a_plain_oracle(norm, b, s):
    """At capacity E/k nothing is dropped: the capacity-gather block and
    the dense oracle both give the plain oracle's output, with the
    selected gates renormalised or not."""
    cfg = _cfg(norm_topk_prob=norm)
    cfg = cfg.scaled(moe_capacity_factor=cfg.n_experts / cfg.top_k)
    p = _params(cfg, 1)
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    want = _oracle(p, x, cfg)
    for fn in (moe.moe_block, moe.moe_block_dense):
        got, _ = fn(p, x, cfg)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_default_renormalises_as_the_dense_oracle():
    cfg = _cfg()
    assert cfg.norm_topk_prob
    lossless = cfg.scaled(moe_capacity_factor=cfg.n_experts / cfg.top_k)
    p = _params(cfg, 3)
    x = torch.randn((2, 7, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4))
    got, _ = moe.moe_block(p, x, lossless)
    want, _ = moe.moe_block_dense(p, x, cfg)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    unnormed, _ = moe.moe_block_dense(p, x, cfg.scaled(norm_topk_prob=False))
    assert not torch.allclose(unnormed, want, atol=1e-4)


def _host_count(p, x, cfg):
    """(routed, dropped) worked out in numpy: per group (a row, or the
    batch of one-token rows), each expert keeps at most
    round(gs k cf / E) of the tokens that chose it."""
    b, s, d = x.shape
    groups = x.reshape(b, s, d) if s > 1 else x.reshape(1, b, d)
    routed = dropped = 0
    for xg in groups.numpy():
        logits = xg @ p["router"].numpy()
        gates = np.exp(logits - logits.max(-1, keepdims=True))
        gates /= gates.sum(-1, keepdims=True)
        top = np.argsort(-gates, axis=-1, kind="stable")[:, :cfg.top_k]
        gs = xg.shape[0]
        cap = min(max(1, round(gs * cfg.top_k * cfg.moe_capacity_factor
                               / cfg.n_experts)), gs)
        chose = np.bincount(top.reshape(-1), minlength=cfg.n_experts)
        routed += top.size
        dropped += int(np.maximum(chose - cap, 0).sum())
    return routed, dropped


@pytest.mark.parametrize("b,s,cf", [(2, 21, 1.25), (1, 40, 1.0), (4, 1, 1.25),
                                    (3, 11, 4.0)])
def test_counters_equal_a_host_count(b, s, cf):
    cfg = _cfg(moe_capacity_factor=cf)
    p = _params(cfg, 5)
    x = torch.randn((b, s, cfg.d_model), generator=torch.Generator()
                    .manual_seed(6))
    routed, dropped = _host_count(p, x, cfg)
    trace.drop_device_counts(CPU)
    with trace.unit("test.moe") as u:
        moe.moe_block(p, x, cfg)
        trace.settle_device_counts(CPU)
    assert u.counts["moe.assignments_routed"] == routed == b * s * cfg.top_k
    assert u.counts["moe.assignments_dropped"] == dropped
    if cf == 1.0:
        assert dropped > 0

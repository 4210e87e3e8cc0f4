"""The MoE block's single-token step reading only the experts its tokens
kept (``moe.expert_ffn_decode``; on the CPU its plain version) against the
batched products over every expert that it replaces and against the dense
oracle; the gate that decides which calls take it; and the counters
``moe.decode_experts`` and ``moe.decode_experts_read`` against a count
made on the host.

Tolerances: the same f32 products over a subset of the experts, so
within f32 rounding (1e-5 of the largest |value|); the dense oracle sums
in another order (1e-5 too); empty slots exactly zero."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import trace
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

CPU = torch.device("cpu")
ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b")
BATCHES = (1, 2, 5, 8)
RTOL = 1e-5


def _case(arch, b, seed=0, **over):
    """SMOKE widths in f32, the router widened so that the gates spread,
    deepseek's bias non-zero; x (b, 1, d) with token 1 a copy of token 0,
    so that from batch 2 on two tokens pick the same experts and the
    single-token group drops over capacity."""
    cfg = get_smoke_config(arch).scaled(dtype="float32", **over)
    p = moe.init_moe(torch.Generator().manual_seed(seed), cfg, device=CPU)
    p["router"] = p["router"] * 8.0
    if "router_bias" in p:
        p["router_bias"] = torch.linspace(-0.05, 0.05, cfg.n_experts)
    x = torch.from_numpy(np.random.default_rng(seed + b).standard_normal(
        (b, 1, cfg.d_model)).astype(np.float32))
    if b >= 2:
        x[1] = x[0]
    return cfg, p, x


def _dispatched(p, x, cfg):
    """The single-token group's routing and dispatched slots."""
    b, _, d = x.shape
    xg = x.reshape(1, b, d)
    cap = moe.capacity(cfg, b)
    tok_idx, weight, experts, slot, _ = moe._route(p, xg, cfg, cap)
    return moe._dispatch(xg, tok_idx), weight, experts, slot


def _near(got, want):
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= RTOL * scale


def _run(p, x, cfg):
    """moe_block's output and the unit's counts."""
    trace.drop_device_counts(CPU)
    with trace.unit("test.moe") as u:
        out, _ = moe.moe_block(p, x, cfg)
        trace.settle_device_counts(CPU)
    return out, u.counts


@pytest.fixture()
def spy(monkeypatch):
    """Calls of ``moe.expert_ffn_decode`` (the slot-skipping path)."""
    calls = []
    real = moe.expert_ffn_decode

    def wrapped(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(moe, "expert_ffn_decode", wrapped)
    return calls


# ---------------------------------------------------------------------------
# the plain slot-skipping products against the batched ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", BATCHES)
def test_slot_skipping_matches_the_batched_products(arch, b):
    cfg, p, x = _case(arch, b)
    xd, weight, experts, slot = _dispatched(p, x, cfg)
    valid = weight[0] != 0
    want = moe._expert_ffn(p, xd, cfg)
    got, read = moe.expert_ffn_decode(
        xd, p["w_gate"], p["w_up"], p["w_down"], valid, cfg.act,
        max_kept=b * cfg.top_k)
    assert got.shape == want.shape and got.dtype == want.dtype
    _near(got[valid], want[valid])
    assert bool((got[~valid] == 0).all())
    kept = {int(e) for e in experts[slot >= 0]}
    assert int(read) == len(kept) == int(valid.any(-1).sum())
    if b == 2:                      # the copied token was dropped
        assert bool((slot < 0).any())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", BATCHES)
def test_moe_block_single_token_matches_the_batched_path(arch, b, spy,
                                                         monkeypatch):
    """moe_block at s = 1 through the slot-skipping path and through the
    batched products (the gate closed): outputs within f32 rounding, the
    same experts and slots, the same routed and dropped counts."""
    cfg, p, x = _case(arch, b)
    got, counts = _run(p, x, cfg)
    assert len(spy) == 1
    route = _dispatched(p, x, cfg)[2:]
    monkeypatch.setattr(moe, "DECODE_MAX_SLOTS", 0)
    want, want_counts = _run(p, x, cfg)
    assert len(spy) == 1
    _near(got, want)
    for a, c in zip(route, _dispatched(p, x, cfg)[2:]):
        assert torch.equal(a, c)
    for name in ("moe.assignments_routed", "moe.assignments_dropped"):
        assert counts[name] == want_counts[name]
    if b == 2:
        assert counts["moe.assignments_dropped"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", BATCHES)
def test_slot_skipping_equals_the_dense_oracle_when_lossless(arch, b, spy,
                                                            monkeypatch):
    """At capacity factor E/k every assignment keeps its slot (C = b, the
    gate's slot limit raised to it), and the single-token step equals the
    dense oracle."""
    monkeypatch.setattr(moe, "DECODE_MAX_SLOTS",
                        max(b, moe.DECODE_MAX_SLOTS))
    base = get_smoke_config(arch)
    cfg, p, x = _case(arch, b, moe_capacity_factor=base.n_experts
                      / base.top_k)
    got, counts = _run(p, x, cfg)
    want, _ = moe.moe_block_dense(p, x, cfg)
    assert len(spy) == 1 and counts["moe.assignments_dropped"] == 0
    _near(got, want)


def test_empty_slots_stay_zero_whatever_they_hold():
    """An empty slot of a kept expert holding NaN, and an expert with no
    valid slot at all, read back as zeros; no valid slot anywhere reads no
    expert."""
    cfg, p, x = _case("qwen2-moe-a2.7b", 5)
    xd, weight, _, _ = _dispatched(p, x, cfg)
    valid = weight[0] != 0
    assert bool((~valid).any())
    xd = xd.clone()
    xd[~valid] = float("nan")
    got, read = moe.expert_ffn_decode_plain(
        xd, p["w_gate"], p["w_up"], p["w_down"], valid, cfg.act)
    assert bool(torch.isfinite(got).all())
    assert bool((got[~valid] == 0).all()) and int(read) > 0
    none = torch.zeros_like(valid)
    got, read = moe.expert_ffn_decode_plain(
        xd, p["w_gate"], p["w_up"], p["w_down"], none, cfg.act)
    assert bool((got == 0).all()) and int(read) == 0


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def test_only_the_single_token_step_takes_the_path(spy):
    cfg, p, _ = _case("qwen2-moe-a2.7b", 1)
    x = torch.randn((2, 7, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    moe.moe_block(p, x, cfg)
    assert spy == []
    moe.moe_block(p, x[:, :1], cfg)
    assert len(spy) == 1


def _gate(cfg, p, xd):
    return moe.slot_skipping(p, xd, cfg)


@pytest.mark.parametrize("case", [
    "plain", "no_grad", "grad", "x_grad", "meta", "slots", "act", "dtype",
    "bf16"])
def test_which_tensors_take_the_path(case):
    cfg, p, x = _case("qwen2-moe-a2.7b", 2)
    xd = _dispatched(p, x, cfg)[0]
    want = case in ("plain", "no_grad", "bf16")
    if case in ("grad", "no_grad"):
        p = dict(p, w_up=p["w_up"].clone().requires_grad_(True))
    if case == "x_grad":
        xd = xd.clone().requires_grad_(True)
    if case == "meta":
        p = {k: v.to("meta") for k, v in p.items()}
        xd = xd.to("meta")
    if case == "slots":
        xd = xd.new_zeros((xd.shape[0], moe.DECODE_MAX_SLOTS + 1,
                           xd.shape[2]))
    if case == "act":
        cfg = cfg.scaled(act="relu")
    if case == "dtype":
        xd = xd.bfloat16()
    if case == "bf16":
        p = {k: v.bfloat16() for k, v in p.items()}
        xd = xd.bfloat16()
    if case == "no_grad":
        with torch.no_grad():
            assert _gate(cfg, p, xd) is want
    else:
        assert _gate(cfg, p, xd) is want


def test_weights_that_want_a_gradient_keep_the_batched_path(spy):
    """Training through a single-token step: the batched products, whose
    gradient autograd takes."""
    cfg, p, x = _case("qwen2-moe-a2.7b", 2)
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out, _ = moe.moe_block(p, x, cfg)
    out.square().sum().backward()
    assert spy == []
    assert float(p["w_down"].grad.abs().sum()) > 0


@pytest.fixture()
def one_rank(tmp_path):
    """A world of one gloo rank in this process, for a ``DTensor``."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "pg"), 1), rank=0, world_size=1)
    try:
        yield dist.device_mesh.init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("which", ["xd", "weights"])
def test_a_dtensor_keeps_the_batched_path(one_rank, which):
    from torch.distributed.tensor import Replicate, distribute_tensor
    cfg, p, x = _case("qwen2-moe-a2.7b", 2)
    xd = _dispatched(p, x, cfg)[0]
    assert _gate(cfg, p, xd)
    if which == "xd":
        xd = distribute_tensor(xd, one_rank, [Replicate()])
    else:
        p = dict(p, w_gate=distribute_tensor(p["w_gate"], one_rank,
                                             [Replicate()]))
    assert not _gate(cfg, p, xd)


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b", BATCHES)
def test_decode_counters_equal_a_host_count(arch, b, monkeypatch):
    cfg, p, x = _case(arch, b)
    experts, slot = _dispatched(p, x, cfg)[2:]
    kept = len({int(e) for e in experts[slot >= 0]})
    _, counts = _run(p, x, cfg)
    assert counts["moe.decode_experts"] == cfg.n_experts
    assert counts["moe.decode_experts_read"] == kept
    assert kept <= min(cfg.n_experts, b * cfg.top_k)
    monkeypatch.setattr(moe, "DECODE_MAX_SLOTS", 0)
    _, counts = _run(p, x, cfg)
    assert counts["moe.decode_experts"] == cfg.n_experts
    assert counts["moe.decode_experts_read"] == cfg.n_experts


def test_a_prefill_counts_no_decode_experts():
    cfg, p, _ = _case("qwen2-moe-a2.7b", 1)
    x = torch.randn((2, 9, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    _, counts = _run(p, x, cfg)
    assert "moe.decode_experts" not in counts
    assert "moe.decode_experts_read" not in counts
    assert counts["moe.assignments_routed"] == 2 * 9 * cfg.top_k

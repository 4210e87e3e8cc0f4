"""The port's MoE block (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``) on the CPU, on the reference's
parameters and numpy-seeded inputs.

Tolerances, f32 with matmuls summed in another order: activations, the
aux loss and gradients within ``TOL`` (atol 1e-4, rtol 1e-4, the
gradients of the leaf's largest |g|); router scores within 1e-6;
selections (top-k masks, the tokens each expert keeps, its drops) equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import model as jmdl
from repro.models import moe as jmoe
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import convert, moe
from repro_torch.models import model as mdl
from repro_torch.tree import leaves

TOL = dict(atol=1e-4, rtol=1e-4)
SCORE_TOL = dict(atol=1e-6, rtol=1e-6)
ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b")
CPU = torch.device("cpu")


def _cfgs(arch, **over):
    over.setdefault("dtype", "float32")
    return jget_smoke(arch).scaled(**over), get_smoke_config(arch).scaled(
        **over)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _params(jcfg, seed=1, bias_seed=None):
    """The reference's MoE parameters; deepseek's router bias made
    non-zero (numpy seed) so that it changes the selection."""
    jp = jmoe.init_moe(jax.random.key(seed), jcfg)
    if bias_seed is not None and "router_bias" in jp:
        jp["router_bias"] = jnp.asarray(np.random.default_rng(
            bias_seed).standard_normal(jcfg.n_experts).astype(
                np.float32) * 0.05)
    return jp, _t(jp)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


# ---------------------------------------------------------------------------
# init, router, selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_matches_the_reference_tree(arch):
    jcfg, cfg = _cfgs(arch)
    want = jax.eval_shape(lambda k: jmoe.init_moe(k, jcfg), jax.random.key(0))
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg, device=CPU)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert v.dtype == torch.float32
    assert ("router_bias" in got) == cfg.router_aux_free_bias
    assert ("shared_gate" in got) == cfg.shared_expert_gate
    # fan-in on axis 1 of the (E, d, f) and (E, f, d) experts
    big = get_config(arch).scaled(n_experts=2, d_expert=512)
    w = moe.init_moe(torch.Generator().manual_seed(0), big, device=CPU)
    for name, fan_in in (("w_gate", big.d_model), ("w_down", 512)):
        assert float(w[name].abs().max()) <= 2 * fan_in ** -0.5
        assert abs(float(w[name].std()) * fan_in ** 0.5 - 0.8796) < 0.02
    if "router_bias" in w:
        assert not bool(w["router_bias"].any())


@pytest.mark.parametrize("arch", ARCHS)
def test_router_scores_match(arch):
    """softmax (qwen2-moe) and sigmoid + bias (deepseek: the bias enters
    the selection scores, not the gates)."""
    jcfg, cfg = _cfgs(arch)
    jp, p = _params(jcfg, bias_seed=3)
    x = _x(0, 2, 9, cfg.d_model)
    want = jmoe.router_scores(jp, jnp.asarray(x), jcfg)
    got = moe.router_scores(p, torch.from_numpy(x), cfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, SCORE_TOL)
    if cfg.router_aux_free_bias:
        assert not torch.equal(got[0], got[1])
    else:
        assert torch.equal(got[0], got[1])


def test_topk_mask_and_ties_match_lax_top_k():
    """Equal scores go to the lower index first, as jax.lax.top_k puts
    them: rows with every value tied, pairs of tied columns, -inf."""
    rng = np.random.default_rng(4)
    sel = rng.integers(0, 4, (6, 40, 12)).astype(np.float32)
    sel[0] = 1.0                                     # every expert tied
    sel[1, :, ::3] = -np.inf
    for k in (1, 2, 5, 12):
        want = jmoe._topk_mask(jnp.asarray(sel), k)
        got = moe._topk_mask(torch.from_numpy(sel), k)
        assert np.array_equal(got.numpy(), np.asarray(want))
        _, jidx = jax.lax.top_k(jnp.asarray(sel), k)
        assert np.array_equal(moe.topk_indices(torch.from_numpy(sel),
                                               k).numpy(), np.asarray(jidx))


def test_load_balance_loss_and_normalized_gates():
    rng = np.random.default_rng(5)
    gates = rng.random((3, 17, 8)).astype(np.float32)
    mask = rng.random((3, 17, 8)) < 0.3
    mask[0, 0] = False                               # no expert: 1e-9 floor
    _close(moe.load_balance_loss(torch.from_numpy(gates),
                                 torch.from_numpy(mask), 2),
           jmoe.load_balance_loss(jnp.asarray(gates), jnp.asarray(mask), 2),
           SCORE_TOL)
    _close(moe._normalized_gates(torch.from_numpy(gates),
                                 torch.from_numpy(mask)),
           jmoe._normalized_gates(jnp.asarray(gates), jnp.asarray(mask)),
           SCORE_TOL)


@pytest.mark.parametrize("gs,k,cf,e,want", [
    (16, 2, 1.25, 8, 5),          # 5.0
    (21, 2, 1.25, 8, 7),          # 6.5625
    (4, 4, 1.25, 60, 1),          # qwen2-moe decode: round(0.33) -> floor 1
    (4000, 4, 1.25, 60, 333),     # qwen2-moe prefill
    (1024, 8, 1.25, 256, 40),     # deepseek's served prompt
    (2, 1, 1.25, 1, 2),           # round(2.5) = 2: ties to even
    (6, 1, 1.25, 1, 6),           # round(7.5) = 8, then at most the group
    (10, 1, 0.5, 2, 2),           # round(2.5) = 2
    (14, 1, 0.5, 2, 4)])          # round(3.5) = 4
def test_capacity_rounds_as_python(gs, k, cf, e, want):
    cfg = get_smoke_config("qwen2-moe-a2.7b").scaled(
        top_k=k, moe_capacity_factor=cf, n_experts=e)
    assert moe.capacity(cfg, gs) == want


def test_shard_dispatch_is_the_identity():
    t = torch.zeros(2, 3, 4, 5)
    assert moe._shard_dispatch(t) is t


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("b,s", [(2, 21), (3, 1), (1, 40)])
@pytest.mark.parametrize("lossless", [False, True])
def test_moe_block_matches_the_reference(arch, b, s, lossless):
    """Groups per batch row (s > 1) or one group over the batch (s = 1,
    decode), at capacity 1.25 (tokens dropped) and at E/k (lossless)."""
    over = {"moe_capacity_factor": 4.0} if lossless else {}
    jcfg, cfg = _cfgs(arch, **over)
    jp, p = _params(jcfg, bias_seed=6)
    x = _x(7, b, s, cfg.d_model)
    want, waux = jmoe.moe_block(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_block(p, torch.from_numpy(x), cfg)
    _close(got, want)
    _close(aux, waux, SCORE_TOL)
    if lossless:
        dense, daux = moe.moe_block_dense(p, torch.from_numpy(x), cfg)
        _close(got, dense)
        assert float(aux) == float(daux)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_tokens_as_the_reference_does(arch):
    """At capacity 1.25 some tokens lose an expert: the port keeps the
    same (group, expert) slots, and differs from the dense oracle."""
    jcfg, cfg = _cfgs(arch)
    jp, p = _params(jcfg, bias_seed=8)
    x = _x(9, 2, 32, cfg.d_model)
    xg = torch.from_numpy(x)
    cap = moe.capacity(cfg, 32)
    tok_idx, weight, experts, slot, _ = moe._route(p, xg, cfg, cap)
    assert bool((slot < 0).any()), "no token was dropped"
    # the reference's own selection
    gates, sel, _ = jmoe.router_scores(jp, jnp.asarray(x), jcfg)
    mask = jmoe._topk_mask(sel, jcfg.top_k)
    prio = jnp.swapaxes(jnp.where(mask, sel, -jnp.inf), 1, 2)
    top_prio, jtok = jax.lax.top_k(prio, cap)
    valid = np.isfinite(np.asarray(top_prio))
    assert np.array_equal(np.where(valid, tok_idx.numpy(), -1),
                          np.where(valid, np.asarray(jtok), -1))
    assert np.array_equal(weight.numpy() > 0, valid)
    got, _ = moe.moe_block(p, xg, cfg)
    dense, _ = moe.moe_block_dense(p, xg, cfg)
    assert not np.allclose(got.numpy(), dense.numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [1, 12])
def test_exact_ties_choose_what_lax_top_k_chooses(arch, s):
    """Identical token rows tie exactly in every expert's priority; at
    capacity below the group the lower token index keeps the slot, as
    in the reference.  Two identical expert columns of the router tie
    within each token."""
    jcfg, cfg = _cfgs(arch, moe_capacity_factor=0.5)
    jp, _ = _params(jcfg, bias_seed=None)
    router = np.array(jp["router"])
    router[:, 3] = router[:, 1]                       # tied experts
    jp["router"] = jnp.asarray(router)
    p = _t(jp)
    row = _x(10, cfg.d_model)
    x = np.broadcast_to(row, (4, s, cfg.d_model)).copy()
    x[:, ::2] = _x(11, cfg.d_model)                   # two tied row kinds
    want, _ = jmoe.moe_block(jp, jnp.asarray(x), jcfg)
    got, _ = moe.moe_block(p, torch.from_numpy(x), cfg)
    _close(got, want)
    # the selections themselves, -inf (empty) slots included
    g, gs = (4, s) if s > 1 else (1, 4)
    xg = x.reshape(g, gs, cfg.d_model)
    cap = moe.capacity(cfg, gs)
    tok_idx, _, _, slot, _ = moe._route(p, torch.from_numpy(xg), cfg, cap)
    _, sel, _ = jmoe.router_scores(jp, jnp.asarray(xg), jcfg)
    mask = jmoe._topk_mask(sel, jcfg.top_k)
    assert np.array_equal(mask[..., 1], mask[..., 3]) or \
        cfg.router_aux_free_bias
    prio = jnp.swapaxes(jnp.where(mask, sel, -jnp.inf), 1, 2)
    assert np.array_equal(tok_idx.numpy(),
                          np.asarray(jax.lax.top_k(prio, cap)[1]))
    assert bool((slot < 0).any())                     # ties were dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_dense_matches_the_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp, p = _params(jcfg, bias_seed=12)
    x = _x(13, 2, 11, cfg.d_model)
    want, waux = jmoe.moe_block_dense(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_block_dense(p, torch.from_numpy(x), cfg)
    _close(got, want)
    _close(aux, waux, SCORE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradient_matches_the_reference(arch):
    """d(sum(out * ct) + aux)/d(params, x) against jax.grad, through the
    gathers, the weights and the combine; the router bias gets none."""
    jcfg, cfg = _cfgs(arch)
    jp, p = _params(jcfg, bias_seed=14)
    x = _x(15, 2, 16, cfg.d_model)
    ct = _x(16, 2, 16, cfg.d_model)

    def jloss(jp, x):
        out, aux = jmoe.moe_block(jp, x, jcfg)
        return jnp.sum(out * ct) + aux
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    names = sorted(p)
    flat = [p[n].requires_grad_(True) for n in names]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_block(p, xt, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum() + aux,
                                flat + [xt], allow_unused=True,
                                materialize_grads=True)
    for name, g in zip(names + ["x"], grads):
        w = np.asarray(jgx if name == "x" else jg[name])
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale, name
    if "router_bias" in p:
        assert not bool(grads[names.index("router_bias")].any())


def test_expert_load_and_router_bias_update():
    jcfg, cfg = _cfgs("deepseek-v3-671b")
    jp, p = _params(jcfg, bias_seed=17)
    x = _x(18, 3, 10, cfg.d_model)
    want = jmoe.expert_load(jp, jnp.asarray(x), jcfg)
    load = moe.expert_load(p, torch.from_numpy(x), cfg)
    _close(load, want, SCORE_TOL)
    assert abs(float(load.sum()) - cfg.top_k) < 1e-6
    want = jmoe.update_router_bias(jp["router_bias"], want, 0.01)
    _close(moe.update_router_bias(p["router_bias"], load, 0.01), want,
           SCORE_TOL)


# ---------------------------------------------------------------------------
# the parameter trees of the MoE models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,full,active", [
    ("qwen2-moe-a2.7b", 14_315_784_192, 2_689_173_504),
    ("deepseek-v3-671b", 682_636_487_424, 38_240_398_080)])
def test_count_params_full_configs(arch, full, active):
    """Full and active counts at full width, from the port's init on
    the meta device (nothing allocated), equal to the reference's."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert mdl.count_params_analytic(cfg) == \
        jmdl.count_params_analytic(jcfg) == full
    assert mdl.count_params_analytic(cfg, active_only=True) == \
        jmdl.count_params_analytic(jcfg, active_only=True) == active
    assert cfg.param_count() == full and cfg.active_param_count() == active


def test_deepseek_cut_to_four_layers_counts_as_served():
    """chip_smoke's [serve-mla] model: 3 dense + 1 MoE layer, no MTP."""
    cut = dict(n_layers=4, mtp_depth=0)
    assert mdl.count_params_analytic(get_config(
        "deepseek-v3-671b").scaled(**cut)) == jmdl.count_params_analytic(
        jget_config("deepseek-v3-671b").scaled(**cut)) == 15_111_101_696


@pytest.mark.parametrize("arch,n_layers", [("qwen2-moe-a2.7b", 24),
                                           ("deepseek-v3-671b", 4)])
def test_scan_layout_of_moe_layers_unstacks_in_order(arch, n_layers):
    """The reference stacks qwen2-moe's 24 MoE layers (reps 24) for its
    scan; deepseek keeps its dense first layer as the prefix and its
    MTP block unstacked.  Each maps onto the port's own layer."""
    jcfg, cfg = _cfgs(arch, n_layers=n_layers)
    jp = jmdl.init_params(jax.random.key(0), jcfg)
    reps = n_layers - cfg.n_dense_layers
    assert jp["decoder"]["scan"][0]["moe"]["w_gate"].shape[0] == reps
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device=CPU)
    body = params["decoder"]["unrolled"]
    assert len(body) == reps and len(params["decoder"]["prefix"]) == \
        cfg.n_dense_layers
    for r in (0, reps - 1):
        assert np.array_equal(
            body[r]["moe"]["w_down"].numpy(),
            np.asarray(jp["decoder"]["scan"][0]["moe"]["w_down"][r]))
    for pre in params["decoder"]["prefix"]:
        assert "mlp" in pre and "moe" not in pre
        assert pre["mlp"]["wo"].shape[0] == cfg.dense_d_ff
    if cfg.mtp_depth:
        assert "moe" in params["mtp"]["block"]
    shapes = leaves(mdl.params_like(cfg))
    assert [tuple(t.shape) for t in leaves(params)] == \
        [tuple(t.shape) for t in shapes]

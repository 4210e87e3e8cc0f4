"""The port's Multi-head Latent Attention (``repro_torch.models.mla``),
deepseek's MoE blocks and its multi-token prediction against the
reference on the CPU, on the reference's parameters and numpy-seeded
inputs.

Tolerances, f32 with matmuls summed in another order: activations and
caches within ``TOL`` (atol 1e-4, rtol 1e-4); the absorbed decode
against the expanded form and full-model logits within ``LOGIT_TOL``
(atol 2e-4, rtol 1e-4, as ``test_torch_models.py``); the MTP loss within
1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro.models import model as jmdl
from repro.models import transformer as jtfm
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert, mla
from repro_torch.models import model as mdl
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_map

TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
ARCH = "deepseek-v3-671b"
CPU = torch.device("cpu")


def _cfgs(**over):
    over.setdefault("dtype", "float32")
    return jget_smoke(ARCH).scaled(**over), get_smoke_config(ARCH).scaled(
        **over)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def _pos(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


def _mla_params(jcfg, seed=2):
    jp = jmla.init_mla(jax.random.key(seed), jcfg)
    # non-trivial norm scales so the latent norms are exercised
    jp["q_norm"] = jnp.asarray(1 + 0.1 * _x(seed + 100, jcfg.q_lora_rank))
    jp["kv_norm"] = jnp.asarray(1 + 0.1 * _x(seed + 101, jcfg.kv_lora_rank))
    return jp, _t(jp)


def test_init_mla_matches_the_reference_tree():
    jcfg, cfg = _cfgs()
    want = jax.eval_shape(lambda k: jmla.init_mla(k, jcfg), jax.random.key(0))
    got = mla.init_mla(torch.Generator().manual_seed(0), cfg, device=CPU)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
    assert torch.equal(got["q_norm"], torch.ones(cfg.q_lora_rank))


def test_queries_and_latent_kv():
    jcfg, cfg = _cfgs()
    jp, p = _mla_params(jcfg)
    x, pos = _x(0, 2, 9, cfg.d_model), _pos(2, 9, start=3)
    for jfn, fn in ((jmla._queries, mla._queries),
                    (jmla._latent_kv, mla._latent_kv)):
        want = jfn(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
        got = fn(p, torch.from_numpy(x), torch.from_numpy(pos), cfg)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w)


@pytest.mark.parametrize("chunked", [False, True])
def test_mla_attention_expanded_form(chunked, monkeypatch):
    """The dense path, and the chunked one (the reference's
    ``set_attention_impl("chunked")``, the port's threshold lowered)."""
    jcfg, cfg = _cfgs()
    jp, p = _mla_params(jcfg)
    x, pos = _x(1, 2, 37, cfg.d_model), _pos(2, 37)
    if chunked:
        monkeypatch.setattr(mla, "CHUNKED_THRESHOLD", 1)
        jattn.set_attention_impl("chunked")
    try:
        want = jmla.mla_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    finally:
        jattn.set_attention_impl("auto")
    got = mla.mla_attention(p, torch.from_numpy(x), torch.from_numpy(pos),
                            cfg)
    _close(got, want)


def test_mla_prefill_then_absorbed_decode_match_the_reference():
    """The latent cache after prefill and five absorbed decode steps,
    outputs and caches."""
    jcfg, cfg = _cfgs()
    jp, p = _mla_params(jcfg, seed=3)
    s, max_len = 13, 24
    x, pos = _x(2, 2, s, cfg.d_model), _pos(2, s)
    jc = jmla.init_mla_cache(jcfg, 2, max_len, jnp.float32)
    c = mla.init_mla_cache(cfg, 2, max_len, torch.float32, CPU)
    want, jc = jmla.mla_prefill(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                jc)
    got, c = mla.mla_prefill(p, torch.from_numpy(x), torch.from_numpy(pos),
                             cfg, c)
    _close(got, want)
    for i in range(5):
        for name in ("ckv", "kpe"):
            _close(c[name], jc[name])
        assert np.array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
        xt = _x(50 + i, 2, 1, cfg.d_model)
        want, jc = jmla.mla_decode(jp, jnp.asarray(xt), jnp.int32(s + i),
                                   jcfg, jc)
        got, c = mla.mla_decode(p, torch.from_numpy(xt), s + i, cfg, c)
        _close(got, want)


def test_absorbed_decode_equals_the_expanded_form():
    """Prefill of n - 1 tokens then the absorbed decode of token n gives
    the expanded form's output at position n - 1 over all n tokens."""
    jcfg, cfg = _cfgs()
    _, p = _mla_params(jcfg, seed=4)
    n = 17
    x = torch.from_numpy(_x(3, 2, n, cfg.d_model))
    full = mla.mla_attention(p, x, torch.from_numpy(_pos(2, n)), cfg)
    c = mla.init_mla_cache(cfg, 2, n + 3, torch.float32, CPU)
    head, c = mla.mla_prefill(p, x[:, :n - 4], torch.from_numpy(
        _pos(2, n - 4)), cfg, c)
    _close(head, full[:, :n - 4].numpy(), LOGIT_TOL)
    for i in range(n - 4, n):
        out, c = mla.mla_decode(p, x[:, i:i + 1], i, cfg, c)
        _close(out, full[:, i:i + 1].numpy(), LOGIT_TOL)


def _layer_tree(jcfg, cfg, layer_idx):
    jp = jtfm.init_block(jax.random.key(layer_idx + 5), jcfg, "global",
                         layer_idx)
    return jp, tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                        jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("layer_idx", [0, 1])
@pytest.mark.parametrize("dense_oracle", [False, True])
def test_deepseek_blocks_train_mode(layer_idx, dense_oracle):
    """Layer 0 is a dense prefix layer (MLA + MLP of dense_d_ff), layer 1
    a MoE layer (MLA + sigmoid router + shared expert): x and the aux
    loss against the reference's block, and through the dense oracle."""
    jcfg, cfg = _cfgs()
    jp, p = _layer_tree(jcfg, cfg, layer_idx)
    assert ("moe" in p) == (layer_idx >= cfg.n_dense_layers)
    if "mlp" in p:
        assert p["mlp"]["wi_gate"].shape[1] == cfg.dense_d_ff
    x, pos = _x(4, 2, 12, cfg.d_model), _pos(2, 12)
    want, waux, _ = jtfm.block_forward(jp, jnp.asarray(x), jcfg, "global",
                                       mode="train",
                                       positions=jnp.asarray(pos),
                                       moe_dense_oracle=dense_oracle)
    got, aux, cache = tfm.block_forward(p, torch.from_numpy(x), cfg,
                                        "global", mode="train",
                                        positions=torch.from_numpy(pos),
                                        moe_dense_oracle=dense_oracle)
    assert cache is None
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(waux), atol=1e-6, rtol=1e-6)
    assert (float(aux) > 0) == ("moe" in p)


def _model(jcfg, cfg, seed=0):
    jp = jmdl.init_params(jax.random.key(seed), jcfg)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                       device=CPU)


def test_mtp_loss_matches_the_reference():
    """The MTP head alone: [norm(h_t); norm(emb(t+1))] -> proj -> the MoE
    block at layer n_layers -> its own final norm -> the shared head."""
    jcfg, cfg = _cfgs()
    jp, params = _model(jcfg, cfg)
    assert "moe" in params["mtp"]["block"]
    batch = mdl.make_batch(3, cfg, 2, 15)
    hidden = _x(5, 2, 15, cfg.d_model)
    want = jmdl._mtp_loss(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                          jcfg, jnp.asarray(hidden))
    got = mdl._mtp_loss(params, batch, cfg, torch.from_numpy(hidden), True)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert mdl.MTP_LOSS_WEIGHT == jmdl.MTP_LOSS_WEIGHT == 0.3


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", ARCH])
def test_prefill_and_decode_equal_the_full_forward_when_lossless(arch):
    """The reference's own invariant (``tests/test_models.py``) on the
    port: at capacity E/k, prefill of n - 1 tokens plus one decode step
    give the full forward's logits at n - 2 and n - 1."""
    cfg = get_smoke_config(arch)
    cfg = cfg.scaled(moe_capacity_factor=cfg.n_experts / cfg.top_k,
                     dtype="float32")
    params = mdl.init_params(cfg, device=CPU)
    n = 12
    batch = mdl.make_batch(6, cfg, 2, n)
    full, _, _ = mdl.forward_train(params, batch, cfg)
    cache = mdl.init_decode_state(cfg, 2, n + 4, dtype=torch.float32,
                                  device=CPU)
    lg, cache = mdl.prefill(params, {"tokens": batch["tokens"][:, :n - 1]},
                            cfg, cache)
    _close(lg, full[:, n - 2].detach().numpy(), LOGIT_TOL)
    lg, cache = mdl.decode_step(params, torch.from_numpy(
        batch["tokens"][:, n - 1:]), n - 1, cfg, cache)
    _close(lg, full[:, n - 1].detach().numpy(), LOGIT_TOL)


def test_forward_train_with_the_dense_oracle_matches_the_reference():
    jcfg, cfg = _cfgs()
    jp, params = _model(jcfg, cfg)
    batch = mdl.make_batch(7, cfg, 2, 10)
    want, waux, _ = jmdl.forward_train(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        moe_dense_oracle=True)
    got, aux, _ = mdl.forward_train(params, batch, cfg,
                                    moe_dense_oracle=True)
    _close(got, want, LOGIT_TOL)
    _close(aux, waux, dict(atol=1e-6, rtol=1e-5))

"""The port's model stack (``repro_torch.models``) against the reference
(``repro.models``) on the CPU, on the same parameters and inputs: the
reference's parameters go through ``params_from_jax`` (layer tests hand
over each layer's tree the same way), inputs are made with numpy.

Tolerance: f32 with matmuls summed in another order (and the reference's
associative scan against the port's kernel path): activations within
``TOL`` (atol 1e-4, rtol 1e-4); logits of the 4- and 7-layer smoke
models within ``LOGIT_TOL`` (atol 2e-4, rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as jmdl
from repro.models import rglru as jrglru
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention, common, convert, rglru
from repro_torch.models import model as mdl
from repro_torch.models import transformer as tfm

TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
ARCH = "recurrentgemma-9b"
CPU = torch.device("cpu")


def _cfgs(**over):
    """The same smoke configuration from both packages, in f32."""
    over.setdefault("dtype", "float32")
    return jget_smoke(ARCH).scaled(**over), get_smoke_config(ARCH).scaled(
        **over)


def _t(tree):
    """A reference tree (jax or numpy leaves) as torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm(zero_centered):
    x, w = _x(0, 3, 5, 64), _x(1, 64, scale=0.1)
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                            zero_centered=zero_centered)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                          zero_centered=zero_centered)
    _close(got, want, dict(atol=1e-6, rtol=1e-6))


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_activation_is_the_reference_form(name):
    """gelu is the tanh form (jax ``approximate=True``), not erf."""
    x = _x(2, 1000, scale=3.0)
    want = jcommon.activation(name)(jnp.asarray(x))
    _close(common.activation(name)(torch.from_numpy(x)), want,
           dict(atol=1e-6, rtol=1e-6))


def test_softcap():
    x = _x(3, 100, scale=60.0)
    _close(common.softcap(torch.from_numpy(x), 30.0),
           jcommon.softcap(jnp.asarray(x), 30.0), dict(atol=1e-5, rtol=1e-6))
    t = torch.from_numpy(x)
    assert common.softcap(t, 0.0) is t                # cap 0: no capping


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope(fraction):
    x = _x(4, 2, 11, 3, 16)
    pos = np.arange(11, dtype=np.int32)[None].repeat(2, 0) + 5
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                              fraction)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10000.0, fraction)
    _close(got, want, dict(atol=2e-5, rtol=1e-5))


def test_dense_init_is_a_truncated_fan_in_normal():
    g = torch.Generator().manual_seed(0)
    w = common.dense_init(g, (256, 512))
    assert w.dtype == torch.float32 and w.shape == (256, 512)
    std = 256 ** -0.5
    assert float(w.abs().max()) <= 2 * std
    # truncation at +-2 sigma shrinks the std by ~0.88
    assert abs(float(w.std()) / std - 0.8796) < 0.02
    e = common.embed_init(g, (1000, 64))
    assert abs(float(e.std()) * 8 - 1.0) < 0.02


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_mlp_and_norm():
    jcfg, cfg = _cfgs()
    jp = jtfm.init_mlp(jax.random.key(1), jcfg, jcfg.d_ff)
    x = _x(5, 2, 7, jcfg.d_model)
    want = jtfm.mlp_forward(jp, jnp.asarray(x), jcfg)
    _close(tfm.mlp_forward(_t(jp), torch.from_numpy(x), cfg), want)
    jn = {"scale": jnp.asarray(_x(6, jcfg.d_model))}
    _close(tfm.apply_norm(_t(jn), torch.from_numpy(x), cfg),
           jtfm.apply_norm(jn, jnp.asarray(x), jcfg),
           dict(atol=1e-6, rtol=1e-6))


@pytest.mark.parametrize("kind,s,max_len", [("local", 21, 40),
                                            ("local", 6, 40),
                                            ("global", 21, 40)])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_attention_prefill_then_decode(kind, s, max_len, use_kernels):
    """Prefill (ring cache past the window for local s=21 > 8) and five
    decode steps against the reference, outputs and caches."""
    jcfg, cfg = _cfgs()
    window = jcfg.local_window if kind == "local" else 0
    jp = jattn.init_attention(jax.random.key(2), jcfg)
    p = _t(jp)
    x = _x(7, 2, s, jcfg.d_model)
    pos = np.arange(s, dtype=np.int32)[None].repeat(2, 0)
    jc = jattn.init_cache(jcfg, 2, max_len, kind, jnp.float32)
    c = attention.init_cache(cfg, 2, max_len, kind, torch.float32, CPU)
    want, jc = jattn.prefill_attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                       jcfg, jc, window=window)
    got, c = attention.prefill_attention(p, torch.from_numpy(x),
                                         torch.from_numpy(pos), cfg, c,
                                         window=window,
                                         use_kernels=use_kernels)
    _close(got, want)
    for name in ("k", "v"):
        _close(c[name], jc[name])
    assert np.array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
    for i in range(5):
        xt = _x(100 + i, 2, 1, jcfg.d_model)
        want, jc = jattn.decode_attention(jp, jnp.asarray(xt),
                                          jnp.int32(s + i), jcfg, jc,
                                          window=window)
        got, c = attention.decode_attention(p, torch.from_numpy(xt), s + i,
                                            cfg, c, window=window)
        _close(got, want)
        assert np.array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("window", [0, 5])
def test_attend_chunked_and_dense(window):
    jcfg, cfg = _cfgs()
    q, k, v = _x(8, 2, 37, 4, 16), _x(9, 2, 37, 1, 16), _x(10, 2, 37, 1, 16)
    pos = np.arange(37, dtype=np.int32)
    want = jattn.attend_chunked(*map(jnp.asarray, (q, k, v, pos, pos)),
                                jcfg, causal=True, window=window, chunk=16)
    got = attention.attend_chunked(*map(torch.from_numpy, (q, k, v, pos,
                                                           pos)),
                                   cfg, causal=True, window=window, chunk=16)
    _close(got, want)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    want = jattn.attend_dense(*map(jnp.asarray, (q, k, v, mask)), jcfg)
    _close(attention.attend_dense(*map(torch.from_numpy, (q, k, v, mask)),
                                  cfg), want)


def test_self_attention_and_head_maps():
    jcfg, cfg = _cfgs()
    jp = jattn.init_attention(jax.random.key(3), jcfg)
    x = _x(11, 2, 13, jcfg.d_model)
    pos = np.arange(13, dtype=np.int32)[None].repeat(2, 0)
    want = jattn.self_attention(jp, jnp.asarray(x), jnp.asarray(pos), jcfg,
                                window=4)
    for use_kernels in (True, False):
        _close(attention.self_attention(_t(jp), torch.from_numpy(x),
                                        torch.from_numpy(pos), cfg, window=4,
                                        use_kernels=use_kernels), want)
    padded = (jget_config("qwen2.5-32b"), get_config("qwen2.5-32b"))
    from repro.configs.base import apply_tp_padding as japply
    from repro_torch.configs.base import apply_tp_padding
    assert jattn.head_maps(japply(padded[0], 16)) == \
        attention.head_maps(apply_tp_padding(padded[1], 16))


def test_kernel_path_needs_positions_from_zero():
    jcfg, cfg = _cfgs()
    p = _t(jattn.init_attention(jax.random.key(3), jcfg))
    x = torch.from_numpy(_x(12, 1, 9, jcfg.d_model))
    c = attention.init_cache(cfg, 1, 16, "local", torch.float32, CPU)
    with pytest.raises(ValueError):
        attention.prefill_attention(p, x, torch.arange(9)[None] + 3, cfg, c,
                                    window=8)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_rglru_block_prefill_decode(use_kernels):
    jcfg, cfg = _cfgs()
    jp = jrglru.init_rglru(jax.random.key(4), jcfg)
    p = _t(jp)
    x = _x(13, 2, 19, jcfg.d_model)
    h0 = _x(14, 2, jcfg.lru_width)
    conv = _x(15, 2, jcfg.ssm_conv - 1, jcfg.lru_width)
    want = jrglru.rglru_block(jp, jnp.asarray(x), jcfg, h0=jnp.asarray(h0),
                              conv_state=jnp.asarray(conv))
    got = rglru.rglru_block(p, torch.from_numpy(x), cfg,
                            h0=torch.from_numpy(h0),
                            conv_state=torch.from_numpy(conv),
                            use_kernels=use_kernels)
    for g, w in zip(got, want):
        _close(g, w)
    jc = jrglru.init_rglru_cache(jcfg, 2)
    c = rglru.init_rglru_cache(cfg, 2, device=CPU)
    want, jc = jrglru.rglru_prefill(jp, jnp.asarray(x), jcfg, jc)
    got, c = rglru.rglru_prefill(p, torch.from_numpy(x), cfg, c,
                                 use_kernels=use_kernels)
    _close(got, want)
    for i in range(4):
        xt = _x(200 + i, 2, 1, jcfg.d_model)
        want, jc = jrglru.rglru_decode(jp, jnp.asarray(xt), jcfg, jc)
        got, c = rglru.rglru_decode(p, torch.from_numpy(xt), cfg, c)
        _close(got, want)
        _close(c["h"], jc["h"])
        _close(c["conv"], jc["conv"])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _jax_serve(jcfg, params, tokens, gen_tokens):
    """Reference prefill + decode logits, fed ``gen_tokens``."""
    b, s = tokens.shape
    cache = jmdl.init_decode_state(jcfg, b, s + 16, dtype=jnp.float32)
    logits, cache = jmdl.prefill(params, {"tokens": jnp.asarray(tokens)},
                                 jcfg, cache)
    out = [np.asarray(logits)]
    for i, t in enumerate(gen_tokens):
        logits, cache = jmdl.decode_step(params, jnp.asarray(t[:, None]),
                                         jnp.int32(s + i), jcfg, cache)
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("n_layers,layout", [(4, "unrolled"), (7, "scan")])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_logits_match_reference(n_layers, layout,
                                                   use_kernels):
    """recurrentgemma smoke, prompt 21 > window 8: 4 layers is one
    pattern repeat plus an extra layer (unrolled layout); 7 layers is two
    repeats (the reference's stacked scan layout) plus an extra layer."""
    jcfg, cfg = _cfgs(n_layers=n_layers)
    jparams = jmdl.init_params(jax.random.key(0), jcfg)
    assert layout in jparams["decoder"]
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    tokens = np.random.default_rng(n_layers).integers(
        0, jcfg.vocab_real, (2, 21)).astype(np.int32)
    gen = [np.random.default_rng(i).integers(0, jcfg.vocab_real, 2)
           for i in range(4)]
    want = _jax_serve(jcfg, jparams, tokens, gen)
    cache = mdl.init_decode_state(cfg, 2, 21 + 16, dtype=torch.float32,
                                  device="cpu")
    logits, cache = mdl.prefill(params, {"tokens": tokens}, cfg, cache,
                                use_kernels=use_kernels)
    got = [logits]
    for i, t in enumerate(gen):
        logits, cache = mdl.decode_step(params, torch.from_numpy(t)[:, None],
                                        21 + i, cfg, cache)
        got.append(logits)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, LOGIT_TOL)


def test_param_tree_matches_reference_shapes():
    jcfg, cfg = _cfgs(n_layers=7)
    jshapes = jax.eval_shape(lambda k: jmdl.init_params(k, jcfg),
                             jax.random.key(0))
    n_j = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))
    params = mdl.init_params(cfg, device="cpu")
    n_p = sum(t.numel() for t in mdl.leaves(params))
    assert n_p == n_j == mdl.count_params_analytic(cfg)


def test_count_params_full_config():
    """recurrentgemma-9b at full width: 9,627,414,528, the reference's
    count (from the port's init on the meta device; nothing allocated)."""
    n = mdl.count_params_analytic(get_config(ARCH))
    assert n == jmdl.count_params_analytic(jget_config(ARCH)) == 9_627_414_528
    assert get_config(ARCH).param_count() == n


def test_unported_kinds_raise():
    for arch in ("deepseek-v3-671b", "whisper-large-v3",
                 "llama-3.2-vision-90b", "qwen2-moe-a2.7b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            mdl.init_params(get_smoke_config(arch), device="cpu")
    jcfg, cfg = _cfgs()
    params = mdl.init_params(cfg, device="cpu")
    cache = mdl.init_decode_state(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mdl.prefill(params, {"tokens": np.zeros((1, 4), np.int32),
                             "frames": None}, cfg, cache)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfm.block_forward(params["decoder"]["unrolled"][0],
                          torch.zeros(1, 2, cfg.d_model), cfg, "rglru",
                          mode="train")

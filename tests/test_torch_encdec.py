"""The port's encoder, encoder-decoder and cross-attention families
against the reference on the CPU: whisper-large-v3 (LayerNorm with bias,
GELU MLP with biases, the bidirectional ``encoder`` blocks, the ``encdec``
self + cross blocks, sinusoid positions) and llama-3.2-vision (the gated
``cross`` blocks), on the same numpy inputs and ``params_from_jax``
weights.

Three whole models: whisper smoke as configured (its decoder is plain
``global`` blocks, so the encoder's output is never read: the reference's
jitted prefill drops it, ROADMAP C20), whisper smoke with
``attn_pattern=("encdec",)`` (the decoder reads the encoder), and
llama-vision smoke at 5 layers (unrolled) and 10 (the reference's scan
layout).  Vision's ``gate`` and ``mlp_gate`` start at 0 and tanh(0) = 0,
which makes a cross layer the identity (C22): every vision test sets
both gates from a numpy seed to nonzero values in both trees.

Tolerances, f32 with sums in another order: block outputs, caches and
the encoder within ``TOL`` (atol 1e-4, rtol 1e-4); logits within
``LOGIT_TOL`` (atol 2e-4, rtol 1e-4), as ``test_torch_models.py``; the
loss within 1e-5 relative and each gradient leaf within 1e-4 of the
leaf's largest |g|, as ``test_torch_train.py``, plus 1e-7 of the tree's
largest |g| (the key bias's gradient is rounding only).  The non-causal B5
route (``use_kernels``) runs ``flash_attention_plain`` here; it is held
to the reference's ``attend_dense``, never to its padded Pallas kernel
(C3).

In the configs' own bf16 the port is held to the reference's bf16 by
|a - b| / |b| over the whole output, averaged over the steps: within
``BF16_RMS`` of it, and no farther from the reference's f32 than
``BF16_NOISE`` times the reference's own bf16 is (both round every op
to bf16, at other places: ROADMAP C23; the readings are in PERF.md).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import attention as jattn
from repro.models import model as jmdl
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention, convert
from repro_torch.models import model as mdl
from repro_torch.models import transformer as tfm
from repro_torch.tree import leaves

TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
BF16_RMS = 2.5e-2
BF16_NOISE = 1.25
WHISPER, VISION = "whisper-large-v3", "llama-3.2-vision-90b"
CPU = "cpu"
PROMPT, STEPS = 11, 4
# name -> (arch, overrides of the smoke config)
MODELS = {
    "whisper": (WHISPER, {}),
    "whisper-encdec": (WHISPER, {"attn_pattern": ("encdec",)}),
    "vision-5": (VISION, {}),
    "vision-10": (VISION, {"n_layers": 10}),
}


def _cfgs(arch, **over):
    """The same smoke configuration from both packages, in f32."""
    over.setdefault("dtype", "float32")
    return jget_smoke(arch).scaled(**over), get_smoke_config(arch).scaled(
        **over)


def _t(tree):
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


def _set_gates(tree, seed):
    """Both tanh gates of every ``cross`` block of a numpy parameter tree
    (a block dict, a list of them, or a stacked scan tree) drawn from
    ``seed`` in [0.3, 0.9), in place; returns the tree."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            if "mlp_gate" in t:
                shape = np.shape(t["mlp_gate"])
                t["mlp_gate"] = rng.uniform(0.3, 0.9, shape).astype(
                    np.float32)
                t["mixer"]["gate"] = rng.uniform(0.3, 0.9, shape).astype(
                    np.float32)
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(tree)
    return tree


def _model(name, scan_layers=True):
    """-> (jcfg, cfg, the reference's params (jnp), the port's)."""
    arch, over = MODELS[name]
    jcfg, cfg = _cfgs(arch, **over)
    jp = jax.tree.map(np.asarray, jmdl.init_params(
        jax.random.key(0), jcfg, scan_layers=scan_layers))
    _set_gates(jp, 5)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, jp),
            convert.params_from_jax(jp, cfg, device=CPU))


def _extras(cfg, b, seed):
    """The stub frontend's input for ``cfg``, numpy f32 from ``seed``."""
    if cfg.is_encoder_decoder:
        return {"frames": _x(seed, b, cfg.encoder_seq, cfg.d_model)}
    return {"image_embeds": _x(seed, b, cfg.n_image_tokens, cfg.d_model)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layernorm_and_gelu_mlp():
    """The audio family's LayerNorm (scale and bias) and GELU MLP with
    biases, on nonzero biases."""
    jcfg, cfg = _cfgs(WHISPER)
    jp = jax.tree.map(np.asarray, jtfm.init_mlp(jax.random.key(1), jcfg,
                                                jcfg.d_ff))
    jp["bi"], jp["bo"] = _x(2, jcfg.d_ff), _x(3, jcfg.d_model)
    assert sorted(tfm.init_mlp(None, cfg, cfg.d_ff, device="meta")) == \
        sorted(jp) == ["bi", "bo", "wi", "wo"]
    x = _x(4, 2, 7, jcfg.d_model)
    _close(tfm.mlp_forward(_t(jp), torch.from_numpy(x), cfg),
           jtfm.mlp_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                            jcfg))
    norm = {"scale": _x(5, jcfg.d_model), "bias": _x(6, jcfg.d_model)}
    assert sorted(tfm.init_norm(cfg)) == ["bias", "scale"]
    _close(tfm.apply_norm(_t(norm), torch.from_numpy(x) * 3 + 1, cfg),
           jtfm.apply_norm(jax.tree.map(jnp.asarray, norm),
                           jnp.asarray(x) * 3 + 1, jcfg),
           dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize("length,d", [(16, 64), (1500, 1280)])
def test_sinusoid_positions(length, d):
    """Within 3e-4: an f32 angle near 1,500 rad has an ulp of 1.2e-4,
    and the two packages' exp() of the frequencies may differ by one ulp
    (6e-8 relative, 9e-5 at 1,500 rad)."""
    want = jtfm.sinusoid_positions(length, d)
    got = tfm.sinusoid_positions(length, d)
    _close(got, want, dict(atol=3e-4 if length > 100 else 2e-5, rtol=0))


@pytest.mark.parametrize("gated", [False, True])
def test_cross_kv_and_cross_attention(gated):
    """``cross_kv`` (with whisper's biases) and ``cross_attention`` (plain
    for whisper, gated with q/k norms for vision) over a memory longer
    than the queries, through both of the port's routes."""
    jcfg, cfg = _cfgs(VISION if gated else WHISPER)
    jp = jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.key(3), jcfg, cross=gated))
    if gated:
        jp["gate"] = np.float32(0.7)
        jp["q_norm"], jp["k_norm"] = _x(7, jcfg.head_dim) + 1, \
            _x(8, jcfg.head_dim) + 1
    else:
        jp["bk"], jp["bv"] = (_x(i, *jp["bk"].shape) for i in (9, 10))
        jp["bq"] = _x(11, *jp["bq"].shape)
    x, mem = _x(12, 2, 5, jcfg.d_model), _x(13, 2, 19, jcfg.d_model)
    jpj = jax.tree.map(jnp.asarray, jp)
    wk, wv = jattn.cross_kv(jpj, jnp.asarray(mem), jcfg, jnp.float32)
    k, v = attention.cross_kv(_t(jp), torch.from_numpy(mem), cfg,
                              torch.float32)
    _close(k, wk)
    _close(v, wv)
    want = jattn.cross_attention(jpj, jnp.asarray(x), jnp.asarray(mem), jcfg,
                                 gated=gated)
    for use_kernels in (True, False):
        _close(attention.cross_attention(
            _t(jp), torch.from_numpy(x), torch.from_numpy(mem), cfg,
            gated=gated, use_kernels=use_kernels), want)


def _block_case(kind):
    """-> (jcfg, cfg, reference block params (jnp), port's, memory)."""
    arch = VISION if kind == "cross" else WHISPER
    jcfg, cfg = _cfgs(arch)
    jp = jax.tree.map(np.asarray, jtfm.init_block(
        jax.random.key(4), jcfg, kind, 0))
    _set_gates(jp, 6)
    for name in ("ln1", "ln2", "ln_cross"):      # nonzero LayerNorm biases
        if name in jp and "bias" in jp[name]:
            jp[name]["bias"] = _x(len(name), jcfg.d_model, scale=0.1)
    m = jcfg.n_image_tokens if kind == "cross" else jcfg.encoder_seq
    return (jcfg, cfg, jax.tree.map(jnp.asarray, jp), _t(jp),
            _x(14, 2, m, jcfg.d_model))


@pytest.mark.parametrize("kind", ["encoder", "encdec", "cross"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_block_train_mode(kind, use_kernels):
    jcfg, cfg, jp, p, mem = _block_case(kind)
    x = _x(15, 2, 9, jcfg.d_model)
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0)
    want, _, _ = jtfm.block_forward(jp, jnp.asarray(x), jcfg, kind,
                                    mode="train", positions=jnp.asarray(pos),
                                    memory=jnp.asarray(mem))
    got, aux, cache = tfm.block_forward(
        p, torch.from_numpy(x), cfg, kind, mode="train",
        positions=torch.from_numpy(pos), memory=torch.from_numpy(mem),
        use_kernels=use_kernels)
    assert cache is None and aux == 0.0
    _close(got, want)


@pytest.mark.parametrize("kind", ["encdec", "cross"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_block_prefill_then_decode(kind, use_kernels):
    """Prefill (ring cache plus the memory's K/V) and four decode steps
    reading the cached K/V, outputs and caches against the reference."""
    jcfg, cfg, jp, p, mem = _block_case(kind)
    s, max_len = 9, 20
    x = _x(16, 2, s, jcfg.d_model)
    pos = np.arange(s, dtype=np.int32)[None].repeat(2, 0)
    jc = jtfm.init_block_cache(jcfg, kind, 2, max_len, dtype=jnp.float32)
    c = tfm.init_block_cache(cfg, kind, 2, max_len, dtype=torch.float32)
    want, _, jc = jtfm.block_forward(jp, jnp.asarray(x), jcfg, kind,
                                     mode="prefill",
                                     positions=jnp.asarray(pos), cache=jc,
                                     memory=jnp.asarray(mem))
    got, _, c = tfm.block_forward(p, torch.from_numpy(x), cfg, kind,
                                  mode="prefill",
                                  positions=torch.from_numpy(pos), cache=c,
                                  memory=torch.from_numpy(mem),
                                  use_kernels=use_kernels)
    _close(got, want)
    assert sorted(c) == sorted(jc)
    for name in c:
        _close(c[name], jc[name])
    for i in range(STEPS):
        xt = _x(17 + i, 2, 1, jcfg.d_model)
        want, _, jc = jtfm.block_forward(jp, jnp.asarray(xt), jcfg, kind,
                                         mode="decode",
                                         position=jnp.int32(s + i), cache=jc)
        got, _, c = tfm.block_forward(p, torch.from_numpy(xt), cfg, kind,
                                      mode="decode", position=s + i, cache=c)
        _close(got, want)
    for name in c:
        _close(c[name], jc[name])


def test_cross_block_is_the_identity_at_init():
    """Vision's gates start at 0 (C22): a freshly drawn ``cross`` block
    returns its input in both packages, whatever the memory."""
    jcfg, cfg = _cfgs(VISION)
    jp = jtfm.init_block(jax.random.key(4), jcfg, "cross", 4)
    x, mem = _x(18, 2, 6, jcfg.d_model), _x(19, 2, 16, jcfg.d_model)
    want, _, _ = jtfm.block_forward(jp, jnp.asarray(x), jcfg, "cross",
                                    mode="train", memory=jnp.asarray(mem))
    np.testing.assert_array_equal(np.asarray(want), x)
    p = tfm.init_block(torch.Generator().manual_seed(0), cfg, "cross", 4)
    assert float(p["mlp_gate"]) == float(p["mixer"]["gate"]) == 0.0
    got, _, _ = tfm.block_forward(p, torch.from_numpy(x), cfg, "cross",
                                  mode="train", memory=torch.from_numpy(mem))
    np.testing.assert_array_equal(got.numpy(), x)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_layers", [True, False], ids=["scan",
                                                             "unrolled"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_encode_matches_reference(scan_layers, use_kernels):
    """``_encode`` (sinusoid positions, the bidirectional stack, the
    final LayerNorm) from both of the reference's layouts."""
    jcfg, cfg, jp, params = _model("whisper", scan_layers)
    assert ("scan" in jp["encoder"]["stack"]) == scan_layers
    frames = _x(20, 2, jcfg.encoder_seq, jcfg.d_model)
    want = jmdl._encode(jp, jnp.asarray(frames), jcfg)
    got = mdl._encode(params, frames, cfg, use_kernels=use_kernels)
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    _close(got, want)


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _jax_serve(jcfg, params, batch, gen_tokens):
    """The reference's jitted prefill + decode logits, fed ``gen_tokens``
    (decode caches in the config's dtype)."""
    b, s = batch["tokens"].shape
    prefill = jax.jit(lambda p, b, c: jmdl.prefill(p, b, jcfg, c))
    decode = jax.jit(lambda p, t, i, c: jmdl.decode_step(p, t, i, jcfg, c))
    cache = jmdl.init_decode_state(jcfg, b, s + 16, dtype=jnp.dtype(
        jcfg.dtype))
    logits, cache = prefill(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, cache)
    out = [np.asarray(logits)]
    for i, t in enumerate(gen_tokens):
        logits, cache = decode(params, jnp.asarray(t[:, None]),
                               jnp.int32(s + i), cache)
        out.append(np.asarray(logits))
    return out


def _port_serve(cfg, params, batch, gen_tokens, use_kernels):
    b, s = batch["tokens"].shape
    cache = mdl.init_decode_state(cfg, b, s + 16, device=CPU,
                                  dtype=mdl.compute_dtype(cfg))
    logits, cache = mdl.prefill(params, batch, cfg, cache,
                                use_kernels=use_kernels)
    out = [logits]
    for i, t in enumerate(gen_tokens):
        logits, cache = mdl.decode_step(params, torch.from_numpy(t)[:, None],
                                        s + i, cfg, cache)
        out.append(logits)
    return out


def _serve_batch(cfg, seed=1):
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_real, (2, PROMPT)).astype(np.int32)
    return {"tokens": tokens, **_extras(cfg, 2, seed)}


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_decode_logits_match_reference(name, use_kernels):
    jcfg, cfg, jp, params = _model(name)
    batch = _serve_batch(cfg)
    gen = [np.random.default_rng(i).integers(0, jcfg.vocab_real, 2)
           for i in range(STEPS)]
    want = _jax_serve(jcfg, jp, batch, gen)
    got = _port_serve(cfg, params, batch, gen, use_kernels)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, LOGIT_TOL)


def _rms(a, b):
    """|a - b| / |b| over every element, in f32."""
    a, b = (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32) for x in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_close(got16, want16, want32):
    """Lists of steps: the port's bf16 within ``BF16_RMS`` of the
    reference's bf16, and no farther from the reference's f32 than
    ``BF16_NOISE`` times the reference's bf16 is (means over the
    steps, printed: ``pytest -s`` shows them)."""
    mean = [float(np.mean([_rms(a, b) for a, b in zip(x, y)]))
            for x, y in ((got16, want16), (got16, want32), (want16, want32))]
    print(f"bf16 |a - b| / |b|: port - reference {mean[0]:.3e}, port - "
          f"reference f32 {mean[1]:.3e}, reference - reference f32 "
          f"{mean[2]:.3e}")
    assert mean[0] <= BF16_RMS, mean
    assert mean[1] <= BF16_NOISE * mean[2], mean


def _bf16(cfg):
    return cfg.scaled(dtype="bfloat16")


@functools.lru_cache(maxsize=None)
def _reference_bf16_and_f32(name):
    """The reference's prefill + decode logits for ``name`` in bf16 and
    in f32 on the same weights, batch and fed tokens."""
    jcfg, cfg, jp, _ = _model(name)
    batch = _serve_batch(cfg)
    gen = [np.random.default_rng(i).integers(0, jcfg.vocab_real, 2)
           for i in range(STEPS)]
    return (batch, gen, _jax_serve(_bf16(jcfg), jp, batch, gen),
            _jax_serve(jcfg, jp, batch, gen))


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("use_kernels", [True, False])
def test_bf16_logits_match_reference_bf16(name, use_kernels):
    """The configs' default bf16 (decode caches in bf16): prefill and 4
    decode steps against the reference's jitted bf16 steps."""
    _, cfg, _, params = _model(name)
    batch, gen, want16, want32 = _reference_bf16_and_f32(name)
    got = _port_serve(_bf16(cfg), params, batch, gen, use_kernels)
    _bf16_close(got, want16, want32)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_bf16_encode_matches_reference_bf16(use_kernels):
    """Whisper's encoder in bf16 against the reference's, jitted."""
    jcfg, cfg, jp, params = _model("whisper")
    frames = _x(20, 2, jcfg.encoder_seq, jcfg.d_model)
    want16 = jax.jit(lambda p, f: jmdl._encode(p, f, _bf16(jcfg)))(
        jp, jnp.asarray(frames))
    want32 = jmdl._encode(jp, jnp.asarray(frames), jcfg)
    got = mdl._encode(params, frames, _bf16(cfg), use_kernels=use_kernels)
    assert got.dtype == torch.bfloat16
    _bf16_close([got], [want16], [want32])


@pytest.mark.parametrize("name", list(MODELS))
def test_memory_moves_the_logits(name):
    """Other frames or image embeddings move the prefill and decode
    logits of the encdec and vision models by more than rounding, in
    both packages; whisper as configured never reads the encoder, so its
    logits stay exactly the same in both (C20)."""
    jcfg, cfg, jp, params = _model(name)
    gen = [np.random.default_rng(i).integers(0, jcfg.vocab_real, 2)
           for i in range(2)]
    runs = {"ref": [], "port": []}
    for seed in (1, 2):
        batch = {**_serve_batch(cfg, 1), **_extras(cfg, 2, seed + 30)}
        runs["ref"].append(_jax_serve(jcfg, jp, batch, gen))
        runs["port"].append([t.numpy() for t in _port_serve(
            cfg, params, batch, gen, use_kernels=True)])
    for a, b in runs.values():
        moved = [float(np.abs(x - y).max()) for x, y in zip(a, b)]
        if name == "whisper":
            assert moved == [0.0] * len(moved)
        else:
            assert min(moved) > 1e-2, moved


def _port_grads(params, batch, cfg):
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss, metrics = mdl.loss_fn(params, batch, cfg)
    return loss, metrics, torch.autograd.grad(
        loss, flat, allow_unused=True, materialize_grads=True)


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_and_gradient_match_reference(name):
    """``loss_fn`` with the memory (the encoder's output or the image
    embeddings) and its gradient against ``jax.value_and_grad``; whisper
    as configured gives its encoder zero gradients in both."""
    jcfg, cfg, jp, params = _model(name)
    batch = {**mdl.make_batch(3, cfg, 2, 12)}
    assert set(batch) == {"tokens", "labels"} | set(_extras(cfg, 1, 0))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmdl.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jcfg), has_aux=True))(jp)
    loss, metrics, grads = _port_grads(params, batch, cfg)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(metrics["ce"].item() - float(jm["ce"])) <= \
        1e-5 * abs(float(jm["ce"]))
    want = leaves(convert.params_from_jax(jax.tree.map(np.asarray, jg), cfg,
                                          device=CPU))
    assert len(grads) == len(want)
    top = max(float(w.abs().max()) for w in want)
    for g, w in zip(grads, want):
        # + 1e-7 of the tree's largest |g|: the key bias's gradient is 0
        # in exact arithmetic (softmax ignores a shift shared by a row),
        # so both packages hold only rounding there (~5e-8 of the top)
        assert float((g - w).abs().max()) <= \
            1e-4 * float(w.abs().max()) + 1e-7 * top
    if name == "whisper":
        enc = {id(t) for t in leaves(params["encoder"])}
        on_enc = [g for t, g in zip(leaves(params), grads) if id(t) in enc]
        assert len(on_enc) == len(enc) > 0
        assert all(float(g.abs().max()) == 0.0 for g in on_enc)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_param_tree_matches_reference(name):
    """The port's init draws the reference's tree (leaf names and shapes,
    in ``jax.tree_util`` order, the encoder included) in the unrolled
    layout."""
    arch, over = MODELS[name]
    jcfg, cfg = _cfgs(arch, **over)
    jshapes = jax.eval_shape(lambda k: jmdl.init_params(
        k, jcfg, scan_layers=False), jax.random.key(0))
    params = mdl.init_params(cfg, device=CPU)
    want = [tuple(x.shape) for x in jax.tree.leaves(jshapes)]
    assert [tuple(t.shape) for t in leaves(params)] == want
    assert sum(t.numel() for t in leaves(params)) == \
        mdl.count_params_analytic(cfg)


@pytest.mark.parametrize("arch,over,n", [
    (WHISPER, {}, 1_392_056_320),
    (VISION, {"n_layers": 10}, 10_657_899_012)])
def test_count_params_full_config(arch, over, n):
    """whisper-large-v3 and llama-3.2-vision cut to 10 layers at full
    width: the reference's counts (the port's from the meta device)."""
    got = mdl.count_params_analytic(get_config(arch).scaled(**over))
    assert got == jmdl.count_params_analytic(
        jget_config(arch).scaled(**over)) == n


def test_serve_main_draws_the_stub_frontends(tmp_path, capsys):
    """``python -m repro_torch.launch.serve`` on whisper and vision smoke
    configs: frames / image embeddings after the prompts, served."""
    from repro_torch.launch import serve
    for arch in (WHISPER, VISION):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                    "2", "--prompt-len", "8", "--gen", "3", "--root",
                    str(tmp_path / arch)])
        assert "generated (2, 3) tokens" in capsys.readouterr().out

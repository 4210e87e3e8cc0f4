"""The port's Mamba2 path (``repro_torch.kernels.ssd``,
``repro_torch.models.ssm`` and the ``ssd`` kind of the stack) against the
reference on the CPU, on the same inputs made with numpy and the same
parameters carried over by ``params_from_jax``.  The reference's Pallas
kernel runs as its own tests run it (``interpret=True``).

Tolerances: the SSD scan against the Pallas kernel, ``ops.ssd_scan`` and
``ssd_chunked`` within ``TOL`` (atol 1e-4, rtol 1e-4: f32 products
summed in another order); against the sequential ``ssd_reference``
within ``SEQ_TOL`` (atol 2e-4, rtol 1e-3, the reference's own
``tests/test_models.py`` tolerance: the chunked form rounds its decays
differently); logits within ``LOGIT_TOL`` (atol 2e-4, rtol 1e-4).

In the configs' own bf16 both packages round every op to bf16, at other
places (the port's SSD sums in f32, its silu rounds once), so the port's
bf16 is held to the reference's bf16 by |a - b| / |b| over the whole
output (the RMS of the difference over the RMS of the reference):
within ``BF16_RMS`` of it, and no farther from the reference's f32 than
``BF16_NOISE`` times the reference's own bf16 is (ROADMAP C23; the
readings behind both limits are in PERF.md).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops as jops
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import model as jmdl
from repro.models import ssm as jssm
from repro_torch import _ext
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ssd_chunked, ssd_scan
from repro_torch.models import convert, ssm
from repro_torch.models import model as mdl
from repro_torch.models import transformer as tfm
from repro_torch.tree import leaves

TOL = dict(atol=1e-4, rtol=1e-4)
SEQ_TOL = dict(atol=2e-4, rtol=1e-3)
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
BF16_RMS = dict(layer=1.5e-2, logits=3e-2)
BF16_NOISE = 1.25
ARCH = "mamba2-130m"


def _inputs(seed, b, s, h, p, n, g=1, with_state=False):
    """x, dt (softplus of a normal), a_log, B, C and an optional initial
    state as f32 numpy arrays, scaled as the reference's tests scale
    them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(f)
    B = (rng.standard_normal((b, s, g, n)) * 0.3).astype(f)
    C = (rng.standard_normal((b, s, g, n)) * 0.3).astype(f)
    s0 = (rng.standard_normal((b, h, p, n)) * 0.5).astype(f) \
        if with_state else None
    return x, dt, a_log, B, C, s0


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


SCANS = {"plain": lambda *a, chunk, s0=None: ssd_chunked(
             *a, chunk, initial_state=s0),
         "wrapper": lambda *a, chunk, s0=None: ssd_scan(
             *a, chunk=chunk, initial_state=s0)}


# ---------------------------------------------------------------------------
# B6: the plain version and the CPU wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", sorted(SCANS))
@pytest.mark.parametrize("b,s,h,p,n,chunk", [(1, 128, 2, 16, 32, 32),
                                             (2, 256, 3, 8, 16, 64),
                                             (1, 64, 1, 32, 64, 16)])
def test_scan_matches_pallas_aligned(fn, b, s, h, p, n, chunk):
    """The reference test's aligned shapes (``tests/test_kernels.py``)."""
    x, dt, a_log, B, C, _ = _inputs(s + n, b, s, h, p, n)
    want = ssd_scan_pallas(*_j(x, dt, a_log, B, C), chunk=chunk,
                           interpret=True)
    y, _ = SCANS[fn](*_t(x, dt, a_log, B, C), chunk=chunk)
    _close(y, want)


@pytest.mark.parametrize("fn", sorted(SCANS))
@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 45, 2, 8, 16, 16),
                                             (1, 1, 3, 8, 16, 16),
                                             (1, 100, 2, 16, 32, 32)])
def test_scan_matches_ops_unaligned(fn, b, s, h, p, n, chunk):
    """Any s: the reference's wrapper pads with zeros (dt 0, the
    identity), the port pads nothing."""
    x, dt, a_log, B, C, _ = _inputs(s * 3 + p, b, s, h, p, n)
    want, _ = jops.ssd_scan(*_j(x, dt, a_log, B, C), chunk=chunk,
                            interpret=True)
    y, final = SCANS[fn](*_t(x, dt, a_log, B, C), chunk=chunk)
    assert y.shape == (b, s, h, p) and final.shape == (b, h, p, n)
    _close(y, want)


@pytest.mark.parametrize("fn", sorted(SCANS))
@pytest.mark.parametrize("b,s,h,p,n,g,chunk", [(2, 70, 3, 8, 16, 1, 16),
                                               (1, 96, 4, 8, 16, 2, 32),
                                               (2, 33, 4, 16, 8, 4, 16)])
def test_scan_matches_ssd_chunked_with_state(fn, b, s, h, p, n, g, chunk):
    """The state contract of ``ssd_chunked``: y and the final state from
    an initial state, B and C by group (g = 1, 2 and h)."""
    x, dt, a_log, B, C, s0 = _inputs(s + g, b, s, h, p, n, g, True)
    want_y, want_f = jssm.ssd_chunked(*_j(x, dt, a_log, B, C), chunk,
                                      initial_state=jnp.asarray(s0))
    y, final = SCANS[fn](*_t(x, dt, a_log, B, C), chunk=chunk,
                         s0=torch.from_numpy(s0))
    _close(y, want_y)
    _close(final, want_f)


@pytest.mark.parametrize("g,with_state", [(1, False), (1, True), (2, True)])
def test_scans_match_the_sequential_oracle(g, with_state):
    """B6's plain version, the port's ``ssd_chunked``, and its
    ``ssd_reference`` against the reference's sequential oracle."""
    x, dt, a_log, B, C, s0 = _inputs(7 + g, 2, 64, 4, 8, 16, g, with_state)
    want_y, want_f = jssm.ssd_reference(
        *_j(x, dt, a_log, B, C), None if s0 is None else jnp.asarray(s0))
    args = _t(x, dt, a_log, B, C)
    st = None if s0 is None else torch.from_numpy(s0)
    for y, final in (ssd_chunked(*args, 16, initial_state=st),
                     ssm.ssd_reference(*args, st)):
        _close(y, want_y, SEQ_TOL)
        _close(final, want_f, SEQ_TOL)


def test_wrapper_runs_plain_on_cpu_and_checks_shapes():
    x, dt, a_log, B, C, s0 = _t(*_inputs(3, 2, 20, 4, 8, 16, 2, True))
    _ext.reset_launch_counts()
    got = ssd_scan(x, dt, a_log, B, C, chunk=8, initial_state=s0)
    want = ssd_chunked(x, dt, a_log, B, C, 8, initial_state=s0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _ext.LAUNCHES["ssd_scan"] == 0     # plain versions not counted
    g3 = torch.zeros((2, 20, 3, 16))
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a_log, g3, g3)                  # h % g != 0
    with pytest.raises(ValueError):
        ssd_scan(x, dt[:, :-1], a_log, B, C)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a_log, B, C, initial_state=s0[..., :8])
    with pytest.raises(ValueError):
        ssd_scan(x[:, :0], dt[:, :0], a_log, B[:, :0], C[:, :0])


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def _cfgs(**over):
    over.setdefault("dtype", "float32")
    return jget_smoke(ARCH).scaled(**over), get_smoke_config(ARCH).scaled(
        **over)


def _layer(jcfg, seed):
    """The reference's random Mamba2 mixer parameters, with a_log, dt_bias
    and d_skip moved off their constant init so they are tested too."""
    jp = jssm.init_ssm(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    h = jssm.n_ssm_heads(jcfg)
    jp["a_log"] = jnp.asarray(np.log(rng.uniform(1.0, 8.0, h)), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.standard_normal(h) * 0.5, jnp.float32)
    jp["d_skip"] = jnp.asarray(rng.uniform(0.5, 1.5, h), jnp.float32)
    jp["norm"] = jnp.asarray(rng.uniform(0.5, 1.5, jp["norm"].shape),
                             jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("use_kernels", [True, False])
def test_ssm_block_matches_reference(use_kernels):
    jcfg, cfg = _cfgs()
    jp, p = _layer(jcfg, 0)
    x = (np.random.default_rng(1).standard_normal((2, 37, cfg.d_model))
         ).astype(np.float32)
    want = jssm.ssm_block(jp, jnp.asarray(x), jcfg)
    got = ssm.ssm_block(p, torch.from_numpy(x), cfg,
                        use_kernels=use_kernels)
    _close(got, want)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_ssm_prefill_then_decode_matches_reference(use_kernels):
    """``ssm_prefill`` from a non-zero cache state, then 4 ``ssm_decode``
    steps: outputs and both caches against the reference's."""
    jcfg, cfg = _cfgs()
    jp, p = _layer(jcfg, 2)
    rng = np.random.default_rng(3)
    b, s = 2, 21
    xs = rng.standard_normal((b, s + 4, cfg.d_model)).astype(np.float32)
    jcache = jssm.init_ssm_cache(jcfg, b)
    jcache["state"] = jnp.asarray(
        rng.standard_normal(jcache["state"].shape) * 0.3, jnp.float32)
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    want, jcache = jssm.ssm_prefill(jp, jnp.asarray(xs[:, :s]), jcfg, jcache)
    got, cache = ssm.ssm_prefill(p, torch.from_numpy(xs[:, :s]), cfg, cache,
                                 use_kernels=use_kernels)
    _close(got, want)
    for k in ("state", "conv"):
        _close(cache[k], jcache[k])
    for t in range(s, s + 4):
        want, jcache = jssm.ssm_decode(jp, jnp.asarray(xs[:, t:t + 1]), jcfg,
                                       jcache)
        got, cache = ssm.ssm_decode(p, torch.from_numpy(xs[:, t:t + 1]), cfg,
                                    cache)
        _close(got, want)
        for k in ("state", "conv"):
            assert cache[k].dtype == torch.float32
            _close(cache[k], jcache[k])


def test_ssd_cache_is_f32_whatever_dtype():
    """As the reference's ``init_ssm_cache(cfg, batch)``: the decode state
    defaults to bf16 for attention, but the SSM cache stays f32."""
    _, cfg = _cfgs()
    cache = tfm.init_block_cache(cfg, "ssd", 3, 16, dtype=torch.bfloat16)
    h = ssm.n_ssm_heads(cfg)
    assert cache["state"].dtype == cache["conv"].dtype == torch.float32
    assert cache["state"].shape == (3, h, cfg.ssm_headdim, cfg.ssm_state)
    assert cache["conv"].shape == (3, cfg.ssm_conv - 1, ssm.conv_dim(cfg))


# ---------------------------------------------------------------------------
# the mamba2 smoke model end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("n_layers,layout", [(1, "unrolled"), (3, "scan")])
def test_prefill_and_decode_logits_match_reference(n_layers, layout,
                                                   use_kernels):
    """21 prompt tokens: not a multiple of ssm_chunk (16)."""
    jcfg, cfg = _cfgs(n_layers=n_layers)
    jparams = jmdl.init_params(jax.random.key(n_layers), jcfg)
    assert layout in jparams["decoder"]
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                     device="cpu")
    b, s = 2, 21
    toks = np.random.default_rng(n_layers).integers(
        0, jcfg.vocab_real, (b, s + 3)).astype(np.int32)
    jcache = jmdl.init_decode_state(jcfg, b, s + 8)
    cache = mdl.init_decode_state(cfg, b, s + 8, device="cpu")
    want, jcache = jmdl.prefill(jparams, {"tokens": jnp.asarray(toks[:, :s])},
                                jcfg, jcache)
    got, cache = mdl.prefill(params, {"tokens": toks[:, :s]}, cfg, cache,
                             use_kernels=use_kernels)
    _close(got, want, LOGIT_TOL)
    for t in range(s, s + 3):
        want, jcache = jmdl.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t), jcfg, jcache)
        got, cache = mdl.decode_step(params, torch.from_numpy(
            toks[:, t:t + 1]), t, cfg, cache)
        _close(got, want, LOGIT_TOL)


def test_param_tree_matches_reference_shapes():
    jcfg, cfg = _cfgs(n_layers=3)
    jshapes = jax.eval_shape(lambda k: jmdl.init_params(k, jcfg),
                             jax.random.key(0))
    n_j = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))
    params = mdl.init_params(cfg, device="cpu")
    assert "lm_head" not in params           # tied embeddings
    assert all("mlp" not in bp and "ln2" not in bp
               for bp in params["decoder"]["unrolled"])
    assert sum(t.numel() for t in leaves(params)) == n_j \
        == mdl.count_params_analytic(cfg)


def test_count_params_full_config():
    """mamba2-130m at full width: 128,983,488, the reference's count."""
    n = mdl.count_params_analytic(get_config(ARCH))
    assert n == jmdl.count_params_analytic(jget_config(ARCH)) == 128_983_488


# ---------------------------------------------------------------------------
# bf16, the configs' default dtype, against the reference's bf16
# ---------------------------------------------------------------------------

def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rms(a, b):
    """|a - b| / |b| over every element, in f32."""
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_close(got16, want16, want32, limit):
    """The port's bf16 within ``limit`` of the reference's bf16, and no
    farther from the reference's f32 than ``BF16_NOISE`` times the
    reference's bf16 is; each argument a list of arrays (steps), their
    distances averaged and printed (``pytest -s`` shows them)."""
    mean = [float(np.mean([_rms(a, b) for a, b in zip(x, y)]))
            for x, y in ((got16, want16), (got16, want32), (want16, want32))]
    print(f"bf16 |a - b| / |b|: port - reference {mean[0]:.3e}, port - "
          f"reference f32 {mean[1]:.3e}, reference - reference f32 "
          f"{mean[2]:.3e}")
    assert mean[0] <= limit, mean
    assert mean[1] <= BF16_NOISE * mean[2], mean


@pytest.mark.parametrize("use_kernels", [True, False])
def test_bf16_ssm_block_matches_reference_bf16(use_kernels):
    """One Mamba2 mixer of mamba2-130m at full width (d 768, 24 heads,
    state 128) over 256 tokens in bf16, against the reference's jitted
    bf16 block on the same weights and input."""
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    assert jcfg.dtype == cfg.dtype == "bfloat16"
    jp, p = _layer(jcfg.scaled(dtype="float32"), 0)
    x = np.random.default_rng(1).standard_normal(
        (1, 256, cfg.d_model)).astype(np.float32)
    want32 = jssm.ssm_block(jp, jnp.asarray(x), jcfg.scaled(dtype="float32"))
    want16 = jax.jit(lambda p, x: jssm.ssm_block(p, x, jcfg))(
        jp, jnp.asarray(x).astype(jnp.bfloat16))
    got = ssm.ssm_block(p, torch.from_numpy(x).bfloat16(), cfg,
                        use_kernels=use_kernels)
    assert got.dtype == torch.bfloat16
    _bf16_close([got], [want16], [want32], BF16_RMS["layer"])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_bf16_prefill_and_decode_match_reference_bf16(use_kernels):
    """The 3-layer mamba2 smoke model in bf16 (bf16 decode caches, the
    SSM state f32 as in both packages): 64 prompt tokens (4 chunks) and
    3 decode steps against the reference's jitted bf16 steps."""
    j32, c32 = _cfgs(n_layers=3)
    j16, c16 = _cfgs(n_layers=3, dtype="bfloat16")
    jparams = jmdl.init_params(jax.random.key(3), j32)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), c32,
                                     device="cpu")
    b, s = 2, 64
    toks = np.random.default_rng(3).integers(
        0, j32.vocab_real, (b, s + 3)).astype(np.int32)

    def reference(jcfg, dtype):
        prefill = jax.jit(lambda p, t, c: jmdl.prefill(p, {"tokens": t},
                                                       jcfg, c))
        decode = jax.jit(lambda p, t, i, c: jmdl.decode_step(p, t, i, jcfg,
                                                             c))
        cache = jmdl.init_decode_state(jcfg, b, s + 8, dtype=dtype)
        lg, cache = prefill(jparams, jnp.asarray(toks[:, :s]), cache)
        out = [lg]
        for t in range(s, s + 3):
            lg, cache = decode(jparams, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t), cache)
            out.append(lg)
        return out

    cache = mdl.init_decode_state(c16, b, s + 8, dtype=torch.bfloat16,
                                  device="cpu")
    lg, cache = mdl.prefill(params, {"tokens": toks[:, :s]}, c16, cache,
                            use_kernels=use_kernels)
    got = [lg]
    for t in range(s, s + 3):
        lg, cache = mdl.decode_step(params, torch.from_numpy(
            toks[:, t:t + 1]), t, c16, cache)
        got.append(lg)
    _bf16_close(got, reference(j16, jnp.bfloat16),
                reference(j32, jnp.float32), BF16_RMS["logits"])


def test_bf16_full_model_no_noisier_than_reference():
    """mamba2-130m at full width and depth (24 layers) in bf16 over 512
    tokens, every position's logits: bf16 noise grows ~0.01 a layer in
    both packages (ROADMAP C23), so at full depth the port's bf16 is one
    more sample of it.  It must be no farther from the reference's f32,
    and no farther from the reference's bf16, than ``BF16_NOISE`` times
    the reference's bf16 is from its f32."""
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    j32, c32 = jcfg.scaled(dtype="float32"), cfg.scaled(dtype="float32")
    jparams = jmdl.init_params(jax.random.key(0), j32)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), c32,
                                     device="cpu")
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_real, (1, 512)).astype(np.int32)
    want = {c.dtype: jax.jit(lambda p, t, c=c: jmdl.forward_train(
        p, {"tokens": t}, c)[0])(jparams, jnp.asarray(toks))
        for c in (jcfg, j32)}
    with torch.no_grad():
        got = mdl.forward_train(params, {"tokens": toks}, cfg)[0]
    port_ref, port_f32, ref_f32 = (
        _rms(got, want["bfloat16"]), _rms(got, want["float32"]),
        _rms(want["bfloat16"], want["float32"]))
    print(f"bf16 |a - b| / |b| over 512 x {cfg.vocab_size} logits: port - "
          f"reference {port_ref:.3e}, port - reference f32 {port_f32:.3e}, "
          f"reference - reference f32 {ref_f32:.3e}")
    assert port_f32 <= BF16_NOISE * ref_f32
    assert port_ref <= BF16_NOISE * ref_f32

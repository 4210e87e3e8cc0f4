"""The model kernels' plain PyTorch versions (what the port runs on the
CPU) against the reference: B5 flash attention against the Pallas kernel
run with ``interpret=True`` and against ``ref.flash_attention_ref``, B7
the RG-LRU scan against ``ref.rglru_scan_ref`` and the model's
associative ``lru_scan`` (the Pallas scan itself does not run on this
jax, ROADMAP C1).  B6, the SSD scan, is tested in ``test_torch_ssm.py``;
here only its wrapper's refusal to fall back on a CUDA tensor.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: attention atol 3e-5 / rtol 1e-4, as the reference's own
kernel tests (f32 sums in another order); the sequential scan within
1e-6 of the sequential oracle, 1e-5 of the log-depth scan (another
rounding order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.rglru import lru_scan as jlru_scan
from repro_torch import _ext
from repro_torch.kernels import (flash_attention, flash_attention_kernel,
                                 flash_attention_plain, rglru_scan,
                                 rglru_scan_plain, ssd_scan)
from repro_torch.models.rglru import lru_scan

ATTN_TOL = dict(atol=3e-5, rtol=1e-4)


def _qkv(seed, b, h, kv, sq, sk, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, hd)).astype(np.float32),
            rng.standard_normal((b, kv, sk, hd)).astype(np.float32),
            rng.standard_normal((b, kv, sk, hd)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# B5: flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kv,s,hd", [
    (1, 4, 4, 128, 64),      # MHA
    (2, 4, 2, 256, 64),      # GQA
    (1, 8, 1, 128, 128),     # MQA, wide head
])
def test_plain_matches_pallas_shapes(b, h, kv, s, hd):
    q, k, v = _qkv(b * h + s, b, h, kv, s, s, hd)
    want = flash_attention_pallas(q, k, v, scale=hd ** -0.5, causal=True,
                                  q_block=64, kv_block=64, interpret=True)
    got = flash_attention_plain(*_t(q, k, v), scale=hd ** -0.5, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("window,softcap,causal", [
    (0, 0.0, True), (64, 0.0, True), (0, 30.0, True), (96, 50.0, True),
    (0, 0.0, False), (64, 30.0, False),
])
def test_plain_matches_pallas_masks(window, softcap, causal):
    q, k, v = _qkv(window + int(softcap), 1, 4, 2, 192, 192, 32)
    want = flash_attention_pallas(q, k, v, scale=0.2, causal=causal,
                                  window=window, softcap=softcap,
                                  q_block=64, kv_block=64, interpret=True)
    got = flash_attention_plain(*_t(q, k, v), scale=0.2, causal=causal,
                                window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("h,kv,sq,sk,causal,window,softcap", [
    (4, 2, 200, 200, False, 0, 0.0),    # ROADMAP C3: the reference's
    (4, 1, 200, 200, False, 50, 30.0),  # padded wrapper is wrong here
    (4, 4, 77, 77, True, 13, 30.0),
    (2, 1, 33, 200, False, 0, 0.0),     # sq < sk
    (2, 2, 1, 1, True, 0, 0.0),
    (6, 3, 129, 129, True, 64, 0.0),
])
def test_plain_matches_ref_unaligned(h, kv, sq, sk, causal, window, softcap):
    q, k, v = _qkv(sq * 7 + sk, 2, h, kv, sq, sk, 16)
    want = ref.flash_attention_ref(q, k, v, scale=0.25, causal=causal,
                                   window=window, softcap=softcap)
    got = flash_attention_plain(*_t(q, k, v), scale=0.25, causal=causal,
                                window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_plain_gives_zero_to_a_query_with_no_visible_key():
    """sq > sk with a window leaves the last queries no key: they get 0,
    as the kernel's divide by max(l, 1e-37) gives."""
    q, k, v = _t(*_qkv(3, 1, 2, 1, 12, 4, 8))
    out = flash_attention_plain(q, k, v, scale=0.3, causal=False, window=3)
    assert torch.equal(out[:, :, 6:], torch.zeros_like(out[:, :, 6:]))
    assert bool((out[:, :, :6] != 0).any(-1).all())


@pytest.mark.parametrize("s,window,softcap", [(200, 0, 0.0), (200, 48, 30.0),
                                              (130, 16, 0.0)])
def test_model_layout_wrapper_matches_ops(s, window, softcap):
    """The port's B5 entry point in model layout (b, s, h, hd) against
    the reference's ``ops.flash_attention`` (interpret mode; causal, so
    its padding is masked)."""
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((2, s, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, s, 1, 32)).astype(np.float32)
    v = rng.standard_normal((2, s, 1, 32)).astype(np.float32)
    want = ops.flash_attention(q, k, v, scale=0.125, causal=True,
                               window=window, softcap=softcap,
                               interpret=True)
    _ext.reset_launch_counts()
    got = flash_attention(*_t(q, k, v), scale=0.125, causal=True,
                          window=window, softcap=softcap)
    assert _ext.LAUNCHES["flash_attention"] == 0     # CPU: plain version
    assert got.shape == (2, s, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_kernel_wrapper_runs_plain_on_cpu():
    q, k, v = _t(*_qkv(5, 2, 4, 2, 37, 37, 16))
    got = flash_attention_kernel(q, k, v, scale=0.25, window=8, softcap=5.0)
    want = flash_attention_plain(q, k, v, scale=0.25, window=8, softcap=5.0)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k[:, :, :, :8], v, scale=0.25)
    with pytest.raises(ValueError):
        flash_attention_kernel(q[:, :3], k, v, scale=0.25)   # 3 % 2 != 0


# ---------------------------------------------------------------------------
# B7: RG-LRU scan
# ---------------------------------------------------------------------------

def _scan_inputs(seed, b, s, w):
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w))))).astype(
        np.float32)
    x = (rng.standard_normal((b, s, w)) * 0.2).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    return a, x, h0


@pytest.mark.parametrize("b,s,w", [(2, 256, 64), (1, 100, 33), (3, 1, 5),
                                   (2, 77, 130)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_plain_matches_reference(b, s, w, with_h0):
    a, x, h0 = _scan_inputs(b * s + w, b, s, w)
    h0 = h0 if with_h0 else None
    got = rglru_scan_plain(*_t(a, x), None if h0 is None
                           else torch.from_numpy(h0)).numpy()
    seq = np.asarray(ref.rglru_scan_ref(a, x, h0))
    assoc = np.asarray(jlru_scan(jnp.asarray(a), jnp.asarray(x),
                                 None if h0 is None else jnp.asarray(h0)))
    assert np.abs(got - seq).max() <= 1e-6
    assert np.abs(got - assoc).max() <= 1e-5
    # the port's own log-depth scan (the use_kernels=False path)
    mine = lru_scan(*_t(a, x), None if h0 is None
                    else torch.from_numpy(h0)).numpy()
    assert np.abs(mine - assoc).max() <= 1e-5


def test_rglru_wrapper_runs_plain_on_cpu_and_checks_shapes():
    a, x, h0 = _t(*_scan_inputs(1, 2, 9, 7))
    _ext.reset_launch_counts()
    assert torch.equal(rglru_scan(a, x, h0), rglru_scan_plain(a, x, h0))
    assert _ext.LAUNCHES["rglru_scan"] == 0
    with pytest.raises(ValueError):
        rglru_scan(a, x[:, :4])
    with pytest.raises(ValueError):
        rglru_scan(a, x, h0[:, :3])


def test_rglru_padding_is_the_identity():
    """Padded steps (a=1, x=0), as the reference's wrapper pads, leave
    the state unchanged."""
    a, x, h0 = _t(*_scan_inputs(2, 1, 10, 6))
    ap = torch.cat([a, torch.ones(1, 6, 6)], 1)
    xp = torch.cat([x, torch.zeros(1, 6, 6)], 1)
    got = rglru_scan_plain(ap, xp, h0)
    assert torch.equal(got[:, :10], rglru_scan_plain(a, x, h0))
    assert torch.equal(got[:, 10:], got[:, 9:10].expand(1, 6, 6))


# ---------------------------------------------------------------------------
# a CUDA tensor launches or raises: never the plain version
# ---------------------------------------------------------------------------

def test_cuda_wrappers_never_fall_back(monkeypatch):
    def broken():
        raise _ext.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_ext, "library", broken)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    q, k, v = _t(*_qkv(0, 1, 2, 1, 8, 8, 64))
    a, x, h0 = _t(*_scan_inputs(0, 1, 4, 8))
    _ext.reset_launch_counts()
    with pytest.raises(_ext.KernelBuildError):
        flash_attention_kernel(q, k, v, scale=0.1)
    with pytest.raises(_ext.KernelBuildError):
        rglru_scan(a, x, h0)
    sx = torch.zeros((1, 5, 2, 8))
    sdt, slog, sb = torch.zeros((1, 5, 2)), torch.zeros(2), torch.zeros(
        (1, 5, 1, 16))
    with pytest.raises(_ext.KernelBuildError):
        ssd_scan(sx, sdt, slog, sb, sb)
    # what the kernels do not take raises before any launch
    with pytest.raises(ValueError):
        flash_attention_kernel(q[..., :32], k[..., :32], v[..., :32],
                               scale=0.1)                   # head_dim 32
    with pytest.raises(TypeError):
        flash_attention_kernel(q.double(), k.double(), v.double(), scale=0.1)
    with pytest.raises(ValueError):
        flash_attention_kernel(q.transpose(2, 3).contiguous().transpose(2, 3),
                               k, v, scale=0.1)             # not contiguous
    with pytest.raises(TypeError):
        rglru_scan(a.double(), x.double())
    with pytest.raises(TypeError):
        ssd_scan(sx.double(), sdt, slog, sb, sb)
    with pytest.raises(ValueError):
        ssd_scan(sx.transpose(2, 3).contiguous().transpose(2, 3), sdt, slog,
                 sb, sb)                                  # not contiguous
    with pytest.raises(ValueError):
        ssd_scan(sx, sdt, slog, sb[..., :12].contiguous(),
                 sb[..., :12].contiguous())                # n 12
    off = torch.zeros(sb.numel() + 1)[1:].view(sb.shape)
    with pytest.raises(ValueError):
        ssd_scan(sx, sdt, slog, off, sb)                # B not on 16 bytes
    assert sum(_ext.LAUNCHES.values()) == 0

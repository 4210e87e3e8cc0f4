"""The precision design of B5 (``csrc/model_kernels.cu``) checked on the CPU,
without a card.

The kernel runs both of its products, S = Q·Kᵀ and O += P·V, on the tensor
cores in TF32 with split operands: a = hi + lo, hi = a rounded to TF32 as
``cvt.rna.tf32.f32`` rounds it, lo = a - hi handed to the tensor cores as
it is (they read the top 19 bits of a tf32 operand, so lo is truncated
there), and a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b with f32 sums.
``_kernel_attention`` below copies the kernel's online softmax as it walks
32-key tiles (the scale, the soft-cap through the reciprocal of the cap
and the mask on S, the running max, the rescale of the sum and of O by
exp(m_old - m_new), the product with 1 / max(l, 1e-37) at the end) and
rounds the operands of its two products as the kernel does (``_mm`` of
``tests/test_torch_ssd_split.py``: B5 and B6 share the split).  Its exp is
torch's; the kernel's (``__expf``, ex2.approx) is within ~2^-21 of it
near 0, where the weights that matter lie, far inside the limit.  On normal q, k, v, as
``chip_smoke.py`` draws them, it must stay within ``ATTN_RTOL`` (1e-4 of
each query row's largest |o|, the limit ``chip_smoke.py`` holds the
kernel to) of the reference's ``flash_attention_ref``; the same walk with
plain TF32 operands must not, which is why the kernel splits them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from test_torch_ssd_split import _mm

ATTN_RTOL = 1e-4
BK = 32                    # the kernel's key tile


def _kernel_attention(q, k, v, *, scale, causal, window, softcap, mode):
    """B5's arithmetic in f32 torch on the CPU: q (b, h, sq, hd), k/v
    (b, kv, sk, hd); query head i reads kv head i // (h // kv)."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    k = k.repeat_interleave(h // kvh, dim=1)
    v = v.repeat_interleave(h // kvh, dim=1)
    m = torch.full((b, h, sq, 1), float("-inf"))
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, hd))
    qi = torch.arange(sq)[:, None]
    inv_cap = torch.tensor(1.0) / softcap if softcap > 0 else None
    # a tile that the mask hides from a row leaves that row as it was
    # (p = 0, corr = exp(0) = 1), so every row may walk every tile
    for k0 in range(0, sk, BK):
        kt, vt = k[:, :, k0:k0 + BK], v[:, :, k0:k0 + BK]
        s = _mm(q, kt.transpose(-1, -2), mode) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s * inv_cap)
        ki = torch.arange(k0, k0 + kt.shape[2])[None, :]
        mask = torch.ones((sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            mask &= ki <= qi
        if window > 0:
            mask &= ki > qi - window
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        live = ~torch.isneginf(m_new)
        p = torch.where(live, torch.exp(s - torch.where(live, m_new, 0.0)),
                        0.0)
        corr = torch.where(live, torch.exp(m - torch.where(live, m_new, 0.0)),
                           1.0)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + _mm(p, vt, mode)
        m = m_new
    return o * (1.0 / l.clamp_min(1e-37))


def _inputs(seed, b, h, kv, sq, sk, hd):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, h, sq, hd)).astype(f),
            rng.standard_normal((b, kv, sk, hd)).astype(f),
            rng.standard_normal((b, kv, sk, hd)).astype(f))


def _rel(got, want):
    """The largest |got - want| over its query row's largest |want|."""
    row = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((got - want).abs() / row).max())


def _error(mode, b, h, kv, sq, sk, hd, causal, window, softcap, seed=0):
    q, k, v = _inputs(seed, b, h, kv, sq, sk, hd)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap)
    want = torch.from_numpy(np.array(ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)))
    got = _kernel_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), mode=mode, **kw)
    return _rel(got, want)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("h,kv", [(4, 1), (4, 2)])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_split_tf32_holds_attn_rtol_of_the_reference(hd, h, kv, window,
                                                     softcap):
    """Causal, s 400 (13 key tiles, the last one partial), MQA and
    GQA."""
    assert _error("split", 1, h, kv, 400, 400, hd, True, window,
                  softcap) <= ATTN_RTOL


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_split_tf32_holds_attn_rtol_unaligned_non_causal(hd):
    """Not causal, sq < sk and sk not a multiple of the key tile."""
    assert _error("split", 2, 2, 1, 301, 557, hd, False, 0,
                  30.0) <= ATTN_RTOL


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_plain_tf32_misses_attn_rtol(hd):
    """The same walk with one TF32 product of rounded operands (what the
    tensor cores give f32 data unsplit) misses 1e-4 at every head_dim."""
    assert _error("tf32", 1, 4, 1, 600, 600, hd, True, 0, 0.0) > ATTN_RTOL

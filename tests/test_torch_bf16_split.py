"""The precision design of the bf16 kernels of B5 and B6
(``csrc/attention_bf16.cu``, ``csrc/ssd_bf16.cu``) checked on the CPU,
without a card.

Both run every product on the bf16 tensor cores with f32 sums.  Operands
that are bf16 in memory (q, k, v; x, B, C) enter exactly, and bf16 x bf16
products are exact in f32.  The f32 operands (B5's P; B6's G, the state S
and x·w) are split, a = hi + lo with hi = bf16(a) and lo = bf16(a - hi)
(round to nearest even, as ``__floats2bfloat162_rn``), and take two
products, hi·b + lo·b.  ``_attention`` copies B5's online softmax over
its key tiles (128 keys, 64 at hd 256) and ``_scan`` B6's chunked form
(each 256-row chunk's own end state, the carry, then 64-row sub-chunks
from the entering state, cumsums of dt·A in f64); both round their
outputs once to bf16, as the kernels write them.

On bf16 values drawn as ``test_flash_attention_kernel_takes_bf16`` and
``test_ssd_kernel_takes_bf16`` (``tests/test_torch_cuda.py``) draw them,
the emulations must hold the limits those card tests hold the kernels to,
against the
port's plain versions (``flash_attention_plain``, ``ssd_chunked``) and the
reference's (``ref.flash_attention_ref``, ``ssm.ssd_reference``) in f32 on
the same values: B5 within 1e-4 of the query row's largest |o| plus 2^-8
of |o| (one output rounding); B6's y within 1e-4 of the (batch, head)'s
largest |y| plus 2^-8 of |y|, its final state within 1e-4.  The same B5
walk with P rounded once to bf16 must miss its limit: that rounding is
as large as the output's and leaves no room, which is why the kernel
takes the second product.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import ssm as jssm
from repro_torch.kernels import flash_attention_plain, ssd_chunked

ATTN_RTOL = 1e-4
SSD_RTOL = 1e-4
OUT_ROUND = 2.0 ** -8          # one rounding to bf16, of |value|
LC, L = 256, 64                # B6's chunk and sub-chunk rows


def _bf(a: torch.Tensor) -> torch.Tensor:
    """a rounded to bf16 (to nearest even), back in f32."""
    return a.to(torch.bfloat16).float()


def _split_mm(a: torch.Tensor, b: torch.Tensor, split: bool = True):
    """a @ b with a f32 and b exact in bf16: hi·b + lo·b with f32 sums
    (``split``), or one product of a rounded to bf16."""
    hi = _bf(a)
    if not split:
        return hi @ b
    return hi @ b + _bf(a - hi) @ b


def _attention(q, k, v, *, scale, causal, window, softcap, split=True):
    """B5's bf16 kernel in f32 torch: q (b, h, sq, hd), k/v (b, kv, sk,
    hd), values exact in bf16; query head i reads kv head i // (h // kv).
    Returns the bf16 output as f32."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    bk = 64 if hd == 256 else 128
    k = k.repeat_interleave(h // kvh, dim=1)
    v = v.repeat_interleave(h // kvh, dim=1)
    m = torch.full((b, h, sq, 1), float("-inf"))
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, hd))
    qi = torch.arange(sq)[:, None]
    inv_cap = torch.tensor(1.0) / softcap if softcap > 0 else None
    # a tile that the mask hides from a row leaves that row as it was
    # (p = 0, corr = exp(0) = 1), so every row may walk every tile
    for k0 in range(0, sk, bk):
        kt, vt = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        s = (q @ kt.transpose(-1, -2)) * scale      # exact products
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
        o = o * corr + _split_mm(p, vt, split)
        m = m_new
    return _bf(o * (1.0 / l.clamp_min(1e-37)))


def _attn_inputs(seed, b, h, kv, sq, sk, hd):
    """Normal q, k, v rounded to bf16 (as the card test
    ``test_flash_attention_kernel_takes_bf16`` draws them)."""
    rng = np.random.default_rng(seed)
    return tuple(_bf(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32))) for shape in ((b, h, sq, hd), (b, kv, sk, hd),
                                    (b, kv, sk, hd)))


def _attn_excess(b, h, kv, sq, sk, hd, causal, window, softcap, split=True,
                 seed=0):
    """The largest error of the emulated kernel over its B5 limit,
    against the port's plain version and the reference (<= 1 holds)."""
    q, k, v = _attn_inputs(seed, b, h, kv, sq, sk, hd)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap)
    got = _attention(q, k, v, split=split, **kw)
    wants = (flash_attention_plain(q, k, v, **kw),
             torch.from_numpy(np.array(ref.flash_attention_ref(
                 *(jnp.asarray(t.numpy()) for t in (q, k, v)), **kw))))
    worst = 0.0
    for want in wants:
        row = want.abs().amax(-1, keepdim=True)
        limit = ATTN_RTOL * row + OUT_ROUND * want.abs()
        worst = max(worst, float(((got - want).abs() / limit.clamp_min(
            1e-30)).max()))
    return worst


# small versions of the served shapes: whisper's encoder (non-causal,
# hd 64) and decoder (causal MHA), the encdec and vision cross attention
# (sq != sk, sk not a multiple of the tile), vision's GQA self attention
# (hd 128), [serve]'s MQA window at hd 256, soft-caps
ATTN_SHAPES = [(1, 4, 4, 300, 300, 64, False, 0, 0.0),
               (1, 4, 4, 200, 200, 64, True, 0, 0.0),
               (1, 4, 4, 96, 301, 64, False, 0, 0.0),
               (1, 8, 2, 256, 256, 128, True, 0, 0.0),
               (1, 8, 2, 130, 321, 128, False, 0, 30.0),
               (1, 4, 1, 400, 400, 256, True, 100, 0.0),
               (1, 4, 2, 333, 333, 256, True, 0, 30.0),
               (2, 2, 1, 77, 201, 256, False, 50, 0.0)]


@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal,window,softcap",
                         ATTN_SHAPES)
def test_split_p_holds_b5_bf16_limit(b, h, kv, sq, sk, hd, causal, window,
                                     softcap):
    assert _attn_excess(b, h, kv, sq, sk, hd, causal, window, softcap) <= 1.0


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_single_rounded_p_misses_b5_bf16_limit(hd):
    """P rounded once to bf16 (one product, no lo) misses the limit at
    every head_dim: its 2^-9 of each weight lands on the outputs where
    the output rounding has already taken the 2^-8."""
    assert _attn_excess(1, 4, 4, 300, 300, hd, False, 0, 0.0,
                        split=False) > 1.0


def _scan(x, dt, a_log, B, C, s0):
    """B6's bf16 kernel in f32 torch: x (b, s, h, p), B, C (b, s, g, n)
    exact in bf16; dt (b, s, h), a_log (h,), s0 (b, h, p, n) f32.
    Returns (y rounded to bf16, as f32; the final state)."""
    b, s, h, p = x.shape
    g, n = B.shape[2:]
    grp = torch.arange(h) // (h // g)
    A = -torch.exp(a_log)
    xh = x.permute(0, 2, 1, 3)                       # (b, h, s, p)
    dth = dt.permute(0, 2, 1)                        # (b, h, s)
    Bh = B[:, :, grp].permute(0, 2, 1, 3)            # (b, h, s, n)
    Ch = C[:, :, grp].permute(0, 2, 1, 3)
    dA = (dth * A[:, None]).double()                 # f32 product, f64 sums
    y = torch.empty_like(xh)
    carry = s0.clone()
    for c0 in range(0, s, LC):
        rows = slice(c0, min(s, c0 + LC))
        # pass 1: the chunk's own end state, (x w)^T B with x w split
        cs = torch.cumsum(dA[..., rows], -1)
        total = cs[..., -1:]
        w = torch.exp((total - cs).float()) * dth[..., rows]
        xw = xh[:, :, rows] * w[..., None]
        local = _split_mm(xw.transpose(-1, -2), Bh[:, :, rows])
        decay = torch.exp(total.float())[..., None]
        # pass 2 hands `carry` in; pass 3: 64-row sub-chunks from it
        S = carry
        carry = carry * decay + local
        for t0 in range(rows.start, rows.stop, L):
            sub = slice(t0, min(rows.stop, t0 + L))
            cs = torch.cumsum(dA[..., sub], -1)
            dts = dth[..., sub]
            Cs, Bs, xs = Ch[:, :, sub], Bh[:, :, sub], xh[:, :, sub]
            G = Cs @ Bs.transpose(-1, -2)            # exact products
            gate = torch.exp((cs[..., :, None] - cs[..., None, :]).float())
            G = (G * gate * dts[..., None, :]).tril()
            # C S^T with S split: (S C^T)^T, the exact C on the right
            y_off = _split_mm(S, Cs.transpose(-1, -2)).transpose(-1, -2)
            y[:, :, sub] = y_off * torch.exp(cs.float())[..., None] + \
                _split_mm(G, xs)
            last = cs[..., -1:]
            w = torch.exp((last - cs).float()) * dts
            S = S * torch.exp(last.float())[..., None] + _split_mm(
                (xs * w[..., None]).transpose(-1, -2), Bs)
    return _bf(y.permute(0, 2, 1, 3)), carry


def _ssd_inputs(seed, b, s, h, p, n, g):
    """The serving statistics of ``test_ssd_kernel_takes_bf16``'s inputs,
    with x, B and C rounded to bf16: dt the softplus of a normal, A =
    -linspace(1, 16, h), x normal, B, C and the state 0.5 x normal."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = _bf(torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(f)))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal(
        (b, s, h)))).astype(f))
    a_log = torch.from_numpy(np.log(np.linspace(1.0, 16.0, h)).astype(f))
    B, C = (_bf(torch.from_numpy((rng.standard_normal((b, s, g, n))
                                  * 0.5).astype(f))) for _ in range(2))
    s0 = torch.from_numpy((rng.standard_normal((b, h, p, n)) * 0.5
                           ).astype(f))
    return x, dt, a_log, B, C, s0


@pytest.mark.parametrize("b,s,h,p,n,g", [(2, 600, 4, 64, 128, 1),
                                         (1, 600, 4, 64, 128, 2),
                                         (2, 300, 6, 40, 32, 3),
                                         (1, 130, 2, 16, 256, 1)])
def test_split_operands_hold_b6_bf16_limits(b, s, h, p, n, g):
    """Several 256-row chunks (and a partial one ending mid sub-chunk)
    from an initial state: y within 1e-4 of the (batch, head)'s largest
    |y| plus 2^-8 of |y|, the state within 1e-4, against ``ssd_chunked``
    and the reference's sequential ``ssd_reference``."""
    args = _ssd_inputs(7 + g, b, s, h, p, n, g)
    y, final = _scan(*args)
    wants = (ssd_chunked(*args[:5], 256, initial_state=args[5]),
             tuple(torch.from_numpy(np.array(w)) for w in
                   jssm.ssd_reference(*(jnp.asarray(t.numpy())
                                        for t in args[:5]),
                                      initial_state=jnp.asarray(
                                          args[5].numpy()))))
    for want_y, want_s in wants:
        scale = want_y.abs().amax(dim=(1, 3), keepdim=True)
        assert bool(((y - want_y).abs() <= SSD_RTOL * scale
                     + OUT_ROUND * want_y.abs()).all())
        sscale = want_s.abs().amax(dim=(2, 3), keepdim=True)
        assert bool(((final - want_s).abs() <= SSD_RTOL * sscale).all())


def test_split_is_exact_to_a_bf16_lo():
    """hi + lo is within 2^-16 of a (hi takes 8 significant bits, lo the
    next 8), and an operand already in bf16 splits into itself and 0."""
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10_000).astype(np.float32))
    hi = _bf(a)
    lo = _bf(a - hi)
    assert float(((hi + lo - a).abs() / a.abs()).max()) <= 2.0 ** -16
    assert torch.equal(_bf(hi - _bf(hi)), torch.zeros_like(hi))

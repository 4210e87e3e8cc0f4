"""The precision design of B6 (``csrc/ssm_kernels.cu``) checked on the CPU,
without a card.

The kernel runs its four products (C·Bᵀ, G·x, C·Sᵀ and (x·w)ᵀ·B) on the
tensor cores in TF32 with split operands: a = hi + lo, hi = a rounded to
TF32 as ``cvt.rna.tf32.f32`` rounds it, lo = a - hi handed to the tensor
cores as it is (they read the top 19 bits of a tf32 operand, so lo is
truncated there), and a·b ≈ lo_a·hi_b + hi_a·lo_b + hi_a·hi_b with f32
sums (``csrc/tf32_mma.cuh``, shared with B5).  ``_kernel_scan`` below
copies the kernel's chunked form (the chunk's own end state over 256
rows, the carry across chunks, then 64-row sub-chunks from each chunk's
entering state, cumsums of dt·A in f64) and rounds the operands of its
four products as the kernel does.  At the serving statistics (A up to
16, softplus dt, several 256-row chunks and an initial state) it must
stay within ``SSD_RTOL`` (1e-4 of the (batch, head)'s largest |value|,
the limit ``chip_smoke.py`` holds the kernel to) of the reference's
sequential ``ssd_reference``; the same form with plain TF32 operands
must not, which is why the kernel splits them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import ssd_chunked

SSD_RTOL = 1e-4
LC, L = 256, 64            # the kernel's chunk and sub-chunk rows


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to 10 mantissa bits, to nearest with ties away from zero
    (``cvt.rna.tf32.f32``): add half a unit of the 13 dropped bits to the
    magnitude, then drop them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _trunc(a: torch.Tensor) -> torch.Tensor:
    """The 13 low mantissa bits dropped: an f32 operand as the tensor cores
    read it in TF32."""
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a, b, mode):
    """a @ b as the tensor cores take it: ``split`` 3xTF32 (hi rounded, lo
    truncated), ``tf32`` one product of rounded operands, ``f32``
    unrounded (f32 sums in all)."""
    if mode == "f32":
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    if mode == "tf32":
        return ah @ bh
    al, bl = _trunc(a - ah), _trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _kernel_scan(x, dt, a_log, B, C, s0, mode):
    """B6's arithmetic in f32 torch on the CPU: x (b, s, h, p), dt (b, s,
    h), a_log (h,), B, C (b, s, g, n), s0 (b, h, p, n)."""
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
        # pass 1: the chunk's own end state and its decay
        cs = torch.cumsum(dA[..., rows], -1)
        total = cs[..., -1:]
        w = torch.exp((total - cs).float()) * dth[..., rows]
        xw = xh[:, :, rows] * w[..., None]
        local = _mm(xw.transpose(-1, -2), Bh[:, :, rows], mode)
        decay = torch.exp(total.float())[..., None]
        # pass 2 hands `carry` in; pass 3: 64-row sub-chunks from it
        S = carry
        carry = carry * decay + local
        for t0 in range(rows.start, rows.stop, L):
            sub = slice(t0, min(rows.stop, t0 + L))
            cs = torch.cumsum(dA[..., sub], -1)
            dts = dth[..., sub]
            Cs, Bs, xs = Ch[:, :, sub], Bh[:, :, sub], xh[:, :, sub]
            G = _mm(Cs, Bs.transpose(-1, -2), mode)
            gate = torch.exp((cs[..., :, None] - cs[..., None, :]).float())
            G = (G * gate * dts[..., None, :]).tril()
            y_off = _mm(Cs, S.transpose(-1, -2), mode)
            y[:, :, sub] = y_off * torch.exp(cs.float())[..., None] + _mm(
                G, xs, mode)
            last = cs[..., -1:]
            w = torch.exp((last - cs).float()) * dts
            S = S * torch.exp(last.float())[..., None] + _mm(
                (xs * w[..., None]).transpose(-1, -2), Bs, mode)
    return y.permute(0, 2, 1, 3), carry


def _inputs(seed, b, s, h, p, n, g):
    """The serving statistics of chip_smoke.py's ``ssd_inputs``: dt the
    softplus of a normal, A = -linspace(1, 16, h), x normal, B, C and the
    state 0.5 x normal."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(f)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(f)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(f)
    s0 = (rng.standard_normal((b, h, p, n)) * 0.5).astype(f)
    return x, dt, a_log, B, C, s0


def _rel(got, want, dims):
    """The largest |got - want| over the (batch, head)'s largest |want|."""
    scale = want.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max())


@pytest.fixture(scope="module")
def cases():
    """(inputs, the reference's (y, final state)) for g 1 and 2: 600 rows,
    two full 256-row chunks and a partial one ending mid sub-chunk."""
    out = {}
    for g in (1, 2):
        args = _inputs(15 + g, 2, 600, 4, 64, 128, g)
        want = jssm.ssd_reference(*(jnp.asarray(a) for a in args[:5]),
                                  initial_state=jnp.asarray(args[5]))
        out[g] = ([torch.from_numpy(a) for a in args],
                  [torch.from_numpy(np.array(w)) for w in want])
    return out


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("mode", ["split", "f32"])
def test_split_tf32_holds_ssd_rtol_of_the_oracle(cases, g, mode):
    args, (want_y, want_s) = cases[g]
    y, final = _kernel_scan(*args, mode)
    assert _rel(y, want_y, (1, 3)) <= SSD_RTOL
    assert _rel(final, want_s, (2, 3)) <= SSD_RTOL


@pytest.mark.parametrize("g", [1, 2])
def test_plain_tf32_misses_ssd_rtol(cases, g):
    args, (want_y, want_s) = cases[g]
    y, final = _kernel_scan(*args, "tf32")
    assert max(_rel(y, want_y, (1, 3)), _rel(final, want_s, (2, 3))) \
        > SSD_RTOL


def test_ssd_chunked_holds_ssd_rtol_of_the_oracle(cases):
    """B6's plain version is held to it within SSD_RTOL on the card, so
    it must itself sit well inside that of the oracle, as the
    reference's `ssd_chunked` does for the state.  Decays to the chunk's
    end taken as differences of two f32 cumsums (which reach ~-2,800 in
    a 256-row chunk at A = -16), where the reference sums the suffix,
    fail this at one chunk of 255 rows without a state (the first case);
    so does y when the in-chunk decays are differences of one f32
    cumsum, as in the reference (1.5e-05 there)."""
    rng = np.random.default_rng(1)
    f = np.float32
    x = rng.standard_normal((2, 255, 8, 64)).astype(f)
    dt = rng.standard_normal((2, 255, 8)).astype(f)
    B = (rng.standard_normal((2, 255, 1, 128)) * 0.5).astype(f)
    C = (rng.standard_normal((2, 255, 1, 128)) * 0.5).astype(f)
    x, dt, B, C = map(torch.from_numpy, (x, dt, B, C))
    dt = torch.nn.functional.softplus(dt)
    a_log = torch.log(torch.linspace(1.0, 16.0, 8))
    want_y, want_s = (torch.from_numpy(np.array(w)) for w in
                      jssm.ssd_reference(*(jnp.asarray(t.numpy()) for t in
                                           (x, dt, a_log, B, C))))
    y, final = ssd_chunked(x, dt, a_log, B, C, 256)
    assert _rel(y, want_y, (1, 3)) <= SSD_RTOL / 10
    assert _rel(final, want_s, (2, 3)) <= SSD_RTOL / 10
    _, ref_final = jssm.ssd_chunked(*(jnp.asarray(t.numpy()) for t in
                                      (x, dt, a_log, B, C)), 256)
    assert _rel(torch.from_numpy(np.array(ref_final)), want_s, (2, 3)) \
        <= SSD_RTOL / 10
    for g in (1, 2):
        args, (want_y, want_s) = cases[g]
        y, final = ssd_chunked(*args[:5], 256, initial_state=args[5])
        assert _rel(y, want_y, (1, 3)) <= SSD_RTOL / 10
        assert _rel(final, want_s, (2, 3)) <= SSD_RTOL / 10


def test_tf32_rounding_is_cvt_rna():
    """10 mantissa bits kept, the half-way case rounded away from zero,
    signs kept, and hi + lo (lo truncated) within 2^-20 of a normal f32
    a."""
    one = 1.0
    ulp = 2.0 ** -10                              # TF32's unit at 1.0
    a = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 **
                      -23, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, 3.0, -0.0])
    assert torch.equal(_tf32(a), want)
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi = _tf32(v)
    lo = _trunc(v - hi)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((hi + lo) - v).abs().max() / v.abs().max()) < 2 ** -20

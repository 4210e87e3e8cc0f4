"""B6's backward checked on the CPU, without a card.

``ssd_chunked_bwd`` (``repro_torch.kernels.ssd``) is the gradient of
``ssd_chunked`` by the chunked algorithm run in reverse, the passes of
the backward kernel (``csrc/ssd_bwd.cu``) as explicit steps.  It is held
to ``torch.autograd.grad`` of ``ssd_chunked`` and to ``jax.grad`` of the
reference's ``repro.models.ssm.ssd_chunked``.

``_kernel_bwd`` below copies the kernel's own order of work: each
256-row chunk's sum_i exp(cs_i) dy_i (x) C_i, the reverse walk over the
chunks' states, then in each chunk the states entering its 64-row
sub-chunks walked forward from the forward's saved state and the
sub-chunks walked back, with cumsums of dt·A in f64, and rounds the
operands of its products as the kernel does (split TF32, as
``tests/test_torch_ssd_split.py`` emulates the forward).  It must hold
each gradient within ``SSD_RTOL`` (1e-4 of the (batch, head)'s largest
|value|, the forward's limit) of the f64 gradient; the same order with
plain TF32 operands must miss it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels.ssd import ssd_chunked, ssd_chunked_bwd
from test_torch_ssd_split import _mm

SSD_RTOL = 1e-4
LC, L = 256, 64            # the kernel's chunk and sub-chunk rows
NAMES = ("dx", "ddt", "da_log", "dB", "dC", "ds0")


def _inputs(seed, b, s, h, p, n, g, state=True, dfinal=True,
            dtype=torch.float32):
    """The card tests' serving statistics: dt the softplus of a normal, A
    = -linspace(1, 16, h), x normal, B, C and the state 0.5 x normal;
    dy and the final state's gradient normal."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)
    x = r(b, s, h, p)
    dt = torch.nn.functional.softplus(r(b, s, h))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float64)
                      ).to(dtype)
    B, C = r(b, s, g, n, scale=0.5), r(b, s, g, n, scale=0.5)
    s0 = r(b, h, p, n, scale=0.5) if state else None
    dy = r(b, s, h, p)
    df = r(b, h, p, n) if dfinal else None
    return (x, dt, a_log, B, C, s0), dy, df


def _autograd(args, dy, df, chunk):
    """The gradients of ``ssd_chunked`` by autograd, in the inputs' dtype
    (the initial state's 0 where there is none)."""
    ins = [t.clone().requires_grad_(True) for t in args if t is not None]
    y, final = ssd_chunked(*ins[:5], chunk, ins[5] if len(ins) > 5 else None)
    loss = (y * dy).sum() + (0 if df is None else (final * df).sum())
    got = list(torch.autograd.grad(loss, ins))
    if len(got) == 5:
        got.append(None)
    return got


def _rel(got, want, dims):
    """The largest |got - want| over the largest |want| of each slice that
    ``dims`` spans (the whole tensor where ``dims`` is None)."""
    if dims is None:
        scale = want.abs().max().clamp_min(1e-30)
    else:
        scale = want.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    return float(((got - want).abs() / scale).max())


# each gradient's slices: dx, ddt per (batch, head), dB, dC per (batch,
# group), d a_log over the heads, the state's per (batch, head)
DIMS = ((1, 3), (1,), None, (1, 3), (1, 3), (2, 3))


def _worst(got, want):
    return {k: _rel(a.double(), w.double(), d)
            for k, a, w, d in zip(NAMES, got, want, DIMS) if w is not None}


CASES = [  # b, s, h, p, n, g, chunk, state, dfinal
    (2, 77, 4, 32, 16, 2, 16, True, True),
    (1, 130, 4, 32, 16, 1, 16, False, False),
    (2, 100, 4, 64, 128, 1, 64, True, False),
    (1, 300, 4, 32, 128, 2, 64, False, True),
    (1, 257, 2, 64, 256, 1, 256, True, True),
    (1, 300, 4, 32, 256, 2, 256, False, False),
    (2, 513, 4, 64, 16, 1, 256, True, True),
    (1, 600, 6, 32, 32, 3, 256, False, True),
]


@pytest.mark.parametrize("b,s,h,p,n,g,chunk,state,dfinal", CASES)
def test_plain_backward_matches_autograd(b, s, h, p, n, g, chunk, state,
                                         dfinal):
    """In f64 the two agree to rounding.  In f32 each gradient lies
    within 1e-5 of the largest of the f64 one (autograd's f32 d a_log
    strays to ~1e-4, its row sums less column sums cancelling)."""
    args, dy, df = _inputs(b * s + n, b, s, h, p, n, g, state, dfinal,
                           torch.float64)
    want = _autograd(args, dy, df, chunk)
    got = ssd_chunked_bwd(*args[:5], dy, chunk, args[5], df)
    assert all(t.dtype == torch.float64 for t in got)
    worst = _worst(got, want)
    assert max(worst.values()) <= 1e-11, worst
    f32 = [None if t is None else t.float() for t in (*args, dy, df)]
    got = ssd_chunked_bwd(*f32[:5], f32[6], chunk, f32[5], f32[7])
    assert all(t.dtype == torch.float32 for t in got)
    worst = _worst(got, want)
    assert max(worst.values()) <= 1e-5, worst
    if not state:   # the state's gradient is the one entering chunk 0
        ds0 = ssd_chunked_bwd(*f32[:5], f32[6], chunk,
                              torch.zeros_like(got[5]), f32[7])[5]
        torch.testing.assert_close(got[5], ds0, rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [16, 64, 256])
@pytest.mark.parametrize("g,state", [(1, True), (2, False)])
def test_plain_backward_matches_the_references_jax_grad(chunk, g, state):
    """``jax.grad`` of the reference's ``ssd_chunked`` at the same chunk,
    both in f64 (the reference's f32 cumsums stray ~1e-4 in d a_log),
    within 1e-10 of each gradient's largest."""
    args, dy, df = _inputs(chunk + g, 2, 200, 4, 32, 64, g, state, True,
                           torch.float64)
    n_in = 6 if state else 5
    with jax.enable_x64(True):
        def loss(*ins):
            y, final = jssm.ssd_chunked(*ins[:5], chunk,
                                        ins[5] if state else None)
            return (jnp.sum(y * jnp.asarray(dy.numpy()))
                    + jnp.sum(final * jnp.asarray(df.numpy())))
        want = jax.grad(loss, argnums=tuple(range(n_in)))(
            *(jnp.asarray(t.numpy()) for t in args[:n_in]))
        want = [torch.from_numpy(np.array(w)) for w in want]
    assert all(w.dtype == torch.float64 for w in want)
    got = ssd_chunked_bwd(*args[:5], dy, chunk, args[5], df)
    worst = _worst(got, want + [None] * (6 - n_in))
    assert max(worst.values()) <= 1e-10, worst


def _kernel_bwd(x, dt, a_log, B, C, s0, dy, df, mode):
    """B6's backward in f32 torch on the CPU, in the kernel's order: x,
    dy (b, s, h, p), dt (b, s, h), a_log (h,), B, C (b, s, g, n), s0 and
    df (b, h, p, n) or None.  Rows are padded with zeros to whole
    chunks, which the kernel reads as zeros (an identity step)."""
    b, s, h, p = x.shape
    g, n = B.shape[2:]
    nc = -(-s // LC)
    pad = nc * LC - s
    grp = torch.arange(h) // (h // g)

    def heads(t):
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)).permute(
            0, 2, 1, 3)
    xh, dyh = heads(x), heads(dy)                   # (b, h, S, p)
    Bh, Ch = heads(B)[:, grp], heads(C)[:, grp]     # (b, h, S, n)
    dth = torch.nn.functional.pad(dt, (0, 0, 0, pad)).permute(0, 2, 1)
    A = -torch.exp(a_log)
    dA = (dth * A[:, None]).double()                # f32 product, f64 sums
    zero = torch.zeros((b, h, p, n))
    s0 = zero if s0 is None else s0

    def cumsum(rows):
        return torch.cumsum(dA[..., rows], -1)

    # the forward's saved states: entering each chunk, and its decay
    states, decay, carry = [], [], s0
    for c in range(nc):
        rows = slice(c * LC, (c + 1) * LC)
        cs = cumsum(rows)
        w = torch.exp((cs[..., -1:] - cs).float()) * dth[..., rows]
        local = _mm((xh[:, :, rows] * w[..., None]).transpose(-1, -2),
                    Bh[:, :, rows], mode)
        states.append(carry)
        decay.append(torch.exp(cs[..., -1:].float())[..., None])
        carry = carry * decay[-1] + local
    # pass 1: each chunk's sum_i exp(cs_i) dy_i (x) C_i; pass 2: the walk
    # back over the chunks from the final state's gradient
    grad = zero if df is None else df
    leave = [None] * nc
    for c in reversed(range(nc)):
        rows = slice(c * LC, (c + 1) * LC)
        e = torch.exp(cumsum(rows).float())
        q = _mm((dyh[:, :, rows] * e[..., None]).transpose(-1, -2),
                Ch[:, :, rows], mode)
        leave[c] = grad
        grad = grad * decay[c] + q
    ds0 = grad
    # pass 3: each chunk's sub-chunks, the states entering them walked
    # forward from the chunk's, then the sub-chunks walked back
    dx, dBp, dC = (torch.zeros_like(t) for t in (xh, Bh, Ch))
    ddt_dir, ddA = torch.zeros_like(dth), torch.zeros_like(dA)
    causal = torch.ones((L, L), dtype=torch.bool).tril()
    for c in range(nc):
        subs = [slice(t0, t0 + L) for t0 in range(c * LC, (c + 1) * LC, L)]
        enter = [states[c]]
        for sub in subs[:-1]:
            cs = cumsum(sub)
            last = cs[..., -1:]
            w = torch.exp((last - cs).float()) * dth[..., sub]
            enter.append(enter[-1] * torch.exp(last.float())[..., None]
                         + _mm((xh[:, :, sub] * w[..., None]).transpose(
                             -1, -2), Bh[:, :, sub], mode))
        dH = leave[c]
        for k in reversed(range(len(subs))):
            sub, H = subs[k], enter[k]
            cs = cumsum(sub)
            last = cs[..., -1:]
            xs, dys, Bs, Cs, dts = (xh[:, :, sub], dyh[:, :, sub],
                                    Bh[:, :, sub], Ch[:, :, sub],
                                    dth[..., sub])
            es = torch.exp(cs.float())
            el = torch.exp((last - cs).float())
            gate = torch.exp((cs[..., :, None] - cs[..., None, :]).float())
            gate = gate.masked_fill(~causal, 0.0)
            scores = _mm(Cs, Bs.transpose(-1, -2), mode)  # the forward's
            Wd = _mm(dys, xs.transpose(-1, -2), mode) * gate
            dx[:, :, sub] = (_mm(Bs, dH.transpose(-1, -2), mode)
                             * el[..., None] + _mm((scores * gate).transpose(
                                 -1, -2), dys, mode)) * dts[..., None]
            db = _mm(xs, dH, mode) * el[..., None]
            to_state = dts * (Bs * db).sum(-1)
            db = db + _mm(Wd.transpose(-1, -2), Cs, mode)
            dc = _mm(dys, H, mode) * es[..., None]
            y_off = (Cs * dc).sum(-1)
            dc = dc + _mm(Wd, Bs * dts[..., None], mode)
            dBp[:, :, sub], dC[:, :, sub] = db * dts[..., None], dc
            ddt_dir[..., sub] = (Bs * db).sum(-1)
            W = Wd * scores * dts[..., None, :]
            W = torch.cumsum(W, -1) - W
            rect = W.flip(-2).cumsum(-2).flip(-2).diagonal(dim1=-2, dim2=-1)
            ddA[..., sub] = (
                rect.double() + y_off.double().flip(-1).cumsum(-1).flip(-1)
                + torch.cumsum(to_state.double(), -1) - to_state.double()
                + (torch.exp(last.float()) * (dH * H).sum((-1, -2))[
                    ..., None]).double())
            dH = dH * torch.exp(last.float())[..., None] + _mm(
                (dys * es[..., None]).transpose(-1, -2), Cs, mode)
    # pass 4: dt and a_log; pass 5: B and C summed over a group's heads
    ddt = ddt_dir + A[:, None] * ddA.float()
    da_log = (A.double() * (dth.double() * ddA).sum((0, 2))).float()

    def rows(t):
        return t.permute(0, 2, 1, 3)[:, :s]
    dB = rows(dBp).reshape(b, s, g, h // g, n).sum(3)
    dC = rows(dC).reshape(b, s, g, h // g, n).sum(3)
    return (rows(dx), ddt.permute(0, 2, 1)[:, :s], da_log, dB, dC, ds0)


@pytest.fixture(scope="module")
def kernel_cases():
    """(inputs, dy, df, the f64 gradients) for g 1 and 2: 600 rows, two
    full 256-row chunks and a partial one ending mid sub-chunk, with an
    initial state and the final state's gradient."""
    out = {}
    for g in (1, 2):
        args, dy, df = _inputs(25 + g, 2, 600, 4, 64, 128, g)
        want = ssd_chunked_bwd(*(t.double() for t in args[:5]), dy.double(),
                               LC, args[5].double(), df.double())
        out[g] = (args, dy, df, want)
    return out


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("mode", ["split", "f32"])
def test_split_tf32_backward_holds_ssd_rtol(kernel_cases, g, mode):
    args, dy, df, want = kernel_cases[g]
    got = _kernel_bwd(*args, dy, df, mode)
    worst = _worst(got, want)
    assert max(worst.values()) <= SSD_RTOL, worst


@pytest.mark.parametrize("g", [1, 2])
def test_plain_tf32_backward_misses_ssd_rtol(kernel_cases, g):
    args, dy, df, want = kernel_cases[g]
    worst = _worst(_kernel_bwd(*args, dy, df, "tf32"), want)
    assert max(worst.values()) > SSD_RTOL, worst


@pytest.mark.parametrize("s,state,dfinal", [(77, False, False),
                                            (256, True, False),
                                            (300, False, True)])
def test_kernel_order_matches_the_plain_backward(s, state, dfinal):
    """The kernel's order of work in f32 (no TF32 rounding) against
    ``ssd_chunked_bwd`` at the kernel's chunk, within 1e-5: a chunk
    shorter than a sub-chunk, one whole chunk, and a partial second."""
    args, dy, df = _inputs(s, 1, s, 4, 32, 16, 2, state, dfinal)
    got = _kernel_bwd(*args, dy, df, "f32")
    want = ssd_chunked_bwd(*args[:5], dy, LC, args[5], df)
    worst = _worst(got, want)
    assert max(worst.values()) <= 1e-5, worst

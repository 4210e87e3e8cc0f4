"""Mamba2 SSD chunked scan (B6): the wrapper and its plain PyTorch version.

``ssd_scan`` launches ``sage_ssd_scan`` (``csrc/ssm_kernels.cu``) on CUDA
tensors with f32 x, B, C and ``sage_ssd_scan_bf16`` (``csrc/ssd_bf16.cu``)
on ones with bf16 x, B, C, and runs ``ssd_chunked``, the reference's
chunked algorithm (arXiv:2405.21060 §6) written as explicit steps, on
CPU tensors; on a CUDA tensor it launches or raises, it never falls
back.  It replaces
``repro/kernels/ssd_scan.py`` ``_ssd_kernel`` and takes the model layout
of ``repro.kernels.ops.ssd_scan``: x (b, s, h, p); dt (b, s, h) after
softplus; a_log (h,) (A = -exp(a_log)); B, C (b, s, g, n) with h % g == 0,
head h reading group h // (h / g).  Unlike the reference's Pallas path it
also takes an initial state and returns the final one, (b, h, p, n) f32,
the contract of ``repro.models.ssm.ssd_chunked``, so a prefill can hand
the state to decode.

Nothing is padded: a partial last chunk is handled by its row count (the
reference's zero padding, dt = 0, is the identity anyway), and any s >= 1
goes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch._ext import count_launch
from repro_torch.kernels.grad import wants_grad, with_plain_grad
from repro_torch.kernels.sharded import (is_distributed, require_local,
                                         run_local)

KERNEL_STATES = (16, 32, 64, 128, 256)   # state sizes n the kernel takes
# the input types the CUDA route takes: f32 x, B, C launch the f32
# kernel, bf16 ones the bf16 kernel (dt, a_log and the state f32 in both)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# rows per chunk of the kernel's states and per sub-chunk of its scores:
# the scratch is sized by them, and the kernel refuses any other pair
KERNEL_CHUNK = 256
KERNEL_SUB = 64


def _segsum(cs: torch.Tensor) -> torch.Tensor:
    """(..., L) inclusive cumsum -> (..., L, L) lower-triangular segment
    sums cs_i - cs_j, the sum over (j, i] (-inf above the diagonal)."""
    L = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=cs.device).tril()
    return diff.masked_fill_(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the reference's algorithm.

    x: (b, s, h, p); dt: (b, s, h) (post-softplus); a_log: (h,) (A =
    -exp); B, C: (b, s, g, n) with h % g == 0.  Returns (y (b, s, h, p)
    in x.dtype, final_state (b, h, p, n)).  B and C are indexed by group,
    not repeated over the heads.  x, B and C narrower than f32 (the
    models' bf16) are computed in f32 and y is rounded once to x.dtype,
    where the reference rounds each product to bf16 (ROADMAP C23); the
    state stays f32.
    """
    out_dtype = x.dtype
    wide = torch.promote_types(x.dtype, torch.float32)
    x, B, C = (t.to(wide) for t in (x, B, C))
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    L = chunk
    xc = x.reshape(b, nc, L, h, p)
    dtc = dt.reshape(b, nc, L, h)
    Bc = B.reshape(b, nc, L, g, n)
    Cc = C.reshape(b, nc, L, g, n)

    A = -torch.exp(a_log)                              # (h,)
    dA = (dtc * A).permute(0, 1, 3, 2)                 # (b, nc, h, L)
    dt_hl = dtc.permute(0, 1, 3, 2)                    # (b, nc, h, L)

    # the in-chunk cumsum of dA in f64: an f32 one reaches ~-2,800 in a
    # 256-row chunk at A = -16, and its ulp there (2.4e-4) would land in
    # every decay.  The L x L decays take it as hi + lo in x's dtype,
    # exp(hi_i - hi_j) with exp(lo_i) and exp(-lo_j) as row and column
    # factors, so they cost no pass more than one f32 cumsum would.
    cs = torch.cumsum(dA.double(), dim=-1)             # (b, nc, h, L)
    hi = cs.to(dA.dtype)
    lo = (cs - hi).to(dA.dtype)

    # intra-chunk (diagonal blocks): Y = (C B^T . decay . causal) @ (dt*x)
    # (out of place throughout, so that autograd can take its gradient:
    # the card's backward of bf16 B6 recomputes this function)
    scores = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)   # (b,nc,g,L,L)
    gated = torch.exp(_segsum(hi)).view(b, nc, g, r, L, L)
    gated = gated * scores[:, :, :, None]
    gated = gated * (dt_hl * torch.exp(-lo)).reshape(b, nc, g, r, 1, L)
    y_diag = torch.matmul(gated.view(b, nc, h, L, L),
                          xc.permute(0, 1, 3, 2, 4))   # (b,nc,h,L,p)
    y_diag = y_diag * torch.exp(lo)[..., None]
    del gated, scores

    # chunk-final states: S_c = sum_t a(t->end) * dt_t * B_t (x) x_t
    decay_to_end = torch.exp(cs[..., -1:] - cs).to(dA.dtype)  # (b,nc,h,L)
    xw = xc * (decay_to_end * dt_hl).permute(0, 1, 3, 2)[..., None]
    states = torch.einsum("bclgrp,bclgn->bcgrpn",
                          xw.view(b, nc, L, g, r, p), Bc)
    states = states.reshape(b, nc, h, p, n)

    # inter-chunk recurrence over chunk states (the state entering each)
    chunk_decay = torch.exp(dA.sum(-1))                # (b,nc,h)
    carry = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state.to(x.dtype))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)             # (b,nc,h,p,n)

    # off-diagonal contribution: C_t . decay(start->t) . S_prev
    y_off = torch.einsum("bclgn,bcgrpn->bcgrlp", Cc,
                         prev_states.view(b, nc, g, r, p, n))
    y_off = y_off.reshape(b, nc, h, L, p) * torch.exp(cs).to(
        dA.dtype)[..., None]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, nc * L, h, p)
    return y[:, :s].to(out_dtype), carry


def ssd_chunked_bwd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                    chunk: int, initial_state: Optional[torch.Tensor] = None,
                    dfinal: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_chunked`` by the chunked algorithm run in
    reverse, the passes of B6's backward kernel (``csrc/ssd_bwd.cu``) as
    explicit steps.  ``dy`` is y's gradient, ``dfinal`` the final
    state's (None: 0).  Returns (dx, ddt, d a_log, dB, dC, d
    initial_state), in f32 or wider, the last one whatever
    ``initial_state`` is (its gradient is the state's entering the first
    chunk).

    With H_c the state entering chunk c, D_c its decay and cs the
    in-chunk cumsum of dt A: (1) Q_c = sum_i exp(cs_i) dy_i (x) C_i; (2)
    the reverse walk dS_c = dH_{c+1}, dH_c = D_c dH_{c+1} + Q_c from dH =
    ``dfinal``; (3) in each chunk, with M = C B^T exp(cs_i - cs_j) and
    Wd = dy x^T exp(cs_i - cs_j) (j <= i), e_j = exp(cs_last - cs_j):
      dx_j  = dt_j (M^T dy + e_j dS B_j),
      dB'_j = Wd^T C + e_j dS^T x_j           (dB = dt dB'),
      dC_i  = Wd (dt B) + exp(cs_i) dy_i H_c,
      ddt_j = B_j . dB'_j + A ddA_j,
    and the gradient of dA_k as sums that cancel nothing: over the
    rectangle i >= k > j of Wd C B^T dt_j, over rows i >= k of
    exp(cs_i) dy_i . H_c C_i, over rows j < k of e_j dt_j x_j . dS B_j,
    and D_c <dS, H_c>, the 1-D sums in f64.  (Autograd of
    ``ssd_chunked`` takes row sums less column sums, and its f32 d a_log
    strays ~1e-4 of its largest where this stays ~1e-6.)  d a_log = A sum
    dt ddA.  dB and dC sum the heads of a group."""
    wide = torch.promote_types(x.dtype, torch.float32)
    x, B, C, dy = (t.to(wide) for t in (x, B, C, dy))
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    nc = -(-s // chunk)
    pad = nc * chunk - s
    L = chunk

    def heads(t):       # (b, s, k, f) -> (b, k, nc, L, f), padded with 0
        t = F.pad(t, (0, 0, 0, 0, 0, pad))
        return t.reshape(b, nc, L, t.shape[2], t.shape[3]).permute(
            0, 3, 1, 2, 4)
    grp = torch.arange(h, device=x.device) // r
    xh, dyh = heads(x), heads(dy)                        # (b, h, nc, L, p)
    Bh, Ch = heads(B)[:, grp], heads(C)[:, grp]          # (b, h, nc, L, n)
    dth = F.pad(dt, (0, 0, 0, pad)).reshape(b, nc, L, h).permute(0, 3, 1, 2)

    A = -torch.exp(a_log)
    dA = dth * A[:, None, None]                          # (b, h, nc, L)
    cs = torch.cumsum(dA.double(), dim=-1)
    last = cs[..., -1:]
    to_end = torch.exp((last - cs).to(dA.dtype))         # exp(cs_last - cs)
    from_start = torch.exp(cs.to(dA.dtype))              # exp(cs)
    decay = torch.exp(last.to(dA.dtype))[..., None]      # (b, h, nc, 1, 1)

    # the states entering each chunk, and the one leaving it
    local = torch.matmul((xh * (to_end * dth)[..., None]).transpose(-1, -2),
                         Bh)                             # (b, h, nc, p, n)
    carry = (torch.zeros((b, h, p, n), dtype=wide, device=x.device)
             if initial_state is None else initial_state.to(wide))
    enter = []
    for c in range(nc):
        enter.append(carry)
        carry = carry * decay[:, :, c] + local[:, :, c]
    H = torch.stack(enter, dim=2)

    # (1) and (2): each chunk's leaving state's gradient
    Q = torch.matmul((dyh * from_start[..., None]).transpose(-1, -2), Ch)
    grad = (torch.zeros((b, h, p, n), dtype=wide, device=x.device)
            if dfinal is None else dfinal.to(wide))
    leave = [None] * nc
    for c in reversed(range(nc)):
        leave[c] = grad
        grad = grad * decay[:, :, c] + Q[:, :, c]
    dS = torch.stack(leave, dim=2)

    # (3): each chunk's own rows
    seg = (cs[..., :, None] - cs[..., None, :]).to(dA.dtype)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    E = torch.exp(seg.masked_fill_(~causal, float("-inf")))
    scores = torch.matmul(Ch, Bh.transpose(-1, -2))
    Wd = torch.matmul(dyh, xh.transpose(-1, -2)) * E      # dy x^T decayed
    dx = dth[..., None] * (to_end[..., None] * torch.matmul(
        Bh, dS.transpose(-1, -2)) + torch.matmul(
            (scores * E).transpose(-1, -2), dyh))
    del seg, E
    dB_state = to_end[..., None] * torch.matmul(xh, dS)
    dC_state = from_start[..., None] * torch.matmul(dyh, H)
    dBh = dB_state + torch.matmul(Wd.transpose(-1, -2), Ch)   # dB / dt
    dCh = dC_state + torch.matmul(Wd, Bh * dth[..., None])
    ddt = (Bh * dBh).sum(-1)                             # (b, h, nc, L)
    # ddA_k, each part a sum with no cancellation: the (i >= k, j < k)
    # rectangle of W = Wd C B^T dt_j, the y_off terms of rows i >= k, the
    # state terms of rows j < k and the chunk decay's
    W = Wd * scores * dth[..., None, :]
    del Wd, scores
    W = torch.cumsum(W, -1) - W                          # sum over j < k
    rect = W.flip(-2).cumsum(-2).flip(-2).diagonal(dim1=-2, dim2=-1)
    del W
    y_off = (Ch * dC_state).sum(-1).double()
    to_state = (dth * (Bh * dB_state).sum(-1)).double()
    ddA = (rect.double() + y_off.flip(-1).cumsum(-1).flip(-1)
           + torch.cumsum(to_state, -1) - to_state
           + (decay * dS * H).sum((-1, -2)).double()[..., None])
    ddt = ddt + A[:, None, None] * ddA.to(ddt.dtype)
    da_log = (A.double() * (dth.double() * ddA).sum((0, 2, 3))).to(A.dtype)

    def rows(t):        # (b, k, nc, L, f) -> (b, s, k, f)
        return t.permute(0, 2, 3, 1, 4).reshape(b, nc * L, t.shape[1],
                                                t.shape[4])[:, :s]
    dB = (dBh * dth[..., None]).view(b, g, r, nc, L, n).sum(2)
    dC = dCh.view(b, g, r, nc, L, n).sum(2)
    return (rows(dx), rows(ddt[..., None])[..., 0], da_log, rows(dB),
            rows(dC), grad)


def _check(x, dt, a_log, B, C, initial_state):
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"ssd_scan takes x (b, s, h, p) and B, C (b, s, g, "
                         f"n), got {tuple(x.shape)}, {tuple(B.shape)} and "
                         f"{tuple(C.shape)}")
    b, s, h, p = x.shape
    g = B.shape[2]
    if (tuple(B.shape[:2]) != (b, s) or g == 0 or h % g
            or tuple(dt.shape) != (b, s, h) or tuple(a_log.shape) != (h,)):
        raise ValueError(f"ssd_scan: dt must be (b, s, h) = {(b, s, h)}, "
                         f"a_log ({h},) and B, C (b, s, g, n) with h % g "
                         f"== 0; got dt {tuple(dt.shape)}, a_log "
                         f"{tuple(a_log.shape)}, B {tuple(B.shape)}")
    if initial_state is not None and tuple(initial_state.shape) != (
            b, h, p, B.shape[3]):
        raise ValueError(f"initial_state must be (b, h, p, n) = "
                         f"{(b, h, p, B.shape[3])}, got "
                         f"{tuple(initial_state.shape)}")
    if s == 0:
        raise ValueError("ssd_scan takes at least one step (s >= 1)")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b, s, h, p) in x.dtype, final state (b, h, p, n) f32).
    A CUDA tensor launches ``sage_ssd_scan`` on f32 x, B, C: its four
    kernels take each 64-row sub-chunk's C·Bᵀ once per group and the
    state at every ``KERNEL_CHUNK`` rows through scratch allocated here
    ((b, g, s/64, 64, 64) and (b, h, nc, p, n) f32), and walk each chunk
    in ``KERNEL_SUB``-row sub-chunks on the tensor cores (split TF32).
    On bf16 x, B, C it launches ``sage_ssd_scan_bf16`` (bf16 tensor
    cores, three kernels: the C·Bᵀ of each sub-chunk is taken where it is
    used, so only the states' scratch).  Both take contiguous inputs and
    n in ``KERNEL_STATES``.
    The chunked form is exact for any chunk
    length, so ``chunk`` only sets the plain version's chunks and the two
    differ by rounding.  A CPU tensor runs ``ssd_chunked``.

    Where autograd records and an input requires grad, the CUDA route
    still launches the kernel.  On f32 x, B, C it keeps the scratch
    (the states entering the chunks, their decays and the sub-chunks'
    C·Bᵀ: 54.5 MB a layer at mamba2's training shape) and its backward
    is a kernel too, ``sage_ssd_scan_bwd`` (``csrc/ssd_bwd.cu``, the
    passes of ``ssd_chunked_bwd``); on bf16 ones the backward is the
    gradient of ``ssd_chunked`` at ``chunk`` recomputed from the saved
    inputs (``kernels.grad``).  Either gives every input's gradient, the
    state's included.
    ``DTensor`` inputs run this on each rank's batch rows and heads
    (``kernels.sharded``; B and C split their groups with the heads,
    or stay whole where there is one group)."""
    _check(x, dt, a_log, B, C, initial_state)
    if is_distributed(x, dt, a_log, B, C, initial_state):
        grp = ("b", None, "h" if B.shape[2] > 1 else None, None)
        return run_local(
            lambda *a: ssd_scan(*a[:5], chunk, a[5]),
            (x, dt, a_log, B, C, initial_state),
            (("b", None, "h", None), ("b", None, "h"), ("h",), grp, grp,
             ("b", "h", None, None)),
            (("b", None, "h", None), ("b", "h", None, None)))
    tensors = (x, dt, a_log, B, C) + (
        () if initial_state is None else (initial_state,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: every input must be on one device")
    if not x.is_cuda:
        return ssd_chunked(x, dt, a_log, B, C, chunk, initial_state)
    if wants_grad(*tensors):
        if _name(x) == "ssd_scan":
            return _ScanWithKernelGrad.apply(x, dt, a_log, B, C,
                                             initial_state)
        return with_plain_grad(
            _launch, lambda *a: ssd_chunked(*a[:5], chunk, a[5]),
            x, dt, a_log, B, C, initial_state, kernel=_name(x))
    return _launch(x, dt, a_log, B, C, initial_state)


class _ScanWithKernelGrad(torch.autograd.Function):
    """B6 on f32 inputs that require grad: the forward's one launch,
    keeping its scratch, and a backward of one ``sage_ssd_scan_bwd``
    launch in a ``grad.recompute`` span (``kernel="ssd_scan"``, the name
    ``ssd_recompute_ms.train`` reads), counted as ``grad.ssd_bwd_kernel``
    in the span's unit."""

    @staticmethod
    def forward(ctx, x, dt, a_log, B, C, initial_state):
        y, final, kept = _launch(x, dt, a_log, B, C, initial_state,
                                 keep=True)
        ctx.dtypes = tuple(None if t is None else t.dtype
                           for t in (x, dt, a_log, B, C, initial_state))
        ctx.save_for_backward(*kept)
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        with trace.span("grad.recompute", device=True, kernel="ssd_scan"):
            trace.count("grad.ssd_bwd_kernel")
            grads = _launch_bwd(*ctx.saved_tensors, dy, dfinal,
                                ctx.needs_input_grad[5])
        return tuple(g.to(t) if need else None for g, t, need in
                     zip(grads, ctx.dtypes, ctx.needs_input_grad))


def _name(x) -> str:
    """The launch's name (its ``_ext.LAUNCHES`` key)."""
    return "ssd_scan_bf16" if x.dtype == torch.bfloat16 else "ssd_scan"


def _launch(x, dt, a_log, B, C, initial_state, keep=False):
    """One launch on checked CUDA inputs: ``sage_ssd_scan`` on f32 x, B, C
    (other inputs cast to f32), ``sage_ssd_scan_bf16`` on bf16 ones (no
    copy of x, B or C; dt, a_log and the state cast to f32, which they
    already are in the models: only tests/test_torch_cuda.py's
    ``test_ssd_kernel_takes_bf16`` hands in a bf16 state).  y comes back
    in x.dtype, the state in f32, as from ``ssd_chunked``.  No caller
    mixes the types of x, B and C, so a mix is refused.  ``keep`` (f32
    only): also return what the backward kernel reads, (x, dt, a_log, B,
    C, states, decay, scores) as launched."""
    require_local(x, dt, a_log, B, C, initial_state)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    tensors = (x, dt, a_log, B, C) + (
        () if initial_state is None else (initial_state,))
    if any(t.dtype not in KERNEL_DTYPES for t in tensors) or \
            not x.dtype == B.dtype == C.dtype:
        raise TypeError(f"sage_ssd_scan takes float32 or bfloat16 inputs, x, "
                        f"B and C of one type; got x {x.dtype}, B {B.dtype}, "
                        f"C {C.dtype}, dt {dt.dtype}, a_log {a_log.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sage_ssd_scan takes contiguous inputs")
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        dt, a_log = dt.float(), a_log.float()
    else:
        x, dt, a_log, B, C = (t.float() for t in (x, dt, a_log, B, C))
    if initial_state is not None:
        initial_state = initial_state.float()
    if any(t.data_ptr() % 16 for t in (B, C) + tensors[5:]):
        raise ValueError("sage_ssd_scan loads B, C and the initial state "
                         "16 bytes at a time: each must start on 16 bytes")
    if n not in KERNEL_STATES:
        raise ValueError(f"sage_ssd_scan takes a state size n in "
                         f"{KERNEL_STATES}, got {n}")
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    nc = -(-s // KERNEL_CHUNK)
    states = torch.empty((b, h, nc, p, n), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((b, h, nc), dtype=torch.float32, device=x.device)
    state_in = None if initial_state is None else initial_state.data_ptr()
    from repro_torch import _ext
    lib = _ext.library()
    name = _name(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if bf16:
            err = lib.sage_ssd_scan_bf16(
                x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B.data_ptr(),
                C.data_ptr(), state_in, b, s, h, p, g, n, y.data_ptr(),
                final.data_ptr(), states.data_ptr(), decay.data_ptr(),
                KERNEL_CHUNK, KERNEL_SUB, stream)
        else:
            scores = torch.empty((b, g, -(-s // KERNEL_SUB), KERNEL_SUB,
                                  KERNEL_SUB), dtype=torch.float32,
                                 device=x.device)
            err = lib.sage_ssd_scan(
                x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B.data_ptr(),
                C.data_ptr(), state_in, b, s, h, p, g, n, y.data_ptr(),
                final.data_ptr(), states.data_ptr(), decay.data_ptr(),
                scores.data_ptr(), KERNEL_CHUNK, KERNEL_SUB, stream)
    _ext.check(lib, err, name)
    count_launch(name)
    if keep:
        return y, final, (x, dt, a_log, B, C, states, decay, scores)
    return y, final


def _bwd_p_slice(n: int) -> int:
    """The p slice of the backward's per-chunk pass (its shared memory
    holds the slice's states): the kernel refuses any other."""
    return 64 if n <= 128 else 16


def _launch_bwd(x, dt, a_log, B, C, states, decay, scores, dy, dfinal,
                want_state):
    """One ``sage_ssd_scan_bwd`` launch on what ``_launch`` kept and the
    outputs' gradients (None: 0).  Returns (dx, ddt, d a_log, dB, dC, d
    initial_state or None), f32."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = states.shape[2]
    nps = -(-p // _bwd_p_slice(n))
    dev = x.device
    dy = (torch.zeros_like(x) if dy is None
          else dy.to(torch.float32).contiguous())
    if dfinal is not None:
        dfinal = dfinal.to(torch.float32).contiguous()
        if dfinal.data_ptr() % 16:
            dfinal = dfinal.clone()

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    dx, ddt, da_log = f32(b, s, h, p), f32(b, s, h), f32(h)
    dB, dC = f32(b, s, g, n), f32(b, s, g, n)
    ds0 = f32(b, h, p, n) if want_state else None
    # scratch: the chunks' leaving states' gradients, the states entering
    # two sub-chunks of each chunk, the per-slice partials of dB and dC
    # (over a group's heads) and of ddt's direct part and ddA
    dstates = f32(b, h, nc, p, n)
    hsub = f32(b, h, nc, KERNEL_CHUNK // KERNEL_SUB - 2, p, n)
    dbp, dcp = f32(b, s, g, h // g * nps, n), f32(b, s, g, h // g * nps, n)
    ddtp, ddap = f32(b, h, nps, s), f32(b, h, nps, s)
    from repro_torch import _ext
    lib = _ext.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sage_ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B.data_ptr(),
            C.data_ptr(), states.data_ptr(), decay.data_ptr(),
            scores.data_ptr(), dy.data_ptr(),
            None if dfinal is None else dfinal.data_ptr(), b, s, h, p, g, n,
            dx.data_ptr(), ddt.data_ptr(), da_log.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), None if ds0 is None else ds0.data_ptr(),
            dstates.data_ptr(), hsub.data_ptr(), dbp.data_ptr(),
            dcp.data_ptr(), ddtp.data_ptr(), ddap.data_ptr(), KERNEL_CHUNK,
            KERNEL_SUB, _bwd_p_slice(n), stream)
    _ext.check(lib, err, "ssd_scan_bwd")
    count_launch("ssd_scan_bwd")
    return dx, ddt, da_log, dB, dC, ds0

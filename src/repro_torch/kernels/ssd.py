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
    # the card's B6 backward recomputes this function)
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
    still launches the kernel, and its backward is the gradient of
    ``ssd_chunked`` at ``chunk`` recomputed from the saved inputs
    (``kernels.grad``), for every input the state included.
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
        return with_plain_grad(
            _launch, lambda *a: ssd_chunked(*a[:5], chunk, a[5]),
            x, dt, a_log, B, C, initial_state)
    return _launch(x, dt, a_log, B, C, initial_state)


def _launch(x, dt, a_log, B, C, initial_state):
    """One launch on checked CUDA inputs: ``sage_ssd_scan`` on f32 x, B, C
    (other inputs cast to f32), ``sage_ssd_scan_bf16`` on bf16 ones (no
    copy of x, B or C; dt, a_log and the state cast to f32, which they
    already are in the models: only tests/test_torch_cuda.py's
    ``test_ssd_kernel_takes_bf16`` hands in a bf16 state).  y comes back
    in x.dtype, the state in f32, as from ``ssd_chunked``.  No caller
    mixes the types of x, B and C, so a mix is refused."""
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
    name = "ssd_scan_bf16" if bf16 else "ssd_scan"
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
    return y, final

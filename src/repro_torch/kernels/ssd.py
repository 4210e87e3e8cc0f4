"""Mamba2 SSD chunked scan (B6): the wrapper and its plain PyTorch version.

``ssd_scan`` launches ``sage_ssd_scan`` (``csrc/ssm_kernels.cu``) on CUDA
tensors and runs ``ssd_chunked``, the reference's chunked algorithm
(arXiv:2405.21060 §6) written as explicit steps, on CPU tensors; on a
CUDA tensor it launches or raises, it never falls back.  It replaces
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

KERNEL_STATES = (16, 32, 64, 128, 256)   # state sizes n the kernel takes
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
    -exp); B, C: (b, s, g, n) with h % g == 0.  Returns (y (b, s, h, p),
    final_state (b, h, p, n)).  B and C are indexed by group, not
    repeated over the heads; the decay matrix is weighted in place.
    """
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
    scores = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)   # (b,nc,g,L,L)
    gated = _segsum(hi).exp_().view(b, nc, g, r, L, L)
    gated.mul_(scores[:, :, :, None]).mul_(
        (dt_hl * torch.exp(-lo)).reshape(b, nc, g, r, 1, L))
    y_diag = torch.matmul(gated.view(b, nc, h, L, L),
                          xc.permute(0, 1, 3, 2, 4))   # (b,nc,h,L,p)
    y_diag.mul_(torch.exp(lo)[..., None])
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
    return y[:, :s], carry


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
    """Returns (y (b, s, h, p), final state (b, h, p, n)).  A CUDA
    tensor launches ``sage_ssd_scan`` (f32, contiguous, n in
    ``KERNEL_STATES``): its four kernels take each 64-row sub-chunk's
    C·Bᵀ once per group and the state at every ``KERNEL_CHUNK`` rows
    through scratch allocated here ((b, g, s/64, 64, 64) and (b, h, nc,
    p, n) f32), and walk each chunk in ``KERNEL_SUB``-row sub-chunks on
    the tensor cores (split TF32).  The chunked form is exact for any chunk
    length, so ``chunk`` only sets the plain version's chunks and the two
    differ by rounding.  A CPU tensor runs ``ssd_chunked``."""
    _check(x, dt, a_log, B, C, initial_state)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    tensors = (x, dt, a_log, B, C) + (
        () if initial_state is None else (initial_state,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssd_scan: every input must be on one device")
    if not x.is_cuda:
        return ssd_chunked(x, dt, a_log, B, C, chunk, initial_state)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("sage_ssd_scan takes float32 inputs")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sage_ssd_scan takes contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors[3:]):
        raise ValueError("sage_ssd_scan loads B, C and the initial state "
                         "as float4: each must start on 16 bytes")
    if n not in KERNEL_STATES:
        raise ValueError(f"sage_ssd_scan takes a state size n in "
                         f"{KERNEL_STATES}, got {n}")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    nc = -(-s // KERNEL_CHUNK)
    states = torch.empty((b, h, nc, p, n), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((b, h, nc), dtype=torch.float32, device=x.device)
    scores = torch.empty((b, g, -(-s // KERNEL_SUB), KERNEL_SUB, KERNEL_SUB),
                         dtype=torch.float32, device=x.device)
    from repro_torch import _ext
    lib = _ext.library()
    with torch.cuda.device(x.device):
        err = lib.sage_ssd_scan(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B.data_ptr(),
            C.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            b, s, h, p, g, n, y.data_ptr(), final.data_ptr(),
            states.data_ptr(), decay.data_ptr(), scores.data_ptr(),
            KERNEL_CHUNK, KERNEL_SUB,
            torch.cuda.current_stream(x.device).cuda_stream)
    _ext.check(lib, err, "ssd_scan")
    count_launch("ssd_scan")
    return y, final

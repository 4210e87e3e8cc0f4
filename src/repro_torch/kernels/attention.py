"""Flash attention (B5): the wrapper, its plain PyTorch version, and the
model-layout entry point.

``flash_attention_kernel`` launches ``sage_flash_attention``
(``csrc/model_kernels.cu``) on f32 CUDA tensors and
``sage_flash_attention_bf16`` (``csrc/attention_bf16.cu``) on bf16 ones,
and runs ``flash_attention_plain`` on CPU tensors; on a CUDA tensor it
launches or raises, it never falls back.  It replaces
``repro/kernels/flash_attention.py`` ``_attn_kernel`` and takes its
layout: q (b, h, sq, hd), k/v (b, kv, sk, hd).  ``flash_attention`` takes
the model layout (b, s, heads, hd), as ``repro.kernels.ops.flash_attention``
does.

Unlike the reference's wrapper, nothing is padded: keys at index >= sk
do not exist, so a non-causal call over an unaligned sk is right too.
"""
from __future__ import annotations

import torch

from repro_torch._ext import count_launch
from repro_torch.kernels.grad import wants_grad, with_plain_grad
from repro_torch.kernels.sharded import (is_distributed, require_local,
                                         run_local)

# the input types the CUDA route takes: f32 q, k, v launch the f32
# kernel, bf16 ones the bf16 kernel (each reads its own type)
KERNEL_DTYPES = {torch.float32, torch.bfloat16}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: float, causal: bool = True,
                          window: int = 0, softcap: float = 0.0
                          ) -> torch.Tensor:
    """Materialised scores, the semantics of ``ref.flash_attention_ref``
    and of the kernel: f32 scores, soft-cap, then the mask (key j visible
    to query i iff j <= i when causal, j > i - window when window > 0),
    softmax, and a divide by max(l, 1e-37).  A query with no visible key
    gets 0.  q (b, h, sq, hd); k/v (b, kv, sk, hd); out in q.dtype."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, kvh, g * sq, hd)
    s = torch.matmul(qg, k.float().transpose(-1, -2)).mul_(scale)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = s.reshape(b, kvh, g, sq, sk)
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    s.masked_fill_(~mask, float("-inf"))
    # the row max only shifts the exponent, so its gradient cancels: it is
    # held constant, which leaves the in-place steps legal under autograd
    # (B5's backward recomputes and differentiates this)
    m = s.detach().amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = s.sub_(m).exp_()
    l = p.sum(-1, keepdim=True).clamp_min(1e-37)
    o = torch.matmul(p.reshape(b, kvh, g * sq, sk), v.float())
    o = o.reshape(b, kvh, g, sq, -1) / l
    return o.reshape(b, h, sq, -1).to(q.dtype)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention takes q (b, h, sq, hd) and k, v "
                         f"(b, kv, sk, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (batch, head_dim, h % kv)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, scale: float, causal: bool = True,
                           window: int = 0, softcap: float = 0.0
                           ) -> torch.Tensor:
    """q (b, h, sq, hd); k/v (b, kv, sk, hd) with h % kv == 0; returns
    (b, h, sq, hd) in q.dtype.  A CUDA tensor launches
    ``sage_flash_attention`` on f32 q, k, v or ``sage_flash_attention_bf16``
    on bf16 ones (contiguous, hd in {64, 128, 256}; the three of one
    type); a CPU tensor runs ``flash_attention_plain``.  Where autograd
    records and an input requires grad, the CUDA route still launches
    the kernel, and its
    backward is the gradient of ``flash_attention_plain`` recomputed from
    the saved inputs (``kernels.grad``).  ``DTensor`` inputs run this on
    each rank's batch rows and heads (``kernels.sharded``)."""
    _check(q, k, v)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if is_distributed(q, k, v):
        lab = ("b", "h", None, None)
        return run_local(flash_attention_kernel, (q, k, v), (lab,) * 3,
                         (lab,), **kw)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, **kw)
    if wants_grad(q, k, v):
        return with_plain_grad(
            lambda *a: _launch(*a, **kw),
            lambda *a: flash_attention_plain(*a, **kw), q, k, v)
    return _launch(q, k, v, **kw)


def _launch(q, k, v, *, scale, causal, window, softcap):
    """One launch on checked CUDA inputs: ``sage_flash_attention`` on f32
    q, k, v, ``sage_flash_attention_bf16`` on bf16 ones (no copy; TMA
    reads them where they lie), the output in their type.  No caller
    mixes the two types, so a mix is refused."""
    require_local(q, k, v)
    dtypes = {q.dtype, k.dtype, v.dtype}
    if len(dtypes) != 1 or not dtypes <= KERNEL_DTYPES:
        raise TypeError(f"flash attention takes q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("sage_flash_attention takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("sage_flash_attention takes q, k, v starting on a "
                         "16-byte boundary (it copies rows 16 bytes at a "
                         "time)")
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if hd not in (64, 128, 256):
        raise ValueError(f"sage_flash_attention takes head_dim 64, 128 or "
                         f"256, got {hd}")
    out = torch.empty_like(q)
    if sq == 0 or sk == 0 or b == 0:
        return out.zero_()
    from repro_torch import _ext
    name = ("flash_attention_bf16" if q.dtype == torch.bfloat16
            else "flash_attention")
    lib = _ext.library()
    with torch.cuda.device(q.device):
        err = getattr(lib, f"sage_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            kvh, sq, sk, hd, float(scale), int(bool(causal)), int(window),
            float(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    _ext.check(lib, err, name)
    count_launch(name)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Model layout: q (b, sq, h, hd); k/v (b, sk, kv, hd).  Returns
    (b, sq, h, hd)."""
    out = flash_attention_kernel(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), scale=scale, causal=causal,
        window=window, softcap=softcap)
    # contiguous here, where the caller's reshape would copy anyway: a
    # DTensor's reshape of the strided view fails in its backward
    return out.transpose(1, 2).contiguous()

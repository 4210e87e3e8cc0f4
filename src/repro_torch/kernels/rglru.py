"""RG-LRU scan (B7): the wrapper and its plain PyTorch version.

``rglru_scan`` launches ``sage_rglru_scan`` (``csrc/model_kernels.cu``)
on CUDA tensors and runs ``rglru_scan_plain`` on CPU tensors; on a CUDA
tensor it launches or raises, it never falls back.  It replaces
``repro/kernels/rglru_scan.py`` ``_rglru_kernel`` and takes the layout of
``repro.kernels.ops.rglru_scan``: a, x (b, s, w), h0 (b, w) or None.
Nothing is padded: any s and w go.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch._ext import count_launch
from repro_torch.kernels.grad import wants_grad, with_plain_grad
from repro_torch.kernels.sharded import (is_distributed, require_local,
                                         run_local)


def rglru_scan_plain(a: torch.Tensor, x: torch.Tensor,
                     h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sequential recurrence of ``ref.rglru_scan_ref``:
    h_t = a_t * h_{t-1} + x_t from h0 (or 0), a multiply and an add each
    rounded to f32, as the kernel does.  Returns (b, s, w) f32."""
    a, x = a.float(), x.float()
    b, s, w = a.shape
    h = (torch.zeros((b, w), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    out = torch.empty((b, s, w), dtype=torch.float32, device=a.device)
    for t in range(s):
        h = a[:, t] * h + x[:, t]
        out[:, t] = h
    return out


def rglru_scan(a: torch.Tensor, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, x: (b, s, w); h0: (b, w) or None.  Returns h (b, s, w) f32.  A
    CUDA tensor launches ``sage_rglru_scan`` (f32, contiguous); a CPU
    tensor runs ``rglru_scan_plain``.  Where autograd records and an
    input requires grad, the CUDA route still launches the kernel, and its
    backward is the gradient of ``rglru_scan_plain`` recomputed from the
    saved inputs (``kernels.grad``).  ``DTensor`` inputs run this on each
    rank's batch rows and width (``kernels.sharded``)."""
    if is_distributed(a, x, h0):
        lab = ("b", None, "h")
        return run_local(rglru_scan, (a, x, h0), (lab, lab, ("b", "h")),
                         (lab,))
    if a.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rglru_scan takes a, x of one (b, s, w) shape, "
                         f"got {tuple(a.shape)} and {tuple(x.shape)}")
    b, s, w = a.shape
    if h0 is not None and tuple(h0.shape) != (b, w):
        raise ValueError(f"h0 must be (b, w) = {(b, w)}, got "
                         f"{tuple(h0.shape)}")
    tensors = (a, x) if h0 is None else (a, x, h0)
    if any(t.device != a.device for t in tensors):
        raise ValueError("rglru_scan: a, x and h0 must share a device")
    if not a.is_cuda:
        return rglru_scan_plain(a, x, h0)
    if wants_grad(*tensors):
        return with_plain_grad(_launch, rglru_scan_plain, a, x, h0,
                               kernel="rglru_scan")
    return _launch(a, x, h0)


def _launch(a, x, h0):
    """One launch of ``sage_rglru_scan`` on checked CUDA inputs."""
    require_local(a, x, h0)
    b, s, w = a.shape
    tensors = (a, x) if h0 is None else (a, x, h0)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("sage_rglru_scan takes float32 a, x and h0")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sage_rglru_scan takes contiguous a, x and h0")
    out = torch.empty((b, s, w), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    from repro_torch import _ext
    lib = _ext.library()
    with torch.cuda.device(a.device):
        err = lib.sage_rglru_scan(
            a.data_ptr(), x.data_ptr(), None if h0 is None else h0.data_ptr(),
            b, s, w, out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    _ext.check(lib, err, "rglru_scan")
    count_launch("rglru_scan")
    return out

"""Operations and bytes, counted from shapes: the yardstick of the kernels'
rooflines and of the model-FLOPs shares, and the card's peaks.

Each input byte is counted once and each output byte once, whatever a
kernel reads again; a kernel's bound is the larger of its operations at
the peak rate and its bytes at the memory's rate.  A product of an m x k
by a k x n matrix is 2 m k n operations.
"""
from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense): the tensor cores' rate for each
# configuration dtype (float32 work reaches the tensor cores as TF32, and
# the split-TF32 kernels do float32-accurate work there), and HBM3.
PEAK_FLOPS = {"float32": 494.7e12, "bfloat16": 989.4e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def ssd_flops(b: int, s: int, h: int, p: int, n: int) -> int:
    """The SSD scan's least work, the step-by-step recurrence: a row of a
    head takes B x (2n + 2p; the decayed input) and the state's update
    and read (4 n p)."""
    return b * s * h * (2 * n + 2 * p + 4 * n * p)


def ssd_bytes(b: int, s: int, h: int, p: int, g: int, n: int,
              with_state: bool, width: int = 4) -> int:
    """x, dt, A, B, C (+ the initial state) in; y and the final state
    out."""
    words = (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
             + (2 if with_state else 1) * b * h * p * n)
    return words * width

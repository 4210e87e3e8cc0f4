"""Gradients through the model kernels B5, B6 and B7.

The reference has no backward kernel: JAX differentiates the plain
functions it trains with (``ssd_chunked``, the dense attention, the
associative scan), and no Pallas kernel of it has a ``custom_vjp``.  On
the card the port's forward launches the kernel, so the kernel's output
needs a gradient of its own: ``with_plain_grad`` wraps a launch in a
``torch.autograd.Function`` whose backward recomputes the kernel's plain
version from the saved inputs and returns ``torch.autograd.grad`` of it.
That is the gradient the reference takes, at the cost of one more
forward of the plain version per call.  Each backward is a
``grad.recompute`` span (``repro_torch.trace``), timed on the device
while tracing is on.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import trace


class _KernelWithPlainGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, launch, plain, kernel, *inputs):
        ctx.plain, ctx.kernel = plain, kernel
        ctx.save_for_backward(*inputs)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        with trace.span("grad.recompute", device=True, kernel=ctx.kernel):
            inputs = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            with torch.enable_grad():
                outs = ctx.plain(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            wrt = [t for t, n in zip(inputs, need) if n]
            got = iter(torch.autograd.grad(outs, wrt, grads,
                                           allow_unused=True))
            # each gradient in its input's dtype (a bf16 input's is bf16)
            return (None, None, None) + tuple(
                _like(next(got), t) if n else None
                for t, n in zip(inputs, need))


def _like(grad, t):
    return None if grad is None else grad.to(t.dtype)


def wants_grad(*tensors) -> bool:
    """True when autograd records and some input requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def with_plain_grad(launch: Callable, plain: Callable, *inputs,
                    kernel: Optional[str] = None):
    """``launch(*inputs)`` (the kernel: a tensor or a tuple of them) with
    the gradient of ``plain(*inputs)``.  Inputs may include None.  The
    backward is a ``grad.recompute`` span of ``repro_torch.trace`` whose
    ``kernel`` attribute names the kernel (its ``_ext.LAUNCHES`` key)."""
    return _KernelWithPlainGrad.apply(launch, plain, kernel, *inputs)

"""PyTorch/CUDA port of the SAGE reproduction, beside ``repro``.

The JAX package ``repro`` stays the reference; this package imports
neither it nor ``jax``.  It keeps its own copies of the JAX-free storage
core (``repro_torch.core``) and runs the in-storage analytics query
(``repro_torch.analytics``) on the card through hand-written CUDA
kernels (``csrc/``), built on first use by ``repro_torch._ext``.

Entry points default to the ``cuda`` device and raise when no card is
usable; pass ``device="cpu"`` to run every kernel's plain PyTorch
version instead.
"""
from repro_torch.device import NoCudaDeviceError, resolve_device  # noqa: F401

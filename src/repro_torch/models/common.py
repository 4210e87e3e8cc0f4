"""Shared model building blocks: norms, activations, RoPE, init, and the
activation-sharding rules.

Functional like the reference: parameters are plain nested dicts of
tensors, layers are functions.  Activation constraints go through a
context-managed ``AxisRules``, as in the reference: with the rules off
(the default) every ``shard_*`` returns its input, so a one-device run
is exactly what it was; with rules on (``axis_rules``, which the mesh
``Trainer`` enters with ``distributed.sharding.default_axis_rules``)
each constraint redistributes a ``DTensor`` activation to the
placements the rule names, which is where the collectives of
tensor parallelism run (a ``Partial`` sum is reduced, a sharded dim
gathered or split).  An activation that is not a ``DTensor`` under
enabled rules raises: the mesh is never switched off quietly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# Activation-sharding rules (t5x-style logical axes, minimal version)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Logical-axis -> mesh-axis rules for activation constraints, and
    the ``DeviceMesh`` they name."""

    batch: Tuple[str, ...] = ()        # e.g. ('pod', 'data')
    heads: Optional[str] = None        # e.g. 'model'
    ff: Optional[str] = None           # e.g. 'model'
    vocab: Optional[str] = None        # e.g. 'model'
    # 'model', or ('data','model') in the serving layout (1 expert/chip)
    expert: object = None
    seq: Optional[str] = None          # sequence parallelism
    enabled: bool = False
    mesh: object = None


_STATE = threading.local()


def current_rules() -> AxisRules:
    return getattr(_STATE, "rules", AxisRules())


@contextlib.contextmanager
def axis_rules(rules: AxisRules):
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def constrain(x: torch.Tensor, spec: Sequence) -> torch.Tensor:
    """Redistribute the ``DTensor`` ``x`` to ``spec`` (one entry per dim:
    None, a mesh-axis name or a tuple of names) on the rules' mesh."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"activation-sharding rules are on, but a "
                        f"{type(x).__name__} of shape {tuple(x.shape)} is "
                        f"not a DTensor")
    from repro_torch.distributed.sharding import placements
    mesh = current_rules().mesh
    return x.redistribute(mesh, placements(tuple(spec), mesh))


def on_replicas(fn, *args):
    """``fn(*args)`` on whole local copies of the ``DTensor`` arguments,
    every output back as a replicated ``DTensor`` of the same mesh: the
    way past an op that has no sharding rule (a stable sort, a scatter,
    a gather by computed indices).  Each rank computes the same whole
    result; the gradient flows back through the redistribution.  With
    no ``DTensor`` argument it is ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Replicate
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    whole = [Replicate()] * mesh.ndim
    out = fn(*(a.redistribute(mesh, whole).to_local()
               if isinstance(a, DTensor) else a for a in args))

    def wrap(t):
        if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
            return DTensor.from_local(t, mesh, whole, run_check=False)
        return t
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _batch(r: AxisRules):
    return r.batch if r.batch else None


def shard_batch_seq(x: torch.Tensor) -> torch.Tensor:
    """Constrain (batch, seq, ...) activations: batch->DP, optionally seq->SP."""
    r = current_rules()
    if not r.enabled:
        return x
    return constrain(x, [_batch(r), r.seq] + [None] * (x.dim() - 2))


def shard_heads(x: torch.Tensor) -> torch.Tensor:
    """Constrain (batch, seq, heads, head_dim) activations: heads->TP."""
    r = current_rules()
    if not r.enabled:
        return x
    return constrain(x, (_batch(r), None, r.heads, None))


def shard_ff(x: torch.Tensor) -> torch.Tensor:
    """Constrain (batch, seq, d_ff) activations: hidden->TP."""
    r = current_rules()
    if not r.enabled:
        return x
    return constrain(x, [_batch(r)] + [None] * (x.dim() - 2) + [r.ff])


def shard_vocab(x: torch.Tensor) -> torch.Tensor:
    r = current_rules()
    if not r.enabled:
        return x
    return constrain(x, [_batch(r)] + [None] * (x.dim() - 2) + [r.vocab])


# --------------------------------------------------------------------------
# Norms / activations
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, *,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm in f32 with cast back (gemma uses zero-centered scale)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    w = scale.float()
    if zero_centered:
        w = 1.0 + w
    return (y * w).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``: the tanh form, not torch's
    default erf form."""
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return gelu_tanh
    raise ValueError(f"unknown activation {name!r}")


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, fraction: float = 1.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension (f32)."""
    rot_dim = int(head_dim * fraction)
    rot_dim -= rot_dim % 2
    exponent = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                            device=device) / rot_dim
    return 1.0 / (theta ** exponent)       # (rot_dim // 2,)


@functools.lru_cache(maxsize=8)
def yarn_frequencies(dim: int, theta: float, factor: float, original: int,
                     beta_fast: float, beta_slow: float,
                     device=None) -> torch.Tensor:
    """YaRN's inverse frequencies (f32, ``dim // 2``): RoPE's, divided by
    ``factor`` below the correction range that rotates ``beta_slow``
    times over ``original`` positions, kept above the one that rotates
    ``beta_fast`` times, and blended linearly between them (DeepSeek-V3's
    ``precompute_freqs_cis``; arXiv:2309.00071).  Kept per arguments: a
    decode step reads them twice a layer.  Callers must not write into
    the tensor."""
    inv = rope_frequencies(dim, theta, device=device)

    def corr(rotations: float) -> float:
        return dim * math.log(original / (rotations * 2 * math.pi)) / (
            2 * math.log(theta))
    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    smooth = 1 - ramp
    return inv / factor * (1 - smooth) + inv * smooth


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: 0.1 mscale ln(factor) + 1 (1 where
    the positions are not stretched)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_inv_freq(cfg, dim: int, device=None) -> torch.Tensor:
    """The inverse frequencies of a configuration's rotated sub-dimension
    of width ``dim``: YaRN's where ``cfg.yarn_factor`` is set, else
    RoPE's."""
    if cfg.yarn_factor:
        return yarn_frequencies(dim, cfg.rope_theta, cfg.yarn_factor,
                                cfg.yarn_original_max_position,
                                cfg.yarn_beta_fast, cfg.yarn_beta_slow,
                                device)
    return rope_frequencies(dim, cfg.rope_theta, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0, *,
               inv_freq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply rotary embedding (half-split rotation).

    x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    With fraction < 1 only the leading ``fraction`` of head_dim is rotated
    (ChatGLM 2d-RoPE).  ``inv_freq`` replaces RoPE's frequencies (YaRN's).
    """
    head_dim = x.shape[-1]
    if inv_freq is None:
        inv_freq = rope_frequencies(head_dim, theta, fraction, x.device)
    rot_dim = inv_freq.shape[0] * 2
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]

    angles = positions[..., None].float() * inv_freq   # (..., seq, rot/2)
    cos = torch.cos(angles)[..., None, :]               # broadcast over heads
    sin = torch.sin(angles)[..., None, :]

    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    rotated = torch.cat([out1, out2], dim=-1).to(x.dtype)
    if rot_dim == head_dim:
        return rotated
    return torch.cat([rotated, x_pass], dim=-1)


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------

def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int],
               in_axis: int = 0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (within ±2σ, σ = fan_in^-0.5), drawn
    in f32 from ``gen`` on ``device``.  On the ``meta`` device nothing is
    drawn (shapes only)."""
    t = _empty(shape, torch.float32, device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(shape[in_axis] ** -0.5)
    return t.to(dtype)


def embed_init(gen: Optional[torch.Generator], shape: Sequence[int],
               dtype=torch.float32, device=None) -> torch.Tensor:
    # fan-in scale keeps tied-embedding logits O(1); archs with
    # embed_scale (gemma) recover O(1) inputs via the sqrt(d) multiplier.
    t = _empty(shape, torch.float32, device)
    if t.device.type != "meta":
        torch.nn.init.normal_(t, 0.0, shape[-1] ** -0.5, generator=gen)
    return t.to(dtype)

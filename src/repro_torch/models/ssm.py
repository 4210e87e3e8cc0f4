"""Mamba2 block, SSD (state-space duality) sequence mixing: the port of
``repro.models.ssm``.

The full-sequence block runs its scan through B6
(``repro_torch.kernels.ssd_scan``: the hand-written CUDA kernel on the
card, ``ssd_chunked`` on the CPU) unless the caller passes
``use_kernels=False``; then it takes ``ssd_chunked`` on any device: B6's
plain version (``kernels/ssd.py``), the reference's chunked algorithm.  ``ssd_reference`` is the
per-timestep sequential oracle.  Unlike the reference, whose prefill
never calls its Pallas kernel (that path returns no state), both paths
start from the cache's state and return the final one.

Decode carries (state, conv_tail): state (b, H, P, N), conv tail
(b, convw-1, conv_dim), both f32: O(1) per token, one step in plain
torch.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd import ssd_chunked, ssd_scan
from repro_torch.models import common
from repro_torch.models.common import dense_init


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm_headdim


def conv_dim(cfg: ModelConfig) -> int:
    return d_inner(cfg) + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_ssm(gen, cfg: ModelConfig, dtype=torch.float32,
             device=None) -> Dict:
    d = cfg.d_model
    di = d_inner(cfg)
    h = n_ssm_heads(cfg)
    cd = conv_dim(cfg)
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    proj_out = 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state + h
    return {
        "in_proj": dense_init(gen, (d, proj_out), **kw),
        "conv_w": dense_init(gen, (cfg.ssm_conv, cd), **kw),
        "conv_b": torch.zeros((cd,), **kw),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "dt_bias": torch.zeros((h,), **f32),
        "d_skip": torch.ones((h,), **f32),
        "norm": torch.ones((di,), **kw),
        "out_proj": dense_init(gen, (di, d), **kw),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di = d_inner(cfg)
    gn = cfg.ssm_ngroups * cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq, then silu (as the reference's;
    the rglru block's conv has no activation).  xbc: (b, s, cd); w: (k,
    cd)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i: i + s, :] * w[i]
    return F.silu(out + b)


def _conv_step(tail: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token depthwise conv.  tail: (b, k-1, cd); x_new: (b, cd)."""
    window = torch.cat([tail, x_new[:, None, :]], dim=1)     # (b, k, cd)
    out = torch.einsum("bkc,kc->bc", window, w.to(x_new.dtype)) + b
    return F.silu(out), window[:, 1:, :]


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------

def ssd_reference(x, dt, a_log, B, C, initial_state=None):
    """Sequential per-timestep oracle (tests)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = torch.repeat_interleave(B, rep, dim=2).float()
    Ch = torch.repeat_interleave(C, rep, dim=2).float()
    A = -torch.exp(a_log)
    xf, dtf = x.float(), dt.float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        a = torch.exp(dtf[:, t] * A)[:, :, None, None]      # (b,h,1,1)
        upd = torch.einsum("bh,bhn,bhp->bhpn", dtf[:, t], Bh[:, t], xf[:, t])
        state = state * a + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


# --------------------------------------------------------------------------
# Block-level forward
# --------------------------------------------------------------------------

def ssm_block(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
              use_kernels: bool = True) -> torch.Tensor:
    """Full-sequence Mamba2 mixer.  x: (b, s, d) (already normed)."""
    y, _, _ = _ssm_forward(p, x, cfg, initial_state=None,
                           use_kernels=use_kernels)
    return y


def _ssm_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                 initial_state: Optional[torch.Tensor], use_kernels: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (out, final state, pre-conv xbc).  B6 (``use_kernels``) or
    ``ssd_chunked`` from ``initial_state``."""
    b, s, _ = x.shape
    di = d_inner(cfg)
    h = n_ssm_heads(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state

    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(x.dtype),
                       p["conv_b"].to(x.dtype))
    xs = xbc[..., :di].reshape(b, s, h, cfg.ssm_headdim)
    B = xbc[..., di: di + g * n].reshape(b, s, g, n)
    C = xbc[..., di + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"])

    if use_kernels:
        y, final = ssd_scan(xs.contiguous(), dt, p["a_log"].float(),
                            B.contiguous(), C.contiguous(),
                            chunk=cfg.ssm_chunk,
                            initial_state=None if initial_state is None
                            else initial_state.float().contiguous())
    else:
        y, final = ssd_chunked(xs, dt, p["a_log"], B, C, chunk=cfg.ssm_chunk,
                               initial_state=initial_state)
    y = y.to(x.dtype) + xs * p["d_skip"].to(x.dtype)[:, None]
    y = y.reshape(b, s, di)
    y = common.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = torch.matmul(common.shard_ff(y), p["out_proj"].to(x.dtype))
    return out, final, xbc_raw


# --------------------------------------------------------------------------
# Decode (O(1) state)
# --------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> Dict:
    h = n_ssm_heads(cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "state": torch.zeros((batch, h, cfg.ssm_headdim, cfg.ssm_state),
                             **kw),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)), **kw),
    }


def ssm_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig, cache: Dict, *,
                use_kernels: bool = True) -> Tuple[torch.Tensor, Dict]:
    """The prompt from the cache's state.  The conv tail is the last k-1
    pre-conv xbc rows, taken from the one in_proj product (the reference
    computes the product again for it, with the same values)."""
    out, final, xbc = _ssm_forward(p, x, cfg, initial_state=cache["state"],
                                   use_kernels=use_kernels)
    km1 = cfg.ssm_conv - 1
    tail = xbc[:, -km1:, :].to(cache["conv"].dtype).contiguous()
    return out, {"state": final.to(cache["state"].dtype), "conv": tail}


def ssm_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig, cache: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """Single-token step.  x: (b, 1, d)."""
    b = x.shape[0]
    di = d_inner(cfg)
    h = n_ssm_heads(cfg)
    g, n = cfg.ssm_ngroups, cfg.ssm_state

    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    xbc_t, conv_tail = _conv_step(cache["conv"].to(x.dtype), xbc[:, 0],
                                  p["conv_w"].to(x.dtype),
                                  p["conv_b"].to(x.dtype))
    xs = xbc_t[..., :di].reshape(b, h, cfg.ssm_headdim)
    B = xbc_t[..., di: di + g * n].reshape(b, g, n)
    C = xbc_t[..., di + g * n:].reshape(b, g, n)
    dtt = F.softplus(dt[:, 0].float() + p["dt_bias"])          # (b, h)

    rep = h // g
    Bh = torch.repeat_interleave(B, rep, dim=1).float()
    Ch = torch.repeat_interleave(C, rep, dim=1).float()
    A = -torch.exp(p["a_log"])
    a = torch.exp(dtt * A)                                     # (b, h)
    state = cache["state"].float()
    state = state * a[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dtt, Bh, xs.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch, state).to(x.dtype)
    y = y + xs * p["d_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(b, 1, di)
    y = common.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"].to(x.dtype))
    return out, {"state": state.to(cache["state"].dtype),
                 "conv": conv_tail.to(cache["conv"].dtype)}

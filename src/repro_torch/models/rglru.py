"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
the port of ``repro.models.rglru``.

The full-sequence block runs its linear recurrence through B7
(``repro_torch.kernels.rglru_scan``: the hand-written CUDA kernel on the
card, the sequential plain version on the CPU) unless the caller passes
``use_kernels=False``; then it takes ``lru_scan``, a log-depth scan in
plain torch like the reference's associative scan.  Decode carries
(h, conv_tail): O(1) per token, one step in plain torch.

Gate projections are block-diagonal with n_heads blocks, as in the
reference implementation.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.models.common import dense_init, gelu_tanh

C_RGLRU = 8.0   # Griffin's fixed gate sharpness constant


def init_rglru(gen, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> Dict:
    d, w = cfg.d_model, cfg.lru_width
    h = cfg.n_heads
    bw = w // h
    kw = dict(dtype=dtype, device=device)
    lin = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=device)
    return {
        "w_x": dense_init(gen, (d, w), **kw),            # x branch
        "b_x": torch.zeros((w,), **kw),
        "w_y": dense_init(gen, (d, w), **kw),            # gate branch
        "b_y": torch.zeros((w,), **kw),
        "conv_w": dense_init(gen, (cfg.ssm_conv, w), **kw),
        "conv_b": torch.zeros((w,), **kw),
        # block-diagonal gate projections: (heads, bw, bw)
        "w_input_gate": dense_init(gen, (h, bw, bw), in_axis=1, **kw),
        "b_input_gate": torch.zeros((h, bw), **kw),
        "w_a_gate": dense_init(gen, (h, bw, bw), in_axis=1, **kw),
        "b_a_gate": torch.zeros((h, bw), **kw),
        # Λ parameter: a = sigmoid(lam) in (0.9, 0.999) at init
        "lam": torch.log(lin / (1 - lin)),
        "w_out": dense_init(gen, (w, d), **kw),
        "b_out": torch.zeros((d,), **kw),
    }


def _gates(p: Dict, xb: torch.Tensor, h: int):
    """Block-diagonal input/recurrence gates.  xb: (..., w)."""
    shp = xb.shape
    xh = xb.reshape(*shp[:-1], h, shp[-1] // h)
    gi = torch.einsum("...hk,hkj->...hj", xh, p["w_input_gate"].to(xb.dtype))
    gi = torch.sigmoid(gi + p["b_input_gate"].to(xb.dtype))
    ga = torch.einsum("...hk,hkj->...hj", xh, p["w_a_gate"].to(xb.dtype))
    ga = torch.sigmoid(ga + p["b_a_gate"].to(xb.dtype))
    return gi.reshape(shp), ga.reshape(shp)


def rglru_coeffs(p: Dict, xb: torch.Tensor, h: int):
    """-> (a, gated_input) with h_t = a_t * h_{t-1} + sqrt(1-a_t^2)*i_t*x_t."""
    gi, ga = _gates(p, xb, h)
    log_a = -C_RGLRU * ga.float() * F.softplus(p["lam"].float())
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    inp = mult * (gi.float() * xb.float())
    return a, inp


def lru_scan(a: torch.Tensor, x: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear recurrence h_t = a_t h_{t-1} + x_t by a log-depth scan
    (Hillis-Steele doubling: step k combines each element with the one
    2^k before it), the plain counterpart of the reference's
    associative scan.  a, x: (b, s, w) f32; h0: (b, w) optional."""
    a, h = a.float(), x.float().clone()
    if h0 is not None:
        # fold h0 into the first step: x_0' = x_0 + a_0 * h0
        h[:, 0] = h[:, 0] + a[:, 0] * h0.float()
    a = a.clone()
    s = a.shape[1]
    off = 1
    while off < s:
        h[:, off:] = h[:, off:] + a[:, off:] * h[:, :-off]
        a[:, off:] = a[:, off:] * a[:, :-off]
        off *= 2
    return h


def _causal_conv(p: Dict, xb: torch.Tensor, k: int,
                 conv_state: Optional[torch.Tensor]):
    """Causal depthwise conv of width k over the sequence -> (xc, tail)."""
    s = xb.shape[1]
    if conv_state is None:
        padded = F.pad(xb, (0, 0, k - 1, 0))
    else:
        padded = torch.cat([conv_state.to(xb.dtype), xb], dim=1)
    conv_tail = padded[:, padded.shape[1] - (k - 1):, :]
    w = p["conv_w"].to(xb.dtype)
    xc = 0
    for i in range(k):
        xc = xc + padded[:, i: i + s, :] * w[i]
    return xc + p["conv_b"].to(xb.dtype), conv_tail


def rglru_block(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
                h0: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                use_kernels: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence recurrent block.  x: (b, s, d) (already normed).

    Returns (out, final_h, conv_tail).
    """
    xb = torch.matmul(x, p["w_x"].to(x.dtype)) + p["b_x"].to(x.dtype)
    yb = torch.matmul(x, p["w_y"].to(x.dtype)) + p["b_y"].to(x.dtype)
    yb = gelu_tanh(yb)
    xc, conv_tail = _causal_conv(p, xb, cfg.ssm_conv, conv_state)

    a, inp = rglru_coeffs(p, xc, cfg.n_heads)
    if use_kernels:
        h = rglru_scan(a, inp, None if h0 is None else h0.float())
    else:
        h = lru_scan(a, inp, h0)
    final_h = h[:, -1]
    out = h.to(x.dtype) * yb
    out = torch.matmul(out, p["w_out"].to(x.dtype)) + p["b_out"].to(x.dtype)
    return out, final_h, conv_tail


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    return {
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.lru_width),
                            dtype=dtype, device=device),
    }


def rglru_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig, cache: Dict,
                  *, use_kernels: bool = True) -> Tuple[torch.Tensor, Dict]:
    out, final_h, conv_tail = rglru_block(
        p, x, cfg, h0=cache["h"], conv_state=None, use_kernels=use_kernels)
    return out, {"h": final_h.contiguous(),
                 "conv": conv_tail.to(cache["conv"].dtype).contiguous()}


def rglru_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig, cache: Dict
                 ) -> Tuple[torch.Tensor, Dict]:
    """Single-token step.  x: (b, 1, d)."""
    xb = torch.matmul(x, p["w_x"].to(x.dtype)) + p["b_x"].to(x.dtype)
    yb = torch.matmul(x, p["w_y"].to(x.dtype)) + p["b_y"].to(x.dtype)
    yb = gelu_tanh(yb)

    window = torch.cat([cache["conv"].to(xb.dtype), xb], dim=1)
    xc = torch.einsum("bkw,kw->bw", window, p["conv_w"].to(xb.dtype))
    xc = (xc + p["conv_b"].to(xb.dtype))[:, None, :]

    a, inp = rglru_coeffs(p, xc, cfg.n_heads)
    h = a[:, 0] * cache["h"] + inp[:, 0]
    out = h[:, None, :].to(x.dtype) * yb
    out = torch.matmul(out, p["w_out"].to(x.dtype)) + p["b_out"].to(x.dtype)
    return out, {"h": h, "conv": window[:, 1:].to(cache["conv"].dtype)}

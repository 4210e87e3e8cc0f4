"""Counts of MLA's prefill attention core, the yardstick of
``mla_attn_roofline.serve``.

The core's least work on a causal prompt of s tokens is each query's
scores over the keys up to its own and the weighted values: h s (s + 1)
/ 2 keys of 2 (qk + v) operations a head, qk = qk_nope_head_dim +
qk_rope_head_dim and v = v_head_dim at the model's widths (never a
kernel's padded ones).  Its least bytes are q and k (s h qk), v and the
output (s h v) once each.
"""
from __future__ import annotations

from typing import Dict


def _widths(m: Dict):
    return (m["n_heads"], m["qk_nope_head_dim"] + m["qk_rope_head_dim"],
            m["v_head_dim"])


def attention_flops(m: Dict, rows: int, s: int) -> int:
    h, qk, v = _widths(m)
    return rows * h * s * (s + 1) // 2 * 2 * (qk + v)


def attention_bytes(m: Dict, rows: int, s: int) -> int:
    h, qk, v = _widths(m)
    width = 4 if m["dtype"] == "float32" else 2
    return rows * s * h * 2 * (qk + v) * width

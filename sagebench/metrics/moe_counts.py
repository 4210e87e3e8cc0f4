"""Counts of the MoE block's expert work, and the program's records of
it that the ``moe_*.serve`` readers share.

The experts' least work on a prefill is each kept assignment (a token
routed to an expert and not dropped at its capacity) through a gated MLP
of width f: three products of d x f, 2 * 3 * d * f operations.  Their
least bytes are the weights of every expert a layer holds, read once a
call: 3 * d * f * E words.  Counting nothing else, a kernel that does
more work or reads more reads below 100 %.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def expert_flops(m: Dict, kept: int) -> int:
    return kept * 2 * 3 * m["d_model"] * m["d_expert"]


def expert_bytes(m: Dict, calls: int) -> int:
    width = 4 if m["dtype"] == "float32" else 2
    return calls * 3 * m["d_model"] * m["d_expert"] * m["n_experts"] * width


def traced_units(rec) -> Optional[List]:
    """The traced requests' ``serve.generate`` unit records: the first
    ``rec.traced`` that start at or after the traced window's start, on
    the clock the profiler and the program share."""
    try:
        from repro_torch import trace
    except ImportError:             # a program that keeps no records
        return None
    t = rec.trace
    if t is None or not t.lo or not rec.traced:
        return None
    us = [u for u in trace.units("serve.generate")
          if u.start_ns >= t.lo][:rec.traced]
    return us if len(us) == rec.traced else None


def prefill_spans(unit_ids) -> Dict[int, List]:
    """Each unit's ``serve.prefill`` span and the spans inside it, by
    unit id."""
    from repro_torch import trace
    spans = [s for s in trace.spans() if s.unit in unit_ids]
    inside = {s.id for s in spans if s.name == "serve.prefill"}
    grew = True
    while grew:
        more = {s.id for s in spans if s.parent in inside} - inside
        grew = bool(more)
        inside |= more
    out: Dict[int, List] = {u: [] for u in unit_ids}
    for s in spans:
        if s.id in inside:
            out[s.unit].append(s)
    return out


def span_ms(spans: List, name: str, calls: int) -> Optional[float]:
    """Device ms of the ``name`` spans, where there are ``calls`` of them
    and each recorded its events."""
    ms = [s.device_ms for s in spans if s.name == name]
    if len(ms) != calls or None in ms:
        return None
    return sum(ms)


def counted(spans: List, name: str) -> int:
    """The counts of ``name`` made inside the spans (a program whose spans
    keep no counts counts 0)."""
    return sum(getattr(s, "counts", {}).get(name, 0) for s in spans)

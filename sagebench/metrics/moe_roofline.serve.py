"""The routed experts' share of their roofline in the traced requests'
prefills, %: the least time of their work over the device ms of the
program's ``moe.experts`` spans (one a layer a prefill).  A prefill's
least time is the larger of its kept assignments' operations (routed
less dropped, the program's counts inside its ``serve.prefill`` span;
``moe_counts.expert_flops``) at the configuration dtype's peak, the
yardstick of ``mfu``, and its layers' expert weights read once
(``moe_counts.expert_bytes``) at the memory's rate."""
from sagebench.counts import bound_s
from sagebench.metrics.moe_counts import (counted, expert_bytes, expert_flops,
                                          prefill_spans, span_ms,
                                          traced_units)


def read(rec):
    us = traced_units(rec)
    if us is None:
        return None
    m = rec.model
    layers = m["n_layers"]
    inside = prefill_spans({u.id for u in us})
    least = busy = 0.0
    for u in us:
        spans = inside[u.id]
        ms = span_ms(spans, "moe.experts", layers)
        if ms is None:
            return None
        routed = counted(spans, "moe.assignments_routed")
        if not routed:
            return None
        kept = routed - counted(spans, "moe.assignments_dropped")
        least += bound_s(expert_flops(m, kept), expert_bytes(m, layers),
                         m["dtype"])
        busy += ms / 1e3
    return 100.0 * least / busy

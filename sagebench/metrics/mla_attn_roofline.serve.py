"""MLA's prefill attention core's share of its roofline in the traced
requests' prefills, %: the least time of its work over the device ms of
the program's ``mla.attention`` spans (one a layer a prefill: q, k and v
in, the heads' outputs out, whatever route the program takes).  A
layer's least time on a prompt is the larger of its causal operations
at the configuration dtype's peak, the yardstick of ``mfu``, and its
q/k/v/o bytes once at the memory's rate, both at the model's widths
(``mla_counts``)."""
from sagebench.counts import bound_s
from sagebench.metrics.mla_counts import attention_bytes, attention_flops
from sagebench.metrics.moe_counts import prefill_spans, span_ms, traced_units


def read(rec):
    us = traced_units(rec)
    if us is None:
        return None
    m = rec.model
    layers = m["n_layers"]
    inside = prefill_spans({u.id for u in us})
    least = busy = 0.0
    for u in us:
        ms = span_ms(inside[u.id], "mla.attention", layers)
        if ms is None:
            return None
        rows, s = u.attrs["batch"], u.attrs["prompt_len"]
        least += layers * bound_s(attention_flops(m, rows, s),
                                  attention_bytes(m, rows, s), m["dtype"])
        busy += ms / 1e3
    return 100.0 * least / busy

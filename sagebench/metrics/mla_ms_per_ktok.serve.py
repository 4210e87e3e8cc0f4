"""Device ms of the MLA blocks in the traced requests' prefills per
thousand prompt tokens: the CUDA events of the program's ``mla.block``
spans (one a layer a prefill) inside each ``serve.prefill`` span."""
from sagebench.metrics.moe_counts import prefill_spans, span_ms, traced_units


def read(rec):
    us = traced_units(rec)
    if us is None:
        return None
    inside = prefill_spans({u.id for u in us})
    total = 0.0
    for u in us:
        ms = span_ms(inside[u.id], "mla.block", rec.model["n_layers"])
        if ms is None:
            return None
        total += ms
    toks = sum(u.attrs["batch"] * u.attrs["prompt_len"] for u in us)
    return 1e3 * total / toks

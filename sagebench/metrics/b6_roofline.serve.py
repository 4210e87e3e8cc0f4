"""B6's share of its roofline in the traced requests' prefills: the least
time of its launches (``counts``: every layer over each request's
batch x prompt length, from the cache's state) over the device time of
its kernels in the trace, %."""
from sagebench.counts import bound_s, ssd_bytes, ssd_flops

KERNELS = r"ssd_(scores|state|carry|out)(_bf16)?_kernel"


def read(rec):
    t = rec.trace
    if t is None or not rec.traced:
        return None
    busy = t.kernel_s(KERNELS)
    if busy <= 0:
        return None
    m = rec.model
    h = m["ssm_expand"] * m["d_model"] // m["ssm_headdim"]
    p, g, n = m["ssm_headdim"], m["ssm_ngroups"], m["ssm_state"]
    width = 4 if m["dtype"] == "float32" else 2
    calls = rec.launches.get("ssd_scan", 0) + rec.launches.get(
        "ssd_scan_bf16", 0)
    units = rec.units[:rec.traced]
    if calls != m["n_layers"] * len(units):
        return None
    least = sum(m["n_layers"] * bound_s(
        ssd_flops(u["batch"], u["prompt_len"], h, p, n),
        ssd_bytes(u["batch"], u["prompt_len"], h, p, g, n, True, width),
        m["dtype"]) for u in units)
    return 100.0 * least / busy

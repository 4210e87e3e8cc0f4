"""B6's share of its roofline in the traced training steps: the least
time of its launches (``counts``: each a forward of every layer, no
initial state) over the device time of its kernels in the trace, %."""
from sagebench.counts import bound_s, ssd_bytes, ssd_flops

KERNELS = r"ssd_(scores|state|carry|out)(_bf16)?_kernel"


def read(rec):
    t = rec.trace
    if t is None or not rec.traced:
        return None
    busy = t.kernel_s(KERNELS)
    calls = rec.launches.get("ssd_scan", 0) + rec.launches.get(
        "ssd_scan_bf16", 0)
    if busy <= 0 or not calls:
        return None
    m, mix = rec.model, rec.traffic
    b, s = mix["batch"], mix["seq"]
    h = m["ssm_expand"] * m["d_model"] // m["ssm_headdim"]
    p, g, n = m["ssm_headdim"], m["ssm_ngroups"], m["ssm_state"]
    width = 4 if m["dtype"] == "float32" else 2
    one = bound_s(ssd_flops(b, s, h, p, n),
                  ssd_bytes(b, s, h, p, g, n, False, width), m["dtype"])
    return 100.0 * calls * one / busy

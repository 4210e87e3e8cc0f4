"""Device ms a traced step spends in B6's backward, the plain recompute
of ``ssd_chunked`` (C15): the CUDA events of the program's
``grad.recompute`` spans whose ``kernel`` is ``ssd_scan`` or
``ssd_scan_bf16`` (one a layer a step), over the traced steps.  The
traced steps' ``train.step`` unit records are the first of the window's
that start at or after the traced window's start."""

KERNELS = ("ssd_scan", "ssd_scan_bf16")


def read(rec):
    try:
        from repro_torch import trace
    except ImportError:             # a program that keeps no records
        return None
    t = rec.trace
    if t is None or not t.lo or not rec.traced:
        return None
    us = [u for u in trace.units("train.step")
          if u.start_ns >= t.lo][:rec.traced]
    if len(us) != rec.traced:
        return None
    ids = {u.id for u in us}
    ms = [s.device_ms for s in trace.spans()
          if s.unit in ids and s.name == "grad.recompute"
          and s.attrs.get("kernel") in KERNELS]
    if len(ms) != rec.model["n_layers"] * len(us) or None in ms:
        return None
    return sum(ms) / len(us)

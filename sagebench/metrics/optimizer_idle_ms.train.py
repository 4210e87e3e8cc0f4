"""Device-idle ms a traced step spends inside the optimizer: the time of
the program's ``train.optimizer`` span (``adamw_update``) less the union
of device operations within it, on the clock the profiler and the
program share, over the traced steps.  The traced steps' ``train.step``
unit records are the first of the window's that start at or after the
traced window's start."""


def _traced(rec):
    """The traced steps' unit records and the program's spans."""
    try:
        from repro_torch import trace
    except ImportError:             # a program that keeps no records
        return None, None
    t = rec.trace
    if t is None or not t.lo or t.busy_s <= 0 or not rec.traced:
        return None, None
    us = [u for u in trace.units("train.step")
          if u.start_ns >= t.lo][:rec.traced]
    if len(us) != rec.traced:
        return None, None
    return us, trace.spans()


def _idle_ns(t, s, e):
    """ns of [s, e] (within the window) in which no device op ran."""
    s, e = max(s, t.lo), min(e, t.hi)
    if e <= s:
        return 0
    return (e - s) - sum(max(0, min(e, be) - max(s, bs))
                         for bs, be in t.busy if be > s and bs < e)


def read(rec):
    us, spans = _traced(rec)
    if us is None:
        return None
    ids = {u.id for u in us}
    opt = [s for s in spans if s.unit in ids and s.name == "train.optimizer"]
    if len(opt) != len(us):
        return None
    t = rec.trace
    return sum(_idle_ns(t, s.start_ns, s.end_ns) for s in opt) / 1e6 / len(us)

"""The device's idle time inside the traced decode steps' issue spans
(the program's ``serve.decode.issue``: ``decode_step`` and the argmax
enqueued), as a share of the traced window: the span's time less the
union of device operations within it, on the clock the profiler and the
program share, %.  The traced requests' ``serve.generate`` unit records
are the first of the window's that start at or after the traced
window's start."""


def _traced(rec):
    """The traced requests' unit records and the program's spans."""
    try:
        from repro_torch import trace
    except ImportError:             # a program that keeps no records
        return None, None
    t = rec.trace
    if t is None or not t.lo or t.busy_s <= 0 or not rec.traced:
        return None, None
    us = [u for u in trace.units("serve.generate")
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
    issue = [s for s in spans
             if s.unit in ids and s.name == "serve.decode.issue"]
    if not issue or len(issue) != sum(
            u.counts.get("serve.decode_steps", 0) for u in us):
        return None
    t = rec.trace
    idle = sum(_idle_ns(t, s.start_ns, s.end_ns) for s in issue)
    return 100.0 * idle / (t.hi - t.lo)

"""Device operations a traced decode step launches: the operations of
the device trace that start between the step's ``serve.decode.issue``
span's start and the end of the ``serve.decode.wait`` span for its
token (the program's spans, on the clock the profiler and the program
share), over the traced requests' decode steps.  The traced requests'
``serve.generate`` unit records are the first of the window's that
start at or after the traced window's start."""
from bisect import bisect_left, bisect_right


def _traced(rec):
    """The traced requests' unit records and the program's spans."""
    try:
        from repro_torch import trace
    except ImportError:             # a program that keeps no records
        return None, None
    t = rec.trace
    if t is None or not t.lo or not t.ops or not rec.traced:
        return None, None
    us = [u for u in trace.units("serve.generate")
          if u.start_ns >= t.lo][:rec.traced]
    if len(us) != rec.traced:
        return None, None
    return us, trace.spans()


def read(rec):
    us, spans = _traced(rec)
    if us is None:
        return None
    ids = {u.id for u in us}
    issue, wait = {}, {}
    for s in spans:
        if s.unit in ids and s.name == "serve.decode.issue":
            issue[s.unit, s.attrs["step"]] = s
        elif s.unit in ids and s.name == "serve.decode.wait":
            wait[s.unit, s.attrs["step"]] = s
    steps = [(s.start_ns, wait[k].end_ns) for k, s in issue.items()
             if k in wait]
    if not steps or len(steps) != sum(
            u.counts.get("serve.decode_steps", 0) for u in us):
        return None
    starts = sorted(s for _, s, _ in rec.trace.ops)
    return sum(bisect_right(starts, e) - bisect_left(starts, s)
               for s, e in steps) / len(steps)

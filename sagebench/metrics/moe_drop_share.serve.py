"""The share of the MoE's assignments (a token routed to one of its top
k experts) dropped over an expert's capacity: the program's counts
``moe.assignments_dropped`` over ``moe.assignments_routed``, summed over
the window's ``serve.generate`` unit records, %.  The window's records
are the first of the window's count that start at or after the traced
window's start, on the clock the profiler and the program share.  0 is
a reading; a program that counts no assignment reads None."""


def _window(rec):
    try:
        from repro_torch import trace
    except ImportError:             # a program that keeps no records
        return None
    if rec.trace is None or not rec.trace.lo:
        return None
    us = [u for u in trace.units("serve.generate")
          if u.start_ns >= rec.trace.lo][:len(rec.units)]
    return us if us and len(us) == len(rec.units) else None


def read(rec):
    us = _window(rec)
    if us is None:
        return None
    routed = sum(u.counts.get("moe.assignments_routed", 0) for u in us)
    if not routed:
        return None
    return 100.0 * sum(u.counts.get("moe.assignments_dropped", 0)
                       for u in us) / routed

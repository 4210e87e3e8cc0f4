"""The share of decode steps that the Server replayed from a CUDA graph:
the program's counts ``serve.decode_graph_steps`` over
``serve.decode_steps``, summed over the ``serve.generate`` unit records
of the requests the profiler did not slow, %.  The window's records are
the first of the window's count that start at or after the traced
window's start, on the clock the profiler and the program share.  A
program that counts no graph step reads 0."""


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
    steady = us[rec.traced:] or us
    steps = sum(u.counts.get("serve.decode_steps", 0) for u in steady)
    if not steps:
        return None
    return 100.0 * sum(u.counts.get("serve.decode_graph_steps", 0)
                       for u in steady) / steps

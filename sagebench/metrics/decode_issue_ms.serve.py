"""Mean host ms a decode step spends issuing its work (the program's
``serve.decode.issue`` spans: ``decode_step`` and the argmax enqueued),
from the program's ``serve.generate`` unit records of the requests the
profiler did not slow.  The window's records are the first of the
window's count that start at or after the traced window's start, on the
clock the profiler and the program share."""


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
    return 1e3 * sum(u.seconds.get("serve.decode.issue", 0.0)
                     for u in steady) / steps

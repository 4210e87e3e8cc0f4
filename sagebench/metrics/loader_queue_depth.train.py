"""Mean batches ready in ``TokenLoader``'s queue as each step takes its
batch: the program's counts ``data.ready`` over ``data.takes``, which a
take carries into the ``train.step`` unit record it feeds, over the
steps the profiler did not slow.  The window's records are the first of
the window's count that start at or after the traced window's start, on
the clock the profiler and the program share (the step after the window
is not one of them)."""


def _window(rec):
    try:
        from repro_torch import trace
    except ImportError:             # a program that keeps no records
        return None
    if rec.trace is None or not rec.trace.lo:
        return None
    us = [u for u in trace.units("train.step")
          if u.start_ns >= rec.trace.lo][:len(rec.units)]
    return us if us and len(us) == len(rec.units) else None


def read(rec):
    us = _window(rec)
    if us is None:
        return None
    steady = us[rec.traced:] or us
    takes = sum(u.counts.get("data.takes", 0) for u in steady)
    if takes != len(steady):
        return None
    return sum(u.counts.get("data.ready", 0) for u in steady) / takes

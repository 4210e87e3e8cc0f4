"""The share of the latent slots that MLA's absorbed decode steps read
which hold a position the step attends to: the program's counts
``mla.decode_slots_valid`` over ``mla.decode_slots_read`` (a step reads
every slot of its cache), summed over the window's ``serve.generate``
unit records, %.  The window's records are the first of the window's
count that start at or after the traced window's start, on the clock the
profiler and the program share.  100 is a step that reads only the
positions it attends to; a program that does not count its decode slots
reads None."""


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
    read_ = sum(u.counts.get("mla.decode_slots_read", 0) for u in us)
    if not read_:
        return None
    return 100.0 * sum(u.counts.get("mla.decode_slots_valid", 0)
                       for u in us) / read_

"""The share of the experts whose weights the MoE's single-token (decode)
steps read: the program's counts ``moe.decode_experts_read`` over
``moe.decode_experts`` (E a call), summed over the window's
``serve.generate`` unit records, %.  The window's records are the first
of the window's count that start at or after the traced window's start,
on the clock the profiler and the program share.  100 is every expert
read each step; a program that does not count its decode experts reads
None."""


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
    experts = sum(u.counts.get("moe.decode_experts", 0) for u in us)
    if not experts:
        return None
    return 100.0 * sum(u.counts.get("moe.decode_experts_read", 0)
                       for u in us) / experts

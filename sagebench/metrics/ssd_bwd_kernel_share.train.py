"""The share of B6's backward passes that launch its backward kernel:
the program's count ``grad.ssd_bwd_kernel`` (one a backward that
launches ``sage_ssd_scan_bwd``) summed over the window's ``train.step``
unit records, over the model's layers times those units, %.  The
window's records are the first of the window's count that start at or
after the traced window's start, on the clock the profiler and the
program share.  100 is every layer's backward through the kernel; a
program that keeps records but no such count reads 0, one that keeps no
records None."""


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
    counted = sum(u.counts.get("grad.ssd_bwd_kernel", 0) for u in us)
    return 100.0 * counted / (rec.model["n_layers"] * len(us))

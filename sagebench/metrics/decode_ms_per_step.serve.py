"""The Server's decode time (its own host clock, synchronised) over its
decode steps, summed over the requests the profiler did not slow, ms a step."""


def read(rec):
    steps = sum(u["gen"] for u in rec.steady)
    return 1e3 * sum(u["decode_s"] for u in rec.steady) / steps

"""The Server's prefill time (its own host clock, synchronised) over the
prompt tokens of the requests the profiler did not slow, ms per
thousand tokens."""


def read(rec):
    toks = sum(u["batch"] * u["prompt_len"] for u in rec.steady)
    return 1e6 * sum(u["prefill_s"] for u in rec.steady) / toks

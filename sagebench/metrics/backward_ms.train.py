"""Mean device ms of a step's backward: from the CUDA event at the end of
the forward (``loss_fn``) to the one at the start of the optimizer
(``adamw_update``), over the steps the profiler did not slow."""
import statistics


def read(rec):
    ms = [u["backward_ms"] for u in rec.steady if "backward_ms" in u]
    return statistics.fmean(ms) if ms else None

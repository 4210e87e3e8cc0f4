"""Mean host ms a step spends waiting in ``next(loader)`` for its batch
from Clovis, over the steps the profiler did not slow."""
import statistics


def read(rec):
    return 1e3 * statistics.fmean(u["loader_wait_s"] for u in rec.steady)

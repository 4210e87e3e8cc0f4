"""90th percentile of the time to first token over every request of the
window, from its arrival to the end of its prefill, its wait in the queue
included.  Above the knee the queue grows through the window, so this
tail swings with the smallest change of pace: it is recorded, not judged
(``serve_tokens_per_s`` is)."""
import statistics


def read(rec):
    ttft = [u["ttft_s"] for u in rec.units]
    if len(ttft) < 10:
        return None
    return statistics.quantiles(ttft, n=10, method="inclusive")[-1]

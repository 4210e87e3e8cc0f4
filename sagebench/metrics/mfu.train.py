"""The model's operations in a training step (the configuration's
``reference.model_flops``, forward and backward) times the steps the
profiler did not slow, over their wall time times the card's peak for
the configuration's dtype, %."""
from sagebench.counts import PEAK_FLOPS


def read(rec):
    mix = rec.traffic
    flops = rec.cell.reference().model_flops(rec.model, mix["batch"],
                                             mix["seq"], train=True)
    steps = rec.steady
    return 100.0 * flops * len(steps) / (
        sum(u["wall_s"] for u in steps) * PEAK_FLOPS[rec.model["dtype"]])

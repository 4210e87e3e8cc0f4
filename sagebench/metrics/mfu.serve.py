"""The model's operations in the requests the profiler did not slow (the
configuration's ``reference.model_flops``: each prefill and its decode
steps) over their wall time times the card's peak for the
configuration's dtype, %."""
from sagebench.counts import PEAK_FLOPS


def read(rec):
    model_flops = rec.cell.reference().model_flops
    reqs = rec.steady
    flops = sum(model_flops(rec.model, u["batch"], u["prompt_len"],
                            u["gen"]) for u in reqs)
    return 100.0 * flops / (sum(u["wall_s"] for u in reqs)
                            * PEAK_FLOPS[rec.model["dtype"]])

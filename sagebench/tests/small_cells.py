"""The benchmark's cells at widths a CPU test holds: each configuration's
widths and depth cut, each mix's batch, lengths and corpus cut, and the
same limits.  The program runs its plain versions on the CPU."""
import copy
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path[0:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

from sagebench import harness  # noqa: E402

SMALL = {
    "mamba2-130m": dict(n_layers=2, d_model=64, vocab_size=256,
                        ssm_state=16, ssm_headdim=16, ssm_chunk=16),
}
SEED = 2**31 + 17


def small_cell(name: str, **traffic) -> harness.Cell:
    c = harness.Cell(name)
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(SMALL[c.config["name"]])
    t = copy.deepcopy(c.traffic)
    if t["driver"] == "train":
        t.update(batch=2, seq=32, corpus_shards=3, shard_tokens=512,
                 trace_units=2)
    else:
        t.update(prompt_len={"median": 30, "sigma": 0.6, "min": 16,
                             "max": 64},
                 arrivals={"shape": 0.5, "rate": 1000.0}, strata=4, gen=3,
                 checked_tokens=12, trace_units=2)
    t.update(traffic)
    c.traffic = t
    return c

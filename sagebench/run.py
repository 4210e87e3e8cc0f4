#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this machine holds.

    python3 sagebench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the checks (each number compared, beside its limit) as the last
lines of standard error, then one JSON object as the last line of
standard output.  Exits non-zero, with no result, where no card is
present, where the program is missing, or where the process has loaded
JAX or the JAX package.  See sagebench/README.md.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# the checkout (for the ``sagebench`` package) and the program's ``src``,
# in place of this script's own directory
sys.path[0:1] = [str(CHECKOUT), str(CHECKOUT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from sagebench import harness
    cell = harness.Cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process loaded {bad}: the benchmark runs the PyTorch "
              "port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The readings that the limits of ``sagebench/limits/<cell>.json`` are
set from (the benchmark's own runs do not run this).

For each seed, in one process: a run of the cell with a short window at
the cell's own load and sizes, and its check's readings (the program's);
then, on the first ``--control`` seeds, the control's: the reference
itself computed at TF32, the precision one step below the
configurations' float32, put in the program's place.  For serving, the
control's ``logit_err`` is read at the served positions and its
``token_gap`` at every position of the prompts and served tokens (the
token that TF32 puts first, under the float32 reference); for training,
the TF32 reference's steps against the float32 reference's.  ``--fault
half_batch`` plants the fault of a training step that leaves half of the
batch out (the mean taken over the rest) and reads the program's numbers
under it.  One JSON line a seed goes to standard output.

    python3 sagebench/control.py --workload mamba2-train \\
        --seeds 11,12,13 --seconds 2 --control 3
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0:1] = [str(CHECKOUT), str(CHECKOUT / "src")]

import torch  # noqa: E402

from sagebench import harness  # noqa: E402
from sagebench.drivers import serve as serve_driver  # noqa: E402
from sagebench.drivers import train as train_driver  # noqa: E402

BLOCK = 2048          # positions a block when every position's logits are read


@torch.no_grad()
def serve_control(ctx, rec):
    """The TF32 reference in the program's place, judged by the float32
    reference."""
    ref, m = ctx.cell.reference(), ctx.cell.model
    worst = {"logit_err": 0.0, "token_gap": 0.0}
    for j in rec.sample:
        u = rec.units[j]
        p = torch.as_tensor(u["prompts"], device=ctx.device)
        s = torch.as_tensor(u["served"], device=ctx.device)
        h19 = ref.serve_hidden(rec.params, p, s, m, True)
        h32 = ref.serve_hidden(rec.params, p, s, m, False)
        L = p.shape[1]
        want = ref.head(rec.params, h32[:, L - 1:], m, False)
        low = ref.head(rec.params, h19[:, L - 1:], m, True)
        worst["logit_err"] = max(worst["logit_err"], float(
            ((low - want).abs().amax(-1) / want.abs().amax(-1)).max()))
        for row in range(h32.shape[0]):
            for a in range(0, h32.shape[1], BLOCK):
                w = ref.head(rec.params, h32[row, a:a + BLOCK], m, False)
                first = ref.head(rec.params, h19[row, a:a + BLOCK], m,
                                 True).argmax(-1)
                gap = w.amax(-1) - w.gather(-1, first[:, None])[:, 0]
                worst["token_gap"] = max(worst["token_gap"],
                                         float(gap.max()))
    return worst


def train_control(ctx, rec):
    """Each stretch the check follows, taken by the TF32 reference from
    the same start, against the float32 reference's."""
    return train_driver.worst([train_driver.compare(
        train_driver.reference_steps(ctx, rec, st, tf32=True),
        train_driver.reference_steps(ctx, rec, st, tf32=False))
        for st in rec.follow])


def halved(step):
    """``Trainer.step`` with the fault of a step that leaves half of the
    batch out, the mean taken over the rest."""
    def step_half(self, params, opt, batch):
        rows = len(batch["tokens"]) // 2
        return step(self, params, opt, {k: v[:rows]
                                        for k, v in batch.items()})
    return step_half


@contextlib.contextmanager
def half_batch():
    from repro_torch.launch.train import Trainer
    step = Trainer.step
    Trainer.step = halved(step)
    try:
        yield
    finally:
        Trainer.step = step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=0,
                    help="on how many of the seeds to read the control")
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from sagebench.reference.common import exact_f32
    exact_f32()
    dev = torch.device("cuda", 0)
    cell = harness.Cell(args.workload)
    driver = serve_driver if cell.traffic["driver"] == "serve" \
        else train_driver
    fault = half_batch if args.fault else contextlib.nullcontext
    for k, seed in enumerate(int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        with harness.store_under(Path(harness.tempfile.mkdtemp(
                dir=harness.os.environ.get("TMPDIR")))) as root:
            ctx = harness.Context(cell, seed, args.seconds, False, dev,
                                  root, t0)
            with fault():
                rec = driver.measure(ctx)
            line = {"seed": seed, "units": len(rec.units),
                    "program": {n: c["value"] for n, c in
                                driver.check(ctx, rec).items()}}
            if k < args.control:
                line["control"] = (serve_control(ctx, rec)
                                   if driver is serve_driver
                                   else train_control(ctx, rec))
            harness.shutil.rmtree(root, ignore_errors=True)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del rec, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

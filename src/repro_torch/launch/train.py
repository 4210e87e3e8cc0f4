"""End-to-end training driver (the port of ``repro.launch.train``).

Runs a training loop with the SAGE substrate engaged: the corpus read
from the object store (``data.pipeline``), streaming / window /
collective checkpoints committed through Clovis transactions,
preemption (SIGTERM -> checkpoint -> exit), HA monitoring and ADDB
telemetry.  Restart resumes from the latest checkpoint.  On the card the
model's scans and attention run through the hand-written kernels, with
their gradients (``kernels.grad``).

There is no mesh yet: ``data_mesh`` or ``model_mesh`` above 1 waits for
the distributed slice (ROADMAP A13).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --device cpu --smoke --steps 20

On the card (the default device) drop ``--device cpu``.
"""
from __future__ import annotations

import argparse
import signal
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import Clovis, HAMonitor
from repro_torch.data.pipeline import TokenLoader, build_synthetic_corpus
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as mdl
from repro_torch.models.transformer import not_ported
from repro_torch.optim import AdamWState, init_error_feedback, init_opt_state


class Trainer:
    def __init__(self, cfg, run: RunConfig, root: Path, *,
                 data_mesh: int = 1, model_mesh: int = 1,
                 param_dtype=torch.float32, device: DeviceLike = None):
        if data_mesh > 1 or model_mesh > 1:
            raise not_ported(f"a {data_mesh} x {model_mesh} mesh", "A13")
        self.cfg = cfg
        self.run = run
        self.device = resolve_device(device)
        self.clovis = Clovis(root, device=self.device)
        self.ha = HAMonitor(self.clovis.store)
        self.ckpt = CheckpointManager(self.clovis,
                                      strategy=run.checkpoint_strategy)
        self._preempted = False
        self.param_dtype = param_dtype
        self.train_step = make_train_step(cfg, run)

    # -- preemption: SIGTERM triggers an immediate streamed checkpoint --
    def install_signal_handler(self, state_ref):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)

    def init_state(self, seed: int = 0):
        params = mdl.init_params(self.cfg, seed=seed, device=self.device,
                                 dtype=self.param_dtype)
        return params, init_opt_state(params)

    def try_restore(self):
        step = self.ckpt.latest_step()
        if step is None:
            return None
        params_like = mdl.params_like(self.cfg, dtype=self.param_dtype)
        opt_like = init_opt_state(params_like)
        state = self.ckpt.restore(step, like={"params": params_like,
                                              "opt": opt_like},
                                  device=self.device)
        opt = state["opt"]
        return step, state["params"], AdamWState(opt.step, opt.m, opt.v)

    def train(self, steps: int, loader, *, start_step: int = 0,
              params=None, opt_state=None, log_every: int = 10):
        if params is None:
            params, opt_state = self.init_state(self.run.seed)
        self.install_signal_handler((params, opt_state))
        # built and never applied, as in the reference's Trainer
        # (ROADMAP C13): its losses are the reference's
        err_fb = (init_error_feedback(params)  # noqa: F841
                  if self.run.grad_compression == "int8" else None)
        history = []
        step = start_step
        t_last = time.time()
        while step < steps:
            batch = next(loader)
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in batch.items()}
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch)
            step += 1
            if step % log_every == 0 or step == steps:
                loss = float(metrics["loss"])
                dt = (time.time() - t_last) / log_every
                t_last = time.time()
                history.append((step, loss))
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"{dt*1e3:7.1f} ms/step  "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
            if (step % self.run.checkpoint_every == 0
                    or step == steps or self._preempted):
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               block=(step == steps or self._preempted))
            if self._preempted:
                ok = self.ckpt.wait()
                print(f"preempted at step {step}; checkpoint "
                      f"{'flushed' if ok else 'INCOMPLETE'}")
                break
        self.ckpt.wait()
        return params, opt_state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--root",
                    default=str(Path(tempfile.gettempdir()) / "sage_train"),
                    help="the run's Clovis store (default: sage_train "
                         "under $TMPDIR)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--checkpoint-strategy", default="stream",
                    choices=("collective", "window", "stream"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "int8"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.scaled(dtype="float32")
    run = RunConfig(arch=args.arch, learning_rate=args.lr,
                    total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
                    checkpoint_strategy=args.checkpoint_strategy,
                    checkpoint_every=args.checkpoint_every,
                    grad_compression=args.grad_compression,
                    remat="none", scan_layers=True)

    trainer = Trainer(cfg, run, Path(args.root), device=args.device)
    build_synthetic_corpus(trainer.clovis, vocab=cfg.vocab_real,
                           n_shards=4, tokens_per_shard=args.batch * (args.seq + 1) * 8)

    start, params, opt = 0, None, None
    if args.resume:
        got = trainer.try_restore()
        if got is not None:
            start, params, opt = got
            print(f"resumed from checkpoint at step {start}")

    loader = TokenLoader(trainer.clovis, batch=args.batch, seq=args.seq,
                         start_step=start)
    try:
        t0 = time.time()
        params, opt, hist = trainer.train(args.steps, loader,
                                          start_step=start, params=params,
                                          opt_state=opt)
        dt = time.time() - t0
        print(f"done: {args.steps - start} steps in {dt:.1f}s on "
              f"{trainer.device}; final loss {hist[-1][1]:.4f}"
              if hist else "done")
        print("ADDB report:", {k: f"{v['bytes']/1e6:.1f}MB"
                               for k, v in trainer.clovis.addb_report().items()
                               if v["bytes"]})
    finally:
        loader.close()
        trainer.ckpt.close()


if __name__ == "__main__":
    main()

"""End-to-end training driver (the port of ``repro.launch.train``).

Runs a training loop with the SAGE substrate engaged: the corpus read
from the object store (``data.pipeline``), streaming / window /
collective checkpoints committed through Clovis transactions,
preemption (SIGTERM -> checkpoint -> exit), HA monitoring and ADDB
telemetry.  Restart resumes from the latest checkpoint, onto any mesh.
On the card the model's scans and attention run through the
hand-written kernels, with their gradients (``kernels.grad``).

In an initialised process group (``torchrun``: gloo on the CPU, NCCL on
the card) the ``Trainer`` trains on a ``data x model`` ``DeviceMesh`` of
it (``launch.mesh``): parameters, AdamW's moments and each batch are
``DTensor``s placed by ``distributed.sharding``'s rules, ``loss_fn``
runs under the reference's activation rules (``models.common``), and
each kernel launches on its rank's rows and heads (``kernels.sharded``).
Clovis is a single-process store whose T1 devices live in ``/dev/shm``
keyed by the root, so rank 0 alone opens it: it reads each batch and
scatters it, and it writes the checkpoints that every rank gathers into
(a collective).  A SIGTERM on any rank stops every rank after the same
step, so that all of them enter the final save.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --device cpu --smoke --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --smoke --data-mesh 2 --model-mesh 2

On the card (the default device) drop ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import trace
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import gather_state
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import RunConfig, apply_tp_padding
from repro_torch.core import Clovis, HAMonitor
from repro_torch.data.pipeline import TokenLoader, build_synthetic_corpus
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (default_axis_rules, distribute,
                                              make_batch_specs,
                                              make_param_specs)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as mdl
from repro_torch.models.common import AxisRules, axis_rules
from repro_torch.models.convert import from_scan_layout, to_scan_layout
from repro_torch.optim import AdamWState, init_error_feedback, init_opt_state


class Trainer:
    def __init__(self, cfg, run: RunConfig, root: Path, *,
                 data_mesh: int = 1, model_mesh: int = 1,
                 param_dtype=torch.float32, device: DeviceLike = None):
        self.cfg = cfg
        self.run = run
        self.device = resolve_device(device)
        self.mesh = None
        self.rules = AxisRules()
        if dist.is_initialized() or data_mesh * model_mesh > 1:
            self.mesh = make_host_mesh(data_mesh, model_mesh,
                                       self.device.type)
            self.rules = default_axis_rules(self.mesh,
                                            run.sequence_parallel)
        self.rank = dist.get_rank() if self.mesh is not None else 0
        # the store is one process's: rank 0 owns it
        self.clovis = self.ha = self.ckpt = None
        if self.rank == 0:
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

    def _any_preempted(self) -> bool:
        """Whether any rank was sent SIGTERM (one all-reduce a step)."""
        if self.mesh is None:
            return self._preempted
        flag = torch.tensor([int(self._preempted)],
                            device=self.mesh.device_type)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def param_specs(self, params):
        return make_param_specs(params, self.cfg, self.mesh,
                                fsdp=self.run.fsdp)

    def _place(self, params, opt: Optional[AdamWState] = None):
        """Parameters (and moments) placed on the mesh by the specs; each
        rank holds the same values, so nothing is sent."""
        if self.mesh is None:
            return params, opt
        specs = self.param_specs(params)
        params = distribute(params, specs, self.mesh)
        if opt is not None:
            opt = AdamWState(opt.step, distribute(opt.m, specs, self.mesh),
                             distribute(opt.v, specs, self.mesh))
        return params, opt

    def init_state(self, seed: int = 0):
        params = mdl.init_params(self.cfg, seed=seed, device=self.device,
                                 dtype=self.param_dtype)
        params, _ = self._place(params)
        return params, init_opt_state(params)

    def _state_like(self):
        params_like = mdl.params_like(self.cfg, dtype=self.param_dtype)
        return {"params": params_like, "opt": init_opt_state(params_like)}

    def try_restore(self):
        """-> (step, params, opt) from the latest checkpoint, placed on
        this trainer's mesh, or None.  Rank 0 reads (a checkpoint of the
        reference's default layout too, its repeated layers stacked
        under ``"scan"``: ``models.convert.from_scan_layout``); the
        other ranks receive their shards."""
        like = self._state_like()
        step = self.ckpt.latest_step() if self.ckpt is not None else None
        if self.mesh is not None:
            box = [step]
            dist.broadcast_object_list(box, src=0)
            step = box[0]
        if step is None:
            return None
        specs = None
        if self.mesh is not None:
            pspecs = self.param_specs(like["params"])
            specs = {"params": pspecs, "opt": AdamWState((), pspecs, pspecs)}
        if self.ckpt is None:
            state = CheckpointManager.receive(like, specs, self.mesh,
                                              self.device)
        elif any("/scan/" in n for n in self.ckpt.leaf_names(step)):
            state = _map_trees(from_scan_layout, self.ckpt.restore(
                step, like=_map_trees(to_scan_layout, like, self.cfg),
                device=self.device), self.cfg)
            if self.mesh is not None:
                state = distribute(state, specs, self.mesh, src_data_rank=0)
        else:
            state = self.ckpt.restore(step, like=like, device=self.device,
                                      mesh=self.mesh, specs=specs)
        opt = state["opt"]
        step_t = (opt.step.to_local() if isinstance(opt.step, DTensor)
                  else opt.step)
        return step, state["params"], AdamWState(step_t, opt.m, opt.v)

    def _batch(self, batch: Optional[Dict]):
        """The step's batch on the device: on a mesh rank 0's batch,
        scattered by the batch specs (the other ranks pass None)."""
        if self.mesh is None:
            return {k: torch.as_tensor(v).to(self.device)
                    for k, v in batch.items()}
        meta = [None if batch is None else
                {k: (tuple(v.shape),
                     str(torch.as_tensor(v).dtype).removeprefix("torch."))
                 for k, v in batch.items()}]
        dist.broadcast_object_list(meta, src=0)
        full = {k: (torch.as_tensor(batch[k]).to(self.device)
                    if batch is not None else
                    torch.empty(shape, device=self.device,
                                dtype=getattr(torch, dt)))
                for k, (shape, dt) in meta[0].items()}
        return distribute(full, make_batch_specs(full, self.mesh),
                          self.mesh, src_data_rank=0)

    def step(self, params, opt_state: AdamWState, batch: Optional[Dict]):
        """One train step on a host batch (numpy or tensors; on a mesh
        only rank 0's is read) -> (params, opt_state, metrics), the
        metrics whole on every rank.  A ``train.step`` unit of
        ``repro_torch.trace``; ``train.batch`` spans the copy to the
        device."""
        with trace.unit("train.step"):
            with trace.span("train.batch"):
                batch = self._batch(batch)
            with axis_rules(self.rules), implicit_replication():
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch)
            metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}
        return params, opt_state, metrics

    def save(self, step: int, params, opt_state, *, block: bool):
        """A checkpoint of the state: gathered on every rank (a
        collective on a mesh), written by rank 0."""
        state = {"params": params, "opt": opt_state}
        if self.mesh is not None:
            state = gather_state(state)
        if self.ckpt is not None:
            self.ckpt.save(step, state, block=block)

    def train(self, steps: int, loader, *, start_step: int = 0,
              params=None, opt_state=None, log_every: int = 10):
        """``loader`` yields the batches (on a mesh, rank 0's; the other
        ranks may pass None)."""
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
            batch = next(loader) if self.rank == 0 else None
            params, opt_state, metrics = self.step(params, opt_state, batch)
            step += 1
            if step % log_every == 0 or step == steps:
                loss = float(metrics["loss"])
                dt = (time.time() - t_last) / log_every
                t_last = time.time()
                history.append((step, loss))
                if self.rank == 0:
                    print(f"step {step:5d}  loss {loss:.4f}  "
                          f"{dt*1e3:7.1f} ms/step  "
                          f"gnorm {float(metrics['grad_norm']):.3f}")
            preempted = self._any_preempted()
            if (step % self.run.checkpoint_every == 0
                    or step == steps or preempted):
                self.save(step, params, opt_state,
                          block=(step == steps or preempted))
            if preempted:
                ok = self.ckpt.wait() if self.ckpt is not None else True
                if self.rank == 0:
                    print(f"preempted at step {step}; checkpoint "
                          f"{'flushed' if ok else 'INCOMPLETE'}")
                break
        if self.ckpt is not None:
            self.ckpt.wait()
        return params, opt_state, history


def _map_trees(fn, state, cfg):
    """``fn(tree, cfg)`` on the parameter tree and on AdamW's moments."""
    opt = state["opt"]
    return {"params": fn(state["params"], cfg),
            "opt": AdamWState(opt.step, fn(opt.m, cfg), fn(opt.v, cfg))}


def init_process_group(device: torch.device):
    """The process group ``torchrun`` describes in the environment
    (NCCL on the card, gloo on the CPU), with a timeout that turns a hung
    collective into an error."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, timeout=timedelta(seconds=300))


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
    ap.add_argument("--data-mesh", type=int, default=1,
                    help="data-parallel ranks (run under torchrun)")
    ap.add_argument("--model-mesh", type=int, default=1,
                    help="tensor-parallel ranks (run under torchrun)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    owns_group = (args.data_mesh * args.model_mesh > 1
                  and not dist.is_initialized())
    if owns_group:
        init_process_group(device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = apply_tp_padding(cfg.scaled(dtype="float32"), args.model_mesh)
    run = RunConfig(arch=args.arch, learning_rate=args.lr,
                    total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
                    checkpoint_strategy=args.checkpoint_strategy,
                    checkpoint_every=args.checkpoint_every,
                    grad_compression=args.grad_compression,
                    remat="none", scan_layers=True)

    trainer = Trainer(cfg, run, Path(args.root), data_mesh=args.data_mesh,
                      model_mesh=args.model_mesh, device=device)
    if trainer.clovis is not None:
        build_synthetic_corpus(trainer.clovis, vocab=cfg.vocab_real,
                               n_shards=4,
                               tokens_per_shard=args.batch * (args.seq + 1) * 8)

    start, params, opt = 0, None, None
    if args.resume:
        got = trainer.try_restore()
        if got is not None:
            start, params, opt = got
            if trainer.rank == 0:
                print(f"resumed from checkpoint at step {start}")

    loader = (TokenLoader(trainer.clovis, batch=args.batch, seq=args.seq,
                          start_step=start)
              if trainer.clovis is not None else None)
    try:
        t0 = time.time()
        params, opt, hist = trainer.train(args.steps, loader,
                                          start_step=start, params=params,
                                          opt_state=opt)
        dt = time.time() - t0
        if trainer.rank == 0:
            mesh = ("" if trainer.mesh is None else
                    f" on a {args.data_mesh} x {args.model_mesh} mesh")
            print(f"done: {args.steps - start} steps in {dt:.1f}s on "
                  f"{trainer.device}{mesh}; final loss {hist[-1][1]:.4f}"
                  if hist else "done")
            print("ADDB report:", {k: f"{v['bytes']/1e6:.1f}MB"
                                   for k, v in
                                   trainer.clovis.addb_report().items()
                                   if v["bytes"]})
        return hist
    finally:
        if loader is not None:
            loader.close()
        if trainer.ckpt is not None:
            trainer.ckpt.close()
        if owns_group:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""Multi-rank scenarios of the port, each run as gloo processes on the CPU.

Not a test file: ``tests/test_torch_distributed.py``,
``test_torch_pipeline.py`` and ``test_torch_dryrun.py`` call ``spawn``,
which starts ``world`` processes (``python -c``, one a rank, each on one
thread) that meet through a ``FileStore`` under the test's ``tmp_path``
(no TCP port, so xdist workers never collide), run one scenario with
all of its checks, and leave rank 0's findings in ``result.json`` (and
arrays in ``result.npz``).  The process group has a 120 s timeout, so a
hung collective fails; ``spawn`` kills every rank past its own timeout.
This module imports no JAX: the tests compare with the reference in
the parent process.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def spawn(scenario: str, world: int, tmp_path: Path, *, timeout: float = 240,
          **params) -> dict:
    """Run ``scenario`` on ``world`` gloo ranks -> rank 0's result."""
    work = Path(tmp_path) / f"dist_{scenario}"
    work.mkdir(parents=True, exist_ok=True)
    (work / "params.json").write_text(json.dumps(params))
    env = {**os.environ, "PYTHONPATH": f"{REPO / 'src'}{os.pathsep}{HERE}",
           "OMP_NUM_THREADS": "1", "TMPDIR": str(work)}
    code = "import torch_dist, sys; torch_dist._rank_main(*sys.argv[1:])"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, scenario, str(r), str(world), str(work)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{scenario}: a rank ran past {timeout} s")
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (f"{scenario}: rank {r} exited "
                                   f"{p.returncode}\n{err[-4000:]}")
    return json.loads((work / "result.json").read_text())


def load_arrays(tmp_path: Path, scenario: str) -> dict:
    with np.load(Path(tmp_path) / f"dist_{scenario}" / "result.npz") as f:
        return dict(f)


def _rank_main(scenario: str, rank: str, world: str, work: str):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, work = int(rank), int(world), Path(work)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / "store"), world), rank=rank,
        world_size=world, timeout=timedelta(seconds=120))
    try:
        params = json.loads((work / "params.json").read_text())
        result, arrays = SCENARIOS[scenario](rank, world, work, **params)
        if rank == 0:
            if arrays:
                np.savez(work / "result.npz", **arrays)
            (work / "result.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def smoke_cfg(arch: str, tp: int):
    """The smoke config in f32; internlm2 as the reference's sharded test
    has it (4 heads over 2 KV heads), padded for ``tp``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import apply_tp_padding
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    if arch == "internlm2-20b":
        cfg = cfg.scaled(n_heads=4, n_kv_heads=2)
    return apply_tp_padding(cfg, tp)


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _max(t) -> float:
    return float(t.max()) if t.numel() else 0.0


def step_check(stepped, want, grads, lr: float):
    """Parameters after one AdamW step against the one-device step's:
    each element within 1e-5 of its leaf's max |value|, except where the
    one-device gradient is within 1e-3 of its leaf's max |g| of zero.
    There the f32 sums of two orders differ in sign or size at rounding
    level and AdamW's first step, m / (sqrt(v) + eps) ~ g / |g|, turns
    that into a step of up to 2 lr either way: those elements are held to
    2 lr.  -> (worst ratio to the tolerance, exempt elements, elements)."""
    worst, exempt, total = 0.0, 0, 0
    for a, b, g in zip(stepped, want, grads):
        d = (_whole(a) - b).abs()
        near0 = g.abs() <= 1e-3 * g.abs().max()
        tol = 1e-5 * float(b.abs().max())
        if tol:
            worst = max(worst, _max(d[~near0]) / tol)
        worst = max(worst, _max(d[near0]) / (2.0 * lr * (1 + 1e-3)))
        exempt += int(near0.sum())
        total += d.numel()
    return worst, exempt, total


# --------------------------------------------------------------------------
# scenarios: (rank, world, work dir, **params) -> (result, arrays)
# --------------------------------------------------------------------------

def numerics(rank, world, work, archs):
    """On a 2 x 2 mesh: the sharded loss, gradients and one train step
    against the port on one device, per arch."""
    import torch
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed.sharding import (default_axis_rules,
                                                  distribute,
                                                  make_batch_specs,
                                                  make_param_specs)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_grad_fn, make_train_step
    from repro_torch.models import model as mdl
    from repro_torch.models import moe
    from repro_torch.models.common import axis_rules
    from repro_torch.optim import init_opt_state
    from repro_torch.tree import leaves

    mesh = make_host_mesh(2, 2, "cpu")
    out = {}
    seen = []
    shard_dispatch = moe._shard_dispatch

    def spy(t):
        t = shard_dispatch(t)
        if hasattr(t, "placements"):
            seen.append([str(p) for p in t.placements])
        return t
    moe._shard_dispatch = spy
    for arch in archs:
        cfg = smoke_cfg(arch, 2)
        run = RunConfig(arch=arch, total_steps=10, warmup_steps=1)
        batch = {k: torch.from_numpy(v)
                 for k, v in mdl.make_batch(1, cfg, 4, 16).items()}

        def fresh():
            return mdl.init_params(cfg, seed=0, device="cpu")
        loss1, _ = mdl.loss_fn(fresh(), batch, cfg)
        g1, _ = make_grad_fn(cfg, run)(fresh(), batch)
        p1 = fresh()
        p1, _, m1 = make_train_step(cfg, run)(p1, init_opt_state(p1), batch)

        def placed():
            p = fresh()
            return distribute(p, make_param_specs(p, cfg, mesh), mesh)
        db = distribute(batch, make_batch_specs(batch, mesh), mesh,
                        src_data_rank=0)
        seen.clear()
        with axis_rules(default_axis_rules(mesh)), implicit_replication():
            loss2, _ = mdl.loss_fn(placed(), db, cfg)
            gd, _ = make_grad_fn(cfg, run)(placed(), db)
            pd = placed()
            pd, _, md = make_train_step(cfg, run)(pd, init_opt_state(pd), db)
        grad_err = max(_rel(_whole(a), b)
                       for a, b in zip(leaves(gd), leaves(g1)))
        misplaced = [i for i, (a, p) in enumerate(zip(leaves(gd),
                                                      leaves(pd)))
                     if tuple(a.placements) != tuple(p.placements)]
        worst, exempt, total = step_check(leaves(pd), leaves(p1),
                                          leaves(g1), float(m1["lr"]))
        out[arch] = {
            "loss_one": float(loss1), "loss_mesh": float(loss2.full_tensor()),
            "grad_err": grad_err, "misplaced_grads": misplaced,
            "step_worst": worst, "step_exempt": exempt, "step_total": total,
            "grad_norm": [float(md["grad_norm"].full_tensor()),
                          float(m1["grad_norm"])],
            "dispatch_placements": list(seen),
            "expert_on_model": all(
                isinstance(pl, Shard) and pl.dim == 0
                for pl in [pd["decoder"]["unrolled"][0]["moe"]["w_gate"]
                           .placements[1]]) if cfg.is_moe else None,
        }
    moe._shard_dispatch = shard_dispatch
    return out, None


SCENARIOS = {"numerics": numerics}


def _snapshot_equal(got, want) -> list:
    """Leaf names whose dtype, shape or bytes differ between two trees of
    host arrays (``gather_state``'s)."""
    from repro_torch.tree import flatten_with_names
    fg, fw = dict(flatten_with_names(got)), dict(flatten_with_names(want))
    if sorted(fg) != sorted(fw):
        return ["<names>"]
    return [n for n in fw
            if np.asarray(fg[n]).dtype != np.asarray(fw[n]).dtype
            or np.asarray(fg[n]).shape != np.asarray(fw[n]).shape
            or np.asarray(fg[n]).tobytes() != np.asarray(fw[n]).tobytes()]


def trainer(rank, world, work, arch, steps, ref_root=None):
    """``main`` on a 2 x 2 mesh, then a checkpoint saved on 2 x 2 and
    restored on 4 x 1 and on one device, then a checkpoint the
    reference's Trainer wrote restored onto 2 x 2."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import gather_state
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import Clovis
    from repro_torch.data.pipeline import TokenLoader, build_synthetic_corpus
    from repro_torch.launch.train import Trainer, main
    from repro_torch.models.convert import to_scan_layout
    from repro_torch.tree import flatten_with_names, tree_map

    out = {}
    # 1. the command line's path
    hist = main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                 str(steps), "--batch", "4", "--seq", "16", "--root",
                 str(work / "main"), "--data-mesh", "2", "--model-mesh", "2",
                 "--checkpoint-every", "1000"])
    out["main_history"] = hist

    # 2. save on 2 x 2; restore on 4 x 1 and on one device
    cfg = smoke_cfg(arch, 2)
    run = RunConfig(arch=arch, total_steps=2, warmup_steps=1,
                    checkpoint_every=1000, checkpoint_strategy="collective")
    root = work / "elastic"
    tr = Trainer(cfg, run, root, data_mesh=2, model_mesh=2, device="cpu")
    loader = None
    if rank == 0:
        build_synthetic_corpus(tr.clovis, vocab=cfg.vocab_real, n_shards=2,
                               tokens_per_shard=4 * 17 * 4)
        loader = TokenLoader(tr.clovis, batch=4, seq=16)
    params, opt, _ = tr.train(2, loader, log_every=1)
    if loader is not None:
        loader.close()
        tr.ckpt.close()
    saved = gather_state({"params": params, "opt": opt})
    tr41 = Trainer(cfg, run, root, data_mesh=4, model_mesh=1, device="cpu")
    step, p41, o41 = tr41.try_restore()
    got41 = gather_state({"params": p41, "opt": o41})
    out["restored_step"] = step
    out["placements_4x1"] = str(
        p41["decoder"]["unrolled"][0]["mixer"]["wq"].placements)
    if rank == 0:
        out["differ_4x1"] = _snapshot_equal(got41, saved)
        one = CheckpointManager(Clovis(root, device="cpu")).restore(
            step, like=tr._state_like(), device="cpu")
        out["differ_one_device"] = _snapshot_equal(
            tree_map(lambda t: t.numpy(), one), saved)
        tr41.ckpt.close()

    # 3. the reference's checkpoint (scan layout) onto 2 x 2
    if ref_root is not None:
        tr_ref = Trainer(cfg, run, Path(ref_root), data_mesh=2,
                         model_mesh=2, device="cpu")
        step, pr, orr = tr_ref.try_restore()
        got = gather_state({"params": pr, "opt": orr})
        out["ref_step"] = step
        if rank == 0:
            from repro_torch.launch.train import _map_trees
            scan = _map_trees(to_scan_layout, tree_map(torch.from_numpy, got),
                              cfg)
            with np.load(work / "ref_state.npz") as f:
                want = dict(f)
            flat = {n: t.numpy() for n, t in flatten_with_names(scan)}
            out["ref_names_equal"] = sorted(flat) == sorted(want)
            out["ref_differ"] = [n for n in want if n not in flat or
                                 flat[n].tobytes() != want[n].tobytes()]
            tr_ref.ckpt.close()
    return out, None


def pipeline(rank, world, work, n_microbatches):
    """GPipe on a 4-stage mesh against the sequential stack."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.pipeline import pipeline_forward, split_stages

    with np.load(work / "inputs.npz") as f:
        w, b, x = (torch.from_numpy(f[k]) for k in ("w", "b", "x"))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def seq(ps, h):
        for r in range(ps["w"].shape[0]):
            h = stage_fn({"w": ps["w"][r], "b": ps["b"][r]}, h)
        return h

    params = {"w": w.clone().requires_grad_(True),
              "b": b.clone().requires_grad_(True)}
    got = pipeline_forward(stage_fn, split_stages(params, world), x,
                           mesh=mesh, n_microbatches=n_microbatches)
    (got ** 2).sum().backward()
    grads = {k: v.grad.clone() for k, v in params.items()}
    for g in grads.values():       # each rank holds its stage's slice
        torch.distributed.all_reduce(g)
    ref = {"w": w.clone().requires_grad_(True),
           "b": b.clone().requires_grad_(True)}
    want = seq(ref, x)
    (want ** 2).sum().backward()
    return ({"fwd_err": float((got - want).abs().max()),
             "grad_err": {k: float((grads[k] - ref[k].grad).abs().max())
                          for k in grads}},
            {"out": got.detach().numpy(), "gw": grads["w"].numpy(),
             "gb": grads["b"].numpy()})


def roofline(rank, world, work, arch):
    """On 2 ranks: the collective bytes of a sharded matmul, and the
    FLOPs of a DTensor step against one device's."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed.sharding import (default_axis_rules,
                                                  distribute,
                                                  make_batch_specs,
                                                  make_param_specs)
    from repro_torch.launch.analysis import StepCounter, collective_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.models import model as mdl
    from repro_torch.models.common import axis_rules

    mesh1 = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    x = distribute_tensor(torch.randn(8, 16), mesh1, [Replicate()])
    w = distribute_tensor(torch.randn(16, 32), mesh1, [Shard(1)])
    coll = collective_bytes(
        lambda: (x @ w).redistribute(mesh1, [Replicate()]))
    out = {"matmul_collectives": coll,
           "matmul_all_gather_operand": 8 * (32 // world) * 4}

    counts = {}
    for name, shape in (("data", (world, 1)), ("model", (1, world))):
        cfg = smoke_cfg(arch, shape[1])
        run = RunConfig(arch=arch)
        batch = {k: torch.from_numpy(v)
                 for k, v in mdl.make_batch(1, cfg, 4, 16).items()}
        params = mdl.init_params(cfg, seed=0, device="cpu")
        with StepCounter() as one:
            make_grad_fn(cfg, run)(params, batch)
        mesh = make_host_mesh(*shape, "cpu")
        params = mdl.init_params(cfg, seed=0, device="cpu")
        dp = distribute(params, make_param_specs(params, cfg, mesh), mesh)
        db = distribute(batch, make_batch_specs(batch, mesh), mesh,
                        src_data_rank=0)
        with axis_rules(default_axis_rules(mesh)), implicit_replication(), \
                StepCounter() as many:
            make_grad_fn(cfg, run)(dp, db)
        counts[name] = {"one_device": one.flops, "per_device": many.flops,
                        "collective_bytes": many.collective_bytes}
    out["step_flops"] = counts
    return out, None


SCENARIOS.update(trainer=trainer, pipeline=pipeline, roofline=roofline)

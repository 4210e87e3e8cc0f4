"""Multi-pod dry run: every (arch x shape x mesh) cell counted without a
card (the port of ``repro.launch.dryrun``).

For each cell this builds ``meta`` stand-ins of the parameters, the
optimizer state, the batch and the caches (shapes and dtypes only,
nothing allocated), places them as ``DTensor``s by the sharding rules on
a ``DeviceMesh`` of the production shape over a ``fake`` process group
of 256 or 512 ranks in this one process (every collective returns at
once), and runs the step under the roofline counter
(``launch.analysis``): per-device FLOPs, bytes, collective bytes by
kind, and argument bytes from the local shards.  This is the way
torchtitan's fake-backend dry run works.

Unlike the reference there is no lowering and no compile: the step runs
eagerly on ``meta`` tensors, and each kernel wrapper takes its plain
version (so the count is the plain versions' work; ``analysis``).  The
port unrolls its layers, so the reference's two-point scan correction
(``_scan_corrected_costs``) has nothing to correct: each row says so.
Peak temporary bytes need the card's allocator and stay unknown (None).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
        --shape train_4k [--multi-pod] [--out results.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

Nothing here touches the environment or a process group when imported.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import RunConfig, apply_tp_padding
from repro_torch.distributed.sharding import (default_axis_rules, distribute,
                                              make_batch_specs,
                                              make_cache_specs,
                                              make_param_specs)
from repro_torch.launch import analysis
from repro_torch.launch.mesh import (MeshShape, make_production_mesh,
                                     mesh_axis_sizes, n_chips)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import model as mdl
from repro_torch.models.common import axis_rules
from repro_torch.models.transformer import (MEMORY_KINDS, init_stack_cache,
                                            stack_kinds)
from repro_torch.optim import AdamWState

META = torch.device("meta")
SCAN_NOTE = ("none needed: the port unrolls its layers, so the count "
             "covers every layer")
TEMP_NOTE = "not measured: peak temporaries need the card's allocator"


def device_mesh_shape(shape: MeshShape) -> MeshShape:
    """The ``DeviceMesh`` the dry run builds for a production mesh: the
    two-pod mesh's ``pod`` and ``data`` axes as one flattened dim
    ``"pod+data"`` of 32 (``distributed.sharding`` maps the specs' axes
    onto it).  It splits every tensor as 2 x 16 x 16 would; DTensor's
    redistribution planner, searching three mesh dims, took minutes a
    cell, and XLA gathers over pod x data in one collective too."""
    if shape.axis_names[:2] != ("pod", "data"):
        return shape
    return MeshShape((shape.shape[0] * shape.shape[1],) + shape.shape[2:],
                     ("pod+data",) + shape.axis_names[2:])


@contextlib.contextmanager
def fake_world(shape: MeshShape):
    """A ``DeviceMesh`` of ``shape`` (``device_mesh_shape``) over a fake
    process group of that many ranks (this process is rank 0), torn
    down afterwards."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake process group: "
                           "run it outside any other")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_chips(shape))
    dshape = device_mesh_shape(shape)
    try:
        yield init_device_mesh("cpu", dshape.shape,
                               mesh_dim_names=dshape.axis_names)
    finally:
        dist.destroy_process_group()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _batch_struct(cfg, batch: int, seq: int, labels: bool = True) -> Dict:
    """``meta`` stand-ins of ``model.make_batch``'s arrays."""
    out = {"tokens": _meta((batch, seq), torch.int32)}
    if labels:
        out["labels"] = _meta((batch, seq), torch.int32)
    if cfg.is_encoder_decoder:
        out["frames"] = _meta((batch, cfg.encoder_seq, cfg.d_model),
                              torch.float32)
    if cfg.cross_attn_period:
        out["image_embeds"] = _meta((batch, cfg.n_image_tokens, cfg.d_model),
                                    torch.float32)
    return out


def _with_memory_kv(cfg, cache: Dict, batch: int) -> Dict:
    """The cache with the K/V a cross block's prefill writes (the port
    allocates none at init; a decode cell reads them)."""
    mem = cfg.encoder_seq if cfg.is_encoder_decoder else cfg.n_image_tokens
    kv = (batch, mem, cfg.n_kv_heads, cfg.head_dim)
    for part, kinds in stack_kinds(cfg).items():
        for c, kind in zip(cache[part], kinds):
            if kind in MEMORY_KINDS:
                c.update(xk=_meta(kv, torch.bfloat16),
                         xv=_meta(kv, torch.bfloat16))
    return cache


def build_cell(arch: str, shape_name: str, *, mesh, logical=None,
               fsdp: bool = True, remat: str = "full",
               sequence_parallel: bool = False, serving_spec: bool = False,
               microbatch: int = 0, param_dtype=torch.bfloat16,
               n_layers_override: Optional[int] = None, cfg=None):
    """-> (step fn, args, cfg, rules, shape) for one dry-run cell on
    ``mesh`` (a ``DeviceMesh``), the specs made for ``logical`` (the
    production ``MeshShape``; default: ``mesh``'s own).  ``shape_name``
    names a ``SHAPES`` entry or is a ``ShapeConfig``; ``cfg`` replaces
    the arch's config (before TP padding), as a cut of it."""
    logical = logical or mesh_shape(mesh)
    tp = mesh_axis_sizes(logical).get("model", 1)
    cfg = apply_tp_padding(cfg or get_config(arch), tp)
    if n_layers_override is not None:
        over = {"n_layers": n_layers_override}
        if cfg.is_encoder_decoder:
            over["n_encoder_layers"] = n_layers_override
        cfg = cfg.scaled(**over)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    rules = default_axis_rules(mesh, sequence_parallel=sequence_parallel,
                               serving=serving_spec)
    params = mdl.params_like(cfg, dtype=param_dtype)
    pspecs = make_param_specs(params, cfg, logical, fsdp=fsdp,
                              serving=serving_spec)
    params = distribute(params, pspecs, mesh)

    def placed(tree, specs):
        return distribute(tree, specs, mesh)

    if shape.kind == "train":
        run = RunConfig(arch=arch, remat=remat, fsdp=fsdp,
                        microbatch=microbatch)
        f32 = {"dtype": torch.float32}
        # the step counter is a host scalar: AdamW reads it as a number
        opt = AdamWState(step=torch.zeros((), dtype=torch.int32),
                         m=placed(mdl.params_like(cfg, **f32), pspecs),
                         v=placed(mdl.params_like(cfg, **f32), pspecs))
        batch = _batch_struct(cfg, shape.global_batch, shape.seq_len)
        batch = placed(batch, make_batch_specs(batch, logical))
        return (make_train_step(cfg, run), (params, opt, batch), cfg, rules,
                shape)
    cache = _with_memory_kv(cfg, init_stack_cache(
        cfg, shape.global_batch, shape.seq_len, torch.bfloat16, META),
        shape.global_batch)
    cache = placed(cache, make_cache_specs(cache, cfg, logical))
    if shape.kind == "prefill":
        batch = _batch_struct(cfg, shape.global_batch, shape.seq_len,
                              labels=False)
        batch = placed(batch, make_batch_specs(batch, logical))
        return make_prefill_step(cfg), (params, batch, cache), cfg, rules, \
            shape
    tok = {"tokens": _meta((shape.global_batch, 1), torch.int32)}
    tok = placed(tok, make_batch_specs(tok, logical))
    # the last position of the cache: a decode at full context
    return (make_decode_step(cfg),
            (params, cache, tok["tokens"], shape.seq_len - 1), cfg, rules,
            shape)


def count_cell(arch: str, shape_name: str, *, mesh, mesh_name: str,
               logical=None, **kw) -> analysis.RooflineReport:
    """Build one cell on ``mesh`` and count its step."""
    logical = logical or mesh_shape(mesh)
    fn, args, cfg, rules, shape = build_cell(arch, shape_name, mesh=mesh,
                                             logical=logical, **kw)
    n_active = mdl.count_params_analytic(cfg, active_only=True)
    # tied embeddings serve as the output head: their matmul is real
    # per-token compute, so only subtract lookup-only tables
    n_embed = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    mf = analysis.model_flops_estimate(cfg, shape.kind, shape.seq_len,
                                       shape.global_batch, n_active, n_embed)
    with axis_rules(rules), implicit_replication():
        return analysis.analyze(
            fn, args, arch=arch, shape=shape.name, mesh_name=mesh_name,
            chips=n_chips(logical), model_flops=mf,
            compute_dtype=_dtype_name(kw.get("param_dtype", torch.bfloat16)))


def mesh_shape(mesh) -> MeshShape:
    return MeshShape(tuple(mesh.shape), tuple(mesh.mesh_dim_names))


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             fsdp: bool = True, remat: str = "full",
             sequence_parallel: bool = False, serving_spec: bool = False,
             microbatch: int = 0, param_dtype=torch.bfloat16,
             n_layers_override: Optional[int] = None,
             verbose: bool = True) -> Dict[str, Any]:
    """One cell on its production mesh over its own fake process group
    -> the reference's row (status OK, SKIP or FAIL)."""
    pshape = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    ok, reason = shape_applicable(arch, SHAPES[shape_name], get_config(arch))
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "SKIP", "reason": reason}
    t0 = time.time()
    try:
        with fake_world(pshape) as mesh:
            rep = count_cell(arch, shape_name, mesh=mesh, mesh_name=mesh_name,
                             logical=pshape, fsdp=fsdp, remat=remat,
                             sequence_parallel=sequence_parallel,
                             serving_spec=serving_spec, microbatch=microbatch,
                             param_dtype=param_dtype,
                             n_layers_override=n_layers_override)
        t_count = time.time() - t0
        row = rep.row()
        row.update({"status": "OK", "scan_corrected": False,
                    "scan_correction": SCAN_NOTE, "temp_bytes_note": TEMP_NOTE,
                    "t_lower_s": None, "t_compile_s": None,
                    "t_count_s": round(t_count, 1), "fsdp": fsdp,
                    "remat": remat, "sp": sequence_parallel,
                    "serving_spec": serving_spec, "microbatch": microbatch,
                    "n_layers_override": n_layers_override})
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] "
                  f"args={rep.argument_bytes / 2**30:.2f}GiB/dev "
                  f"flops/dev={rep.flops_per_device:.3e} "
                  f"bytes/dev={rep.bytes_per_device:.3e} "
                  f"t_comp={rep.t_compute*1e3:.2f}ms "
                  f"t_mem={rep.t_memory*1e3:.2f}ms "
                  f"t_coll={rep.t_collective*1e3:.2f}ms "
                  f"bottleneck={rep.bottleneck} "
                  f"useful={rep.useful_flops_ratio:.2f} "
                  f"({t_count:.1f} s)")
        return row
    except Exception as e:  # record failures: they are bugs to fix
        traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                "elapsed_s": round(time.time() - t0, 1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--remat", default="full", choices=("none", "dots", "full"))
    ap.add_argument("--sp", action="store_true", help="sequence parallelism")
    ap.add_argument("--serving-spec", action="store_true",
                    help="inference param layout: EP over data x model, no FSDP")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every model to this many layers")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                row = run_cell(arch, shape, multi_pod=mp,
                               fsdp=not args.no_fsdp, remat=args.remat,
                               sequence_parallel=args.sp,
                               serving_spec=args.serving_spec,
                               microbatch=args.microbatch,
                               n_layers_override=args.layers)
                results.append(row)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(row) + "\n")

    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\ndry-run summary: {n_ok} OK, {n_skip} SKIP, {n_fail} FAIL "
          f"of {len(results)} cells")
    if n_fail:
        for r in results:
            if r["status"] == "FAIL":
                print("  FAIL:", r["arch"], r["shape"], r["mesh"], r["error"])
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()

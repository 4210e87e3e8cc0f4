"""The port's distributed layer against the reference, on the CPU.

Specs (``repro_torch.distributed.sharding``) are held to the reference's
``make_param_specs``, ``make_cache_specs`` and ``make_batch_specs`` leaf
by leaf, for every arch on the 16 x 16, 2 x 16 x 16 and 2 x 4 meshes,
with FSDP on and off and in the serving layout, against both of the
reference's layouts: its ``"scan"`` stacks (the leading ``reps`` axis,
never sharded, dropped) and its unrolled one.

The reference's sharded numerics fail on this tree (ROADMAP C2), so the
port on a mesh is held to the port on one device, whose loss
``tests/test_torch_train.py`` holds to JAX's.  The multi-rank cases run
as gloo processes (``tests/torch_dist.py``): on a 2 x 2 mesh the sharded
loss within rtol 2e-5 of one device's for internlm2 smoke (4 heads over
2 KV heads, the reference's own case), qwen2-moe smoke (experts sharded
over ``model``) and mamba2 smoke (data parallel only); each gradient
leaf within 1e-5 of its largest |g|; the parameters after one AdamW step
within 1e-5 of each leaf's largest |value|, except elements whose
gradient is within 1e-3 of the leaf's largest |g| of zero: AdamW's first
step is about g / |g| there, so two sum orders can part by 2 lr
(``torch_dist.step_check``).  ``Trainer`` on 2 x 2 through ``main``;
checkpoints saved on 2 x 2 restore bit for bit on 4 x 1 and on one
device, and the reference ``Trainer``'s checkpoint restores onto 2 x 2.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import apply_tp_padding as japply
from repro.data.pipeline import TokenLoader as RefLoader
from repro.data.pipeline import build_synthetic_corpus as ref_corpus
from repro.distributed import sharding as jsh
from repro.launch.train import Trainer as RefTrainer
from repro.models import model as jmdl
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import apply_tp_padding
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.train import main
from repro_torch.models import model as mdl
from repro_torch.models.model import _encoder_cfg
from repro_torch.models.transformer import init_stack_cache, stack_plan
from repro_torch.tree import flatten_with_names

MESHES = {"16x16": MeshShape((16, 16), ("data", "model")),
          "2x16x16": MeshShape((2, 16, 16), ("pod", "data", "model")),
          "2x4": MeshShape((2, 4), ("data", "model"))}
LAYOUTS = {"fsdp": dict(fsdp=True), "no_fsdp": dict(fsdp=False),
           "serving": dict(serving=True)}
NUMERICS_ARCHS = ("internlm2-20b", "qwen2-moe-a2.7b", "mamba2-130m")
CACHE_BATCH, CACHE_LEN = 32, 64
TRAIN_ARCH = "internlm2-20b"
TRAIN_STEPS = 3
LOSS_RTOL = 2e-5
GRAD_RTOL = 1e-5


class RefMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, m: MeshShape):
        self.axis_names = m.axis_names
        self.devices = np.empty(m.shape, np.int8)


def _key(k) -> str:
    return str(k.key) if hasattr(k, "key") else str(k.idx)


def _ref_flat(structs, specs):
    """[(name, shape, spec tuple)] of a reference tree and its specs."""
    leaves = jax.tree_util.tree_flatten_with_path(structs)[0]
    spec_leaves = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    assert len(leaves) == len(spec_leaves)
    out = []
    for (path, leaf), spec in zip(leaves, spec_leaves):
        spec = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        out.append(("/".join(_key(k) for k in path), tuple(leaf.shape),
                    spec))
    return out


def _as_port(flat, cfg):
    """The reference's leaves under the port's names: a ``"scan"`` leaf
    becomes ``reps`` per-layer leaves without its leading axis."""
    out = {}
    for name, shape, spec in flat:
        parts = name.split("/")
        if "scan" not in parts:
            out[name] = (shape, spec)
            continue
        i = parts.index("scan")
        scfg = _encoder_cfg(cfg) if parts[0] == "encoder" else cfg
        _, reps, pattern, _ = stack_plan(scfg)
        assert shape[0] == reps and spec[0] is None, name
        pos = int(parts[i + 1])
        for r in range(reps):
            port = parts[:i] + ["unrolled", str(r * len(pattern) + pos)] + \
                parts[i + 2:]
            out["/".join(port)] = (shape[1:], spec[1:])
    return out


def _port_flat(tree, specs):
    names = flatten_with_names(tree)
    return {n: (tuple(t.shape), s)
            for (n, t), s in zip(names, sh.spec_leaves(tree, specs))}


def _configs(arch, mesh):
    tp = MESHES[mesh].shape[-1]
    return japply(jget_config(arch), tp), apply_tp_padding(get_config(arch),
                                                           tp)


@functools.lru_cache(maxsize=None)
def _ref_params(arch, tp, scan):
    """The reference's parameter shapes (16 x 16 and 2 x 16 x 16 share
    them: tp 16)."""
    jcfg = japply(jget_config(arch), tp)
    return jax.eval_shape(lambda: jmdl.init_params(
        jax.random.key(0), jcfg, scan_layers=scan))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(arch, mesh):
    jcfg, cfg = _configs(arch, mesh)
    m = MESHES[mesh]
    like = mdl.params_like(cfg)
    for scan in (True, False):
        jtree = _ref_params(arch, m.shape[-1], scan)
        for layout, kw in LAYOUTS.items():
            want = _as_port(_ref_flat(
                jtree, jsh.make_param_specs(jtree, jcfg, RefMesh(m), **kw)),
                cfg)
            got = _port_flat(like, sh.make_param_specs(like, cfg, m, **kw))
            assert sorted(got) == sorted(want), (scan, layout)
            bad = [n for n in got if got[n] != want[n]]
            assert not bad, (scan, layout, [(n, got[n], want[n])
                                            for n in bad[:5]])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_the_references(arch, mesh):
    jcfg, cfg = _configs(arch, mesh)
    m = MESHES[mesh]
    cache = init_stack_cache(cfg, CACHE_BATCH, CACHE_LEN, torch.bfloat16,
                             torch.device("meta"))
    got = _port_flat(cache, sh.make_cache_specs(cache, cfg, m))
    for scan in (True, False):
        jcache = jax.eval_shape(lambda: jmdl.init_decode_state(
            jcfg, CACHE_BATCH, CACHE_LEN, scan_layers=scan))
        want = _as_port(_ref_flat(
            jcache, jsh.make_cache_specs(jcache, jcfg, RefMesh(m))), cfg)
        # the port allocates no placeholder K/V for cross blocks
        assert set(got) <= set(want)
        assert not set(want) - set(got) - {
            n for n in want if n.rsplit("/", 1)[-1] in ("xk", "xv")}
        bad = [n for n in got if got[n] != want[n]]
        assert not bad, (scan, [(n, got[n], want[n]) for n in bad[:5]])
    jbatch = jmdl.batch_struct(jcfg, CACHE_BATCH, CACHE_LEN)
    want = {n: (s, sp) for n, s, sp in _ref_flat(
        jbatch, jsh.make_batch_specs(jbatch, RefMesh(m)))}
    batch = {k: torch.empty(v.shape, device="meta")
             for k, v in jbatch.items()}
    assert _port_flat(batch, sh.make_batch_specs(batch, m)) == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_divisible(arch):
    """The reference's check on the port's specs: every sharded dim
    divides the production mesh axes it is split over."""
    m = MESHES["16x16"]
    cfg = apply_tp_padding(get_config(arch), 16)
    like = mdl.params_like(cfg)
    specs = sh.make_param_specs(like, cfg, m, fsdp=True)
    sizes = dict(zip(m.axis_names, m.shape))
    n_sharded = 0
    for (name, leaf), spec in zip(flatten_with_names(like),
                                  sh.spec_leaves(like, specs)):
        for dim, ax in enumerate(spec):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            total = int(np.prod([sizes[a] for a in axes]))
            assert leaf.shape[dim] % total == 0, (name, dim, ax)
            n_sharded += 1
        assert len(sh.local_shape(leaf.shape, spec, m)) == leaf.dim()
    assert n_sharded > 0


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    assert sh.placements((("pod", "data", "model"), None), m) == [
        Shard(0), Shard(0), Shard(0)]
    assert sh.placements((None, "model", ("pod", "data")), m) == [
        Shard(2), Shard(2), Shard(1)]
    flat = MeshShape((32, 16), ("pod+data", "model"))
    assert sh.placements((None, ("pod", "data")), flat) == [
        Shard(1), Replicate()]
    assert sh.local_shape((64, 48), (("pod", "data"), "model"), flat) == (
        2, 3)
    with pytest.raises(ValueError):
        sh.placements((("data", "pod"),), m)      # not the mesh's order
    with pytest.raises(ValueError):
        sh.placements(("data",), flat)            # inside a flattened dim


# --------------------------------------------------------------------------
# 2 x 2 gloo mesh: numerics against one device
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def numerics(tmp_path_factory):
    return torch_dist.spawn("numerics", 4, tmp_path_factory.mktemp("num"),
                            timeout=300, archs=list(NUMERICS_ARCHS))


@pytest.mark.parametrize("arch", NUMERICS_ARCHS)
def test_sharded_loss_equals_one_device(numerics, arch):
    r = numerics[arch]
    np.testing.assert_allclose(r["loss_mesh"], r["loss_one"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", NUMERICS_ARCHS)
def test_sharded_gradients_and_step_equal_one_device(numerics, arch):
    r = numerics[arch]
    assert r["grad_err"] <= GRAD_RTOL
    assert r["misplaced_grads"] == []       # on the parameters' placements
    assert r["step_worst"] <= 1.0, r
    np.testing.assert_allclose(*r["grad_norm"], rtol=LOSS_RTOL)


def test_experts_shard_over_the_model_axis(numerics):
    """C17: ``_shard_dispatch`` places the dispatch tensors' E over the
    expert axis (``model``, mesh dim 1) and their rows over ``data``."""
    r = numerics["qwen2-moe-a2.7b"]
    assert r["expert_on_model"] is True
    assert r["dispatch_placements"]
    assert all(p == ["S(1)", "S(0)"] for p in r["dispatch_placements"])
    assert numerics["internlm2-20b"]["dispatch_placements"] == []


# --------------------------------------------------------------------------
# The Trainer on 2 x 2, and mesh-elastic checkpoints
# --------------------------------------------------------------------------

def _reference_checkpoint(root):
    """Two steps of the reference's Trainer (its default scan layout)
    into ``root``; -> its state as {leaf name: array}."""
    cfg = jget_smoke(TRAIN_ARCH).scaled(dtype="float32", n_heads=4,
                                        n_kv_heads=2)
    run = JRunConfig(arch=TRAIN_ARCH, total_steps=2, warmup_steps=1,
                     checkpoint_every=1000, checkpoint_strategy="collective",
                     remat="none")
    tr = RefTrainer(cfg, run, root)
    ref_corpus(tr.clovis, vocab=cfg.vocab_real, n_shards=2,
               tokens_per_shard=4 * 17 * 4)
    loader = RefLoader(tr.clovis, batch=4, seq=16)
    try:
        params, opt, _ = tr.train(2, loader, log_every=1)
    finally:
        loader.close()
        tr.ckpt.close()
    state = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    return dict(flatten_with_names(state))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    work = tmp / "dist_trainer"
    work.mkdir()
    ref = _reference_checkpoint(tmp / "ref")
    np.savez(work / "ref_state.npz", **ref)
    one = main(["--arch", TRAIN_ARCH, "--smoke", "--device", "cpu",
                "--steps", str(TRAIN_STEPS), "--batch", "4", "--seq", "16",
                "--root", str(tmp / "one"), "--checkpoint-every", "1000"])
    got = torch_dist.spawn("trainer", 4, tmp, timeout=300, arch=TRAIN_ARCH,
                           steps=TRAIN_STEPS, ref_root=str(tmp / "ref"))
    return got, one


def test_trainer_trains_on_a_2x2_mesh_through_main(trained):
    got, one = trained
    (step, loss), = got["main_history"]
    (step1, loss1), = one
    assert step == step1 == TRAIN_STEPS
    np.testing.assert_allclose(loss, loss1, rtol=LOSS_RTOL)


def test_checkpoint_saved_on_2x2_restores_on_4x1_and_one_device(trained):
    got, _ = trained
    assert got["restored_step"] == 2
    assert got["placements_4x1"] == "(Shard(dim=0), Replicate())"
    assert got["differ_4x1"] == []
    assert got["differ_one_device"] == []


def test_reference_checkpoint_restores_onto_2x2(trained):
    got, _ = trained
    assert got["ref_step"] == 2
    assert got["ref_names_equal"] is True
    assert got["ref_differ"] == []

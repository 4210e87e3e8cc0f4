"""The port's training stack against the reference, on the CPU: the train
mode of the models, ``loss_fn`` and its gradient (the MoE aux loss and
deepseek's MTP loss included), AdamW, gradient compression, the data
pipeline, the steps and the ``Trainer``.

Weights are the reference's, carried over with ``params_from_jax``;
batches and noise are made with numpy (or handed from the reference, for
the compression noise).  Tolerances, f32 throughout with sums in another
order: the loss within 1e-5 relative; each gradient leaf within 1e-4 of
that leaf's largest |g|; one AdamW update and the schedule within 1e-6;
the ce, aux and MTP terms each within 1e-5 relative; the first Trainer
losses within 1e-3 relative (they compound five updates); microbatch accumulation within 1e-5 of the leaf's largest |g|.
"""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import RunConfig as JRunConfig
from repro.core.addb import Addb as RefAddb
from repro.core.clovis import Clovis as RefClovis
from repro.data.pipeline import build_synthetic_corpus as ref_corpus
from repro.data.pipeline import TokenLoader as RefLoader
from repro.launch.train import Trainer as RefTrainer
from repro.models import model as jmdl
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.optim import compress_grads as jcompress
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import Addb, Clovis
from repro_torch.data.pipeline import TokenLoader, build_synthetic_corpus
from repro_torch.kernels.grad import with_plain_grad
from repro_torch.kernels.ssd import ssd_chunked
from repro_torch.launch.steps import (make_decode_step, make_eval_step,
                                      make_grad_fn, make_prefill_step)
from repro_torch.launch.train import Trainer
from repro_torch.models import convert
from repro_torch.models import model as mdl
from repro_torch.models import transformer as tfm
from repro_torch.optim import (AdamWState, adamw_update, clip_by_global_norm,
                               compress_grads, global_norm,
                               init_error_feedback, init_opt_state,
                               lr_schedule)
from repro_torch.optim.adamw import _decay_mask
from repro_torch.tree import leaves, tree_map

ARCHS = ("mamba2-130m", "recurrentgemma-9b", "qwen2.5-32b",
         "qwen2-moe-a2.7b", "deepseek-v3-671b")
CPU = "cpu"


def _cfgs(arch, **over):
    over.setdefault("dtype", "float32")
    return jget_smoke(arch).scaled(**over), get_smoke_config(arch).scaled(
        **over)


def _ref_params(jcfg, cfg, seed=0):
    jp = jmdl.init_params(jax.random.key(seed), jcfg)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                       device=CPU)


def _port_grads(params, batch, cfg, **kw):
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    loss, metrics = mdl.loss_fn(params, batch, cfg, **kw)
    # deepseek's router bias gets no gradient (zeros, as in the reference)
    return loss, metrics, torch.autograd.grad(loss, flat, allow_unused=True,
                                              materialize_grads=True)


def _leaf_close(got, want, rtol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.detach().numpy() - w).max()) <= rtol * scale


# ---------------------------------------------------------------------------
# loss and gradient against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_the_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp, params = _ref_params(jcfg, cfg)
    batch = mdl.make_batch(1, cfg, 2, 24)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmdl.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jcfg), has_aux=True))(jp)
    loss, metrics, grads = _port_grads(params, batch, cfg)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(metrics["tokens"]) == float(jm["tokens"]) == 2 * 23
    assert set(metrics) == set(jm)
    for name in set(jm) - {"tokens", "loss"}:     # ce, aux and mtp
        assert abs(metrics[name].item() - float(jm[name])) <= \
            1e-5 * abs(float(jm[name]))
    assert (metrics["aux"].item() > 0) == cfg.is_moe
    assert ("mtp" in metrics) == (cfg.mtp_depth > 0)
    want = leaves(convert.params_from_jax(jax.tree.map(np.asarray, jg), cfg,
                                          device=CPU))
    assert len(grads) == len(want)
    _leaf_close(grads, [w.numpy() for w in want], 1e-4)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_recomputes_blocks_with_the_same_gradient(remat):
    jcfg, cfg = _cfgs("mamba2-130m")
    _, params = _ref_params(jcfg, cfg)
    batch = mdl.make_batch(2, cfg, 2, 20)
    l0, _, g0 = _port_grads(params, batch, cfg)
    l1, _, g1 = _port_grads(params, batch, cfg, remat=remat)
    assert l1.item() == l0.item()
    _leaf_close(g1, [g.numpy() for g in g0], 1e-6)


def test_train_mode_of_each_ported_kind_matches_the_reference():
    """block_forward(mode="train") of global and local attention and the
    RG-LRU block (recurrentgemma) and SSD (mamba2) against the
    reference's block, x in and x out."""
    for arch, kinds in (("recurrentgemma-9b", ("rglru", "local")),
                        ("mamba2-130m", ("ssd",)),
                        ("qwen2.5-32b", ("global",))):
        jcfg, cfg = _cfgs(arch)
        jp, params = _ref_params(jcfg, cfg)
        layers = dict(zip(tfm.stack_kinds(cfg)["unrolled"],
                          params["decoder"]["unrolled"]))
        x = np.random.default_rng(3).standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
        for kind in kinds:
            jblock = jax.tree.map(jnp.asarray, tree_map(
                lambda t: t.numpy(), layers[kind]))
            want, aux, _ = jtfm.block_forward(
                jblock, jnp.asarray(x), jcfg, kind, mode="train",
                positions=jnp.asarray(pos))
            got, got_aux, cache = tfm.block_forward(
                layers[kind], torch.from_numpy(x), cfg, kind, mode="train",
                positions=torch.from_numpy(pos.copy()))
            assert cache is None and float(aux) == float(got_aux) == 0.0
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), atol=1e-4,
                                       rtol=1e-4)


def test_kernel_gradient_machinery_is_the_plain_gradient():
    """``with_plain_grad`` (the card's B5/B6/B7 backward) returns the
    gradient of the plain function, the state input's included; here the
    'kernel' is the plain version itself, so the two must be equal."""
    rng = np.random.default_rng(4)
    b, s, h, p, n, g = 2, 20, 4, 8, 16, 2
    shapes = [(b, s, h, p), (b, s, h), (h,), (b, s, g, n), (b, s, g, n),
              (b, h, p, n)]
    ins = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
           for sh in shapes]
    ins[1] = ins[1].abs() * 0.1

    def plain(*a):
        return ssd_chunked(*a[:5], 8, a[5])
    a = [t.clone().requires_grad_(True) for t in ins]
    y, f = plain(*a)
    want = torch.autograd.grad((y * y).sum() + f.sum(), a)
    k = [t.clone().requires_grad_(True) for t in ins]
    y, f = with_plain_grad(plain, plain, *k)
    assert y.grad_fn is not None and f.grad_fn is not None
    got = torch.autograd.grad((y * y).sum() + f.sum(), k)
    for gk, gw in zip(got, want):
        assert torch.equal(gk, gw)


# ---------------------------------------------------------------------------
# optimizer and compression against the reference's arithmetic
# ---------------------------------------------------------------------------

def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32),
            "scale": (1 + rng.standard_normal((8,)) * 0.1).astype(
                np.float32)}


def test_adamw_update_matches_the_reference():
    kw = dict(learning_rate=1e-2, warmup_steps=3, total_steps=10,
              weight_decay=0.1, grad_clip=0.5)
    jrun, run = JRunConfig(**kw), RunConfig(**kw)
    p0 = _opt_tree(0)
    jp, jst = ({k: jnp.asarray(v) for k, v in p0.items()},
               jadamw.init_opt_state({k: jnp.asarray(v)
                                      for k, v in p0.items()}))
    params = tree_map(torch.from_numpy, {k: v.copy() for k, v in p0.items()})
    st = init_opt_state(params)
    assert _decay_mask(params) == {"w": True, "b": False, "scale": False}
    for i in range(3):
        g = _opt_tree(10 + i)
        jp, jst, jmet = jadamw.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jst, jrun)
        params, st, met = adamw_update(
            params, tree_map(torch.from_numpy, g), st, run)
        assert int(st.step) == int(jst.step) == i + 1
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                       rtol=1e-6)
        for tree, jtree in ((params, jp), (st.m, jst.m), (st.v, jst.v)):
            for k in p0:
                np.testing.assert_allclose(tree[k].numpy(),
                                           np.asarray(jtree[k]), rtol=1e-6,
                                           atol=1e-6)


def test_lr_schedule_matches_the_reference():
    kw = dict(learning_rate=3e-4, warmup_steps=7, total_steps=50)
    for step in range(0, 56):
        want = float(jadamw.lr_schedule(jnp.int32(step), JRunConfig(**kw)))
        got = float(lr_schedule(torch.tensor(step, dtype=torch.int32),
                                RunConfig(**kw)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12)


def test_compress_grads_with_pinned_noise_is_the_references_arithmetic():
    """The reference's own uniforms (one per leaf from its split keys)
    handed to the port give the same int8 codes, scales and residuals."""
    grads = _opt_tree(5)
    err = {k: np.random.default_rng(6).standard_normal(v.shape).astype(
        np.float32) * 0.01 for k, v in grads.items()}
    key = jax.random.key(9)
    jout, jerr, jratio = jcompress({k: jnp.asarray(v) for k, v in
                                    grads.items()},
                                   {k: jnp.asarray(v) for k, v in
                                    err.items()}, key)
    names = sorted(grads)
    keys = jax.random.split(key, len(names))
    noise = [torch.from_numpy(np.array(jax.random.uniform(
        k, grads[n].shape, jnp.float32, -0.5, 0.5))) for k, n in
        zip(keys, names)]
    out, new_err, ratio = compress_grads(
        tree_map(torch.from_numpy, grads), tree_map(torch.from_numpy, err),
        _noise=noise)
    for n in names:
        assert np.array_equal(out[n].numpy(), np.asarray(jout[n]))
        assert np.array_equal(new_err[n].numpy(), np.asarray(jerr[n]))
    assert float(ratio) == float(jratio)


def test_compression_error_feedback_tracks_the_gradient():
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))}
    err = init_error_feedback(g)
    gen = torch.Generator().manual_seed(0)
    total = torch.zeros_like(g["w"])
    for _ in range(20):
        deq, err, ratio = compress_grads(g, err, gen)
        total += deq["w"]
    np.testing.assert_allclose((total / 20).numpy(), g["w"].numpy(),
                               atol=0.02)
    assert 3.5 < float(ratio) < 4.5


def test_adamw_moves_against_gradient_and_skips_decay_on_1d():
    run = RunConfig(learning_rate=0.1, warmup_steps=0, total_steps=10,
                    weight_decay=0.5)
    params = {"w": torch.ones((4, 8)), "b": torch.zeros((8,)),
              "scale": torch.ones((8,))}
    new, opt, m = adamw_update(params, tree_map(torch.ones_like, params),
                               init_opt_state(params), run)
    assert bool((new["w"] < 1).all()) and int(opt.step) == 1
    assert float(m["grad_norm"]) > 0
    params = {"w": torch.ones((4, 8)), "scale": torch.ones((8,))}
    new, _, _ = adamw_update(params, tree_map(torch.zeros_like, params),
                             init_opt_state(params), run)
    assert bool((new["w"] < 1).all())
    assert torch.equal(new["scale"], torch.ones(8))


def test_clip_by_global_norm():
    clipped, norm = clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert float(norm) > 1.0
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# data pipeline: a copy of the reference's
# ---------------------------------------------------------------------------

def test_corpus_objects_are_the_references_bytes(tmp_path):
    ref = RefClovis(tmp_path / "ref", addb=RefAddb())
    port = Clovis(tmp_path / "port", addb=Addb(), device=CPU)
    kw = dict(vocab=100, n_shards=3, tokens_per_shard=2048, seed=4)
    assert ref_corpus(ref, **kw) == build_synthetic_corpus(port, **kw)
    oids = sorted(port.container("corpus"))
    assert oids == sorted(ref.container("corpus")) and len(oids) == 3
    for oid in oids:
        assert port.get(oid) == ref.get(oid)
        assert port.store.meta(oid).attrs == ref.store.meta(oid).attrs
    rl = RefLoader(ref, batch=2, seq=16, start_step=5)
    pl = TokenLoader(port, batch=2, seq=16, start_step=5)
    try:
        for _ in range(3):
            a, b = next(rl), next(pl)
            assert all(np.array_equal(a[k], b[k]) for k in a)
    finally:
        rl.close()
        pl.close()


def test_token_loader_host_sharding(tmp_path):
    cl = Clovis(tmp_path / "s", addb=Addb(), device=CPU)
    build_synthetic_corpus(cl, vocab=100, n_shards=4, tokens_per_shard=2048)
    la = TokenLoader(cl, batch=2, seq=8, host_id=0, n_hosts=2)
    lb = TokenLoader(cl, batch=2, seq=8, host_id=1, n_hosts=2)
    try:
        assert set(la.shards).isdisjoint(lb.shards)
        assert len(la.shards) + len(lb.shards) == 4
        b = next(la)
        assert np.array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    finally:
        la.close()
        lb.close()


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def test_microbatch_accumulation_equals_the_full_batch():
    jcfg, cfg = _cfgs("mamba2-130m")
    _, params = _ref_params(jcfg, cfg)
    batch = mdl.make_batch(3, cfg, 4, 16)
    full, fm = make_grad_fn(cfg, RunConfig(remat="none"))(params, batch)
    acc, am = make_grad_fn(cfg, RunConfig(remat="none",
                                          microbatch=2))(params, batch)
    _leaf_close(leaves(acc), [g.numpy() for g in leaves(full)], 1e-5)
    np.testing.assert_allclose(float(am["loss"]), float(fm["loss"]),
                               rtol=1e-5)


def test_prefill_decode_and_eval_steps():
    jcfg, cfg = _cfgs("mamba2-130m")
    _, params = _ref_params(jcfg, cfg)
    batch = mdl.make_batch(4, cfg, 2, 10)
    cache = mdl.init_decode_state(cfg, 2, 16, dtype=torch.float32,
                                  device=CPU)
    logits, cache = make_prefill_step(cfg)(params, batch, cache)
    want, _ = mdl.prefill(params, batch, cfg, mdl.init_decode_state(
        cfg, 2, 16, dtype=torch.float32, device=CPU))
    assert torch.equal(logits, want) and logits.grad_fn is None
    nxt, cache = make_decode_step(cfg)(params, cache,
                                       logits.argmax(-1)[:, None], 10)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
    metrics = make_eval_step(cfg)(params, batch)
    assert set(metrics) == {"ce", "aux", "tokens", "loss"}


# ---------------------------------------------------------------------------
# the Trainer: tests/test_system.py's cases on the port
# ---------------------------------------------------------------------------

def _mk_trainer(tmp_path, arch="qwen2.5-32b", **run_kw):
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    run = RunConfig(arch=arch, total_steps=30, warmup_steps=3,
                    checkpoint_every=10, remat="none", **run_kw)
    tr = Trainer(cfg, run, tmp_path / "run", device=CPU)
    build_synthetic_corpus(tr.clovis, vocab=cfg.vocab_real, n_shards=2,
                           tokens_per_shard=4096)
    return cfg, run, tr


def test_trainer_reduces_loss(tmp_path):
    cfg, run, tr = _mk_trainer(tmp_path)
    loader = TokenLoader(tr.clovis, batch=4, seq=32)
    try:
        _, _, hist = tr.train(30, loader, log_every=5)
    finally:
        loader.close()
        tr.ckpt.close()
    losses = [l for _, l in hist]
    assert losses[-1] < losses[0] and np.isfinite(losses).all()


def test_trainer_restart_resumes_step_and_state(tmp_path):
    cfg, run, tr = _mk_trainer(tmp_path)
    loader = TokenLoader(tr.clovis, batch=4, seq=32)
    try:
        params, opt, _ = tr.train(20, loader, log_every=10)
    finally:
        loader.close()
        tr.ckpt.close()
    tr2 = Trainer(cfg, run, tmp_path / "run", device=CPU)
    step, params2, opt2 = tr2.try_restore()
    assert step == 20 and int(opt2.step) == 20
    assert isinstance(opt2, AdamWState)
    for a, b in zip(leaves((params, opt)), leaves((params2, opt2))):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b)
    loader2 = TokenLoader(tr2.clovis, batch=4, seq=32, start_step=step)
    try:
        _, _, hist = tr2.train(25, loader2, start_step=step, params=params2,
                               opt_state=opt2, log_every=5)
    finally:
        loader2.close()
        tr2.ckpt.close()
    assert hist[-1][0] == 25


def test_training_with_grad_compression(tmp_path):
    """int8 error-feedback compression applied by hand still trains (the
    Trainer builds the feedback and never applies it, as the reference's
    does: ROADMAP C13)."""
    cfg = get_smoke_config("internlm2-20b").scaled(dtype="float32")
    run = RunConfig(total_steps=20, warmup_steps=2, learning_rate=1e-3,
                    remat="none")
    params = mdl.init_params(cfg, device=CPU)
    opt = init_opt_state(params)
    err = init_error_feedback(params)
    batch = mdl.make_batch(1, cfg, 4, 32)
    grad_fn = make_grad_fn(cfg, run)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(15):
        grads, metrics = grad_fn(params, batch)
        grads, err, ratio = compress_grads(grads, err, gen)
        params, opt, _ = adamw_update(params, grads, opt, run)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]
    assert 3.5 < float(ratio) < 4.5


def test_ha_failure_during_training_survives(tmp_path):
    cfg, run, tr = _mk_trainer(tmp_path, checkpoint_strategy="collective")
    loader = TokenLoader(tr.clovis, batch=4, seq=32)
    try:
        params, opt, _ = tr.train(10, loader, log_every=10)
        dev = tr.clovis.pools["t1_nvram"].devices[0]
        assert tr.ha.engage_repair(dev.name)
        tr.train(20, loader, start_step=10, params=params, opt_state=opt,
                 log_every=10)
    finally:
        loader.close()
        tr.ckpt.close()
    tr2 = Trainer(cfg, run, tmp_path / "run", device=CPU)
    got = tr2.try_restore()
    assert got is not None and got[0] == 20
    tr2.ckpt.close()


def test_addb_telemetry_collected(tmp_path):
    cfg, run, tr = _mk_trainer(tmp_path)
    loader = TokenLoader(tr.clovis, batch=4, seq=32)
    try:
        tr.train(10, loader, log_every=10)
    finally:
        loader.close()
        tr.ckpt.close()
    rep = tr.clovis.addb_report()
    assert rep.get("put", {}).get("bytes", 0) > 0
    assert rep.get("get", {}).get("bytes", 0) > 0


@pytest.mark.parametrize("arch", ["mamba2-130m", "qwen2.5-32b",
                                  "qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_first_losses_match_the_reference_trainer(tmp_path, arch):
    jcfg, cfg = _cfgs(arch)
    kw = dict(arch=arch, total_steps=30, warmup_steps=3,
              checkpoint_every=100, remat="none", learning_rate=1e-3)
    jp, params = _ref_params(jcfg, cfg)
    ref = RefTrainer(jcfg, JRunConfig(**kw), tmp_path / "ref")
    port = Trainer(cfg, RunConfig(**kw), tmp_path / "port", device=CPU)
    hists = []
    for tr, corpus, loader_cls, p, opt in (
            (ref, ref_corpus, RefLoader, jp, jadamw.init_opt_state(jp)),
            (port, build_synthetic_corpus, TokenLoader, params,
             init_opt_state(params))):
        corpus(tr.clovis, vocab=cfg.vocab_real, n_shards=2,
               tokens_per_shard=4096)
        loader = loader_cls(tr.clovis, batch=4, seq=32)
        try:
            hists.append(tr.train(5, loader, params=p, opt_state=opt,
                                  log_every=1)[2])
        finally:
            loader.close()
            tr.ckpt.close()
    want, got = hists
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4, 5]
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 1e-3 * abs(w)


def test_sigterm_preempts_with_a_flushed_checkpoint(tmp_path):
    """SIGTERM mid-run: the Trainer finishes the step, saves it with a
    blocking checkpoint and stops."""
    cfg, run, tr = _mk_trainer(tmp_path)
    loader = TokenLoader(tr.clovis, batch=4, seq=32)

    class KillAfterThree:
        n = 0

        def __next__(self):
            self.n += 1
            if self.n == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return next(loader)
    old = signal.getsignal(signal.SIGTERM)
    try:
        _, opt, hist = tr.train(30, KillAfterThree(), log_every=1)
    finally:
        signal.signal(signal.SIGTERM, old)
        loader.close()
        tr.ckpt.close()
    assert hist[-1][0] == 3 and int(opt.step) == 3
    assert tr.ckpt.latest_step() == 3


def test_trainer_on_a_mesh_waits_for_the_distributed_slice(tmp_path):
    """A mesh needs an initialised process group: outside one the
    Trainer raises instead of training on one device
    (tests/test_torch_distributed.py trains on a 2 x 2 gloo mesh)."""
    cfg = get_smoke_config("mamba2-130m").scaled(dtype="float32")
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(cfg, RunConfig(), tmp_path / "run", data_mesh=2,
                device=CPU)

"""The port's serving driver (``repro_torch.launch.serve.Server``) against
the reference's (``repro.launch.serve.Server``) on the same weights: the
reference's random parameters go through ``params_from_jax`` into the
port's server.  Greedy tokens must be equal; logits within ``LOGIT_TOL``
(atol 2e-4, rtol 1e-4: f32 matmuls summed in another order) of the
reference's prefill and decode fed the same tokens.  The token log must
read back from the port's Clovis."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.launch.serve import Server as JServer
from repro.models import model as jmdl
from repro_torch import NoCudaDeviceError, trace
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import FunctionShipper
from repro_torch.launch import serve
from repro_torch.launch.serve import Server
from repro_torch.models import model as mdl
from repro_torch.models.convert import params_from_jax

ARCH = "recurrentgemma-9b"
SSM_ARCH = "mamba2-130m"
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
B, PROMPT, GEN = 3, 21, 6


def _reference_logits(jcfg, params, prompts, out):
    """The reference's prefill and decode logits, fed the served tokens."""
    cache = jmdl.init_decode_state(jcfg, B, PROMPT + GEN + 8,
                                   dtype=jnp.float32)
    logits, cache = jmdl.prefill(params, {"tokens": jnp.asarray(prompts)},
                                 jcfg, cache)
    want = [np.asarray(logits)]
    for i in range(GEN - 1):
        logits, cache = jmdl.decode_step(params, jnp.asarray(out[:, i:i + 1]),
                                         jnp.int32(PROMPT + i), jcfg, cache)
        want.append(np.asarray(logits))
    return want


# the unrolled and scan layouts of recurrentgemma and of mamba2 (21
# prompt tokens: not a multiple of mamba2's smoke ssm_chunk, 16)
@pytest.mark.parametrize("arch,n_layers", [
    pytest.param(ARCH, 4, id="4"), pytest.param(ARCH, 7, id="7"),
    pytest.param(SSM_ARCH, 1, id="mamba2-1"),
    pytest.param(SSM_ARCH, 3, id="mamba2-3")])
def test_generate_matches_reference_server(tmp_path, arch, n_layers):
    jcfg = jget_smoke(arch).scaled(dtype="float32", n_layers=n_layers)
    cfg = get_smoke_config(arch).scaled(dtype="float32", n_layers=n_layers)
    prompts = np.random.default_rng(n_layers).integers(
        0, jcfg.vocab_real, (B, PROMPT)).astype(np.int32)
    jsrv = JServer(jcfg, root=tmp_path / "j", max_len=PROMPT + GEN + 8)
    want_out, _ = jsrv.generate(prompts, GEN)
    jsrv.close()
    params = params_from_jax(jax.tree.map(np.asarray, jsrv.params), cfg,
                             device="cpu")
    srv = Server(cfg, tmp_path / "p", device="cpu", params=params,
                 max_len=PROMPT + GEN + 8)
    out, stats = srv.generate(prompts, GEN, keep_logits=True)
    srv.close()
    assert out.dtype == np.int32 and out.shape == (B, GEN)
    np.testing.assert_array_equal(out, want_out)
    assert len(stats["logits"]) == GEN + 1
    want = _reference_logits(jcfg, jsrv.params, prompts, out)
    for got, w in zip(stats["logits"], want):
        np.testing.assert_allclose(got.numpy(), w, **LOGIT_TOL)
    assert stats["prefill_s"] > 0 and stats["tok_per_s"] > 0


@pytest.mark.parametrize("arch", [ARCH, SSM_ARCH])
def test_kernel_and_plain_paths_serve_the_same_tokens(tmp_path, arch):
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_real, (B, PROMPT)).astype(np.int32)
    outs = []
    for use_kernels in (True, False):
        srv = Server(cfg, tmp_path / str(use_kernels), device="cpu",
                     use_kernels=use_kernels, log_tokens=False,
                     max_len=PROMPT + GEN + 8)
        outs.append(srv.generate(prompts, GEN, keep_logits=True))
        srv.close()
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1]["logits"], outs[1][1]["logits"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LOGIT_TOL)


def test_token_log_reads_back_from_clovis(tmp_path):
    cfg = get_smoke_config(ARCH).scaled(dtype="float32")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_real, (B, PROMPT)).astype(np.int32)
    srv = Server(cfg, tmp_path / "s", device="cpu", max_len=64)
    t0 = time.time_ns()               # the unit records are the process's
    addb = len(srv.clovis.addb.records("serve"))    # and so is the ADDB
    out, _ = srv.generate(prompts, GEN)
    out2, _ = srv.generate(prompts[:, :10], GEN)
    srv.close()
    cl = srv.clovis
    assert "stream/tokens" in cl.container("servelog")
    log = np.frombuffer(cl.get("stream/tokens"), np.int32)
    # one row of B tokens per decode step, both calls in order
    np.testing.assert_array_equal(
        log.reshape(2 * GEN, B), np.concatenate([out.T, out2.T]))
    recs = [u for u in trace.units("serve.generate") if u.start_ns >= t0]
    assert [(r.attrs["batch"], r.attrs["prompt_len"], r.attrs["gen"])
            for r in recs] == [(B, PROMPT, GEN), (B, 10, GEN)]
    assert [r.attrs["batch"] * r.counts["serve.decode_steps"]
            for r in recs] == [B * GEN, B * GEN]
    assert len(cl.addb.records("serve")) == addb
    sh = FunctionShipper(cl)
    try:
        res = sh.ship("histogram", "stream/tokens")
    finally:
        sh.shutdown()
    assert res.ok and int(np.asarray(res.value).sum()) == log.nbytes


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config(ARCH).scaled(dtype="float32")
    with pytest.raises(NoCudaDeviceError):
        Server(cfg, tmp_path / "s")
    with pytest.raises(NoCudaDeviceError):
        serve.mdl.init_params(cfg)


def test_main_serves_the_smoke_model_on_the_cpu(tmp_path, capsys):
    serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "12", "--gen", "3",
                "--root", str(tmp_path / "m")])
    assert "generated (2, 3) tokens" in capsys.readouterr().out


def test_main_serves_mamba2_on_the_cpu(tmp_path, capsys):
    serve.main(["--arch", SSM_ARCH, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "19", "--gen", "3",
                "--root", str(tmp_path / "m")])
    assert "generated (2, 3) tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_graph_gate(arch):
    """The graph serves SSD-only stacks on a CUDA device: mamba2, and no
    stack with attention, RG-LRU, MoE or an encoder; never on the CPU,
    nor with ``extra`` inputs."""
    cfg = get_config(arch)
    cuda = torch.device("cuda", 0)
    assert serve.graphs_decode(cfg, cuda) is (arch == SSM_ARCH)
    assert serve.graphs_decode(cfg, cuda, {}) is (arch == SSM_ARCH)
    assert not serve.graphs_decode(cfg, cuda, {"frames": np.zeros(1)})
    assert not serve.graphs_decode(cfg, torch.device("cpu"))


def test_cpu_server_serves_eagerly(tmp_path):
    """On the CPU a mamba2 Server replays no graph: it serves the tokens
    and the logits, bit for bit, of an eager prefill + decode_step loop
    on the same weights."""
    cfg = get_smoke_config(SSM_ARCH).scaled(dtype="float32")
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_real, (B, PROMPT)).astype(np.int32)
    srv = Server(cfg, tmp_path / "s", device="cpu", max_len=PROMPT + GEN)
    out, stats = srv.generate(prompts, GEN, keep_logits=True)
    srv.close()
    rec = trace.units("serve.generate")[-1]
    assert rec.counts.get("serve.decode_graph_steps", 0) == 0
    assert rec.counts.get("serve.decode_graph_captures", 0) == 0
    assert rec.counts["serve.decode_steps"] == GEN
    cache = mdl.init_decode_state(cfg, B, PROMPT + GEN, dtype=torch.float32,
                                  device="cpu")
    logits, cache = mdl.prefill(srv.params, {"tokens": prompts}, cfg, cache)
    want, toks = [logits], []
    for i in range(GEN):
        toks.append(logits.argmax(-1)[:, None])
        logits, cache = mdl.decode_step(srv.params, toks[-1], PROMPT + i,
                                        cfg, cache)
        want.append(logits)
    np.testing.assert_array_equal(out, torch.cat(toks, 1).numpy())
    for got, w in zip(stats["logits"], want):
        assert torch.equal(got, w)

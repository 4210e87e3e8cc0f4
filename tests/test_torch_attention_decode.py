"""Decode positions on the device and the Server's decode graph for
attention stacks, on the CPU.

Decode reads its position as an int or as a 0-d tensor on the device;
both must give the same outputs and caches, bit for bit, for global and
local (ring) attention, the ring's wrap included.  Prefill fills the
cache it is given in place, so a cache that served an earlier, longer
prompt serves a shorter one as a fresh cache does.  The Server's graph
path (``DecodeGraph``) is rehearsed with the CUDA graph's capture and
replay stood in for by running the captured step again: it must serve
the eager loop's tokens and logits bit for bit, and count what it
routes as the eager loop does."""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch.serve import Server
from repro_torch.models import attention
from repro_torch.models import model as mdl

CPU = torch.device("cpu")
# qwen2-moe: global attention and MoE; gemma2: local (window 8) and
# global attention, softcaps, a scaled embedding; mamba2: SSD alone
ARCHS = ("qwen2-moe-a2.7b", "gemma2-27b", "mamba2-130m")


def _cfg(arch):
    return get_smoke_config(arch).scaled(dtype="float32")


def _attention_params(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    p = attention.init_attention(g, cfg)
    for k in ("bq", "bk", "bv"):
        if k in p:
            p[k] = 0.1 * torch.randn(p[k].shape, generator=g)
    return p


@pytest.mark.parametrize("arch,kind,s", [
    ("qwen2-moe-a2.7b", "global", 5), ("gemma2-27b", "local", 5),
    ("gemma2-27b", "local", 13), ("gemma2-27b", "global", 13)])
def test_tensor_position_matches_int_position(arch, kind, s):
    """Prefill of ``s`` tokens, then 6 decode steps (local: window 8,
    so the ring wraps while decoding from 5 and is full at 13)."""
    cfg = _cfg(arch)
    window = cfg.local_window if kind == "local" else 0
    p = _attention_params(cfg, 3)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, s, cfg.d_model), generator=g)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(2, s)
    caches = []
    for _ in range(2):
        c = attention.init_cache(cfg, 2, 24, kind, torch.float32, CPU)
        _, c = attention.prefill_attention(p, x, pos, cfg, c, window=window,
                                           use_kernels=False)
        caches.append(c)
    at = torch.tensor(s)
    for i in range(6):
        xt = torch.randn((2, 1, cfg.d_model), generator=g)
        a, caches[0] = attention.decode_attention(p, xt, s + i, cfg,
                                                  caches[0], window=window)
        b, caches[1] = attention.decode_attention(p, xt, at, cfg,
                                                  caches[1], window=window)
        at = at + 1
        assert torch.equal(a, b)
        for name in ("k", "v", "pos"):
            assert torch.equal(caches[0][name], caches[1][name])


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_decode_step_takes_a_tensor_position(arch):
    cfg = _cfg(arch)
    params = mdl.init_params(cfg, device=CPU)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_real, (2, 11))
    outs = []
    for as_tensor in (False, True):
        cache = mdl.init_decode_state(cfg, 2, 20, dtype=torch.float32,
                                      device=CPU)
        logits, cache = mdl.prefill(params, {"tokens": toks}, cfg, cache)
        got = [logits]
        for i in range(5):
            at = torch.tensor(11 + i) if as_tensor else 11 + i
            logits, cache = mdl.decode_step(params, got[-1].argmax(-1)[:, None],
                                            at, cfg, cache)
            got.append(logits)
        outs.append(got)
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_prefill_refills_a_used_cache(arch):
    """A cache that held a 17-token prompt and its decode serves a
    6-token prompt as a fresh cache does: the slots past the prompt are
    marked empty."""
    cfg = _cfg(arch)
    params = mdl.init_params(cfg, device=CPU)
    rng = np.random.default_rng(6)
    long, short = (rng.integers(0, cfg.vocab_real, (1, n)) for n in (17, 6))

    def serve_short(cache):
        logits, cache = mdl.prefill(params, {"tokens": short}, cfg, cache)
        got = [logits]
        for i in range(4):
            logits, cache = mdl.decode_step(params, got[-1].argmax(-1)[:, None],
                                            6 + i, cfg, cache)
            got.append(logits)
        return got

    used = mdl.init_decode_state(cfg, 1, 24, dtype=torch.float32, device=CPU)
    _, used = mdl.prefill(params, {"tokens": long}, cfg, used)
    _, used = mdl.decode_step(params, torch.tensor([[3]]), 17, cfg, used)
    fresh = mdl.init_decode_state(cfg, 1, 24, dtype=torch.float32,
                                  device=CPU)
    for a, b in zip(serve_short(used), serve_short(fresh)):
        assert torch.equal(a, b)


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    """A CUDA graph stood in for: a replay runs the captured step."""

    def replay(self):
        self.owner.logits.copy_(self.owner._step())


@contextlib.contextmanager
def _fake_capture(graph, capture_error_mode=None):
    yield


@pytest.fixture()
def fake_graphs(monkeypatch):
    """The decode graph's CUDA calls stood in for on the CPU, and the
    gate opened there while ``gate["on"]``."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    init = serve.DecodeGraph.__init__

    def owned(self, *a, **kw):
        init(self, *a, **kw)
        self.graph.owner = self
    monkeypatch.setattr(serve.DecodeGraph, "__init__", owned)
    real, gate = serve.graphs_decode, {"on": True}
    monkeypatch.setattr(serve, "graphs_decode", lambda cfg, device, extra=None:
                        gate["on"] and real(cfg, torch.device("cuda", 0),
                                            extra))
    return gate


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch", [1, 2])
def test_graph_path_rehearsed_on_the_cpu(tmp_path, fake_graphs, arch, batch):
    """One Server through the graph path serves three calls of other
    prompt lengths (local attention's ring wraps in the longer ones) as
    an eager Server does, bit for bit: tokens and every kept logits
    tensor; it captures once (its warm-up steps counted for nothing),
    and counts the MoE's routed and dropped assignments as the eager
    Server does."""
    cfg = _cfg(arch)
    gen, lens = 5, (14, 4, 23)
    params = mdl.init_params(cfg, device=CPU)
    servers = [Server(cfg, tmp_path / str(i), device=CPU, params=params,
                      max_len=max(lens) + gen, log_tokens=False)
               for i in range(2)]
    rng = np.random.default_rng(batch)
    before = trace.counters()
    for n in lens:
        prompts = rng.integers(0, cfg.vocab_real, (batch, n)).astype(np.int32)
        runs = []
        for srv, on in zip(servers, (True, False)):
            fake_graphs["on"] = on
            out, st = srv.generate(prompts, gen, keep_logits=True)
            runs.append((out, st, trace.units("serve.generate")[-1].counts))
        (out, st, g_counts), (want_out, want, e_counts) = runs
        np.testing.assert_array_equal(out, want_out)
        assert len(st["logits"]) == gen + 1
        for a, b in zip(st["logits"], want["logits"]):
            assert torch.equal(a, b)
        assert g_counts["serve.decode_graph_steps"] == gen
        assert "serve.decode_graph_steps" not in e_counts
        for name in ("moe.assignments_routed", "moe.assignments_dropped"):
            assert g_counts.get(name) == e_counts.get(name)
            assert (name in g_counts) is (arch == "qwen2-moe-a2.7b")
    after = trace.counters()
    assert after.get("serve.decode_graph_captures", 0) \
        - before.get("serve.decode_graph_captures", 0) == 1
    for srv in servers:
        srv.close()

"""The port's tracing (``repro_torch.trace``) on the CPU: spans kept only
while tracing is on (the environment, ``enable()``, a recording
``torch.profiler``), their parents and units across threads, the
profiler's clock, the Server's stats and counts, the loader's depth
counter, and the records' totals under threads that race."""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.grad import with_plain_grad
from repro_torch.launch.serve import DECODE_SPANS, Server

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture()
def traced():
    """Tracing on for the test, off after it."""
    trace.enable()
    try:
        yield
    finally:
        trace.enable(False)


def _mine(since):
    return [s for s in trace.spans() if s.start_ns >= since]


class _FakeEvent:
    """A CUDA event's interface, counting what is recorded."""
    made = []

    def __init__(self, enable_timing=False):
        self.t = None
        _FakeEvent.made.append(self)

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture()
def fake_cuda(monkeypatch):
    """CUDA events that run on the CPU: ``device=True`` spans record
    them as they would on the card."""
    _FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    return _FakeEvent


def test_off_keeps_no_span_enters_no_range_records_no_event(monkeypatch,
                                                            fake_cuda):
    entered = []
    rf = trace._profiler.record_function

    def counted(name):
        entered.append(name)
        return rf(name)
    monkeypatch.setattr(trace._profiler, "record_function", counted)
    assert not trace.is_on()
    t0 = time.time_ns()
    with trace.unit("test.unit") as u:
        with trace.span("test.a", device=True):
            trace.count("test.n", 2)
    assert _mine(t0) == [] and entered == [] and fake_cuda.made == []
    # the unit record is kept all the same
    assert u.end_ns >= u.start_ns >= t0
    assert set(u.seconds) == {"test.unit", "test.a"}
    assert u.counts == {"test.n": 2}
    assert trace.units("test.unit")[-1] is u


def test_enable_turns_it_on(monkeypatch, fake_cuda, traced):
    entered = []
    rf = trace._profiler.record_function

    def counted(name):
        entered.append(name)
        return rf(name)
    monkeypatch.setattr(trace._profiler, "record_function", counted)
    t0 = time.time_ns()
    with trace.span("test.a", device=True, x=1):
        time.sleep(0.002)
    [s] = _mine(t0)
    assert (s.name, s.attrs, entered) == ("test.a", {"x": 1}, ["test.a"])
    assert len(fake_cuda.made) == 2
    assert 1.5 <= s.device_ms <= 1e3 * (s.end_ns - s.start_ns) / 1e6 + 1


def test_profiler_turns_it_on():
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.is_on()
        with trace.span("test.profiled"):
            pass
    assert not trace.is_on()
    with trace.span("test.after"):
        pass
    assert [s.name for s in _mine(t0)] == ["test.profiled"]


@pytest.mark.parametrize("env", ["1", None])
def test_environment_turns_it_on(env):
    code = ("from repro_torch import trace\n"
            "with trace.span('test.env'):\n    pass\n"
            "print(trace.is_on(), len(trace.spans()))\n")
    environ = {k: v for k, v in os.environ.items()
               if k != "REPRO_TORCH_TRACE"}
    if env:
        environ["REPRO_TORCH_TRACE"] = env
    environ["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", code], env=environ,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == (["True", "1"] if env else ["False", "0"])


def test_parents_and_units_across_threads(fake_cuda, traced):
    """A lent span takes spans of threads with nothing open, as
    autograd's device thread runs ``grad.recompute``; the kernels'
    recompute itself on the CPU runs on the caller's thread."""
    t0 = time.time_ns()
    x = torch.randn(4, 3, requires_grad=True)

    def plain(t):
        return (t * t).sum(-1)
    with trace.unit("train.step") as u:
        with trace.span("train.backward", device=True, lend=True):
            y = with_plain_grad(plain, plain, x, kernel="ssd_scan")
            (g,) = torch.autograd.grad(y.sum(), [x])
            th = threading.Thread(target=lambda: trace.span(
                "grad.recompute", kernel="other").__enter__().__exit__())
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
        with trace.span("train.optimizer"):
            with trace.span("train.optimizer.read"):
                pass
    torch.testing.assert_close(g, 2 * x.detach())
    by = {(s.name, s.attrs.get("kernel")): s for s in _mine(t0)}
    unit = by["train.step", None]
    back, opt = by["train.backward", None], by["train.optimizer", None]
    here, there = by["grad.recompute", "ssd_scan"], by["grad.recompute",
                                                        "other"]
    assert {s.unit for s in by.values()} == {u.id}
    assert unit.id == u.id and unit.parent is None
    assert back.parent == opt.parent == unit.id
    assert here.parent == there.parent == back.id
    assert by["train.optimizer.read", None].parent == opt.id
    assert there.thread != here.thread == threading.get_ident()
    assert here.device_ms is not None and there.device_ms is None
    assert u.seconds["grad.recompute"] > 0
    # nothing is lent once the span closes
    assert trace._lent == []


def test_ssd_backward_kernel_counts_in_the_lent_step(monkeypatch, fake_cuda,
                                                     traced):
    """B6's backward kernel counts ``grad.ssd_bwd_kernel`` inside its
    ``grad.recompute`` span (``kernel="ssd_scan"``): run on a thread with
    no span open, as autograd's device thread runs it, the count lands in
    the lent ``train.step`` unit and in the span's record.  The launch is
    stood in for by ``ssd_chunked_bwd`` on the CPU."""
    from repro_torch.kernels import ssd
    t0 = time.time_ns()
    g = torch.Generator().manual_seed(0)
    x, dy = (torch.randn((1, 70, 2, 8), generator=g) for _ in range(2))
    dt = torch.rand((1, 70, 2), generator=g) * 0.1
    a_log = torch.zeros(2)
    B, C = (torch.randn((1, 70, 1, 16), generator=g) for _ in range(2))
    threads = []

    def launch_bwd(x, dt, a_log, B, C, states, decay, scores, dy, dfinal,
                   want_state):
        threads.append(threading.get_ident())
        return ssd.ssd_chunked_bwd(x, dt, a_log, B, C, dy, 64)[:5] + (None,)
    monkeypatch.setattr(ssd, "_launch_bwd", launch_bwd)
    ctx = SimpleNamespace(
        saved_tensors=(x, dt, a_log, B, C, None, None, None),
        needs_input_grad=(True,) * 5 + (False,),
        dtypes=(torch.float32,) * 5 + (None,))
    before = trace.counters().get("grad.ssd_bwd_kernel", 0)
    out = {}
    with trace.unit("train.step") as u:
        with trace.span("train.backward", device=True, lend=True):
            th = threading.Thread(target=lambda: out.update(
                grads=ssd._ScanWithKernelGrad.backward(ctx, dy, None)))
            th.start()
            th.join(timeout=60)
            assert not th.is_alive()
    assert threads and threads[0] != threading.get_ident()
    assert u.counts["grad.ssd_bwd_kernel"] == 1
    assert trace.counters()["grad.ssd_bwd_kernel"] == before + 1
    (span,) = [s for s in _mine(t0) if s.name == "grad.recompute"]
    assert span.attrs["kernel"] == "ssd_scan" and span.unit == u.id
    assert span.counts == {"grad.ssd_bwd_kernel": 1}
    assert span.device_ms is not None
    want = ssd.ssd_chunked_bwd(x, dt, a_log, B, C, dy, 64)
    for got, w in zip(out["grads"][:5], want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert out["grads"][5] is None


def _clock_gaps():
    """|start gap|, |end gap| (ns) of each span of a profiled unit against
    the profiler's range of its name."""
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.unit("test.clock"):
            for i in range(5):
                with trace.span("test.tick", i=i):
                    torch.ones(64).sum()
                    time.sleep(0.001)
    ours = sorted((s for s in _mine(t0) if s.name.startswith("test.")),
                  key=lambda s: s.start_ns)
    theirs = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() in ("test.clock", "test.tick")),
                    key=lambda e: e.start_ns())
    assert [s.name for s in ours] == [e.name() for e in theirs]
    assert len(ours) == 6
    return [(abs(s.start_ns - e.start_ns()),
             abs(s.end_ns - e.start_ns() - e.duration_ns()))
            for s, e in zip(ours, theirs)]


def test_spans_share_the_profilers_clock():
    """Each span lies within 100 us of the profiler's range of its name
    (Unix-epoch ns on both; a span reads the clock just inside the
    range).  Another process can hold this one off the core between the
    range's stamp and the span's read, so the best of three profiled
    units is taken."""
    with profile(activities=[ProfilerActivity.CPU]):   # the first sets up
        with trace.span("test.warm"):
            pass
    worst = min(max(max(g) for g in _clock_gaps()) for _ in range(3))
    assert worst < 100_000, worst


@pytest.mark.parametrize("gen", [1, 4])
def test_server_stats_are_its_spans(tmp_path, traced, gen):
    cfg = get_smoke_config("mamba2-130m").scaled(dtype="float32")
    srv = Server(cfg, tmp_path / "s", device="cpu", max_len=32)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_real, (2, 9)).astype(np.int32)
    before = trace.counters()
    t0 = time.time_ns()
    out, st = srv.generate(prompts, gen)
    srv.close()
    [u] = [u for u in trace.units("serve.generate") if u.start_ns >= t0]
    spans = [s for s in _mine(t0) if s.unit == u.id]
    secs = {}
    for s in spans:
        secs[s.name] = secs.get(s.name, 0) + (s.end_ns - s.start_ns) / 1e9
    assert st["prefill_s"] == pytest.approx(secs["serve.prefill"], abs=1e-9)
    assert st["decode_s"] == pytest.approx(
        sum(secs[n] for n in DECODE_SPANS), abs=1e-9)
    assert u.attrs == {"batch": 2, "prompt_len": 9, "gen": gen}
    # one wait a token read (the prefill's, then each step's but the
    # last's) and the final sync; one push a returned token
    names = [s.name for s in sorted(spans, key=lambda s: s.start_ns)]
    assert names.count("serve.decode.issue") == gen
    assert names.count("serve.decode.wait") == gen + 1
    assert names.count("serve.decode.log") == gen
    steps = {s.attrs["step"] for s in spans
             if s.name == "serve.decode.wait"}
    assert steps == set(range(-1, gen))
    after = trace.counters()
    names = ("serve.decode_steps", "serve.decode_tokens_returned")
    got = {k: after.get(k, 0) - before.get(k, 0) for k in names}
    assert got == {"serve.decode_steps": gen,
                   "serve.decode_tokens_returned": gen - 1}
    assert {k: u.counts.get(k, 0) for k in names} == got
    assert out.shape == (2, gen)


def test_loader_counts_each_take(tmp_path):
    from repro_torch.core import Clovis, layouts
    from repro_torch.data.pipeline import CORPUS_CONTAINER, TokenLoader
    cl = Clovis(tmp_path / "c", device="cpu")
    rng = np.random.default_rng(0)
    for j in range(2):
        cl.put_array(f"corpus/shard{j}", rng.integers(0, 50, 300).astype(
            np.int32), container=CORPUS_CONTAINER,
            layout=layouts.DEFAULT_LAYOUTS["data"])
    loader = TokenLoader(cl, batch=2, seq=8, prefetch=3)
    try:
        deadline = time.monotonic() + 60
        while not loader._q.full() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert loader._q.full()
        before = trace.counters()
        next(loader)                       # outside a unit: carried over
        with trace.unit("train.step") as u:
            pass
        with trace.unit("train.step") as v:
            next(loader)
        after = trace.counters()
    finally:
        loader.close()
    assert after["data.takes"] - before.get("data.takes", 0) == 2
    ready = after["data.ready"] - before.get("data.ready", 0)
    assert 3 + 2 <= ready <= 3 + 3
    assert u.counts == {"data.takes": 1, "data.ready": 3}
    assert v.counts["data.takes"] == 1 and 2 <= v.counts["data.ready"] <= 3
    assert u.seconds["data.take"] >= 0 and "data.take" in v.seconds


def test_records_under_racing_threads():
    """Many threads opening units, spans and counts at once lose no add:
    each unit holds its own, and the counter holds them all."""
    n_threads, n_units = 16, 50
    before = trace.counters().get("test.race", 0)
    got = [[] for _ in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(n_units):
                with trace.unit("test.race", k=k) as u:
                    for _ in range(3):
                        with trace.span("test.race.inner"):
                            trace.count("test.race")
                got[k].append(u)
        ths = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(old)
    assert trace.counters()["test.race"] - before == 3 * n_threads * n_units
    for k, us in enumerate(got):
        assert len(us) == n_units
        assert all(u.counts == {"test.race": 3} and u.attrs == {"k": k}
                   for u in us)

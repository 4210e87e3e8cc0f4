"""The readers of the program's own records (``repro_torch.trace``) on
the small cells at CPU sizes, traced: they find exactly the window's
unit records on the shared clock (the set-up's before the window and
the training step after it are not among them), the program's readers
return numbers, and the device-trace readers return None, never 0."""
import importlib.util

import pytest
import torch

from small_cells import SEED, small_cell
from sagebench import harness
from sagebench.drivers import serve as serve_driver
from sagebench.drivers import train as train_driver

CPU = torch.device("cpu")
KIND = {"mamba2-train": "train.step", "mamba2-longprompt": "serve.generate"}
HARNESS_UNIT = {"mamba2-train": "train.step",
                "mamba2-longprompt": "serve.request"}
NEW = {
    "mamba2-longprompt": ["decode_issue_ms.serve", "decode_wait_ms.serve",
                          "decode_ops_per_step.serve",
                          "decode_issue_idle.serve",
                          "decode_useful_share.serve"],
    "mamba2-train": ["ssd_recompute_ms.train", "optimizer_idle_ms.train",
                     "loader_queue_depth.train"],
}


def _reader(name):
    path = harness.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", params=sorted(KIND))
def measured(request, tmp_path_factory):
    """A traced run's record of the cell, and its entries."""
    from repro_torch import trace
    name = request.param
    cell = small_cell(name)
    driver = train_driver if name == "mamba2-train" else serve_driver
    root = tmp_path_factory.mktemp(name)
    with harness.store_under(root):
        ctx = harness.Context(cell, SEED, 0.5, True, CPU, root, 0.0)
        rec = driver.measure(ctx)
    return name, cell, rec, trace.units(KIND[name])


def test_readers_find_the_window_units(measured):
    name, cell, rec, units = measured
    assert rec.trace is not None and rec.trace.lo
    after = [u for u in units if u.start_ns >= rec.trace.lo]
    # training runs one more step after the window; serving none
    extra = 1 if name == "mamba2-train" else 0
    assert len(after) == len(rec.units) + extra
    for metric in NEW[name]:
        mod = _reader(metric)
        if hasattr(mod, "_window"):
            assert mod._window(rec) == after[:len(rec.units)]


def test_program_readers_read_and_device_readers_do_not(measured):
    name, cell, rec, _ = measured
    entries = {m["name"]: m for m in cell.per_layer}
    got = {m: _reader(m).read(rec) for m in NEW[name]}
    for m, v in got.items():
        if entries[m]["source"] == "device_trace":
            assert v is None, (m, v)
        else:
            assert isinstance(v, float) and v >= 0, (m, v)
    if name == "mamba2-longprompt":
        gen = cell.traffic["gen"]
        assert got["decode_useful_share.serve"] == pytest.approx(
            100.0 * (gen - 1) / gen)
        decode = 1e3 * sum(u["decode_s"] for u in rec.steady) / sum(
            u["gen"] for u in rec.steady)
        assert got["decode_issue_ms.serve"] + got["decode_wait_ms.serve"] \
            <= decode * (1 + 1e-9)
    else:
        prefetch = 4           # TokenLoader's default, as the driver runs it
        assert 0 <= got["loader_queue_depth.train"] <= prefetch


def test_readers_return_none_without_the_records(measured, monkeypatch):
    """A program without ``repro_torch.trace`` (an older checkout) reads
    None, and raises nothing."""
    import builtins
    name, _, rec, _ = measured
    real = builtins.__import__

    def no_trace(mod, globals=None, locals=None, fromlist=(), level=0):
        if mod == "repro_torch" and fromlist and "trace" in fromlist:
            raise ImportError("no trace")
        return real(mod, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", no_trace)
    for metric in NEW[name]:
        assert _reader(metric).read(rec) is None


def test_device_readers_on_a_planted_trace(measured):
    """Device operations planted in the traced units' spans: one a decode
    step over the second quarter of its issue span; one a traced step
    over the first half of its optimizer span.  The readers count them
    and the idle left around them."""
    import copy

    from repro_torch import trace
    from sagebench.devtrace import TraceSummary
    name, cell, rec, units = measured
    traced = [u.id for u in units if u.start_ns >= rec.trace.lo][:rec.traced]
    want = "serve.decode.issue" if name != "mamba2-train" \
        else "train.optimizer"
    spans = [s for s in trace.spans() if s.unit in traced and s.name == want]
    assert spans
    ops = []
    for s in spans:
        d = s.end_ns - s.start_ns
        lo = s.start_ns + (d // 4 if name != "mamba2-train" else 0)
        ops.append(("planted", lo, lo + d // 2))
    planted = copy.copy(rec)
    planted.trace = TraceSummary(ops, rec.trace.spans, HARNESS_UNIT[name])
    assert planted.trace.lo == rec.trace.lo
    idle = sum((s.end_ns - s.start_ns) - (s.end_ns - s.start_ns) // 2
               for s in spans)
    if name == "mamba2-train":
        assert _reader("optimizer_idle_ms.train").read(planted) == \
            pytest.approx(idle / 1e6 / rec.traced)
    else:
        assert _reader("decode_ops_per_step.serve").read(planted) == 1.0
        t = planted.trace
        assert _reader("decode_issue_idle.serve").read(planted) == \
            pytest.approx(100.0 * idle / (t.hi - t.lo))

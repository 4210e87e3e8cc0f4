"""The reader of ``ssd_bwd_kernel_share.train`` on synthetic unit records
of the program (``repro_torch.trace.Unit``): three window units of
mamba2's training steps (24 layers), counted by a program whose every
backward launches B6's backward kernel, one whose units carry no such
count (the reader's 0), and none without records or a window."""
import importlib.util
from types import SimpleNamespace

import pytest

from small_cells import harness

NAME = "ssd_bwd_kernel_share.train"
LAYERS = 24


def _reader():
    path = harness.BENCH_DIR / "metrics" / f"{NAME}.py"
    spec = importlib.util.spec_from_file_location("reader_bwd_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _units(per_step, start=10):
    from repro_torch import trace
    units = []
    for i in range(3):
        u = trace.Unit("train.step", {})
        u.start_ns = start + 10 * i
        u.counts = {"data.takes": 1}
        if per_step is not None:
            u.counts["grad.ssd_bwd_kernel"] = per_step
        units.append(u)
    return units


def _rec(traced=True):
    return SimpleNamespace(trace=SimpleNamespace(lo=5) if traced else None,
                           units=[{}, {}, {}], traced=1,
                           model={"n_layers": LAYERS})


@pytest.mark.parametrize("per_step,want", [
    (LAYERS, 100.0),        # every layer's backward through the kernel
    (None, 0.0),            # units without the count (the parent)
])
def test_share_reads_the_counter(monkeypatch, per_step, want):
    from repro_torch import trace
    units = _units(per_step)
    monkeypatch.setattr(trace, "units", lambda kind: list(units))
    got = _reader().read(_rec())
    assert isinstance(got, float) and got == pytest.approx(want)


def test_share_reads_only_the_window(monkeypatch):
    """A unit that started before the window counts for nothing; without
    a traced window, or with fewer units than the window's, nothing is
    read."""
    from repro_torch import trace
    early = _units(LAYERS, start=1)[0]
    units = [early] + _units(LAYERS // 2)
    monkeypatch.setattr(trace, "units", lambda kind: list(units))
    assert _reader().read(_rec()) == pytest.approx(50.0)
    assert _reader().read(_rec(traced=False)) is None
    monkeypatch.setattr(trace, "units", lambda kind: list(units[:3]))
    assert _reader().read(_rec()) is None
    monkeypatch.setattr(trace, "units", lambda kind: [])
    assert _reader().read(_rec()) is None

"""The reader of ``decode_graph_share.serve`` on synthetic unit records of
the program (``repro_torch.trace.Unit``): a traced request, then two
steady ones of 4 decode steps each."""
import importlib.util
from types import SimpleNamespace

import pytest

from small_cells import harness

NAME = "decode_graph_share.serve"


def _reader():
    path = harness.BENCH_DIR / "metrics" / f"{NAME}.py"
    spec = importlib.util.spec_from_file_location("reader_graph_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _units(graph_steps):
    from repro_torch import trace
    units = []
    for start in (10, 20, 30):
        u = trace.Unit("serve.generate", {})
        u.start_ns = start
        u.counts = {"serve.decode_steps": 4}
        if graph_steps is not None:
            u.counts["serve.decode_graph_steps"] = graph_steps
        units.append(u)
    return units


@pytest.mark.parametrize("graph_steps,traced,want", [
    (4, True, 100.0),       # every step replayed from the graph
    (2, True, 50.0),
    (None, True, 0.0),      # the counter never counted: eager steps
    (4, False, None),       # no traced window: nothing to read
])
def test_decode_graph_share_reads_the_counters(monkeypatch, graph_steps,
                                               traced, want):
    from repro_torch import trace
    units = _units(graph_steps)
    monkeypatch.setattr(trace, "units", lambda kind: list(units))
    rec = SimpleNamespace(trace=SimpleNamespace(lo=5) if traced else None,
                          units=[{}, {}, {}], traced=1)
    assert _reader().read(rec) == want


def test_decode_graph_share_reads_only_the_steady_window(monkeypatch):
    """A unit before the window and the traced request count for
    nothing."""
    from repro_torch import trace
    early, traced = _units(0)[:2]
    early.start_ns = 1
    units = [early, traced] + _units(4)[1:]
    monkeypatch.setattr(trace, "units", lambda kind: list(units))
    rec = SimpleNamespace(trace=SimpleNamespace(lo=5), units=[{}, {}, {}],
                          traced=1)
    assert _reader().read(rec) == 100.0

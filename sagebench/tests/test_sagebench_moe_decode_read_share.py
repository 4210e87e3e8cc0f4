"""The reader of ``moe_decode_read_share.serve`` on synthetic unit records
of the program (``repro_torch.trace.Unit``): three window units of a
qwen2-moe server's decode steps (60 experts a MoE call), counted by a
program that reads every expert, one that reads 4 of 60 (batch 1, top 4)
and one that keeps no such counters (the reader's None)."""
import importlib.util
from types import SimpleNamespace

import pytest

from small_cells import harness

NAME = "moe_decode_read_share.serve"
E, CALLS = 60, 24 * 13          # 24 MoE layers x 13 decode steps a request


def _reader():
    path = harness.BENCH_DIR / "metrics" / f"{NAME}.py"
    spec = importlib.util.spec_from_file_location("reader_read_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _units(read_per_call, start=10):
    from repro_torch import trace
    units = []
    for i in range(3):
        u = trace.Unit("serve.generate", {})
        u.start_ns = start + 10 * i
        u.counts = {"moe.assignments_routed": 4 * 1900 * 24}
        if read_per_call is not None:
            u.counts["moe.decode_experts"] = CALLS * E
            u.counts["moe.decode_experts_read"] = CALLS * read_per_call
        units.append(u)
    return units


def _rec(traced=True):
    return SimpleNamespace(trace=SimpleNamespace(lo=5) if traced else None,
                           units=[{}, {}, {}], traced=1)


@pytest.mark.parametrize("read_per_call,want", [
    (E, 100.0),             # the batched products: every expert read
    (4, 100.0 * 4 / 60),    # batch 1 through the slot-skipping kernel
    (None, None),           # no decode-expert counters (the parent)
])
def test_read_share_reads_the_counters(monkeypatch, read_per_call, want):
    from repro_torch import trace
    units = _units(read_per_call)
    monkeypatch.setattr(trace, "units", lambda kind: list(units))
    got = _reader().read(_rec())
    assert got == (None if want is None else pytest.approx(want))
    if want is not None:
        assert round(got, 2) in (100.0, 6.67)


def test_read_share_reads_only_the_window(monkeypatch):
    """A unit that started before the window counts for nothing; without
    a traced window, or with fewer units than the window's, nothing is
    read."""
    from repro_torch import trace
    early = _units(E, start=1)[0]
    units = [early] + _units(4)
    monkeypatch.setattr(trace, "units", lambda kind: list(units))
    assert _reader().read(_rec()) == pytest.approx(100.0 * 4 / 60)
    assert _reader().read(_rec(traced=False)) is None
    monkeypatch.setattr(trace, "units", lambda kind: list(units[:3]))
    assert _reader().read(_rec()) is None

"""The port's stream path against the reference, on the CPU.

The same seeded stream of (key, quality, reading, shard) int rows goes
into a continuous query of ``repro`` (Pallas segment reduce with
``interpret=True``) and of ``repro_torch`` (``device="cpu"``: the
kernels' plain PyTorch versions).  ``SyncStream`` hands every pushed
element to the queries on the caller's thread, in push order, so both
packages see one element sequence and the same watermarks; each must
emit the same windows in the same order, with int aggregates
byte-identical and float means within ``rtol=1e-5`` (f32 partial sums).
The real threaded ``StreamContext``, ``StreamTap``, ``clovis_appender``
and storage windows are checked against the reference too.
"""
import numpy as np
import pytest
import torch

from repro.analytics import EventWindow as JEventWindow
from repro.analytics import SessionWindow as JSessionWindow
from repro.analytics import col as jcol
from repro.core import Clovis as JClovis
from repro.core import StreamContext as JStreamContext
from repro.core import StreamTap as JStreamTap
from repro.core import WindowAllocator as JWindowAllocator
from repro.core import clovis_appender as jclovis_appender
from repro.core.streams import StreamElement as JElement
from repro_torch.analytics import (EventWindow, SessionWindow,
                                   WatermarkTracker, col)
from repro_torch.analytics.plan import optimize_streaming
from repro_torch.core import (Clovis, StorageWindow, StreamContext,
                              StreamTap, WindowAllocator, clovis_appender,
                              tee)
from repro_torch.core.streams import StreamElement


class SyncStream:
    """A live stream whose ``push`` delivers each element to the
    subscribers at once, on the caller's thread."""

    def __init__(self, element_cls, n_producers=1):
        self.n_producers = n_producers
        self._cls = element_cls
        self._subs = []
        self._seq = [0] * n_producers

    def subscribe(self, fn):
        self._subs.append(fn)
        return lambda: self._subs.remove(fn)

    def push(self, producer, stream_id, payload, *, event_ts=None):
        el = self._cls(self._seq[producer], stream_id, payload,
                       event_ts=event_ts, producer=producer)
        self._seq[producer] += 1
        for fn in list(self._subs):
            fn(el)
        return True

    def flush(self, deadline_s=0.0):
        return True


@pytest.fixture()
def engines(tmp_path):
    je = JClovis(tmp_path / "ref", devices_per_tier=3).analytics(
        interpret=True)
    pe = Clovis(tmp_path / "port", devices_per_tier=3,
                device="cpu").analytics()
    yield je, pe
    je.close()
    pe.close()


def _elements(seed, n=400, n_producers=2, late_every=23):
    """(producer, stream id, row, event_ts): per-producer rising event
    times with jitter, and every ``late_every``-th element a straggler
    from 0.5-3 s in the past."""
    rng = np.random.default_rng(seed)
    clock = [0.0] * n_producers
    out = []
    for i in range(n):
        p = int(rng.integers(0, n_producers))
        clock[p] += float(rng.exponential(0.05))
        ts = clock[p]
        if late_every and i % late_every == late_every - 1:
            ts = max(0.0, ts - float(rng.uniform(0.5, 3.0)))
        row = np.array([rng.integers(0, 8), rng.integers(0, 100),
                        rng.integers(-40, 40), p], np.int64)
        out.append((p, f"s{p % 2}", row, ts))
    return out


def _chain(eng, c, agg, grouped):
    ds = eng.from_stream(eng._live).filter(c(1) >= 30)
    if grouped:
        ds = ds.key_by(c(0))
    return ds.aggregate(agg, value=None if agg == "count" else c(2))


def _run_both(engines, window_pair, agg, grouped, elements, n_producers=2,
              **kw):
    """Run one continuous query per package over the same elements;
    returns (port results, reference results, port cq, reference cq)."""
    out = []
    for eng, c, win, cls in ((engines[0], jcol, window_pair[1], JElement),
                             (engines[1], col, window_pair[0],
                              StreamElement)):
        eng._live = SyncStream(cls, n_producers)
        cq = eng.run_continuous(_chain(eng, c, agg, grouped), win, **kw)
        for p, sid, row, ts in elements:
            eng._live.push(p, sid, row, event_ts=ts)
        out.append((cq.close(), cq))
    (jres, jcq), (res, cq) = out
    return res, jres, cq, jcq


def _same_value(got, want, agg):
    if isinstance(want, tuple):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].dtype == want[1].dtype
        if agg == "mean":
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
        else:
            assert got[1].tobytes() == want[1].tobytes()
    elif agg == "mean":
        assert got == pytest.approx(want, rel=1e-5)
    else:
        assert type(got) is type(want) and got == want


def _same_results(res, jres, agg):
    assert len(res) == len(jres) > 0
    for r, j in zip(res, jres):
        assert (r.stream_id, r.start, r.end, r.rows, r.final, r.revision) \
            == (j.stream_id, j.start, j.end, j.rows, j.final, j.revision)
        _same_value(r.value, j.value, agg)


WINDOWS = {
    "tumbling": lambda m: (m.EventWindow(1.0), {}),
    "tumbling_late": lambda m: (m.EventWindow(1.0, allowed_lateness_s=0.5),
                                {}),
    "sliding": lambda m: (m.EventWindow(2.0, slide_s=0.5,
                                        allowed_lateness_s=0.25), {}),
    "session": lambda m: (m.SessionWindow(gap_s=0.15,
                                          allowed_lateness_s=3.0), {}),
    "retraction": lambda m: (m.EventWindow(1.0, allowed_lateness_s=1.0),
                             {"retraction": True}),
}


class _Mods:
    def __init__(self, ew, sw):
        self.EventWindow, self.SessionWindow = ew, sw


PORT, REF = _Mods(EventWindow, SessionWindow), \
    _Mods(JEventWindow, JSessionWindow)


@pytest.mark.parametrize("kind", sorted(WINDOWS))
@pytest.mark.parametrize("agg,grouped", [("sum", True), ("mean", True),
                                         ("count", False), ("max", False)])
def test_continuous_windows_match_reference(engines, kind, agg, grouped):
    win, kw = WINDOWS[kind](PORT)
    jwin, _ = WINDOWS[kind](REF)
    res, jres, cq, jcq = _run_both(engines, (win, jwin), agg, grouped,
                                   _elements(len(kind) * 7 + len(agg)),
                                   delta_rows=7, **kw)
    _same_results(res, jres, agg)
    st, jst = cq.stats, jcq.stats
    for k in ("windows_opened", "windows_closed", "emitted", "late_count",
              "elements", "session_merges", "provisional_emits",
              "retractions", "peak_open_windows", "peak_buffered_rows"):
        assert st[k] == jst[k], k
    assert [(e.stream_id, e.seq, e.event_ts, e.missed, e.assigned)
            for e in cq.late] == \
        [(e.stream_id, e.seq, e.event_ts, e.missed, e.assigned)
         for e in jcq.late]
    if kind == "tumbling":
        assert st["late_count"] > 0            # the side channel is used
    if kind == "retraction":
        assert st["retractions"] > 0
    if kind == "session":
        assert st["session_merges"] > 0


def test_block_payload_is_its_rows_pushed_one_by_one(engines):
    """A 2-D payload is a block of rows sharing the element's event time:
    the port's windows over 8-row blocks equal the reference's over the
    same rows pushed one per element."""
    rng = np.random.default_rng(4)
    blocks = [rng.integers(0, 100, (8, 4)) for _ in range(60)]
    _, pe = engines
    pe._live = SyncStream(StreamElement)
    cq = pe.run_continuous(_chain(pe, col, "sum", True), EventWindow(0.5),
                           delta_rows=24)
    for i, b in enumerate(blocks):
        pe._live.push(0, "s", b, event_ts=i * 0.05)
    res = cq.close()
    rows = [(0, "s", r, i * 0.05) for i, b in enumerate(blocks) for r in b]
    _, jres, _, _ = _run_both(engines, (EventWindow(0.5), JEventWindow(0.5)),
                              "sum", True, rows, n_producers=1,
                              delta_rows=24)
    _same_results(res, jres, "sum")
    assert cq.stats["elements"] == 60 and sum(r.rows for r in res) == \
        sum(int((b[:, 1] >= 30).sum()) for b in blocks)


def test_threaded_stream_context_matches_reference(engines):
    """The real StreamContext (consumer thread), one producer: every
    final window equals the reference's."""
    elements = _elements(9, n=300, n_producers=1, late_every=0)
    out = []
    for eng, c, ctx_cls, win in ((engines[0], jcol, JStreamContext,
                                  JEventWindow(0.5)),
                                 (engines[1], col, StreamContext,
                                  EventWindow(0.5))):
        ctx = ctx_cls(n_producers=1)
        eng._live = ctx
        cq = eng.run_continuous(_chain(eng, c, "sum", True), win,
                                delta_rows=16)
        for p, sid, row, ts in elements:
            ctx.push(p, sid, row, event_ts=ts)
        out.append(cq.close())
        assert cq.late_count == 0
        ctx.close()
    _same_results(out[1], out[0], "sum")


def test_stream_tap_batch_query_matches_reference(engines):
    elements = _elements(2, n=300)
    vals = []
    for eng, c, ctx_cls, tap in ((engines[0], jcol, JStreamContext,
                                  JStreamTap()),
                                 (engines[1], col, StreamContext,
                                  StreamTap())):
        ctx = ctx_cls(n_producers=2, attach=tap)
        for p, sid, row, ts in elements:
            ctx.push(p, sid, row, event_ts=ts)
        assert ctx.close()
        ds = eng.from_stream(tap).filter(c(1) >= 30).key_by(c(0))
        vals.append((eng.run(ds.aggregate("sum", value=c(2))).value,
                     eng.run(ds.aggregate("mean", value=c(2))).value,
                     eng.explain(ds.aggregate("sum", value=c(2)))))
    (js, jm, jx), (ps, pm, px) = vals
    _same_value(ps, js, "sum")
    _same_value(pm, jm, "mean")
    assert px == jx and px.startswith("from_stream")


def test_live_source_rules_and_plans(engines):
    je, pe = engines
    pe._live = SyncStream(StreamElement)
    je._live = SyncStream(JElement)
    for eng, c in ((je, jcol), (pe, col)):
        ds = _chain(eng, c, "sum", True)
        with pytest.raises(ValueError, match="run_continuous"):
            eng.run(ds)
        with pytest.raises(ValueError, match="live stream"):
            eng.run_continuous(eng.from_stream(StreamTap()).aggregate(
                "sum"), EventWindow(1.0))
    assert pe.explain(_chain(pe, col, "sum", True)) == \
        je.explain(_chain(je, jcol, "sum", True))
    with pytest.raises(ValueError, match="terminal aggregate"):
        optimize_streaming(pe.from_stream(pe._live).filter(col(0) > 1).ops)
    with pytest.raises(ValueError, match="retraction"):
        pe.run_continuous(_chain(pe, col, "sum", True),
                          SessionWindow(gap_s=1.0), retraction=True)


def test_event_window_and_watermark_units():
    from repro.analytics import WatermarkTracker as JWatermarkTracker
    for size, slide in ((1.0, None), (2.0, 1.0), (0.256, None)):
        w, jw = EventWindow(size, slide), JEventWindow(size, slide)
        for t in (0.0, 0.5, 0.99, 1.0, 4.095, -0.5):
            assert w.keys_for(t) == jw.keys_for(t)
    wm, jwm = WatermarkTracker(3), JWatermarkTracker(3)
    for p, t in ((0, 5.0), (2, 9.0), (1, 3.0), (1, 2.0)):
        wm.observe(p, t)
        jwm.observe(p, t)
        assert wm.watermark() == jwm.watermark()
    wm.seal(1)
    jwm.seal(1)
    assert wm.watermark() == jwm.watermark() == 5.0


# ---------------------------------------------------------------------------
# streams and storage windows (core copies)
# ---------------------------------------------------------------------------

def test_clovis_appender_writes_the_reference_bytes(tmp_path):
    got = []
    for cl, appender, ctx_cls in (
            (Clovis(tmp_path / "p", device="cpu"), clovis_appender,
             StreamContext),
            (JClovis(tmp_path / "j"), jclovis_appender, JStreamContext)):
        ctx = ctx_cls(n_producers=1, attach=appender(cl, block_size=64))
        for i in range(64):
            ctx.push(0, "metrics", np.float32(i))
        assert ctx.close()
        got.append(cl.get("stream/metrics"))
    assert got[0] == got[1] == np.arange(64, dtype=np.float32).tobytes()


def test_tee_and_backpressure_copies():
    from repro_torch.core import StreamBackpressureError
    seen = []

    def bad(el):
        raise RuntimeError("boom")

    sc = StreamContext(n_producers=1, consumer_ratio=1,
                       attach=tee(bad, lambda el: seen.append(el.seq)))
    for i in range(10):
        sc.push(0, "s", i)
    assert sc.close()
    assert sorted(seen) == list(range(10))
    assert sc.stats["attach_errors"] == 10
    sc = StreamContext(n_producers=1, queue_depth=1, drop_policy="error")
    sc._stop.set()                              # no consumer drains
    for t in sc._threads:
        t.join(timeout=5)
    sc.push(0, "s", 0)
    with pytest.raises(StreamBackpressureError):
        sc.push(0, "s", 1)


def test_storage_windows_torch_handoff_and_ingest(tmp_path):
    cl = Clovis(tmp_path / "p", device="cpu")
    jcl = JClovis(tmp_path / "j")
    wa, jwa = WindowAllocator(cl), JWindowAllocator(jcl)
    data = np.linspace(0, 1, 16).reshape(4, 4)
    for tier in (None, "t1_nvram", "t2_flash"):
        win = wa.alloc(f"w_{tier}", (4, 4), "float64", tier=tier)
        win.from_torch(torch.from_numpy(data))
        win.accumulate(np.ones((4, 4)))
        t = win.to_torch(device="cpu")
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), data + 1)
        t[0, 0] = -1.0                           # a copy, not a view
        assert win.get()[0, 0] == data[0, 0] + 1
        jwin = jwa.alloc(f"w_{tier}", (4, 4), "float64", tier=tier)
        jwin.put(data)
        jwin.accumulate(np.ones((4, 4)))
        assert wa.ingest(f"w_{tier}") == jwa.ingest(f"w_{tier}")
        oid = f"win/w_{tier}"
        assert cl.get(oid) == jcl.get(oid)
        back = wa.restore(f"r_{tier}", oid, tier=tier)
        np.testing.assert_array_equal(back.get(), data + 1)
    path = wa._open["w_t2_flash"].path
    wa.free("w_t2_flash")
    np.testing.assert_array_equal(
        StorageWindow(path, (4, 4), "float64").get(), data + 1)

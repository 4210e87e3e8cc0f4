"""The port's edge ingest (``repro_torch.edge``) against the reference's
cases, on the port's stream runtime and analytics engine (CPU, the plain
versions of the kernels).

``tests/chaos.py``'s harness is loaded a second time as a private module,
its ``repro.edge`` imports rewritten to ``repro_torch.edge`` in memory,
so ``tests/test_edge_chaos.py`` keeps the reference's classes in the
same process.  Buffer files are interchangeable byte for byte: the two
packages write the same segments from the same events, and each replays
what the other wrote.  Integer window sums must be equal.
"""
import importlib.util
import itertools
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.edge import EdgeBuffer as RefEdgeBuffer
from repro.edge import encode_array as ref_encode_array
from repro_torch.analytics import EventWindow, col
from repro_torch.core import (Addb, Clovis, StreamBackpressureError,
                              StreamContext, StreamTap, tee)
from repro_torch.edge import (EdgeBuffer, EdgeBufferCorruption,
                              EdgeIngestor, IdempotencyLedger, encode_array)

SEEDS = [int(s) for s in
         os.environ.get("SAGE_CHAOS_SEEDS", "7").split(",") if s.strip()]
WINDOW_S = 1.0
REORDER_S = 0.4
LATENESS_S = 0.5


def _load_chaos():
    """``tests/chaos.py`` as a module of its own over the port's edge,
    registered under its own name ``torch_chaos`` (dataclasses look
    their module up); ``chaos`` and ``repro.edge`` stay the reference's."""
    path = Path(__file__).resolve().parent / "chaos.py"
    src = path.read_text().replace("from repro.edge", "from repro_torch.edge")
    spec = importlib.util.spec_from_file_location("torch_chaos", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


chaos = _load_chaos()


@pytest.fixture()
def eng(tmp_path):
    e = Clovis(tmp_path / "sage", addb=Addb(), devices_per_tier=3,
               device="cpu").analytics()
    yield e
    e.close()


def _grouped_to_dict(results):
    out = {}
    for r in results:
        if r.value is None:
            continue
        keys, vals = r.value
        for k, v in zip(keys, vals):
            out[int(k)] = out.get(int(k), 0) + int(v)
    return out


def test_chaos_harness_runs_on_the_port():
    h = chaos.ChaosHarness.__init__.__globals__
    assert h["EdgeIngestor"] is EdgeIngestor
    assert h["IdempotencyLedger"] is IdempotencyLedger


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_exactly_once_vs_batch(eng, tmp_path, seed):
    producers = 2
    tap = StreamTap()
    ctx = StreamContext(n_producers=producers, attach=tap)
    ds = eng.from_stream(ctx).key_by(col(0)).aggregate("sum", value=col(1))
    cq = eng.run_continuous(
        ds, EventWindow(WINDOW_S, allowed_lateness_s=LATENESS_S),
        delta_rows=16)
    harness = chaos.ChaosHarness(ctx, tmp_path / "edge", producers,
                                 window_s=WINDOW_S)
    actions = chaos.make_schedule(seed, producers=producers, n_events=150,
                                  window_s=WINDOW_S, reorder_s=REORDER_S)
    harness.run(actions)
    recovery = harness.final_recovery()
    assert ctx.close()
    results = cq.close()

    st_ = harness.stats
    assert st_["crashes"] >= 1 and st_["torn_crashes"] >= 1
    assert st_["duplicates_injected"] >= 1
    assert st_["poison_injected"] >= 1
    assert st_["lost"] >= 1
    assert st_["ingest_applied"] == st_["emitted"]
    assert recovery["applied"] + st_["replay_applied"] >= st_["lost"]
    assert harness.dlq.published == st_["poison_injected"]
    assert all(d.payload.startswith(b"\x89NOT-AN-NPY")
               for d in harness.dlq.drain())
    assert st_["buf_torn_tail_recovered"] >= 1

    streaming = _grouped_to_dict(results)
    late_adjust = {}
    for le in cq.late:
        if not le.assigned:
            k, v = int(le.payload[0]), int(le.payload[1])
            late_adjust[k] = late_adjust.get(k, 0) + v
    keys, vals = (eng.from_stream(tap).key_by(col(0))
                  .aggregate("sum", value=col(1)).collect())
    batch = {int(k): int(v) for k, v in zip(keys, vals)}
    assert batch == harness.expected
    combined = dict(streaming)
    for k, v in late_adjust.items():
        combined[k] = combined.get(k, 0) + v
    assert combined == batch
    assert chaos.TORN_SENTINEL not in set(batch.values())
    cst = cq.stats
    assert cst["open_windows"] == 0 and cst["buffered_rows"] == 0


def test_crash_replay_is_idempotent_across_restarts(eng, tmp_path):
    tap = StreamTap()
    ctx = StreamContext(n_producers=1, attach=tap)
    ds = eng.from_stream(ctx).key_by(col(0)).aggregate("sum", value=col(1))
    cq = eng.run_continuous(ds, EventWindow(1.0, allowed_lateness_s=0.5),
                            delta_rows=4)
    harness = chaos.ChaosHarness(ctx, tmp_path / "edge", 1)
    ing = harness.ingestors[0]
    for i in range(10):
        ing.send("s0", np.array([i // 4, i], np.int64), event_ts=0.1 * i)
    for _ in range(2):
        out = harness.ingestors[0].replay()
        assert out["applied"] == 0 and out["duplicate"] == 10
    assert ctx.close()
    assert _grouped_to_dict(cq.close()) == {0: 0 + 1 + 2 + 3,
                                            1: 4 + 5 + 6 + 7, 2: 8 + 9}


def test_tee_isolation_mid_chaos(tmp_path):
    tap = StreamTap()
    boom = {"n": 0}

    def flaky(el):
        boom["n"] += 1
        raise RuntimeError("flaky persistence branch")

    ctx = StreamContext(n_producers=1, attach=tee(flaky, tap))
    ing = EdgeIngestor(ctx, EdgeBuffer(tmp_path / "b", source="p0"),
                       producer=0)
    for i in range(8):
        ing.send("s0", np.array([0, 1], np.int64), event_ts=0.1 * i)
    ing.replay()
    assert ctx.close()
    assert tap.partitions()["s0"].shape[0] == 8
    assert boom["n"] == 8
    assert ctx.stats["attach_errors"] == 8


def test_backpressured_ingest_is_retryable(tmp_path):
    gate = threading.Event()
    tap = StreamTap()

    def gated(el):
        gate.wait(5.0)
        tap(el)

    ctx = StreamContext(n_producers=1, queue_depth=1, attach=gated,
                        drop_policy="error")
    ing = EdgeIngestor(ctx, EdgeBuffer(tmp_path / "b", source="p0"),
                       producer=0)
    rejected = 0
    for i in range(6):
        try:
            ing.send("s0", np.array([0, 1 << i], np.int64),
                     event_ts=0.1 * i)
        except StreamBackpressureError:
            rejected += 1
    assert rejected >= 1
    assert ing.stats["backpressure"] == rejected
    gate.set()
    deadline = time.time() + 10.0
    while True:
        try:
            ing.replay()
            break
        except StreamBackpressureError:
            assert time.time() < deadline
            time.sleep(0.01)
    assert ing.stats["applied"] == 6
    assert ctx.close()
    assert int(tap.partitions()["s0"][:, 1].sum()) == sum(
        1 << i for i in range(6))


# ---------------------------------------------------------------------------
# buffer files: the two packages' bytes
# ---------------------------------------------------------------------------

EVENTS = [("s0", np.array([k, 10 * k], np.int64), 0.25 * k)
          for k in range(40)] + [("stream/π", b"raw-bytes", 7.5)]


def _fill(cls, enc, root):
    buf = cls(root, source="p0", segment_bytes=512)
    for sid, value, ts in EVENTS:
        buf.append(sid, value if isinstance(value, bytes) else enc(value),
                   event_ts=ts)
    buf.close()


def _segments(root):
    return {p.name: p.read_bytes() for p in sorted(root.glob("seg-*.log"))}


def test_buffer_files_are_the_references_bytes(tmp_path):
    _fill(RefEdgeBuffer, ref_encode_array, tmp_path / "ref")
    _fill(EdgeBuffer, encode_array, tmp_path / "port")
    ref, port = _segments(tmp_path / "ref"), _segments(tmp_path / "port")
    assert len(ref) > 1 and ref == port


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_buffer_written_by_one_replays_in_the_other(tmp_path, writer,
                                                    reader):
    classes = {"ref": (RefEdgeBuffer, ref_encode_array),
               "port": (EdgeBuffer, encode_array)}
    root = tmp_path / "buf"
    _fill(*classes[writer], root)
    seg = sorted(root.glob("seg-*.log"))[-1]
    with seg.open("r+b") as fh:           # a torn tail for the reader
        fh.seek(0, 2)
        fh.truncate(fh.tell() - 3)
    buf = classes[reader][0](root, source="p0", segment_bytes=512)
    got = [(r.event_id, r.stream_id, r.payload, r.event_ts)
           for r in buf.replay()]
    want = [(i, sid, v if isinstance(v, bytes) else encode_array(v), ts)
            for i, (sid, v, ts) in enumerate(EVENTS[:-1])]
    assert got == want
    assert buf.stats["torn_tail_recovered"] == 1
    assert buf.append("s1", b"x").event_id == len(EVENTS) - 1
    buf.close()


# ---------------------------------------------------------------------------
# tests/test_edge_properties.py's properties on the port
# ---------------------------------------------------------------------------

_DIR = itertools.count()
_events = st.lists(
    st.tuples(st.sampled_from(["a", "b", "stream/π"]),
              st.binary(max_size=64),
              st.floats(min_value=0.0, max_value=1e6, allow_nan=False)),
    min_size=1, max_size=30)
_fixture_ok = dict(deadline=None,
                   suppress_health_check=[HealthCheck.function_scoped_fixture])


def _fresh_dir(tmp_path):
    return tmp_path / f"buf{next(_DIR)}"


@settings(max_examples=30, **_fixture_ok)
@given(events=_events, segment_bytes=st.integers(64, 512))
def test_buffer_replay_roundtrips_every_append(tmp_path, events,
                                               segment_bytes):
    root = _fresh_dir(tmp_path)
    buf = EdgeBuffer(root, segment_bytes=segment_bytes)
    want = []
    for sid, payload, ets in events:
        rec = buf.append(sid, payload, event_ts=ets)
        want.append((rec.event_id, sid, payload, float(ets)))
    buf.close()
    re = EdgeBuffer(root, segment_bytes=segment_bytes)
    assert [(r.event_id, r.stream_id, r.payload, r.event_ts)
            for r in re.replay()] == want
    assert re.next_event_id == len(events)
    re.close()


@settings(max_examples=30, **_fixture_ok)
@given(events=_events, segment_bytes=st.integers(64, 256),
       n_ack=st.integers(0, 30))
def test_prune_never_loses_unacked_records(tmp_path, events, segment_bytes,
                                           n_ack):
    root = _fresh_dir(tmp_path)
    buf = EdgeBuffer(root, segment_bytes=segment_bytes)
    recs = [buf.append(sid, p, event_ts=ts) for sid, p, ts in events]
    acked = {r.event_id for r in recs[:min(n_ack, len(recs))]}
    for eid in acked:
        buf.ack(eid)
    buf.prune()
    assert {r.event_id for r in recs} - acked <= {
        r.event_id for r in buf.replay()}
    buf.close()
    re = EdgeBuffer(root, segment_bytes=segment_bytes)
    assert re.next_event_id == len(recs)
    assert re.append("tail", b"x").event_id == len(recs)
    re.close()


@settings(max_examples=30, **_fixture_ok)
@given(events=_events, cut=st.integers(1, 12))
def test_torn_final_record_recovers_prefix(tmp_path, events, cut):
    root = _fresh_dir(tmp_path)
    buf = EdgeBuffer(root, segment_bytes=1 << 16)
    recs = [buf.append(sid, p, event_ts=ts) for sid, p, ts in events]
    buf.close()
    seg = sorted(root.glob("seg-*.log"))[-1]
    with seg.open("r+b") as fh:
        fh.truncate(seg.stat().st_size
                    - min(cut, len(recs[-1].encode()) - 1))
    re = EdgeBuffer(root, segment_bytes=1 << 16)
    assert [r.event_id for r in re.replay()] == [
        r.event_id for r in recs[:-1]]
    assert re.stats["torn_tail_recovered"] >= 1
    assert re.next_event_id == len(recs) - 1
    re.close()


def test_mid_file_damage_raises_corruption(tmp_path):
    root = _fresh_dir(tmp_path)
    buf = EdgeBuffer(root, segment_bytes=1 << 16)
    for i in range(4):
        buf.append("s", b"payload-%d" % i)
    buf.close()
    seg = sorted(root.glob("seg-*.log"))[0]
    data = bytearray(seg.read_bytes())
    data[10] ^= 0xFF
    seg.write_bytes(bytes(data))
    with pytest.raises(EdgeBufferCorruption):
        EdgeBuffer(root, segment_bytes=1 << 16)


@settings(max_examples=50, deadline=None)
@given(ids=st.lists(st.integers(0, 40), min_size=0, max_size=80),
       dup_factor=st.integers(1, 3))
def test_ledger_multiset_with_dups_equals_set_once(ids, dup_factor):
    ledger = IdempotencyLedger()
    admitted = [eid for eid in ids * dup_factor if ledger.admit("src", eid)]
    assert sorted(admitted) == sorted(set(ids))
    assert all(ledger.seen("src", eid) for eid in ids)
    floor = ledger.floor("src")
    assert set(range(floor + 1)) <= set(ids) or floor == -1
    assert len(ledger) == len(set(ids))


@settings(max_examples=30, deadline=None)
@given(ids=st.lists(st.integers(0, 25), min_size=1, max_size=60))
def test_ledger_floor_compacts_contiguous_prefix(ids):
    ledger = IdempotencyLedger()
    for eid in ids:
        ledger.mark("src", eid)
    distinct = set(ids)
    k = -1
    while k + 1 in distinct:
        k += 1
    assert ledger.floor("src") == k
    assert ledger.pending_gap("src") == len([i for i in distinct if i > k])


def test_ledger_sources_are_independent():
    ledger = IdempotencyLedger()
    assert ledger.admit("p0", 0)
    assert ledger.admit("p1", 0)
    assert not ledger.admit("p0", 0)
    assert ledger.floor("p0") == 0 and ledger.floor("p1") == 0

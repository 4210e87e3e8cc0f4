"""Continuous queries — incremental watermarked event-time windows over
a live StreamContext (paper §1, §4.2: data from "large, dispersed
scientific instruments and sensors" is processed *as it streams in*,
not round-tripped through the store as raw bytes).

The batch path drains a stream through ``StreamTap`` and queries the
frozen rows.  This module is the live path: ``run_continuous`` turns a
``Dataset.from_stream(ctx)`` chain into a long-running incremental
operator that

  * **subscribes** to the StreamContext, so consumer workers hand it
    every element in place (no second copy of the stream);
  * assigns elements to event-time windows (tumbling or sliding) and
    accumulates **incremental partial aggregates** — deltas of buffered
    rows are folded through the same vectorised op interpreter and
    segmented-reduce kernel (CUDA on a ``cuda`` KernelCfg device) the
    batch engine uses, so a window never re-scans what it already
    aggregated;
  * tracks a merged **low-watermark** over the per-producer event
    clocks (Dataflow/Flink semantics: the watermark is the min over
    producers of the latest event time each has emitted);
  * closes a window once the watermark passes its end plus the allowed
    lateness, combines its partials — scalars through FunctionShipper's
    partial-aggregate registry, grouped aggregates through
    ``plan.merge_partials`` — and emits a ``WindowResult`` via callback
    or a bounded result queue;
  * routes elements that arrive *beyond* the allowed lateness of an
    already-closed window to a **late side channel** (visible, counted,
    never silently dropped);
  * records per-window emit latency in ADDB (op ``stream_window``) for
    percipience.

Window lifecycle::

    open ──accumulate (delta partials)──▶ watermark ≥ end+lateness
      ▲                                         │ close
      │ first on-time element                   ▼
      └────────── late side channel ◀── element for a closed window

Memory is bounded: an open window holds at most ``delta_rows`` raw rows
(plus one element's block) and O(#deltas) small partials; closed windows
are freed at emit.

An element's payload is one row, as in the reference, unless it is a
2-D array: then it is a block of rows that share the element's event
time (an instrument frame), so a high-rate stream need not pay one
queue hop per row.  The reference treats a 2-D payload as one row of
its flattened values; every other payload means the same in both.
"""
from __future__ import annotations

import math
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analytics.plan import (KernelCfg, PhysicalPlan,
                                        StreamingPlan, _agg_values,
                                        _grouped_partial, apply_ops, as_rows,
                                        merge_partials)

_NEG_INF = float("-inf")
_POS_INF = float("inf")


# ---------------------------------------------------------------------------
# event-time windows
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EventWindow:
    """Event-time window specification: tumbling ``size_s`` windows, or
    sliding when ``slide_s`` is given (an element then belongs to every
    window covering its event time).  ``allowed_lateness_s`` is the
    bounded-lateness policy: a window stays open for stragglers until
    the watermark passes ``end + allowed_lateness_s``; anything later
    goes to the late side channel."""
    size_s: float
    slide_s: Optional[float] = None
    allowed_lateness_s: float = 0.0

    def __post_init__(self):
        if self.size_s <= 0:
            raise ValueError("window size_s must be positive")
        if self.slide_s is not None and self.slide_s <= 0:
            raise ValueError("window slide_s must be positive")
        if self.allowed_lateness_s < 0:
            raise ValueError("allowed_lateness_s cannot be negative")

    @property
    def stride(self) -> float:
        return self.size_s if self.slide_s is None else self.slide_s

    def keys_for(self, event_ts: float) -> List[int]:
        """Integer window keys covering ``event_ts`` (window k spans
        [k*stride, k*stride + size)).  Integer keys, not float starts,
        so window identity is immune to float drift."""
        hi = math.floor(event_ts / self.stride)
        lo = math.floor((event_ts - self.size_s) / self.stride) + 1
        return list(range(lo, hi + 1))

    def start(self, k: int) -> float:
        return k * self.stride

    def end(self, k: int) -> float:
        return k * self.stride + self.size_s


@dataclass(frozen=True)
class SessionWindow:
    """Session (gap) windows: a window is a burst of activity separated
    from the next by at least ``gap_s`` of event-time silence — the
    natural windowing for instrument runs and experiment shots, whose
    extents are data-defined rather than clock-defined.

    An element at event time ``t`` spans ``[t, t + gap_s)``; sessions
    that overlap merge (so one straggler can weld two bursts into one —
    exactly the Dataflow session semantics).  A session closes when the
    watermark passes its end (last event time + gap) plus the allowed
    lateness.  Sessions always emit final results; speculative
    retraction mode is a fixed-window feature (merging would retract
    *other* sessions' identities, not just values)."""
    gap_s: float
    allowed_lateness_s: float = 0.0

    def __post_init__(self):
        if self.gap_s <= 0:
            raise ValueError("session gap_s must be positive")
        if self.allowed_lateness_s < 0:
            raise ValueError("allowed_lateness_s cannot be negative")


# ---------------------------------------------------------------------------
# watermarks
# ---------------------------------------------------------------------------

class WatermarkTracker:
    """Merged low-watermark over per-producer event clocks.

    Each producer's local watermark is the max event time it has
    emitted so far (monotonic by construction); the merged watermark is
    the min over producers — no element with an earlier event time can
    still be in flight, assuming producers stamp non-decreasing event
    times (out-of-order stragglers are the allowed-lateness budget's
    job).  ``seal``-ed producers leave the min (a finished producer must
    not hold every window open forever); sealing all of them sends the
    watermark to +inf, flushing every open window.  ``idle_timeout_s``
    optionally excludes producers that have gone silent for that many
    wall-clock seconds — the Flink idle-source escape hatch."""

    def __init__(self, n_producers: int):
        if n_producers <= 0:
            raise ValueError("need at least one producer")
        now = time.time()
        self._last = [_NEG_INF] * n_producers
        self._wall = [now] * n_producers
        self._sealed = [False] * n_producers
        self._high = _NEG_INF           # monotonic floor on the merge
        self._lock = threading.Lock()

    def observe(self, producer: int, event_ts: float):
        with self._lock:
            if event_ts > self._last[producer]:
                self._last[producer] = event_ts
            self._wall[producer] = time.time()

    def seal(self, producer: Optional[int] = None):
        with self._lock:
            if producer is None:
                self._sealed = [True] * len(self._sealed)
            else:
                self._sealed[producer] = True

    def watermark(self, idle_timeout_s: Optional[float] = None) -> float:
        with self._lock:
            now = time.time()
            unsealed, active = [], []
            for i in range(len(self._last)):
                if self._sealed[i]:
                    continue
                unsealed.append(self._last[i])
                if not (idle_timeout_s is not None
                        and now - self._wall[i] > idle_timeout_s):
                    active.append(self._last[i])
            if not unsealed:
                return _POS_INF          # every producer finished
            # idle producers leave the min; with everyone idle, advance
            # only to the furthest event time actually observed (a global
            # stall must not flush windows as if the stream had ended),
            # and never regress (watermarks are monotonic)
            wm = min(active) if active else max(unsealed)
            if wm > self._high:
                self._high = wm
            return self._high


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WindowResult:
    """One emitted window: ``value`` is a scalar (global aggregate) or a
    ``(keys, values)`` pair (grouped), exactly what the batch engine
    would return for the same rows.  ``emit_latency_s`` is emit wall
    time minus the wall time the watermark crossed the window's close
    threshold (the ADDB-recorded percipience signal).

    With speculative ``retraction`` mode enabled, a window may emit
    more than once: ``final=False`` results are provisional (emitted
    once the watermark passes the window *end*, revised whenever late
    data lands within the allowed lateness), and a higher ``revision``
    for the same ``(stream_id, start, end)`` retracts every lower one.
    The ``final=True`` emission is the committed value — byte-identical
    to batch recomputation, exactly as in final-only mode."""
    stream_id: str
    start: float
    end: float
    value: Any
    rows: int
    emit_latency_s: float
    final: bool = True
    revision: int = 0


@dataclass(frozen=True)
class LateElement:
    """An element that missed its window(s) by more than the allowed
    lateness.  ``missed`` is how many of its windows had already
    closed; with sliding windows an element can be late for older
    windows yet still land in newer ones (``assigned``)."""
    stream_id: str
    seq: int
    event_ts: float
    payload: Any
    missed: int
    assigned: bool


def _payload_rows(payload) -> np.ndarray:
    """An element's rows as (r, ncols): a 2-D payload is a block of r
    rows; any other payload is one row of its flattened values."""
    arr = np.asarray(payload)
    return arr if arr.ndim == 2 else np.atleast_1d(arr).reshape(1, -1)


@dataclass
class _OpenWindow:
    pending: List[np.ndarray] = field(default_factory=list)
    pending_rows: int = 0            # rows in ``pending``
    partials: List[Any] = field(default_factory=list)
    rows: int = 0                    # post-row-ops rows aggregated
    revision: int = -1               # last provisional revision emitted
    dirty: bool = False              # data arrived since that emission


@dataclass
class _OpenSession:
    """One open session window: ``lo`` is the earliest event time seen,
    ``hi`` the latest plus the gap (the session's provisional end —
    it extends as activity continues and jumps when sessions merge)."""
    lo: float
    hi: float
    win: _OpenWindow = field(default_factory=_OpenWindow)


# ---------------------------------------------------------------------------
# the continuous-query operator
# ---------------------------------------------------------------------------

class ContinuousQuery:
    """A long-running incremental query over a live StreamContext.

    Construct through ``AnalyticsEngine.run_continuous`` — results
    arrive via the ``on_result`` callback (consumer-thread context) or
    the bounded result queue (``poll``/``drain``); late elements via
    ``late``/``late_count``; ``close()`` seals the watermark, emits
    every still-open window, and returns the drained results."""

    def __init__(self, ctx, splan: StreamingPlan, window, *,
                 shipper, kcfg: Optional[KernelCfg] = None, addb=None,
                 tag: str = "cq",
                 on_result: Optional[Callable[[WindowResult], None]] = None,
                 max_results: int = 1024, delta_rows: int = 256,
                 idle_timeout_s: Optional[float] = None,
                 late_capacity: int = 1024, retraction: bool = False):
        if delta_rows <= 0:
            raise ValueError("delta_rows must be positive")
        if not isinstance(window, (EventWindow, SessionWindow)):
            raise TypeError("window must be an EventWindow or a "
                            "SessionWindow")
        if retraction and isinstance(window, SessionWindow):
            raise ValueError("retraction (speculative emission) is a "
                             "fixed-window feature; session windows "
                             "emit final results only")
        self._ctx = ctx
        self._splan = splan
        self._window = window
        self._retraction = retraction
        self._kcfg = kcfg or KernelCfg()
        self._addb = addb
        self.tag = tag
        self._on_result = on_result
        self._idle_timeout_s = idle_timeout_s
        # scalar windows combine through the SAME partial-aggregate
        # registry batch ship_partial uses; grouped windows through the
        # same merge_partials path the batch executor uses
        self._pa = (shipper.partial_agg(splan.agg.agg)
                    if splan.merge == "scalar" else None)
        self._gplan = PhysicalPlan([], [], "group", splan.agg.agg)
        self._delta_rows = delta_rows
        self._open: Dict[Tuple[str, int], _OpenWindow] = {}
        self._sessions: Dict[str, List[_OpenSession]] = {}
        self._results: "queue.Queue[WindowResult]" = \
            queue.Queue(maxsize=max_results)
        self.late: Deque[LateElement] = deque(maxlen=late_capacity)
        self._lock = threading.RLock()
        self._closed = False
        self._counts = {"windows_opened": 0, "windows_closed": 0,
                        "emitted": 0, "late_count": 0, "elements": 0,
                        "dropped_results": 0, "callback_errors": 0,
                        "peak_open_windows": 0, "peak_buffered_rows": 0,
                        "session_merges": 0, "provisional_emits": 0,
                        "retractions": 0}
        self._buffered = 0
        self._advanced_wm = _NEG_INF     # last watermark _advance acted on
        self._wm = WatermarkTracker(ctx.n_producers)
        self._unsubscribe = ctx.subscribe(self._on_element)

    # -- ingest (runs on StreamContext consumer threads) ----------------

    def _on_element(self, el):
        ets = el.event_time
        emitted: List[WindowResult] = []
        with self._lock:
            if self._closed:
                return
            self._counts["elements"] += 1
            wm = self._wm.watermark(self._idle_timeout_s)
            row = _payload_rows(el.payload)
            if isinstance(self._window, SessionWindow):
                missed, assigned = self._assign_session(el, ets, row, wm)
            else:
                missed, assigned = self._assign_fixed(el, ets, row, wm)
            if missed:
                self._counts["late_count"] += 1
                self.late.append(LateElement(el.stream_id, el.seq, ets,
                                             el.payload, missed, assigned))
            if el.producer >= 0:
                self._wm.observe(el.producer, ets)
                emitted = self._advance(
                    self._wm.watermark(self._idle_timeout_s))
        self._deliver(emitted)

    def _buffer_row(self, w: _OpenWindow, row: np.ndarray):
        w.pending.append(row)
        w.pending_rows += row.shape[0]
        w.dirty = True
        self._buffered += row.shape[0]
        self._counts["peak_buffered_rows"] = max(
            self._counts["peak_buffered_rows"], self._buffered)
        if w.pending_rows >= self._delta_rows:
            self._flush_delta(w)

    def _n_open(self) -> int:
        return len(self._open) + sum(len(s) for s in
                                     self._sessions.values())

    def _assign_fixed(self, el, ets: float, row: np.ndarray,
                      wm: float) -> Tuple[int, bool]:
        lateness = self._window.allowed_lateness_s
        missed, assigned = 0, False
        for k in self._window.keys_for(ets):
            if wm >= self._window.end(k) + lateness:
                missed += 1              # watermark-closed before arrival
                continue
            key = (el.stream_id, k)
            w = self._open.get(key)
            if w is None:
                w = self._open[key] = _OpenWindow()
                self._counts["windows_opened"] += 1
                self._counts["peak_open_windows"] = max(
                    self._counts["peak_open_windows"], self._n_open())
            self._buffer_row(w, row)
            assigned = True
        return missed, assigned

    def _assign_session(self, el, ets: float, row: np.ndarray,
                        wm: float) -> Tuple[int, bool]:
        """Join/extend/merge session windows for one element.  An open
        overlapping session always absorbs the element (that is what
        batch recomputation would do); only an element whose would-be
        session ``[ets, ets + gap)`` is already past the watermark *and*
        touches no open session is late."""
        gap = self._window.gap_s
        lateness = self._window.allowed_lateness_s
        sessions = self._sessions.setdefault(el.stream_id, [])
        # overlap of [ets, ets + gap) with open [lo, hi)
        touching = [s for s in sessions
                    if ets + gap > s.lo and ets < s.hi]
        if not touching:
            if wm >= ets + gap + lateness:
                return 1, False          # its session already closed
            s = _OpenSession(ets, ets + gap)
            sessions.append(s)
            self._counts["windows_opened"] += 1
            self._counts["peak_open_windows"] = max(
                self._counts["peak_open_windows"], self._n_open())
        else:
            s = touching[0]
            s.lo = min(s.lo, ets)
            s.hi = max(s.hi, ets + gap)
            for other in touching[1:]:   # one straggler can weld bursts
                s.lo = min(s.lo, other.lo)
                s.hi = max(s.hi, other.hi)
                self._flush_delta(other.win)
                s.win.partials.extend(other.win.partials)
                s.win.rows += other.win.rows
                sessions.remove(other)
                self._counts["session_merges"] += 1
        self._buffer_row(s.win, row)
        return 0, True

    def _flush_delta(self, w: _OpenWindow):
        """Fold the buffered delta into a partial: one vectorised pass
        of the row ops + one kernel partial over the *delta only* — the
        incremental half of the batch fragment interpreter."""
        if not w.pending:
            return
        arr = np.concatenate(w.pending)
        self._buffered -= w.pending_rows
        w.pending, w.pending_rows = [], 0
        rows = as_rows(arr)
        if self._splan.row_ops:
            rows = apply_ops(self._splan.row_ops, rows, self._kcfg)[1]
        if rows.shape[0] == 0:
            return
        vals = _agg_values(rows, self._splan.agg)
        if self._splan.key is not None:
            kv = np.asarray(self._splan.key.key(rows))
            w.partials.append(_grouped_partial(kv, vals, self._splan.agg,
                                               self._kcfg))
        else:
            w.partials.append(self._pa.partial(vals))
        w.rows += rows.shape[0]

    # -- window lifecycle ----------------------------------------------

    def _advance(self, wm: float) -> List[WindowResult]:
        """Close every open window the watermark has passed (end +
        allowed lateness), in end-time order; returns the results for
        delivery *outside* the operator lock.  A watermark that has not
        moved since the last advance cannot close anything (elements
        are only assigned to windows the watermark has not passed), so
        the open-window scan is skipped on the hot path — except in
        retraction mode, where a stalled watermark can still owe
        re-emissions for dirty provisional windows."""
        if wm == _NEG_INF:
            return []
        if wm <= self._advanced_wm and not self._retraction:
            return []
        if wm > self._advanced_wm:
            self._advanced_wm = wm
        if isinstance(self._window, SessionWindow):
            return self._advance_sessions(wm)
        lateness = self._window.allowed_lateness_s
        due = [key for key in self._open
               if wm >= self._window.end(key[1]) + lateness]
        wm_wall = time.time()
        out = [self._close_window(key, wm_wall) for key in
               sorted(due, key=lambda t: (self._window.end(t[1]), t[0]))]
        if self._retraction:
            # speculative zone: end <= wm < end + lateness — emit a
            # provisional result on entry, re-emit when late data made
            # the previous emission stale (the retraction)
            spec = [(key, w) for key, w in self._open.items()
                    if wm >= self._window.end(key[1])
                    and (w.revision < 0 or w.dirty)]
            for key, w in sorted(spec, key=lambda t: (
                    self._window.end(t[0][1]), t[0][0])):
                out.append(self._emit_provisional(key, w, wm_wall))
        return out

    def _advance_sessions(self, wm: float) -> List[WindowResult]:
        lateness = self._window.allowed_lateness_s
        due: List[Tuple[str, _OpenSession]] = []
        for sid, sess in self._sessions.items():
            for s in list(sess):
                if wm >= s.hi + lateness:
                    sess.remove(s)
                    due.append((sid, s))
        wm_wall = time.time()
        out = []
        for sid, s in sorted(due, key=lambda t: (t[1].hi, t[0])):
            out.append(self._finish(sid, s.lo, s.hi, s.win, wm_wall,
                                    final=True))
        return out

    def _combine(self, w: _OpenWindow):
        """Window value from accumulated partials, without consuming
        them (provisional emissions re-combine after late deltas)."""
        self._flush_delta(w)
        if self._splan.merge == "group":
            return merge_partials(self._gplan, list(w.partials), self._kcfg)
        return self._pa.combine(list(w.partials)) if w.partials else None

    def _finish(self, sid: str, start: float, end: float, w: _OpenWindow,
                wm_wall: float, *, final: bool) -> WindowResult:
        value = self._combine(w)
        latency = time.time() - wm_wall
        revision = w.revision + 1
        w.revision = revision
        w.dirty = False
        if final:
            self._counts["windows_closed"] += 1
            if self._addb is not None:
                self._addb.record_window(self.tag, sid, start, w.rows,
                                         latency)
        else:
            self._counts["provisional_emits"] += 1
            if revision > 0:
                self._counts["retractions"] += 1
        return WindowResult(sid, start, end, value, w.rows, latency,
                            final=final,
                            revision=revision if self._retraction else 0)

    def _close_window(self, key: Tuple[str, int],
                      wm_wall: float) -> WindowResult:
        sid, k = key
        w = self._open.pop(key)
        return self._finish(sid, self._window.start(k),
                            self._window.end(k), w, wm_wall, final=True)

    def _emit_provisional(self, key: Tuple[str, int], w: _OpenWindow,
                          wm_wall: float) -> WindowResult:
        sid, k = key
        return self._finish(sid, self._window.start(k),
                            self._window.end(k), w, wm_wall, final=False)

    def _deliver(self, results: List[WindowResult]):
        """Hand closed windows to the caller — callback or bounded
        queue — with the operator lock released, so a slow (or
        stream-feeding) callback can never stall ingestion or deadlock
        against producers."""
        for res in results:
            if self._on_result is not None:
                try:
                    self._on_result(res)
                except Exception:
                    with self._lock:
                        self._counts["callback_errors"] += 1
                continue
            while True:
                try:
                    self._results.put_nowait(res)
                    break
                except queue.Full:      # bounded queue: drop the oldest
                    try:
                        self._results.get_nowait()
                        with self._lock:
                            self._counts["dropped_results"] += 1
                    except queue.Empty:
                        pass
        if results:
            with self._lock:
                self._counts["emitted"] += len(results)

    # -- caller surface -------------------------------------------------

    def poll(self, timeout: Optional[float] = None
             ) -> Optional[WindowResult]:
        """Next emitted window, or None if nothing arrived in time."""
        try:
            return self._results.get(timeout=timeout) if timeout \
                else self._results.get_nowait()
        except queue.Empty:
            return None

    def drain(self) -> List[WindowResult]:
        """Every currently-queued result (non-blocking)."""
        out = []
        while True:
            try:
                out.append(self._results.get_nowait())
            except queue.Empty:
                return out

    @property
    def watermark(self) -> float:
        return self._wm.watermark(self._idle_timeout_s)

    @property
    def late_count(self) -> int:
        with self._lock:
            return self._counts["late_count"]

    @property
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._counts)
            out["open_windows"] = self._n_open()
            out["buffered_rows"] = self._buffered
            out["watermark"] = self._wm.watermark(self._idle_timeout_s)
            out["closed"] = self._closed
            return out

    def seal(self, producer: Optional[int] = None):
        """Mark producer(s) finished: they stop holding the watermark
        back.  Sealing all producers flushes every open window."""
        with self._lock:
            self._wm.seal(producer)
            emitted = self._advance(self._wm.watermark(self._idle_timeout_s))
        self._deliver(emitted)

    def close(self, drain_deadline_s: float = 5.0) -> List[WindowResult]:
        """End the query: drain in-flight elements (best effort), seal
        the watermark so every open window closes and emits, detach
        from the stream, and return the queued results."""
        try:
            self._ctx.flush(drain_deadline_s)
        except Exception:
            pass                     # context may already be closed
        self._unsubscribe()
        emitted: List[WindowResult] = []
        with self._lock:
            if not self._closed:
                self._wm.seal()
                emitted = self._advance(_POS_INF)   # close everything
                self._closed = True
        self._deliver(emitted)
        return self.drain()

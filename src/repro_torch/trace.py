"""Spans, unit records and counters of the program, on one clock.

Every place in the compute path that times or counts its own work
records here.  Three kinds of record:

- **Spans** (``span(name, **attrs)``): a name, a start and an end on
  ``time.time_ns()`` (Unix-epoch ns, the clock ``torch.profiler`` stamps
  its events with), the enclosing span, the unit the span belongs to and
  its attributes.  Spans are kept only while tracing is on; then each
  also opens a ``torch.profiler.record_function`` range of its name, so
  that it shows in any device trace, and a span opened with
  ``device=True`` records a pair of CUDA events around its work, whose
  device ms are resolved when read (``SpanRecord.device_ms``).
- **Unit records** (``unit(kind, **attrs)``): one a ``Server.generate``
  call (``serve.generate``) or a ``Trainer.step`` (``train.step``): its
  id, start and end, attributes, and the host seconds of each span and
  the counts recorded inside it.  Always kept, in a ring of the last
  ``UNIT_RING``.  A unit is itself a span of its kind's name.
- **Counters** (``count(name, n)``): process-wide integer totals, always
  kept; a count made inside a unit is added to the unit's counts too.

Tracing is on while ``REPRO_TORCH_TRACE=1`` was set when this module was
imported, after ``enable()``, or while a ``torch.profiler`` records.
Off, a span keeps no record, enters no ``record_function`` and records no
event: it checks that flag and reads the clock twice for its unit's
seconds.

A span belongs to the innermost span open on its thread.  A span opened
with ``lend=True`` also lends itself to threads that have no span open,
while it is open: ``train.backward`` lends itself to autograd's device
thread, where ``grad.recompute`` runs.  Spans and counts recorded on a
thread outside any unit are carried into the next unit that thread
opens (``data.take`` into the ``train.step`` that the taken batch
feeds).

Read with ``spans()``, ``units(kind)`` and ``counters()``.  Safe across
threads: autograd's device thread, the token stream's consumer and the
loader's producer may record beside the caller's.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

UNIT_RING = 4096
SPAN_RING = 1 << 16

_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_enabled = os.environ.get("REPRO_TORCH_TRACE") == "1"
_lent: List["_Open"] = []
_spans: "deque[SpanRecord]" = deque(maxlen=SPAN_RING)
_units: "deque[Unit]" = deque(maxlen=UNIT_RING)
_counters: Dict[str, int] = {}


def enable(on: bool = True):
    """Turn tracing on (or off again) for the whole process."""
    global _enabled
    _enabled = on


def is_on() -> bool:
    """Whether spans are kept now."""
    return _enabled or _profiler._is_profiler_enabled


class _Tally:
    """Host seconds of spans and counts, by name."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def _add(self, other: "_Tally"):
        for k, v in other.seconds.items():
            self.seconds[k] = self.seconds.get(k, 0.0) + v
        for k, v in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + v


class Unit(_Tally):
    """One unit of work: ``kind``, ``id``, ``start_ns``, ``end_ns`` (None
    while open), ``attrs``, and ``seconds`` and ``counts`` by name (a
    name's spans summed)."""

    def __init__(self, kind: str, attrs: Dict):
        super().__init__()
        self.kind, self.attrs = kind, attrs
        self.id = next(_ids)
        self.start_ns = self.end_ns = None


class SpanRecord:
    """One span: ``name``, ``id`` (a unit's span has the unit's),
    ``parent`` (its enclosing span's id, or None), ``unit`` (its unit's
    id, or None), ``start_ns``, ``end_ns``,
    ``attrs``, ``thread`` (the recording thread's ident)."""

    __slots__ = ("name", "id", "parent", "unit", "start_ns", "end_ns",
                 "attrs", "thread", "_events")

    def __init__(self, name, parent, unit, attrs, id=None):
        self.name, self.parent, self.unit, self.attrs = (name, parent, unit,
                                                         attrs)
        self.id = next(_ids) if id is None else id
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = None
        self._events = None

    @property
    def device_ms(self) -> Optional[float]:
        """Device ms between the span's CUDA events (waits for the later
        one), or None where it recorded none."""
        if self._events is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])


class _Open:
    """An open span: what ``span`` and ``unit`` return."""

    __slots__ = ("name", "attrs", "device", "lend", "kind", "tally",
                 "unit_id", "rec", "_rf", "_t0")

    def __init__(self, name, attrs, device=False, lend=False, kind=False):
        self.name, self.attrs = name, attrs
        self.device, self.lend, self.kind = device, lend, kind

    def __enter__(self):
        stack = _stack()
        top = _top(stack)
        if self.kind:
            self.tally = Unit(self.name, self.attrs)
            self.unit_id = self.tally.id
            pending = _pending()
            _local.pending = _Tally()
            with _lock:
                self.tally._add(pending)
        elif top is not None:
            self.tally, self.unit_id = top.tally, top.unit_id
        else:
            self.tally, self.unit_id = _pending(), None
        self.rec = self._rf = None
        if is_on():
            parent = top.rec.id if top is not None and top.rec else None
            self.rec = SpanRecord(self.name, parent, self.unit_id,
                                  self.attrs,
                                  self.unit_id if self.kind else None)
            if self.device and torch.cuda.is_initialized():
                # made before the range opens: the first event a profiler
                # sees takes ms to make
                self.rec._events = (torch.cuda.Event(enable_timing=True),
                                    torch.cuda.Event(enable_timing=True))
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
            if self.rec._events is not None:
                self.rec._events[0].record()
        stack.append(self)
        if self.lend:
            with _lock:
                _lent.append(self)
        self._t0 = time.time_ns()
        if self.rec is not None:
            self.rec.start_ns = self._t0
        if self.kind:
            self.tally.start_ns = self._t0
            return self.tally
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if rec._events is not None:
                rec._events[1].record()
            self._rf.__exit__(None, None, None)
        # read after the range's end, as the start is read after its start
        t1 = time.time_ns()
        if self.lend:
            with _lock:
                _lent.remove(self)
        _stack().pop()
        with _lock:
            secs = self.tally.seconds
            secs[self.name] = secs.get(self.name, 0.0) + (t1 - self._t0) / 1e9
            if rec is not None:
                rec.end_ns = t1
                _spans.append(rec)
        if self.kind:
            self.tally.end_ns = t1
            with _lock:
                _units.append(self.tally)
        return False


def _stack() -> List[_Open]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _top(stack: List[_Open]) -> Optional[_Open]:
    """The span a new span or count on this thread belongs to."""
    if stack:
        return stack[-1]
    lent = _lent[-1:]           # one read: another thread may pop it
    return lent[0] if lent else None


def _pending() -> _Tally:
    try:
        return _local.pending
    except AttributeError:
        _local.pending = _Tally()
        return _local.pending


def span(name: str, *, device: bool = False, lend: bool = False,
         **attrs) -> _Open:
    """A span of ``name`` (a context manager).  ``device``: also time it
    by CUDA events while tracing is on; ``lend``: threads with no span
    open put their spans under this one while it is open."""
    return _Open(name, attrs, device, lend)


def unit(kind: str, **attrs) -> _Open:
    """A unit of ``kind`` (a context manager whose ``as`` gives the
    ``Unit``, filled in as its spans and counts close)."""
    return _Open(kind, attrs, kind=True)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` and to the current unit's count
    (or to what the thread carries into its next unit)."""
    top = _top(_stack())
    tally = top.tally if top is not None else _pending()
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        tally.counts[name] = tally.counts.get(name, 0) + n


def spans() -> List[SpanRecord]:
    """The kept spans, oldest first (the last ``SPAN_RING``)."""
    with _lock:
        return list(_spans)


def units(kind: str) -> List[Unit]:
    """The closed units of ``kind``, oldest first (of the last
    ``UNIT_RING`` of every kind)."""
    with _lock:
        return [u for u in _units if u.kind == kind]


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)

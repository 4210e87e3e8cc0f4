"""MPIStream analogue — decoupled producer/consumer I-O offload (paper §4.2).

Producers (training/simulation steps) emit fine-grained *stream elements*
into bounded queues; a small set of consumer workers (paper uses 1
consumer per 15 producers) drains them concurrently, applying an attached
computation (write to Clovis, statistics, visualisation prep).  The
producer returns immediately after an enqueue — step time is decoupled
from I/O exactly as in Fig. 7.

Properties:
  * bounded queues give backpressure (block, drop-newest, or drop-oldest
    policy);
  * consumers are work-stealing across producer queues (straggler
    mitigation);
  * ``flush(deadline)`` drains synchronously — the preemption path
    (SIGTERM -> flush -> exit) uses it;
  * per-element sequence numbers + consumer-side ordering give in-order
    appends per stream id;
  * ``subscribe`` lets additional consumers (the continuous-query
    operator in ``analytics/streaming.py``) observe every consumed
    element in place — no second copy of the stream.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

StreamFn = Callable[["StreamElement"], None]


class StreamBackpressureError(RuntimeError):
    """A producer's bounded queue could not admit an element.

    Raised by ``StreamContext.push`` under the ``error`` drop policy (a
    full queue rejects the element immediately) or under the default
    ``block`` policy when a ``timeout`` was given and expired.  Carries
    enough context to identify the misbehaving producer — resilient
    edge ingestion (``repro.edge``) surfaces this instead of silently
    losing data, so the caller can replay from its durable buffer."""

    def __init__(self, producer: int, stream_id: str, depth: int,
                 policy: str):
        super().__init__(
            f"producer {producer} backpressured on stream "
            f"{stream_id!r}: queue of depth {depth} is full "
            f"(policy={policy})")
        self.producer = producer
        self.stream_id = stream_id
        self.depth = depth
        self.policy = policy


@dataclass(order=True)
class StreamElement:
    """One record of the MPIStream flow (paper §4.2): what a producer
    rank hands to the I/O offload path per step.

    ``seq`` is the per-producer sequence number (consumer-side ordering
    key — the paper's in-order append guarantee per stream).  ``ts`` is
    *processing time* (when the element entered the stream runtime);
    ``event_ts`` is optional *event time* (when the modelled phenomenon
    happened — instrument clock, simulation step time).  Watermarked
    continuous queries (analytics/streaming.py, Dataflow-model
    semantics) window by ``event_ts`` and fall back to arrival time when
    the producer did not stamp one.  ``producer`` identifies the source
    rank so per-producer low-watermarks can be merged."""
    seq: int
    stream_id: str = field(compare=False)
    payload: Any = field(compare=False)
    ts: float = field(default_factory=time.time, compare=False)
    event_ts: Optional[float] = field(default=None, compare=False)
    producer: int = field(default=-1, compare=False)

    @property
    def event_time(self) -> float:
        """Event time, falling back to arrival (processing) time."""
        return self.ts if self.event_ts is None else self.event_ts


class StreamContext:
    """The MPIStream runtime (paper §4.2, Fig. 7): producer ranks emit
    into bounded per-producer queues and return immediately; a small
    consumer pool (paper's 1:15 consumer:producer ratio) drains them and
    applies the attached computation, decoupling step time from I/O.

    ``drop_policy``: ``"block"`` (backpressure, the default),
    ``"drop"`` (reject the *new* element when the queue is full),
    ``"drop_oldest"`` (evict the oldest queued element to admit the new
    one — live telemetry wants the freshest data), or ``"error"``
    (raise a typed ``StreamBackpressureError`` so a hostile producer is
    *told*, not silently shed).  Dropped elements are counted in
    ``stats["dropped"]`` either way; backpressure rejections
    additionally in ``stats["backpressure_errors"]``."""

    def __init__(self, *, n_producers: int, consumer_ratio: int = 15,
                 queue_depth: int = 256, attach: Optional[StreamFn] = None,
                 drop_policy: str = "block"):
        """attach: the computation applied to every consumed element."""
        if drop_policy not in ("block", "drop", "drop_oldest", "error"):
            raise ValueError("drop_policy must be block | drop | "
                             "drop_oldest | error")
        self.n_producers = n_producers
        self.n_consumers = max(1, -(-n_producers // consumer_ratio))
        self.drop_policy = drop_policy
        self._queues: List[queue.Queue] = [
            queue.Queue(maxsize=queue_depth) for _ in range(n_producers)]
        self._attach = attach or (lambda el: None)
        self._seq = [0] * n_producers
        self._stop = threading.Event()
        self._consumed = 0
        self._dropped = 0
        self._produced = 0
        self._attach_errors = 0
        self._bp_errors = 0
        self._lock = threading.Lock()
        self._subscribers: List[StreamFn] = []
        self._threads: List[threading.Thread] = []
        for c in range(self.n_consumers):
            t = threading.Thread(target=self._consumer_loop, args=(c,),
                                 daemon=True, name=f"sage-stream-c{c}")
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------------

    def push(self, producer: int, stream_id: str, payload: Any,
             *, event_ts: Optional[float] = None,
             timeout: Optional[float] = None) -> bool:
        """Producer-side emit; returns False if the element was dropped
        (``drop`` policy) and raises ``StreamBackpressureError`` under
        the ``error`` policy (or when a ``block`` ``timeout`` expires).
        ``event_ts`` stamps event time for watermarked continuous
        queries; producers should stamp non-decreasing event times
        (out-of-order stragglers are absorbed by the query's allowed
        lateness).

        Admission is lock-free against concurrent producers on the same
        queue: non-blocking policies retry ``put_nowait`` instead of
        trusting a ``full()`` snapshot, so a racing producer can never
        convert ``drop``/``drop_oldest``/``error`` into an unbounded
        block."""
        q = self._queues[producer]
        el = StreamElement(self._seq[producer], stream_id, payload,
                           event_ts=event_ts, producer=producer)
        self._seq[producer] += 1
        with self._lock:
            self._produced += 1
        if self.drop_policy == "block":
            try:
                q.put(el, timeout=timeout)   # blocks on full (backpressure)
            except queue.Full:
                with self._lock:
                    self._dropped += 1
                    self._bp_errors += 1
                raise StreamBackpressureError(producer, stream_id,
                                              q.maxsize, self.drop_policy)
            return True
        while True:
            try:
                q.put_nowait(el)
                return True
            except queue.Full:
                if self.drop_policy == "drop":
                    with self._lock:
                        self._dropped += 1
                    return False
                if self.drop_policy == "error":
                    with self._lock:
                        self._dropped += 1
                        self._bp_errors += 1
                    raise StreamBackpressureError(producer, stream_id,
                                                  q.maxsize,
                                                  self.drop_policy)
                try:                   # drop_oldest: evict, then retry
                    q.get_nowait()
                    q.task_done()      # keep unfinished_tasks accounting
                    with self._lock:
                        self._dropped += 1
                except queue.Empty:
                    pass               # a consumer drained it first

    def subscribe(self, fn: StreamFn) -> Callable[[], None]:
        """Register a consumer-side observer: ``fn(el)`` runs for every
        consumed element, after the attached computation, on the
        consumer thread and on the *same* element object (no copy).
        Observer exceptions are counted (``stats["attach_errors"]``)
        and never break the drain.  Returns an unsubscribe callable."""
        with self._lock:
            self._subscribers.append(fn)

        def unsubscribe():
            with self._lock:
                if fn in self._subscribers:
                    self._subscribers.remove(fn)

        return unsubscribe

    def _consumer_loop(self, cid: int):
        """Work-stealing drain over the producer queues."""
        n = self.n_producers
        idle_spins = 0
        while not self._stop.is_set() or self._pending() > 0:
            progressed = False
            for off in range(n):
                q = self._queues[(cid + off * self.n_consumers) % n]
                try:
                    el = q.get_nowait()
                except queue.Empty:
                    continue
                try:
                    try:
                        self._attach(el)
                    except Exception:
                        # resilient drain: a failing attached computation
                        # must not kill the consumer thread or starve
                        # subscribers of the element
                        with self._lock:
                            self._attach_errors += 1
                    with self._lock:
                        subs = list(self._subscribers)
                    for fn in subs:
                        try:
                            fn(el)
                        except Exception:
                            with self._lock:
                                self._attach_errors += 1
                finally:
                    with self._lock:
                        self._consumed += 1
                    q.task_done()
                progressed = True
            if not progressed:
                idle_spins += 1
                time.sleep(min(0.001 * idle_spins, 0.05))
            else:
                idle_spins = 0

    def _pending(self) -> int:
        # unfinished_tasks counts elements dequeued but whose attached
        # computation has not completed (task_done) — flush must wait for
        # those too, or a transactional commit can race an in-flight write
        return sum(q.unfinished_tasks for q in self._queues)

    # ------------------------------------------------------------------

    def flush(self, deadline_s: float = 30.0) -> bool:
        """Drain everything (preemption path). True if fully drained."""
        t0 = time.time()
        while self._pending() > 0:
            if time.time() - t0 > deadline_s:
                return False
            time.sleep(0.002)
        return True

    def close(self, deadline_s: float = 30.0) -> bool:
        ok = self.flush(deadline_s)
        self._stop.set()
        for t in self._threads:
            t.join(timeout=deadline_s)
        return ok

    @property
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"produced": self._produced, "consumed": self._consumed,
                    "dropped": self._dropped, "pending": self._pending(),
                    "attach_errors": self._attach_errors,
                    "backpressure_errors": self._bp_errors,
                    "consumers": self.n_consumers}


def tee(*fns: StreamFn) -> StreamFn:
    """Fan one consumed element out to several attached computations
    (e.g. persist via clovis_appender AND feed a StreamTap).

    Branches are isolated: a raising branch never starves the others of
    the element.  The first exception is re-raised after every branch
    ran, so StreamContext still counts it in ``stats["attach_errors"]``
    (failures stay visible instead of vanishing)."""

    def attach(el: StreamElement):
        first: Optional[BaseException] = None
        for fn in fns:
            try:
                fn(el)
            except Exception as e:   # isolate: remaining branches still run
                if first is None:
                    first = e
        if first is not None:
            raise first

    return attach


class StreamTap:
    """Stream → dataset bridge — the *drain-then-batch* half of SAGE's
    "process data as it streams in" claim (paper §1, §4.2): an attached
    computation that folds consumed elements into per-stream row
    buffers, which the analytics engine scans as in-memory partitions
    (``Dataset.from_stream``).  The incremental alternative — windowed
    results emitted while the stream is still live — is the
    continuous-query operator (``analytics/streaming.py``), which
    subscribes to the context instead of buffering a dataset.

    Rows are kept in sequence order regardless of which consumer drained
    them (consumers are work-stealing, so arrival order is not seq
    order).  ``max_rows`` bounds memory per stream: oldest rows are
    dropped once exceeded — live queries window over recent data, the
    persisted stream objects hold full history.
    """

    def __init__(self, max_rows: int = 1 << 16):
        self.max_rows = max_rows
        self._rows: Dict[str, List[tuple]] = {}
        self._lock = threading.Lock()

    def __call__(self, el: StreamElement):
        import numpy as np
        row = np.atleast_1d(np.asarray(el.payload))
        with self._lock:
            buf = self._rows.setdefault(el.stream_id, [])
            buf.append((el.seq, row))
            # amortised trim: sort only once the buffer doubles the
            # bound, so the consumer hot path stays O(1) per element
            if len(buf) > 2 * self.max_rows:
                buf.sort(key=lambda t: t[0])
                del buf[: len(buf) - self.max_rows]

    def partitions(self) -> Dict[str, "np.ndarray"]:
        """Per-stream (rows, ncols) arrays, rows in sequence order."""
        import numpy as np
        with self._lock:
            out = {}
            for sid, buf in self._rows.items():
                if not buf:
                    continue
                ordered = sorted(buf, key=lambda t: t[0])[-self.max_rows:]
                out[sid] = np.stack([r for _, r in ordered])
            return out

    def clear(self):
        with self._lock:
            self._rows.clear()


def clovis_appender(clovis, container: str = "streams",
                    block_size: int = 1 << 16, layout=None) -> StreamFn:
    """Attached computation that appends elements to per-stream objects —
    'streaming data to Clovis clients to perform I/O on the object
    storage' (paper §4.2 future work, realised here).

    Locking is per stream id so multiple consumers drain *different*
    streams fully in parallel (device time overlaps)."""
    import numpy as np
    meta_lock = threading.Lock()
    locks: Dict[str, threading.Lock] = {}
    buffers: Dict[str, List[bytes]] = {}

    def attach(el: StreamElement):
        payload = el.payload
        if hasattr(payload, "tobytes"):
            raw = np.asarray(payload).tobytes()
        elif isinstance(payload, bytes):
            raw = payload
        else:
            raw = repr(payload).encode()
        with meta_lock:
            lock = locks.setdefault(el.stream_id, threading.Lock())
        with lock:
            buffers.setdefault(el.stream_id, []).append(raw)
            chunks = buffers[el.stream_id]
            total = sum(len(c) for c in chunks)
            if total >= block_size:
                oid = f"stream/{el.stream_id}"
                with meta_lock:
                    if not clovis.exists(oid):
                        clovis.create(oid, block_size=block_size,
                                      container=container, layout=layout)
                # flush whole blocks via the append fast path; keep the tail
                n_full = (total // block_size) * block_size
                data = b"".join(chunks)
                clovis.store.append(oid, data[:n_full])
                buffers[el.stream_id] = [data[n_full:]] if data[n_full:] else []

    return attach

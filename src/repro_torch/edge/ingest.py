"""EdgeIngestor — the gateway between durable edge buffers and the
store's stream runtime, where at-least-once becomes exactly-once.

Delivery pipeline per record (docs/ingestion.md):

    EdgeBuffer record
        │ ledger.seen?  ──yes──▶ counted duplicate (replay / redelivery)
        ▼ no
    decode payload ──raises──▶ dead-letter channel (poison event,
        │                      ADDB-visible, ledger-marked so replays
        ▼ ok                   of the same poison count as duplicates)
    StreamContext.push ──full──▶ StreamBackpressureError (typed,
        │                        per-producer; the record stays unacked
        ▼ admitted               and unmarked, so replay retries it)
    ledger.mark + buffer.ack  ──▶ exactly-once applied

Ordering is the whole point: the ledger is marked only *after* the
element is in the stream (marking earlier would convert a failed
delivery into silent loss), and the buffer is acked only on terminal
outcomes (applied / duplicate / poison), so ``prune()`` can never
discard an event the store has not absorbed.
"""
from __future__ import annotations

import io
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, Optional

import numpy as np

from repro_torch.core.streams import StreamBackpressureError
from repro_torch.edge.buffer import EdgeBuffer, EdgeRecord
from repro_torch.edge.ledger import IdempotencyLedger

APPLIED = "applied"
DUPLICATE = "duplicate"
POISON = "poison"


def encode_array(arr) -> bytes:
    """Canonical payload codec: numpy array -> npy bytes."""
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def decode_array(payload: bytes) -> np.ndarray:
    """Inverse of ``encode_array``; raises on anything that is not a
    well-formed npy buffer — the poison-event detector."""
    return np.load(io.BytesIO(payload), allow_pickle=False)


@dataclass(frozen=True)
class DeadLetter:
    """One undecodable event, parked instead of dropped: everything a
    runbook needs to reprocess it after the decoder is fixed."""
    source: str
    event_id: int
    stream_id: str
    event_ts: float
    payload: bytes
    reason: str


class DeadLetterQueue:
    """Bounded dead-letter channel.  Poison events are *routed* here —
    never silently shed — and the count is ADDB-visible through the
    ingestor (``addb.edge_trace("dlq")``)."""

    def __init__(self, capacity: int = 1024):
        self._items: Deque[DeadLetter] = deque(maxlen=capacity)
        self._published = 0
        self._lock = threading.Lock()

    def publish(self, letter: DeadLetter):
        with self._lock:
            self._items.append(letter)
            self._published += 1

    def drain(self) -> list:
        with self._lock:
            out = list(self._items)
            self._items.clear()
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def published(self) -> int:
        """Total letters ever published (survives ``drain``)."""
        with self._lock:
            return self._published


class EdgeIngestor:
    """Exactly-once delivery of one producer's EdgeBuffer into a
    StreamContext.

    ``send(stream_id, array, event_ts)`` is the happy producer path:
    durably append, then deliver.  ``deliver(record)`` is the raw path
    chaos schedules and replays drive.  ``replay()`` re-delivers every
    unpruned buffered record — applied events come back as counted
    duplicates, lost ones are applied for the first time.
    """

    def __init__(self, ctx, buffer: EdgeBuffer, *, producer: int,
                 ledger: Optional[IdempotencyLedger] = None,
                 dlq: Optional[DeadLetterQueue] = None,
                 decoder: Callable[[bytes], Any] = decode_array,
                 addb=None):
        self.ctx = ctx
        self.buffer = buffer
        self.producer = producer
        self.ledger = ledger if ledger is not None else IdempotencyLedger()
        self.dlq = dlq if dlq is not None else DeadLetterQueue()
        self._decoder = decoder
        self._addb = addb
        self._lock = threading.Lock()
        self._counts = {"applied": 0, "duplicates": 0, "poison": 0,
                        "backpressure": 0, "replays": 0}

    # -- producer surface ----------------------------------------------

    def send(self, stream_id: str, value, *, event_ts: float = 0.0) -> str:
        """Append one event durably, then deliver it.  Arrays are
        encoded with the canonical codec; raw bytes pass through (how
        a broken instrument injects poison)."""
        payload = (value if isinstance(value, (bytes, bytearray))
                   else encode_array(value))
        rec = self.buffer.append(stream_id, bytes(payload),
                                 event_ts=event_ts)
        return self.deliver(rec)

    def deliver(self, rec: EdgeRecord) -> str:
        """Deliver one buffered record; returns ``applied`` |
        ``duplicate`` | ``poison``.  Raises ``StreamBackpressureError``
        when the stream cannot admit the element — the record stays
        unacked and unmarked so a later replay retries it."""
        source = self.buffer.source
        if self.ledger.seen(source, rec.event_id):
            self._count("duplicates")
            self._trace("duplicate", rec)
            self.buffer.ack(rec.event_id)
            return DUPLICATE
        try:
            value = self._decoder(rec.payload)
        except Exception as e:
            self.dlq.publish(DeadLetter(source, rec.event_id,
                                        rec.stream_id, rec.event_ts,
                                        rec.payload, repr(e)))
            self._count("poison")
            self._trace("dlq", rec, ok=False)
            # marked so a replayed poison is a duplicate, not a second
            # dead letter — DLQ counts are exactly-once too
            self.ledger.mark(source, rec.event_id)
            self.buffer.ack(rec.event_id)
            return POISON
        try:
            admitted = self.ctx.push(self.producer, rec.stream_id, value,
                                     event_ts=rec.event_ts)
        except StreamBackpressureError:
            self._count("backpressure")
            self._trace("backpressure", rec, ok=False)
            raise
        if not admitted:               # "drop" policy rejected it
            self._count("backpressure")
            self._trace("backpressure", rec, ok=False)
            raise StreamBackpressureError(self.producer, rec.stream_id,
                                          -1, self.ctx.drop_policy)
        self.ledger.mark(source, rec.event_id)
        self.buffer.ack(rec.event_id)
        self._count("applied")
        return APPLIED

    # -- recovery surface ----------------------------------------------

    def replay(self) -> Dict[str, int]:
        """Crash recovery: re-deliver every unpruned buffered record in
        id order.  Returns outcome counts for this replay pass."""
        out = {APPLIED: 0, DUPLICATE: 0, POISON: 0}
        for rec in self.buffer.replay():
            out[self.deliver(rec)] += 1
        self._count("replays")
        if self._addb is not None:
            self._addb.record_edge("replay", self.buffer.source,
                                   f"applied={out[APPLIED]}",
                                   n=sum(out.values()))
        return out

    def prune(self) -> int:
        """Drop fully-acked buffer segments (ADDB-visible)."""
        removed = self.buffer.prune()
        if removed and self._addb is not None:
            self._addb.record_edge("prune", self.buffer.source, n=removed)
        return removed

    # -- accounting ----------------------------------------------------

    def _count(self, key: str):
        with self._lock:
            self._counts[key] += 1

    def _trace(self, kind: str, rec: EdgeRecord, ok: bool = True):
        if self._addb is not None:
            self._addb.record_edge(kind, self.buffer.source,
                                   f"{rec.stream_id}#{rec.event_id}",
                                   n=len(rec.payload), ok=ok)

    @property
    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._counts)
        out["dead_letters"] = self.dlq.published
        out["ledger_floor"] = self.ledger.floor(self.buffer.source)
        return out

"""EdgeBuffer — durable producer-side replay buffer (paper §1, §4.2).

SAGE's data arrives from "large, dispersed scientific instruments and
sensors"; the instrument side of that pipe fails in every way a
network-attached embedded box can: crash mid-send, redeliver after an
ack was lost, corrupt a record, die halfway through writing one.  The
EdgeBuffer is the producer's write-ahead log against all of that: every
event is appended to a checksummed segment file *before* delivery into
the store's StreamContext, so a crashed producer replays from disk
instead of losing data, and the store-side idempotency ledger
(``repro_torch.edge.ledger``) turns the resulting at-least-once delivery into
exactly-once window aggregates.

Segment format (docs/ingestion.md):

    segment file  seg-<first_event_id 012d>.log
    record        u32 body_len | u32 crc32(body) | body
    body          u64 event_id | f64 event_ts |
                  u16 stream_id_len | stream_id utf-8 | payload bytes

Durability/atomicity contract:

  * a record is written in one ``write()`` call and flushed; a crash
    mid-append can only produce a **torn tail** — a truncated final
    record in the final segment.  ``replay()``/open detect it (short
    read or checksum mismatch at EOF) and truncate the file back to the
    last intact record, so earlier records are never corrupted by a
    crash (``stats["torn_tail_recovered"]`` counts recoveries);
  * checksum damage *before* the tail is real corruption (bad media,
    truncated copy) and raises ``EdgeBufferCorruption`` — silently
    skipping records would break exactly-once accounting;
  * ``ack(event_id)`` marks an event delivered; ``prune()`` deletes
    only segments whose every record is acked, so replay after a crash
    is bounded by the unacked window, not the stream's history.  Acks
    are in-memory on purpose: losing them re-replays acked events,
    which the ledger absorbs (at-least-once buffer + dedup ledger =
    exactly-once pipeline).
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional

_HEADER = struct.Struct("<II")          # body_len, crc32
_BODY_FIXED = struct.Struct("<QdH")     # event_id, event_ts, stream_id_len


class EdgeBufferCorruption(RuntimeError):
    """A non-tail record failed its checksum — the segment is damaged
    beyond what a torn append can explain."""


@dataclass(frozen=True)
class EdgeRecord:
    """One durable edge event: ``event_id`` is the buffer-assigned
    monotonic id (the idempotency key, scoped by the buffer's
    ``source``), ``payload`` the raw encoded bytes (decoding — and
    poison detection — happens at ingest, not at storage)."""
    event_id: int
    stream_id: str
    event_ts: float
    payload: bytes

    def encode(self) -> bytes:
        sid = self.stream_id.encode()
        body = (_BODY_FIXED.pack(self.event_id, self.event_ts, len(sid))
                + sid + self.payload)
        return _HEADER.pack(len(body), zlib.crc32(body)) + body


def _decode_body(body: bytes) -> EdgeRecord:
    eid, ets, sid_len = _BODY_FIXED.unpack_from(body)
    off = _BODY_FIXED.size
    sid = body[off:off + sid_len].decode()
    return EdgeRecord(eid, sid, ets, body[off + sid_len:])


class EdgeBuffer:
    """Append-only, checksummed, prunable segment log for one producer.

    Thread-safety: one producer thread appends; ``ack``/``prune`` may
    be called from the delivery path (same or another thread) — all
    state is guarded by one lock.  Reopening an existing directory
    recovers: segments are scanned, a torn tail is truncated, and the
    next event id continues after the last durable record.
    """

    def __init__(self, root, *, source: str = "edge",
                 segment_bytes: int = 1 << 16, fsync: bool = False):
        if segment_bytes <= 0:
            raise ValueError("segment_bytes must be positive")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.source = source
        self.segment_bytes = segment_bytes
        self.fsync = fsync
        self._lock = threading.Lock()
        self._acked: set = set()
        self._acked_floor = -1          # every id <= floor is acked
        self._counts = {"appended": 0, "acked": 0, "pruned_segments": 0,
                        "torn_tail_recovered": 0, "replayed": 0}
        self._fh = None
        self._next_id = 0
        self._recover()

    # -- recovery ------------------------------------------------------

    def _segments(self) -> List[Path]:
        return sorted(self.root.glob("seg-*.log"))

    def _recover(self):
        """Scan existing segments, truncating a torn tail on the last
        one, and position the next event id after the last record."""
        segs = self._segments()
        for i, seg in enumerate(segs):
            last_tail = i == len(segs) - 1
            for rec in self._read_segment(seg, truncate_torn=last_tail):
                self._next_id = max(self._next_id, rec.event_id + 1)

    def _read_segment(self, seg: Path, *, truncate_torn: bool
                      ) -> Iterator[EdgeRecord]:
        data = seg.read_bytes()
        off = 0
        while off < len(data):
            torn = True
            if off + _HEADER.size <= len(data):
                blen, crc = _HEADER.unpack_from(data, off)
                body = data[off + _HEADER.size: off + _HEADER.size + blen]
                if len(body) == blen and zlib.crc32(body) == crc:
                    torn = False
            if torn:
                tail_of_file = True      # any damage reaching EOF is torn
                if off + _HEADER.size <= len(data):
                    blen, _ = _HEADER.unpack_from(data, off)
                    tail_of_file = off + _HEADER.size + blen >= len(data)
                if truncate_torn and tail_of_file:
                    with seg.open("r+b") as fh:
                        fh.truncate(off)
                    with self._lock:
                        self._counts["torn_tail_recovered"] += 1
                    return
                raise EdgeBufferCorruption(
                    f"{seg.name}: corrupt record at offset {off} "
                    f"(not a recoverable torn tail)")
            yield _decode_body(body)
            off += _HEADER.size + blen

    # -- append path ---------------------------------------------------

    def append(self, stream_id: str, payload: bytes, *,
               event_ts: float = 0.0) -> EdgeRecord:
        """Durably append one event and return its record (with the
        assigned event id).  The record is on disk before this
        returns — deliver *after* appending, never before."""
        if not isinstance(payload, (bytes, bytearray)):
            raise TypeError("payload must be bytes — encode arrays with "
                            "repro_torch.edge.encode_array")
        with self._lock:
            rec = EdgeRecord(self._next_id, stream_id, float(event_ts),
                             bytes(payload))
            self._next_id += 1
            raw = rec.encode()
            if (self._fh is None
                    or self._fh.tell() + len(raw) > self.segment_bytes):
                self._roll(rec.event_id)
            self._fh.write(raw)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._counts["appended"] += 1
            return rec

    def _roll(self, first_id: int):
        if self._fh is not None:
            self._fh.close()
        path = self.root / f"seg-{first_id:012d}.log"
        self._fh = path.open("ab")

    # -- replay / ack / prune ------------------------------------------

    def replay(self) -> Iterator[EdgeRecord]:
        """Yield every durable, unpruned record in event-id order —
        the crash-recovery path.  A torn tail on the final segment is
        truncated in place; earlier records are yielded intact."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
            segs = self._segments()
        for i, seg in enumerate(segs):
            for rec in self._read_segment(seg,
                                          truncate_torn=i == len(segs) - 1):
                with self._lock:
                    self._counts["replayed"] += 1
                yield rec

    def ack(self, event_id: int):
        """Mark one event delivered (applied, deduplicated, or routed
        to the dead-letter channel — all terminal outcomes)."""
        with self._lock:
            if event_id <= self._acked_floor:
                return
            self._acked.add(event_id)
            self._counts["acked"] += 1
            while self._acked_floor + 1 in self._acked:
                self._acked_floor += 1
                self._acked.discard(self._acked_floor)

    def prune(self) -> int:
        """Delete segments whose every record is acked; returns how
        many segments were removed.  The newest segment is never
        pruned, even when fully acked: it anchors ``next_event_id``
        across reopens — deleting it would restart ids at 0 after a
        crash, and reused ids read as duplicates to the ledger."""
        removed = 0
        with self._lock:
            all_segs = self._segments()
            if len(all_segs) <= 1:
                return 0
            segs = all_segs[:-1]        # never the newest (see above)
            # a segment's records span [its first id, next seg's first)
            bounds = [int(s.stem.split("-")[1]) for s in all_segs]
            for seg, lo, hi in zip(segs, bounds, bounds[1:]):
                if hi - 1 <= self._acked_floor:
                    seg.unlink()
                    removed += 1
                    self._counts["pruned_segments"] += 1
                else:
                    break               # segments are id-ordered
        return removed

    # -- lifecycle / introspection -------------------------------------

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                if self.fsync:
                    os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None

    @property
    def next_event_id(self) -> int:
        with self._lock:
            return self._next_id

    @property
    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._counts)
            out["acked_floor"] = self._acked_floor
            out["segments"] = len(self._segments())
            return out

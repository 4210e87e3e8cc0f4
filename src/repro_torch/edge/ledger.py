"""Event-id idempotency ledger — the store-side half of exactly-once.

The EdgeBuffer gives *at-least-once* delivery: a crashed producer
replays every unpruned record, and a flaky network can redeliver what
was already applied.  The ledger turns that into exactly-once window
aggregates: an event key (``source``, ``event_id``) is *admitted* at
most once; replays and duplicate deliveries are recognized and skipped
before they ever reach the StreamContext, so no window partial can
double-count.

Memory is bounded per source: event ids are monotonic per EdgeBuffer,
so the ledger keeps a contiguous *floor* (every id ≤ floor is applied)
plus a small sparse set of applied ids above it — out-of-order arrivals
briefly inflate the set, and it collapses back into the floor as the
gaps fill.  The algebraic invariant (hypothesis-tested in
tests/test_edge_properties.py): applying any multiset of events with
duplicates admits exactly the distinct set, in first-arrival order.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple


class IdempotencyLedger:
    """Dedup registry over (source, event_id) keys.

    ``seen`` / ``mark`` are split on purpose: the ingest gateway checks
    ``seen`` first, attempts delivery, and ``mark``s only after the
    element is durably in the stream — marking before a failed delivery
    would *lose* the event (it would replay as a "duplicate").
    ``admit`` fuses both for callers whose delivery cannot fail.
    """

    def __init__(self):
        self._floor: Dict[str, int] = {}     # ids <= floor are applied
        self._above: Dict[str, set] = {}
        self._lock = threading.Lock()

    def _state(self, source: str) -> Tuple[int, set]:
        return (self._floor.setdefault(source, -1),
                self._above.setdefault(source, set()))

    def seen(self, source: str, event_id: int) -> bool:
        with self._lock:
            floor, above = self._state(source)
            return event_id <= floor or event_id in above

    def mark(self, source: str, event_id: int):
        with self._lock:
            floor, above = self._state(source)
            if event_id <= floor:
                return
            above.add(event_id)
            while self._floor[source] + 1 in above:
                self._floor[source] += 1
                above.discard(self._floor[source])

    def admit(self, source: str, event_id: int) -> bool:
        """Atomically check-and-mark; True iff the event is fresh."""
        with self._lock:
            floor, above = self._state(source)
            if event_id <= floor or event_id in above:
                return False
            above.add(event_id)
            while self._floor[source] + 1 in above:
                self._floor[source] += 1
                above.discard(self._floor[source])
            return True

    def floor(self, source: str) -> int:
        with self._lock:
            return self._floor.get(source, -1)

    def pending_gap(self, source: str) -> int:
        """How many above-floor ids the sparse set currently holds —
        the memory the out-of-order tail is costing."""
        with self._lock:
            return len(self._above.get(source, ()))

    def __len__(self) -> int:
        with self._lock:
            return sum(f + 1 for f in self._floor.values()) + \
                sum(len(s) for s in self._above.values())

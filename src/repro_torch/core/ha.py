"""HA subsystem — failure monitoring and automated repair (paper §3.2.1).

The monitor consumes failure events across the storage tiers.  It does not
act on events in isolation: events are digested over a sliding window of
recent cluster history (the paper's "quasi-ordered sets of events") and a
repair procedure is engaged only when evidence crosses a threshold — one
transient IO error is noise, a burst is a failure.

Repair procedures:
  * device failure  -> mark failed, re-silver every mirrored object and
    rebuild parity objects onto healthy devices, then evict.
  * checksum burst on one object -> integrity scrub: re-silver the
    implicated replicas and verify the object end-to-end (the read path
    itself falls back to healthy replicas / parity on bad blocks).
  * straggler (p99 latency >> tier model) -> demote: report to HSM so hot
    objects migrate away (see core.hsm).

Every decision is recorded in ADDB (op ``ha_decision``; see
``Addb.ha_trace``) and broadcast to ``subscribe``d listeners — the
cluster layer (repro_torch.cluster) turns device evictions into ring
evictions and query re-routing, and an HSM daemon can react to straggler
demotion reports.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.object_store import ObjectStore


@dataclass(frozen=True)
class FailureEvent:
    ts: float
    kind: str          # io_error | checksum | timeout | straggler
    device: str
    entity: str = ""
    detail: str = ""


class HAMonitor:
    def __init__(self, store: ObjectStore, *, window_s: float = 60.0,
                 error_threshold: int = 3,
                 scrub_threshold: Optional[int] = None,
                 on_repair: Optional[Callable[[str, List[str]], None]] = None):
        self.store = store
        self.window_s = window_s
        self.error_threshold = error_threshold
        self.scrub_threshold = scrub_threshold or error_threshold
        self.events: Deque[FailureEvent] = deque(maxlen=10_000)
        self.repaired: List[Tuple[str, List[str]]] = []
        self.evicted: List[str] = []
        self.scrubbed: List[str] = []
        self._lock = threading.RLock()
        self._on_repair = on_repair
        self._subscribers: List[Callable[[str, str, Dict], None]] = []
        self._digesting = False
        # the store reports read-path device errors through FDMI
        store.fdmi_register(self._fdmi_event)

    def _fdmi_event(self, event: str, oid: str, info: Dict):
        if event == "device_error":
            err = info.get("error", "")
            kind = "checksum" if "checksum" in err else "io_error"
            self.observe(FailureEvent(time.time(), kind,
                                      info.get("device", "?"), oid, err))

    # ------------------------------------------------------------------
    # notification hooks (the cluster layer and HSM subscribe here)
    # ------------------------------------------------------------------

    def subscribe(self, fn: Callable[[str, str, Dict], None]):
        """``fn(kind, subject, info)`` after every repair decision the
        monitor engages: kind is ``repair`` | ``evict`` | ``scrub`` |
        ``straggler``, subject the device (or object, for scrub) acted
        on.  This is how decisions propagate *out* of one store: the
        cluster layer evicts the node from the placement ring, HSM
        migrates hot objects off demoted stragglers."""
        with self._lock:
            if fn not in self._subscribers:
                self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[str, str, Dict], None]):
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    def _notify(self, kind: str, subject: str, info: Dict):
        with self._lock:
            subs = list(self._subscribers)
        for fn in subs:
            try:
                fn(kind, subject, info)
            except Exception:
                pass   # listeners must not break the repair path

    # ------------------------------------------------------------------

    def observe(self, ev: FailureEvent):
        with self._lock:
            self.events.append(ev)
        self._digest()

    def _recent(self, device: str) -> List[FailureEvent]:
        now = time.time()
        return [e for e in self.events
                if e.device == device and now - e.ts <= self.window_s]

    def _digest(self):
        """Quasi-ordered window digestion -> repair decision."""
        with self._lock:
            if self._digesting:
                # repair procedures read the store, which can report
                # fresh device errors re-entrantly; the outer digest
                # will see them on its next pass
                return
            self._digesting = True
        try:
            with self._lock:
                by_dev: Dict[str, int] = defaultdict(int)
                by_obj: Dict[str, int] = defaultdict(int)
                now = time.time()
                for e in self.events:
                    if now - e.ts > self.window_s:
                        continue
                    if e.kind in ("io_error", "checksum", "timeout"):
                        by_dev[e.device] += 1
                    if e.kind == "checksum" and e.entity:
                        by_obj[e.entity] += 1
                to_scrub = [o for o, n in by_obj.items()
                            if n >= self.scrub_threshold
                            and o not in self.scrubbed]
                to_repair = [d for d, n in by_dev.items()
                             if n >= self.error_threshold
                             and d not in self.evicted]
            for oid in to_scrub:
                self.engage_scrub(oid)
            for dev in to_repair:
                self.engage_repair(dev)
        finally:
            with self._lock:
                self._digesting = False

    # ------------------------------------------------------------------

    def engage_repair(self, device_name: str) -> List[str]:
        """Mark the device failed, re-protect all affected objects, evict."""
        t0 = time.time()
        dev = self._find_device(device_name)
        if dev is not None:
            dev.fail()
        affected = self.store.objects_on_device(device_name)
        repaired = []
        for oid in affected:
            try:
                if self.store.repair_object(oid, device_name):
                    repaired.append(oid)
            except (IOError, OSError, KeyError):
                continue
        with self._lock:
            self.evicted.append(device_name)
            self.repaired.append((device_name, repaired))
        self.store.addb.record_ha("repair", device_name,
                                  detail=f"objects={len(affected)}",
                                  nbytes=len(repaired),
                                  latency_s=time.time() - t0)
        self.store.addb.record_ha("evict", device_name)
        self._notify("repair", device_name, {"repaired": repaired,
                                             "affected": len(affected)})
        self._notify("evict", device_name, {"repaired": len(repaired),
                                            "affected": len(affected)})
        if self._on_repair:
            self._on_repair(device_name, repaired)
        return repaired

    def engage_scrub(self, oid: str) -> bool:
        """Integrity scrub of one object after a checksum burst:
        re-silver the replicas the events implicated, then verify the
        whole object with an internal read (no demand-access
        bookkeeping).  Returns True when the object verified clean."""
        t0 = time.time()
        with self._lock:
            devices = sorted({e.device for e in self.events
                              if e.entity == oid and e.kind == "checksum"})
        ok = True
        repaired = 0
        try:
            _, repaired = self.store.scrub_object(oid)
            self.store.read(oid, _notify=False)
        except (IOError, OSError, KeyError):
            ok = False
        with self._lock:
            self.scrubbed.append(oid)
            # consume the digested evidence: one burst = one scrub
            kept = [e for e in self.events
                    if not (e.entity == oid and e.kind == "checksum")]
            self.events = deque(kept, maxlen=self.events.maxlen)
        self.store.addb.record_ha("scrub", oid,
                                  detail=",".join(devices) or "-",
                                  nbytes=repaired,
                                  latency_s=time.time() - t0, ok=ok)
        self._notify("scrub", oid, {"devices": devices, "ok": ok,
                                    "replicas_repaired": repaired})
        return ok

    def _find_device(self, name: str):
        for pool in self.store.pools.values():
            for d in pool.devices:
                if d.name == name:
                    return d
        return None

    # ------------------------------------------------------------------

    def straggler_report(self, addb, factor: float = 5.0) -> List[str]:
        """Devices whose p99 latency exceeds `factor` x their tier model.

        Each straggler is recorded to ADDB and broadcast to subscribers
        as a demotion report — the HSM side of the contract: hot objects
        should migrate away from a consistently slow device."""
        out = []
        p99 = addb.device_latency_percentile(0.99)
        for pool in self.store.pools.values():
            for d in pool.devices:
                lat = p99.get(d.name)
                if lat is not None and lat > factor * max(d.model.latency, 1e-9):
                    out.append(d.name)
                    self.store.addb.record_ha(
                        "straggler", d.name,
                        detail=f"p99={lat:.3e}s model={d.model.latency:.3e}s",
                        latency_s=lat)
                    self._notify("straggler", d.name,
                                 {"p99_s": lat, "factor": factor,
                                  "tier": d.tier})
                    self.observe(FailureEvent(time.time(), "straggler",
                                              d.name))
        return out

"""Async prefetch engine — percipience acting ahead of demand, the
*action* stage of SAGE's loop (pre-staging predicted-next objects into
fast tiers, the paper follow-up's explicit self-optimisation goal).

On every demand read the prefetcher asks the Markov predictor for the
likely next objects and promotes them toward the fast tier via
``ObjectStore.migrate`` *before* the read arrives.  Guard rails:

  * a byte budget bounds how much speculative data may sit staged in the
    fast tier at once (released when a staged object is actually read —
    residency becomes HSM's problem from then on);
  * a bounded worker pool bounds migration concurrency (``sync=True``
    stages inline for deterministic tests/benchmarks);
  * outcomes are recorded back into ADDB (``prefetch_stage`` /
    ``prefetch_hit`` / ``prefetch_miss``) so the loop is itself observable
    telemetry.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Set

from repro_torch.core import layouts as lay
from repro_torch.core.addb import Addb
from repro_torch.core.object_store import ObjectStore
from repro_torch.core.tiers import TIER_ORDER, T1_NVRAM

from repro_torch.percipience.telemetry import FeatureExtractor


class Prefetcher:
    def __init__(self, store: ObjectStore, extractor: FeatureExtractor, *,
                 byte_budget: int = 64 << 20, max_workers: int = 2,
                 target_tier: str = T1_NVRAM, top_k: int = 3,
                 min_confidence: float = 0.1,
                 layout_kind: str = lay.MIRRORED,
                 addb: Optional[Addb] = None, sync: bool = False):
        self.store = store
        self.extractor = extractor
        self.byte_budget = byte_budget
        self.target_tier = target_tier
        self.top_k = top_k
        self.min_confidence = min_confidence
        self.layout_kind = layout_kind
        self.addb = addb or store.addb
        self.sync = sync
        self._pool = None if sync else ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="prefetch")
        self._futures: List[Future] = []
        self._staged: Dict[str, int] = {}      # oid -> bytes charged
        self._in_flight: Set[str] = set()
        self._staged_bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.staged_total = 0
        self.skipped_budget = 0

    # ------------------------------------------------------------------

    def attach(self) -> "Prefetcher":
        self.store.register_read_hook(self.on_read)
        self.store.fdmi_register(self._on_event)
        return self

    def _on_event(self, event: str, oid: str, info: Dict):
        """Release budget charges for staged objects that leave the fast
        tier without ever being read (HSM demotion, deletion) — otherwise
        dead charges ratchet up until prefetching starves."""
        if event == "delete":
            self.release(oid)
        elif event == "migrate" and info.get("tier") != self.target_tier:
            self.release(oid)

    def on_read(self, oid: str, nbytes: int):
        """Demand read observed: account the outcome, then act on the
        predicted next accesses."""
        with self._lock:
            charged = self._staged.pop(oid, None)
            if charged is not None:
                self._staged_bytes -= charged
                self.hits += 1
                hit = True
            else:
                self.misses += 1
                hit = False
        self.addb.record("prefetch_hit" if hit else "prefetch_miss",
                         oid, "-", nbytes, 0.0, ok=hit)

        for bucket, p in self.extractor.predict_next(
                oid, k=self.top_k, min_p=self.min_confidence):
            for cand in self.extractor.oids_in_bucket(bucket):
                if cand != oid:
                    self._submit(cand)

    # ------------------------------------------------------------------

    def _tier_rank(self, tier: str) -> int:
        return TIER_ORDER.index(tier)

    def _submit(self, oid: str):
        try:
            meta = self.store.meta(oid)
        except KeyError:
            return
        if (meta.attrs.get("pinned")
                or self._tier_rank(meta.layout.tier)
                <= self._tier_rank(self.target_tier)):
            return                              # already fast enough
        size = self.store.read_size(oid)
        with self._lock:
            if oid in self._staged or oid in self._in_flight:
                return
            if self._staged_bytes + size > self.byte_budget:
                self.skipped_budget += 1
                return
            self._staged_bytes += size
            self._in_flight.add(oid)
        if self.sync:
            self._stage(oid, size)
        else:
            self._futures.append(self._pool.submit(self._stage, oid, size))

    def _stage(self, oid: str, size: int):
        try:
            meta = self.store.meta(oid)
            layout = lay.Layout(self.layout_kind, self.target_tier,
                                meta.layout.width)
            self.store.migrate(oid, layout)
            with self._lock:
                self._staged[oid] = size
                self.staged_total += 1
            self.addb.record("prefetch_stage", oid, "-", size, 0.0)
        except (IOError, OSError, KeyError):
            with self._lock:
                self._staged_bytes -= size
        finally:
            with self._lock:
                self._in_flight.discard(oid)

    # ------------------------------------------------------------------

    def drain(self, timeout: Optional[float] = None):
        """Wait for queued stagings to finish (no-op in sync mode)."""
        fs, self._futures = self._futures, []
        for f in fs:
            f.result(timeout=timeout)

    def release(self, oid: str):
        """Un-charge a staged object (e.g. HSM demoted it before a hit)."""
        with self._lock:
            charged = self._staged.pop(oid, None)
            if charged is not None:
                self._staged_bytes -= charged

    @property
    def staged_bytes(self) -> int:
        with self._lock:
            return self._staged_bytes

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "staged_total": self.staged_total,
                "staged_bytes": self._staged_bytes,
                "skipped_budget": self.skipped_budget,
            }

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)

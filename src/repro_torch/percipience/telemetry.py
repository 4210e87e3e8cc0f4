"""Percipience feature extraction — the *observation* stage of SAGE's
loop, built on the ADDB telemetry the paper dedicates §3.2.2 to.

The extractor taps the three observation surfaces the store already has:

  * ``Addb.subscribe``       — per-device op telemetry (get/put records)
    feeds per-object sliding-window access histories (timestamps, sizes,
    inter-arrival gaps), the raw material for heat scoring;
  * the object-store read hook — the object-level demand-access sequence
    feeds a bucketed object→object co-access transition matrix (first-
    order Markov counts), the raw material for next-access prediction;
  * ``fdmi_register``        — create/delete/migrate events keep the
    bucket table and per-object state consistent with store mutations.

Everything is bounded: histories are deques of ``hist_len``, the
transition matrix is ``max_objects x max_objects`` with objects folded
into buckets (first-seen assignment, wrap-around reuse), so memory is
O(max_objects * hist_len) regardless of how many objects the store holds.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.addb import Addb, AddbRecord


class FeatureExtractor:
    """Sliding-window per-object access features + co-access transitions."""

    #: addb ops counted as object accesses
    ACCESS_OPS = ("get", "put")

    def __init__(self, hist_len: int = 64, max_objects: int = 256,
                 coalesce_s: float = 0.02):
        self.hist_len = hist_len
        self.max_objects = max_objects
        self.coalesce_s = coalesce_s
        # oid -> deque[(ts, nbytes)]
        self._hist: Dict[str, Deque[Tuple[float, int]]] = {}
        # bucket bookkeeping for the transition matrix
        self._bucket: Dict[str, int] = {}
        self._bucket_members: Dict[int, List[str]] = {}
        self._next_bucket = 0
        self.transitions = np.zeros((max_objects, max_objects), np.float64)
        self._prev_read: Optional[str] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------

    def attach(self, store, addb: Optional[Addb] = None) -> "FeatureExtractor":
        """Subscribe to a store's ADDB stream, read hook, and FDMI bus."""
        (addb or store.addb).subscribe(self.on_record)
        store.register_read_hook(self.on_read)
        store.fdmi_register(self.on_event)
        return self

    # ------------------------------------------------------------------
    # observation surfaces
    # ------------------------------------------------------------------

    def on_record(self, rec: AddbRecord):
        """ADDB subscriber: fold per-device op records into the per-object
        history.  Block/replica fan-out is coalesced: records for the same
        object within ``coalesce_s`` merge into one access (sizes sum)."""
        if rec.op not in self.ACCESS_OPS:
            return
        with self._lock:
            h = self._hist.get(rec.entity)
            if h is None:
                h = self._hist[rec.entity] = deque(maxlen=self.hist_len)
                self._assign_bucket(rec.entity)
            if h and rec.ts - h[-1][0] < self.coalesce_s:
                ts, nb = h[-1]
                h[-1] = (rec.ts, nb + rec.nbytes)
            else:
                h.append((rec.ts, rec.nbytes))

    def on_read(self, oid: str, nbytes: int):
        """Read-path hook: object-level access ordering -> Markov counts."""
        with self._lock:
            b = self._assign_bucket(oid)
            prev = self._prev_read
            if prev is not None and prev != oid:
                self.transitions[self._assign_bucket(prev), b] += 1.0
            self._prev_read = oid

    def on_event(self, event: str, oid: str, info: Dict):
        """FDMI bus: keep per-object state consistent with mutations."""
        if event == "delete":
            with self._lock:
                self._hist.pop(oid, None)
                if self._prev_read == oid:
                    self._prev_read = None

    # ------------------------------------------------------------------
    # bucketing
    # ------------------------------------------------------------------

    def _assign_bucket(self, oid: str) -> int:
        b = self._bucket.get(oid)
        if b is None:
            b = self._next_bucket % self.max_objects
            self._next_bucket += 1
            self._bucket[oid] = b
            self._bucket_members.setdefault(b, []).append(oid)
        return b

    def bucket_of(self, oid: str) -> int:
        with self._lock:
            return self._assign_bucket(oid)

    def oids_in_bucket(self, bucket: int) -> List[str]:
        with self._lock:
            return list(self._bucket_members.get(bucket, ()))

    # ------------------------------------------------------------------
    # feature tensors
    # ------------------------------------------------------------------

    def history_tensors(self) -> Tuple[List[str], np.ndarray, np.ndarray,
                                       np.ndarray]:
        """Dense per-object access-history tensors.

        Returns ``(oids, timestamps, sizes, mask)`` where the arrays are
        (n_objects, hist_len), right-aligned (most recent access last)
        and left-padded with mask 0.  Timestamps stay float64 — epoch
        seconds do not survive float32.
        """
        with self._lock:
            oids = sorted(self._hist)
            n, L = len(oids), self.hist_len
            ts = np.zeros((n, L), np.float64)
            sz = np.zeros((n, L), np.float64)
            mask = np.zeros((n, L), np.float64)
            for i, oid in enumerate(oids):
                h = self._hist[oid]
                k = len(h)
                if k:
                    ts[i, L - k:] = [t for t, _ in h]
                    sz[i, L - k:] = [b for _, b in h]
                    mask[i, L - k:] = 1.0
        return oids, ts, sz, mask

    def inter_arrival_gaps(self) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """(oids, gaps, mask): per-object inter-arrival gap tensors
        aligned like history_tensors (gap[i, j] = ts[j] - ts[j-1])."""
        oids, ts, _, mask = self.history_tensors()
        prev = np.concatenate([ts[:, :1], ts[:, :-1]], axis=1)
        gaps = np.clip(ts - prev, 0.0, None) * mask
        gmask = mask.copy()
        # first valid entry of each row has no predecessor
        first = np.argmax(mask, axis=1)
        gmask[np.arange(len(oids)), first] = 0.0
        gaps[np.arange(len(oids)), first] = 0.0
        return oids, gaps, gmask

    def transition_matrix(self, smooth: float = 0.0) -> np.ndarray:
        """Row-normalised co-access transition probabilities
        (max_objects x max_objects); zero rows stay zero when smooth=0."""
        with self._lock:
            counts = self.transitions + smooth
        sums = counts.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            probs = np.where(sums > 0, counts / np.where(sums > 0, sums, 1.0),
                             0.0)
        return probs

    def predict_next(self, oid: str, k: int = 3, min_p: float = 0.0
                     ) -> List[Tuple[int, float]]:
        """Top-k (bucket, probability) successors of ``oid`` — the
        single-row fast path for the read-hook prefetcher: O(max_objects)
        numpy, no full-matrix normalisation, no device round-trip.
        heat.markov_topk remains for genuinely batched callers."""
        with self._lock:
            row = self.transitions[self._assign_bucket(oid)].copy()
        total = row.sum()
        if total <= 0:
            return []
        row /= total
        order = np.argsort(row)[::-1][:k]
        return [(int(b), float(row[b])) for b in order if row[b] > min_p]

    def access_count(self, oid: str) -> int:
        with self._lock:
            h = self._hist.get(oid)
            return len(h) if h else 0

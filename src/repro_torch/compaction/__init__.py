"""Log-structured compaction + manifest snapshots (docs/compaction.md).

``CompactionService`` is the facade ``Clovis.compaction()`` /
``ClusterClovis.compaction()`` return: an append-path that publishes
immutable delta blocks behind per-container versioned manifests, a
background compactor that merges small append runs into large
RTHMS-placed blocks, and snapshot-pinned reads that stay byte-identical
while compaction rewrites the container underneath.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.compaction.compactor import (CRASH_POINTS, CompactionGroup,
                                              CompactionPolicy,
                                              CompactionReport, Compactor,
                                              CompactorCrash)
from repro_torch.compaction.manifest import (MANIFEST_CONTAINER, BlockEntry,
                                             ContainerManifest,
                                             ManifestCorruption,
                                             ManifestRegistry, RetiredBlock,
                                             Snapshot, manifest_oid)

__all__ = [
    "BlockEntry", "CompactionGroup", "CompactionPolicy", "CompactionReport",
    "CompactionService", "Compactor", "CompactorCrash", "ContainerManifest",
    "CRASH_POINTS", "MANIFEST_CONTAINER", "ManifestCorruption",
    "ManifestRegistry", "RetiredBlock", "Snapshot", "manifest_oid",
]


class CompactionService:
    """Ingest + compact + snapshot-read facade over one Clovis stack.

    ``append_rows`` is the manifest-aware write path: each call
    publishes one immutable delta block and commits a manifest version,
    so readers that pin see either all of an append or none of it —
    and caches/stats for every untouched block stay valid.
    ``auto_recover`` sweeps crash orphans out of every persisted
    manifest's container at construction (the reopen-after-crash path).
    """

    def __init__(self, clovis, *, policy: Optional[CompactionPolicy] = None,
                 catalog=None, crash_hook=None, auto_recover: bool = True):
        self.clovis = clovis
        self.registry: ManifestRegistry = clovis.manifests
        if catalog is None:
            catalog = getattr(clovis, "_stats_catalog", None)
        self.compactor = Compactor(clovis, self.registry, policy=policy,
                                   catalog=catalog, crash_hook=crash_hook)
        self._lock = threading.Lock()
        self.appends = 0
        if auto_recover:
            for container in self.registry.containers():
                self.compactor.recover(container)

    # -- write path ----------------------------------------------------

    def append_rows(self, container: str, rows) -> Snapshot:
        """Durably append one batch of rows as an immutable delta block
        and commit it to the container's manifest.  Returns the new
        snapshot.  Ordering: block first, manifest second — a crash in
        between leaves an orphan ``recover`` deletes, never a manifest
        pointing at missing data."""
        arr = np.ascontiguousarray(np.atleast_2d(np.asarray(rows)))
        if arr.ndim != 2 or not arr.shape[0]:
            raise ValueError("append_rows wants a non-empty 2-D row batch")
        manifest = self.registry.get(container)
        oid = manifest.allocate("delta")
        t0 = time.time()
        self.clovis.put_array(oid, arr, container=container)
        version = self.clovis.store.meta(oid).version
        snap = manifest.append_block(
            BlockEntry(oid, version, int(arr.shape[0]), int(arr.nbytes)))
        cat = self.compactor.catalog
        if cat is not None:
            from repro_torch.analytics.cost import summarize_rows
            cat.observe(oid, version, summarize_rows(arr))
        # direct dirty mark: cluster writes don't traverse a single
        # store's FDMI bus, and the FDMI tracker dedups with this
        self.compactor.tracker.mark(container, arr.nbytes)
        with self._lock:
            self.appends += 1
        self.clovis.addb.record_compaction(
            "append", container, oid, nbytes=arr.nbytes,
            latency_s=time.time() - t0)
        return snap

    # -- read path -----------------------------------------------------

    def manifest(self, container: str) -> ContainerManifest:
        return self.registry.get(container)

    def pin(self, container: str) -> Snapshot:
        return self.registry.get(container).pin()

    def unpin(self, snap: Snapshot):
        self.registry.get(snap.container).unpin(snap)

    def read_rows(self, container: str,
                  snapshot: Optional[Snapshot] = None,
                  columns: Optional[List[int]] = None) -> np.ndarray:
        """The container's logical rows in manifest order — from a
        pinned snapshot (stable while compaction runs) or the current
        version.  ``columns`` prunes the scan to the named column
        indices (ranged reads on colblock partitions — only those
        columns' blocks are fetched; row-major deltas slice after a
        full read).  Empty manifests read as a (0, 0) array."""
        snap = snapshot or self.registry.get(container).snapshot()
        if columns is not None:
            parts = [self.clovis.read_columns(e.oid, columns).stack(columns)
                     if hasattr(self.clovis, "read_columns")
                     else self.clovis.materialize(e.oid)[:, columns]
                     for e in snap.entries]
            if not parts:
                return np.zeros((0, len(columns)))
        else:
            parts = [self.clovis.materialize(e.oid) for e in snap.entries]
            if not parts:
                return np.zeros((0, 0))
        return np.vstack(parts)

    # -- compaction ----------------------------------------------------

    def compact(self, container: Optional[str] = None
                ) -> Dict[str, CompactionReport]:
        if container is not None:
            return {container: self.compactor.compact_container(container)}
        return self.compactor.run_once()

    def gc(self, container: Optional[str] = None) -> List[str]:
        containers = ([container] if container is not None
                      else self.registry.cached())
        out: List[str] = []
        for c in containers:
            out.extend(self.registry.get(c).gc(self.compactor._delete))
        return out

    def recover(self, container: str) -> int:
        return self.compactor.recover(container)

    def start(self, interval_s: float = 0.25):
        """Run the compactor in the background until ``stop``."""
        self.compactor.start(interval_s)

    def stop(self):
        self.compactor.stop()

    def close(self):
        self.compactor.close()

    @property
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"appends": self.appends,
                    "containers": len(self.registry.cached())}

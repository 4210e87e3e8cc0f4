"""Background compactor — merges small append runs into large
tier-appropriate blocks behind manifest snapshots.

Append-heavy ingestion (continuous queries, edge pipelines) publishes
many small delta blocks; every one adds a partition to each query, and
at production scale the container drowns in fragments.  The compactor
keeps reorganisation off the query path (the Bell/Gray/Szalay rule):

  1. ``AppendTracker`` (``core/fdmi.py``) accumulates per-container
     write pressure off the store's FDMI event bus;
  2. ``select_groups`` packs compatible small blocks (same dtype/row
     width, manifest order preserved) into ``CompactionGroup``s;
  3. each group's rows are merged into one new block, placed on the
     tier RTHMS ``recommend_tier`` picks for its merged size, and
     published with a single manifest ``replace`` commit;
  4. blocks the commit retired are deleted once no pinned snapshot can
     reach them (``ContainerManifest.gc``).

Crash ordering is write-new-then-flip: the merged block is durable
before the manifest commits, and the old blocks outlive the commit
until GC.  A crash at any point leaves the previous manifest version
fully readable; ``recover`` deletes the orphan blocks a crash between
block write and commit leaves behind.

``crash_hook(point)`` is called at every ordering point (see
``CRASH_POINTS``) — the chaos gauntlet raises ``CompactorCrash`` from
it to kill the compactor mid-merge deterministically.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.compaction.manifest import (BlockEntry, ContainerManifest,
                                             Snapshot)
from repro_torch.core import layouts as lay
from repro_torch.core.hsm import recommend_tier

# cooperative crash points, in execution order
CRASH_POINTS = ("before_merge_write", "after_merge_write",
                "before_commit", "after_commit")


class CompactorCrash(RuntimeError):
    """Raised by a test crash hook: the compactor process died here."""


@dataclass(frozen=True)
class CompactionPolicy:
    """When and how much to merge."""
    small_bytes: int = 64 << 10     # blocks at or below this are fragments
    min_group: int = 3              # never merge fewer than this
    max_group: int = 64             # bound one merge's working set
    target_bytes: int = 8 << 20     # stop growing a group near this
    read_fraction: float = 0.9      # merged blocks are read-mostly (RTHMS)
    columnar: bool = True           # merged blocks get the colblock layout


@dataclass(frozen=True)
class CompactionGroup:
    """One planned merge: a run of compatible small blocks."""
    container: str
    entries: Tuple[BlockEntry, ...]

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self.entries)

    @property
    def rows(self) -> int:
        return sum(e.rows for e in self.entries)


@dataclass
class CompactionReport:
    """What one ``compact_container`` pass did."""
    container: str
    groups: int = 0
    blocks_in: int = 0
    blocks_out: int = 0
    rows: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    gc_deleted: int = 0
    manifest_version: int = 0
    tiers: List[str] = field(default_factory=list)


class Compactor:
    """Merges small append runs behind manifest commits.

    ``clovis`` is a Clovis or ClusterClovis facade; ``registry`` the
    shared ManifestRegistry (``clovis.manifests``).  ``crash_hook`` is
    called with each CRASH_POINTS name as the merge passes it.
    """

    def __init__(self, clovis, registry, *,
                 policy: Optional[CompactionPolicy] = None,
                 addb=None, catalog=None,
                 crash_hook: Optional[Callable[[str], None]] = None):
        from repro_torch.core.fdmi import AppendTracker
        self.clovis = clovis
        self.registry = registry
        self.policy = policy or CompactionPolicy()
        self.addb = addb if addb is not None else clovis.addb
        self.catalog = catalog
        self.crash_hook = crash_hook
        self.tracker = AppendTracker(store=clovis.store)
        clovis.store.fdmi_register(self.tracker)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def close(self):
        self.stop()
        self.clovis.store.fdmi_unregister(self.tracker)

    def _crash(self, point: str):
        if self.crash_hook is not None:
            self.crash_hook(point)

    # -- planning ------------------------------------------------------

    def _signature(self, entry: BlockEntry):
        """Merge compatibility: dtype + row width from object attrs
        (None = unmergeable: meta missing or not a row array)."""
        try:
            attrs = self.clovis.store.meta(entry.oid).attrs
        except KeyError:
            return None
        if attrs.get("kind") not in ("array", "colblock"):
            return None
        shape = attrs.get("shape") or []
        if len(shape) != 2:
            return None
        return (attrs.get("dtype"), int(shape[1]))

    def select_groups(self, snap: Snapshot) -> List[CompactionGroup]:
        """Pack manifest-order runs of compatible small blocks into
        groups.  Order is preserved within and across groups, so the
        merged container reads back in the same logical order."""
        pol = self.policy
        groups: List[CompactionGroup] = []
        run: List[BlockEntry] = []
        run_sig, run_bytes = None, 0

        def flush():
            nonlocal run, run_sig, run_bytes
            if len(run) >= pol.min_group:
                groups.append(CompactionGroup(snap.container, tuple(run)))
            run, run_sig, run_bytes = [], None, 0

        for e in snap.entries:
            sig = self._signature(e) if e.nbytes <= pol.small_bytes else None
            if sig is None:
                flush()
                continue
            if run and (sig != run_sig or len(run) >= pol.max_group
                        or run_bytes + e.nbytes > pol.target_bytes):
                flush()
            run.append(e)
            run_sig, run_bytes = sig, run_bytes + e.nbytes
        flush()
        return groups

    # -- merging -------------------------------------------------------

    def _merge_group(self, manifest: ContainerManifest,
                     group: CompactionGroup, report: CompactionReport):
        t0 = time.time()
        parts = [self.clovis.materialize(e.oid, _notify=False)
                 for e in group.entries]
        merged = np.ascontiguousarray(np.vstack(parts))
        store = self.clovis.store
        tier = recommend_tier(store, size_bytes=merged.nbytes,
                              read_fraction=self.policy.read_fraction,
                              random_access=False)
        oid = manifest.allocate("blk")
        # merged blocks are the read-mostly bulk of a container: lay
        # them out columnar (when the facade supports it) so scans can
        # fetch just the columns a query touches with ranged reads
        columnar = (self.policy.columnar
                    and hasattr(self.clovis, "put_columnar"))
        self._crash("before_merge_write")
        if columnar:
            self.clovis.put_columnar(oid, merged, container=group.container,
                                     layout=lay.Layout(lay.STRIPED, tier, 2))
        else:
            self.clovis.put_array(oid, merged, container=group.container,
                                  layout=lay.Layout(lay.STRIPED, tier, 2))
        self._crash("after_merge_write")     # block durable, manifest old
        entry = BlockEntry(oid, store.meta(oid).version,
                           int(merged.shape[0]), int(merged.nbytes),
                           gen=max(e.gen for e in group.entries) + 1)
        self._crash("before_commit")
        snap = manifest.replace([e.oid for e in group.entries], entry)
        self._crash("after_commit")          # committed, old blocks pending GC
        if self.catalog is not None:
            from repro_torch.analytics.cost import summarize_rows
            self.catalog.observe(oid, entry.version, summarize_rows(merged))
        report.groups += 1
        report.blocks_in += len(group.entries)
        report.blocks_out += 1
        report.rows += entry.rows
        report.bytes_in += group.nbytes
        report.bytes_out += entry.nbytes
        report.manifest_version = snap.version
        report.tiers.append(tier)
        self.addb.record_compaction("merge", group.container, oid,
                                    nbytes=merged.nbytes,
                                    latency_s=time.time() - t0)

    def _delete(self, oid: str):
        try:
            if self.clovis.exists(oid):
                self.clovis.delete(oid)
        except KeyError:
            pass

    def compact_container(self, container: str) -> CompactionReport:
        """One full pass: GC what earlier commits left pending, merge
        every selectable group, GC again."""
        manifest = self.registry.get(container)
        report = CompactionReport(container,
                                  manifest_version=manifest.version)
        report.gc_deleted += len(manifest.gc(self._delete))
        for group in self.select_groups(manifest.snapshot()):
            self._merge_group(manifest, group, report)
        deleted = manifest.gc(self._delete)
        report.gc_deleted += len(deleted)
        if deleted:
            self.addb.record_compaction("gc", container,
                                        detail=str(len(deleted)))
        return report

    def run_once(self) -> Dict[str, CompactionReport]:
        """Compact every manifest-managed container the FDMI tracker
        saw writes for since the last pass (plus any with pending GC)."""
        containers = set(self.tracker.drain())
        containers.update(self.registry.cached())    # pending GC sweeps
        out: Dict[str, CompactionReport] = {}
        for c in sorted(containers):
            if self.registry.lookup(c) is None:
                continue                     # writes to an unmanaged container
            out[c] = self.compact_container(c)
        return out

    # -- crash recovery ------------------------------------------------

    def recover(self, container: str) -> int:
        """Delete crash orphans: subsystem-named blocks present in the
        container but unknown to the manifest (a crash between the
        merged-block write and the manifest commit strands exactly
        these).  Returns how many were deleted."""
        manifest = self.registry.get(container)
        known = manifest.known_oids()
        prefix = f"{container}/"
        n = 0
        for oid in list(self.clovis.container(container)):
            tail = oid[len(prefix):] if oid.startswith(prefix) else ""
            if not (tail.startswith("delta-") or tail.startswith("blk-")):
                continue                     # not ours: never touch it
            if oid in known:
                continue
            self._delete(oid)
            n += 1
        if n:
            self.addb.record_compaction("recover", container, detail=str(n))
        return n

    # -- background loop -----------------------------------------------

    def start(self, interval_s: float = 0.25):
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.run_once()
                except CompactorCrash:
                    return                   # the chaos kill: thread dies
                except Exception:
                    pass                     # background pass must not wedge

        self._stop.clear()
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="sage-compactor")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

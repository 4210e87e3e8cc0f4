"""Container manifests — versioned snapshot identity for log-structured
containers (ROADMAP: compaction + manifest snapshots).

A *manifest* is the authoritative, versioned list of the blocks that
make up one container's logical content.  Every mutation — an appended
delta block, a compaction that replaces a run of small blocks with one
merged block — commits a new manifest version; the block list at any
version is immutable.  That gives the stack three things the raw
container listing cannot provide:

  * **snapshot pinning** — a reader pins the current version and sees a
    stable, immutable block set while appends and compactions commit
    new versions underneath (the analytics executor pins per query);
  * **crash atomicity** — compaction writes its merged block *first*
    and flips the manifest *last*; a crash in between leaves an orphan
    block and an untouched manifest, so reopened containers serve
    byte-identical results from the old version (``Compactor.recover``
    deletes the orphans);
  * **precise invalidation** — blocks are immutable once published, so
    version-keyed partial caches and the StatsCatalog stay valid for
    every block an append or compaction did not touch.

Persistence format (docs/compaction.md): the manifest is itself a Clovis
object (``manifest/<container>`` in the ``manifests`` container), one
JSONL line per committed version::

    <crc32 of body, 8 hex chars> <body JSON>\n
    body = {"v": version, "seq": allocation counter,
            "entries": [[oid, object_version, rows, nbytes, gen], ...],
            "retired": [[oid, retired_at], ...]}

Each line fully describes that version (the history window is bounded);
the newest valid line is the live state.  Commits rewrite the object
through ``clovis.put`` — one store write, atomic at the store's version
flip, and K-way replicated for free under ``ClusterClovis``.  A torn
final line (a crash mid-copy of the underlying device file) is
truncated on load like the EdgeBuffer's torn tail; damage before the
tail raises ``ManifestCorruption``.

GC contract: a block retired at manifest version ``r`` is visible to
snapshots of versions ``< r`` only.  ``gc()`` returns the retired
blocks whose ``retired_at`` is <= every pinned version (no pinned
reader can still reach them); the compactor deletes those objects and
the manifest forgets them.  Time-travel reads (``snapshot_at``) are
valid as long as the blocks they reference have not been GC'd.
"""
from __future__ import annotations

import json
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

MANIFEST_CONTAINER = "manifests"


def manifest_oid(container: str) -> str:
    return f"manifest/{container}"


class ManifestCorruption(RuntimeError):
    """A non-tail manifest line failed its checksum — damage a crashed
    commit cannot explain."""


@dataclass(frozen=True)
class BlockEntry:
    """One immutable block of a container's logical content."""
    oid: str
    version: int          # object-store version the block was published at
    rows: int
    nbytes: int
    gen: int = 0          # merge generation: 0 = raw append delta

    def to_list(self) -> List:
        return [self.oid, self.version, self.rows, self.nbytes, self.gen]

    @staticmethod
    def from_list(v: Sequence) -> "BlockEntry":
        return BlockEntry(str(v[0]), int(v[1]), int(v[2]), int(v[3]),
                          int(v[4]))


@dataclass(frozen=True)
class RetiredBlock:
    """A block removed from the manifest at version ``retired_at`` —
    still on disk until every pin that can see it is released."""
    oid: str
    retired_at: int


@dataclass(frozen=True)
class Snapshot:
    """An immutable view of one container at one manifest version."""
    container: str
    version: int
    entries: Tuple[BlockEntry, ...]

    @property
    def oids(self) -> List[str]:
        return [e.oid for e in self.entries]

    @property
    def rows(self) -> int:
        return sum(e.rows for e in self.entries)

    @property
    def nbytes(self) -> int:
        return sum(e.nbytes for e in self.entries)


class ContainerManifest:
    """The versioned block list of one container.

    Thread-safety: one lock guards all state; ``commit`` persists the
    new line *before* mutating memory, so a failed persist leaves the
    manifest at the old version (and a crashed process reopens to
    whatever line last hit the store).
    """

    def __init__(self, clovis, container: str, *, history: int = 64):
        self.clovis = clovis
        self.container = container
        self.oid = manifest_oid(container)
        self.history = max(history, 1)
        self._lock = threading.RLock()
        self._lines: "OrderedDict[int, Tuple[BlockEntry, ...]]" = \
            OrderedDict()
        self._retired: List[RetiredBlock] = []
        self._pins: Dict[int, int] = {}          # version -> refcount
        self._version = 0
        self._seq = 0
        self.torn_tail_recovered = 0
        if clovis.exists(self.oid):
            self._load()

    # -- persistence ---------------------------------------------------

    def _load(self):
        raw = self.clovis.get(self.oid, _notify=False)
        lines = raw.decode().splitlines()
        for i, line in enumerate(lines):
            rec = self._parse_line(line)
            if rec is None:
                if i == len(lines) - 1:          # torn tail: drop it
                    self.torn_tail_recovered += 1
                    break
                raise ManifestCorruption(
                    f"{self.oid}: corrupt manifest line {i} "
                    "(not a recoverable torn tail)")
            entries = tuple(BlockEntry.from_list(e) for e in rec["entries"])
            self._lines[int(rec["v"])] = entries
            self._version = int(rec["v"])
            self._seq = int(rec["seq"])
            self._retired = [RetiredBlock(str(o), int(r))
                             for o, r in rec["retired"]]

    @staticmethod
    def _parse_line(line: str) -> Optional[Dict]:
        if len(line) < 10 or line[8] != " ":
            return None
        crc, body = line[:8], line[9:]
        if f"{zlib.crc32(body.encode()):08x}" != crc:
            return None
        try:
            return json.loads(body)
        except ValueError:
            return None

    def _encode_line(self, version: int,
                     entries: Tuple[BlockEntry, ...],
                     retired: List[RetiredBlock], seq: int) -> str:
        body = json.dumps(
            {"v": version, "seq": seq,
             "entries": [e.to_list() for e in entries],
             "retired": [[r.oid, r.retired_at] for r in retired]},
            sort_keys=True)
        return f"{zlib.crc32(body.encode()):08x} {body}\n"

    def _persist(self, lines: "OrderedDict[int, Tuple[BlockEntry, ...]]",
                 retired: List[RetiredBlock], seq: int):
        # every line re-encodes the *final* retired list + seq: only the
        # newest valid line is live state, older lines serve snapshot_at
        out = "".join(
            self._encode_line(v, ents, retired, seq)
            for v, ents in lines.items())
        data = out.encode()
        if hasattr(self.clovis, "create"):       # single-node Clovis
            if not self.clovis.exists(self.oid):
                self.clovis.create(self.oid, block_size=1 << 16,
                                   container=MANIFEST_CONTAINER,
                                   attrs={"kind": "manifest"})
            self.clovis.put(self.oid, data)
        else:                                    # ClusterClovis: replicated
            self.clovis.put(self.oid, data, container=MANIFEST_CONTAINER)
        emit = getattr(self.clovis.store, "fdmi_emit", None)
        if emit is not None:
            emit("manifest_commit", self.oid,
                 {"container": self.container,
                  "version": next(reversed(lines)) if lines else 0})

    # -- naming --------------------------------------------------------

    def allocate(self, prefix: str) -> str:
        """A fresh block oid (``<container>/<prefix>-<seq>``).  The
        counter is persisted at the next commit; a crash in between may
        reuse a number, which is safe: the orphan it collides with is
        either overwritten by the new ``put_array`` or deleted first by
        ``Compactor.recover``."""
        with self._lock:
            self._seq += 1
            return f"{self.container}/{prefix}-{self._seq:08d}"

    # -- commits -------------------------------------------------------

    def commit(self, entries: Sequence[BlockEntry],
               retire: Sequence[str] = ()) -> Snapshot:
        """Atomically publish a new version whose block list is
        ``entries``; ``retire`` names the block oids dropped relative to
        the previous version (they stay on disk until ``gc``)."""
        with self._lock:
            version = self._version + 1
            ents = tuple(entries)
            lines = OrderedDict(self._lines)
            lines[version] = ents
            while len(lines) > self.history:
                lines.popitem(last=False)
            retired = self._retired + [RetiredBlock(o, version)
                                       for o in retire]
            self._persist(lines, retired, self._seq)   # durable first
            self._lines = lines
            self._retired = retired
            self._version = version
            return Snapshot(self.container, version, ents)

    def append_block(self, entry: BlockEntry) -> Snapshot:
        with self._lock:
            return self.commit(self._lines.get(self._version, ()) + (entry,))

    def replace(self, old_oids: Sequence[str],
                new_entry: BlockEntry) -> Snapshot:
        """Compaction commit: swap a group of blocks for their merged
        block, preserving manifest order (the merged block takes the
        group's first position)."""
        old = set(old_oids)
        with self._lock:
            cur = self._lines.get(self._version, ())
            out: List[BlockEntry] = []
            placed = False
            for e in cur:
                if e.oid in old:
                    if not placed:
                        out.append(new_entry)
                        placed = True
                    continue
                out.append(e)
            if not placed:
                out.append(new_entry)
            return self.commit(out, retire=[e.oid for e in cur
                                            if e.oid in old])

    # -- views ---------------------------------------------------------

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def versions(self) -> List[int]:
        with self._lock:
            return list(self._lines)

    def snapshot(self) -> Snapshot:
        with self._lock:
            return Snapshot(self.container, self._version,
                            self._lines.get(self._version, ()))

    def snapshot_at(self, version: int) -> Snapshot:
        with self._lock:
            if version == 0:
                return Snapshot(self.container, 0, ())
            if version not in self._lines:
                raise KeyError(
                    f"{self.container}: manifest version {version} not in "
                    f"history {list(self._lines)}")
            return Snapshot(self.container, version, self._lines[version])

    def known_oids(self) -> set:
        """Every block oid the manifest can account for — history
        entries plus not-yet-GC'd retired blocks.  Anything else in the
        container matching the subsystem's naming is a crash orphan."""
        with self._lock:
            out = {e.oid for ents in self._lines.values() for e in ents}
            out.update(r.oid for r in self._retired)
            return out

    # -- pinning + GC --------------------------------------------------

    def pin(self) -> Snapshot:
        """Pin the current version: its blocks survive GC until the
        matching ``unpin``.  Returns the pinned snapshot."""
        with self._lock:
            snap = self.snapshot()
            self._pins[snap.version] = self._pins.get(snap.version, 0) + 1
            return snap

    def unpin(self, snap: Snapshot):
        with self._lock:
            n = self._pins.get(snap.version, 0) - 1
            if n <= 0:
                self._pins.pop(snap.version, None)
            else:
                self._pins[snap.version] = n

    def pinned_versions(self) -> List[int]:
        with self._lock:
            return sorted(self._pins)

    def gc(self, delete=None) -> List[str]:
        """Drop retired blocks no pinned reader can still reach: a
        block retired at version ``r`` is visible to pins of versions
        < r, so it is deletable once ``min(pinned) >= r`` (or nothing
        is pinned).  ``delete(oid)`` removes each object *before* the
        manifest forgets it — a crash in between re-runs as an
        idempotent delete, never a leak.  Returns the deleted oids."""
        with self._lock:
            floor = min(self._pins) if self._pins else self._version
            dead = [r.oid for r in self._retired if r.retired_at <= floor]
            if not dead:
                return []
            if delete is not None:
                for oid in dead:
                    delete(oid)
            self._retired = [r for r in self._retired
                             if r.retired_at > floor]
            self._persist(self._lines, self._retired, self._seq)
            return dead


class ManifestRegistry:
    """Per-facade cache of ContainerManifests (``clovis.manifests``).

    ``get`` creates the manifest (managing the container from then on);
    ``lookup`` returns None for unmanaged containers, which is how the
    analytics executor decides whether a query can pin a snapshot —
    containers written with plain ``put_array`` behave exactly as
    before this subsystem existed.
    """

    def __init__(self, clovis, *, history: int = 64):
        self.clovis = clovis
        self.history = history
        self._lock = threading.Lock()
        self._manifests: Dict[str, ContainerManifest] = {}

    def get(self, container: str) -> ContainerManifest:
        with self._lock:
            m = self._manifests.get(container)
            if m is None:
                m = ContainerManifest(self.clovis, container,
                                      history=self.history)
                self._manifests[container] = m
            return m

    def lookup(self, container: str) -> Optional[ContainerManifest]:
        """The manifest if ``container`` is manifest-managed (cached or
        persisted), else None."""
        with self._lock:
            m = self._manifests.get(container)
        if m is not None:
            return m
        if self.clovis.exists(manifest_oid(container)):
            return self.get(container)
        return None

    def cached(self) -> List[str]:
        with self._lock:
            return sorted(self._manifests)

    def containers(self) -> List[str]:
        """Every persisted manifest's container (cached or not)."""
        pref = "manifest/"
        out = {o[len(pref):] for o in
               self.clovis.container(MANIFEST_CONTAINER)
               if o.startswith(pref)}
        out.update(self.cached())
        return sorted(out)

"""FDMI plugins (paper §3.2.2) — third-party data-management extensions.

The extension interface is the ObjectStore's mutation event bus
(``fdmi_register``).  Shipped plugins mirror the paper's examples:
integrity checking, data compression (accounting), and data indexing.
"""
from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional

from repro_torch.core.clovis import Clovis


class AppendTracker:
    """Compaction-trigger plugin: accumulates per-container write
    pressure off the store's FDMI event bus.

    Registered by the ``Compactor`` (``clovis.store.fdmi_register``);
    every ``write`` event is attributed to its owning container (store
    metadata first, ``<container>/...`` oid prefix as the fallback) and
    ``drain()`` hands the dirty set to the next compaction pass.  The
    compaction service also ``mark``s directly on its own append path —
    cluster writes fan out node-locally and never traverse one store's
    bus, so the direct mark is the trigger that always fires.
    """

    def __init__(self, store=None):
        self.store = store
        self._lock = threading.Lock()
        self._dirty: Dict[str, Dict[str, int]] = {}

    def __call__(self, event: str, oid: str, info: Dict):
        if event != "write":
            return
        container = info.get("container")
        if container is None and self.store is not None:
            try:
                container = self.store.meta(oid).container
            except KeyError:
                container = None
        if container is None and "/" in oid:
            container = oid.split("/", 1)[0]
        if container:
            self.mark(container, append=bool(info.get("append")))

    def mark(self, container: str, nbytes: int = 0, append: bool = True):
        with self._lock:
            d = self._dirty.setdefault(container,
                                       {"writes": 0, "appends": 0,
                                        "bytes": 0})
            d["writes"] += 1
            d["appends"] += 1 if append else 0
            d["bytes"] += int(nbytes)

    def drain(self) -> Dict[str, Dict[str, int]]:
        """Dirty containers since the last drain (and reset)."""
        with self._lock:
            out, self._dirty = self._dirty, {}
            return out

    def peek(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {c: dict(d) for c, d in self._dirty.items()}


class IntegrityPlugin:
    """File-system-integrity-checker analogue: scrubs objects on demand
    and records checksum violations observed on the event bus."""

    def __init__(self, clovis: Clovis):
        self.clovis = clovis
        self.violations: List[str] = []
        clovis.fdmi_register(self._on_event)

    def _on_event(self, event: str, oid: str, info: Dict):
        if event == "device_error" and "checksum" in info.get("error", ""):
            self.violations.append(oid)

    def scrub(self, container: str = "default") -> List[str]:
        bad = []
        for oid in self.clovis.container(container):
            meta = self.clovis.store.meta(oid)
            try:
                data = self.clovis.store.read(oid)
            except IOError:
                bad.append(oid)
                continue
            bs = meta.block_size
            for idx, crc in meta.checksums.items():
                blk = data[idx * bs: (idx + 1) * bs]
                if zlib.crc32(blk) != crc:
                    bad.append(oid)
                    break
        return bad


class CompressionPlugin:
    """Transparent compression accounting on writes (zlib probe): records
    the achievable ratio per object so HSM/archival policies can use it."""

    def __init__(self, clovis: Clovis, level: int = 1):
        self.clovis = clovis
        self.level = level
        self.ratios: Dict[str, float] = {}
        clovis.fdmi_register(self._on_event)

    def _on_event(self, event: str, oid: str, info: Dict):
        if event != "write":
            return
        try:
            data = self.clovis.get(oid)
        except (IOError, KeyError):
            return
        if not data:
            return
        comp = zlib.compress(data[: 1 << 20], self.level)
        self.ratios[oid] = len(data[: 1 << 20]) / max(len(comp), 1)


class IndexingPlugin:
    """Data-indexing plugin: maintains a Clovis index mapping containers
    to their objects with size/kind attrs (metadata catalogue)."""

    def __init__(self, clovis: Clovis, index_name: str = "catalogue"):
        self.clovis = clovis
        self.index = clovis.index(index_name)
        clovis.fdmi_register(self._on_event)

    def _on_event(self, event: str, oid: str, info: Dict):
        if event in ("create", "write", "migrate"):
            try:
                meta = self.clovis.store.meta(oid)
            except KeyError:
                return
            key = f"{meta.container}/{oid}".encode()
            val = (f"kind={meta.attrs.get('kind', 'blob')};"
                   f"size={meta.attrs.get('size', meta.nblocks * meta.block_size)};"
                   f"tier={meta.layout.tier}").encode()
            self.index.put({key: val}, persist=False)
        elif event == "delete":
            pref = oid.encode()
            keys = [k for k in self.index._keys if k.endswith(pref)]
            if keys:
                self.index.delete(keys, persist=False)

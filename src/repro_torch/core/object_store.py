"""Mero-analogue object store (paper §3.2.1).

Objects are arrays of power-of-two-sized blocks, read/written at block
granularity.  Each object has a *layout* (striped / mirrored / parity on a
tier), belongs to a *container*, carries per-block CRC32 checksums
(integrity checking), and is versioned: transactional writes land in the
next version and become visible on commit (see core.transactions).

The store emits FDMI events for every mutation and ADDB telemetry for
every device op; the HA engine and HSM daemon plug into those.
"""
from __future__ import annotations

import json
import threading
import time
import zlib
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.core import layouts as lay
from repro_torch.core.addb import Addb, GLOBAL_ADDB
from repro_torch.core.tiers import TierDevice, TierPool
from repro_torch.core.transactions import (Transaction, TransactionManager,
                                     WriteAheadLog)


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclass
class ObjectMeta:
    oid: str
    block_size: int
    layout: lay.Layout
    container: str = "default"
    version: int = 0
    nblocks: int = 0
    checksums: Dict[int, int] = field(default_factory=dict)   # block -> crc32
    created: float = field(default_factory=time.time)
    last_access: float = field(default_factory=time.time)
    access_count: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        d = asdict(self)
        d["layout"] = {"kind": self.layout.kind, "tier": self.layout.tier,
                       "width": self.layout.width}
        d["checksums"] = {str(k): v for k, v in self.checksums.items()}
        return json.dumps(d)

    @staticmethod
    def from_json(s: str) -> "ObjectMeta":
        d = json.loads(s)
        d["layout"] = lay.Layout(**d["layout"])
        d["checksums"] = {int(k): v for k, v in d["checksums"].items()}
        return ObjectMeta(**d)


class ObjectStore:
    def __init__(self, root: Path, pools: Dict[str, TierPool],
                 addb: Optional[Addb] = None):
        self.root = Path(root)
        self.meta_dir = self.root / "meta"
        self.meta_dir.mkdir(parents=True, exist_ok=True)
        self.pools = pools
        self.addb = addb or GLOBAL_ADDB
        self.txn_mgr = TransactionManager(WriteAheadLog(self.root / "wal.log"))
        self._meta: Dict[str, ObjectMeta] = {}
        self._containers: Dict[str, Dict[str, Any]] = {"default": {}}
        self._fdmi: List[Callable[[str, str, Dict], None]] = []
        self._read_hooks: List[Callable[[str, int], None]] = []
        self._write_hooks: List[Callable[[str, int], None]] = []
        self._lock = threading.RLock()
        self._load_meta()
        self.recover()

    # ------------------------------------------------------------------
    # metadata persistence
    # ------------------------------------------------------------------

    def _meta_path(self, oid: str) -> Path:
        return self.meta_dir / (oid.replace("/", "__") + ".json")

    def _persist_meta(self, meta: ObjectMeta):
        self._meta_path(meta.oid).write_text(meta.to_json())

    def _load_meta(self):
        for p in self.meta_dir.glob("*.json"):
            try:
                meta = ObjectMeta.from_json(p.read_text())
                self._meta[meta.oid] = meta
                self._containers.setdefault(meta.container, {})[meta.oid] = True
            except (json.JSONDecodeError, KeyError, TypeError):
                continue

    # ------------------------------------------------------------------
    # FDMI plugin bus
    # ------------------------------------------------------------------

    def fdmi_register(self, fn: Callable[[str, str, Dict], None]):
        """fn(event, oid, info) on create/write/commit/delete/migrate."""
        self._fdmi.append(fn)

    def fdmi_unregister(self, fn: Callable[[str, str, Dict], None]):
        if fn in self._fdmi:
            self._fdmi.remove(fn)

    def _emit(self, event: str, oid: str, info: Optional[Dict] = None):
        for fn in list(self._fdmi):
            try:
                fn(event, oid, info or {})
            except Exception:
                pass   # plugins must not break the store

    def fdmi_emit(self, event: str, oid: str, info: Optional[Dict] = None):
        """Publish an event from a subsystem layered above the store
        (the compaction manifest announces ``manifest_commit`` here) —
        the FDMI bus carries store *and* store-adjacent mutations."""
        self._emit(event, oid, info)

    def register_read_hook(self, fn: Callable[[str, int], None]):
        """fn(oid, nbytes) after every demand read — the percipience
        prefetcher and feature extractor observe the access stream here.
        Internal reads (migration, repair) do not fire hooks."""
        self._read_hooks.append(fn)

    def _notify_read(self, oid: str, nbytes: int):
        for fn in list(self._read_hooks):
            try:
                fn(oid, nbytes)
            except Exception:
                pass   # observers must not break the read path

    def register_write_hook(self, fn: Callable[[str, int], None]):
        """fn(oid, nbytes) after every committed write/append — the
        analytics StatsCatalog invalidates per-partition selectivity
        statistics here (a new version means old stats are stale).
        Migration does not fire the hook: it moves bytes, not content."""
        self._write_hooks.append(fn)

    def unregister_write_hook(self, fn: Callable[[str, int], None]):
        if fn in self._write_hooks:
            self._write_hooks.remove(fn)

    def _notify_write(self, oid: str, nbytes: int):
        for fn in list(self._write_hooks):
            try:
                fn(oid, nbytes)
            except Exception:
                pass   # observers must not break the write path

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def _devices(self, layout: lay.Layout) -> List[TierDevice]:
        """All devices of the tier, in stable order: placement must not
        shift when a device fails (reads skip failed replicas; HA repair
        re-creates them on substitutes)."""
        pool = self.pools[layout.tier]
        if not pool.devices:
            raise IOError(f"tier {layout.tier} has no devices")
        return pool.devices

    def _block_key(self, oid: str, version: int, idx: int,
                   replica: int = 0, parity: bool = False) -> str:
        kind = "p" if parity else "b"
        return f"{oid.replace('/', '__')}/v{version}/{kind}{idx}.r{replica}"

    def _placements(self, meta: ObjectMeta, idx: int, version: int
                    ) -> List[Tuple[TierDevice, str]]:
        """(device, key) pairs holding block idx (all replicas)."""
        devs = self._devices(meta.layout)
        out = []
        for r, di in enumerate(meta.layout.replicas_for(idx, len(devs))):
            out.append((devs[di], self._block_key(meta.oid, version, idx, r)))
        return out

    # ------------------------------------------------------------------
    # object lifecycle
    # ------------------------------------------------------------------

    def create_object(self, oid: str, block_size: int = 1 << 20,
                      layout: Optional[lay.Layout] = None,
                      container: str = "default",
                      attrs: Optional[Dict] = None) -> ObjectMeta:
        if not _is_pow2(block_size):
            raise ValueError("block size must be a power of two")
        layout = layout or lay.DEFAULT_LAYOUTS["data"]
        with self._lock:
            if oid in self._meta:
                raise KeyError(f"object {oid} exists")
            meta = ObjectMeta(oid, block_size, layout, container,
                              attrs=attrs or {})
            self._meta[oid] = meta
            self._containers.setdefault(container, {})[oid] = True
            self._persist_meta(meta)
        self._emit("create", oid, {"container": container})
        return meta

    def exists(self, oid: str) -> bool:
        return oid in self._meta

    def meta(self, oid: str) -> ObjectMeta:
        return self._meta[oid]

    def list_container(self, container: str) -> List[str]:
        return sorted(self._containers.get(container, {}))

    def containers(self) -> List[str]:
        return sorted(self._containers)

    # ------------------------------------------------------------------
    # block I/O
    # ------------------------------------------------------------------

    def write(self, oid: str, data: bytes, start_block: int = 0,
              txn: Optional[Transaction] = None):
        """Write data at block granularity.

        Outside a transaction the write commits immediately (version bump).
        Inside one, blocks land in the next version; visibility flips on
        commit.
        """
        meta = self._meta[oid]
        bs = meta.block_size
        nblocks = -(-len(data) // bs)
        version = meta.version + 1
        t0 = time.time()

        new_checksums: Dict[int, int] = {}
        for i in range(nblocks):
            idx = start_block + i
            blk = data[i * bs: (i + 1) * bs]
            new_checksums[idx] = zlib.crc32(blk)
            wrote = 0
            last_err: Optional[Exception] = None
            for dev, key in self._placements(meta, idx, version):
                try:
                    dev.write_block(key, blk)
                    wrote += 1
                    self.addb.record("put", oid, dev.name, len(blk),
                                     time.time() - t0)
                except (IOError, OSError) as e:   # degraded write
                    last_err = e
                    self._emit("device_error", oid,
                               {"device": dev.name, "block": idx,
                                "error": str(e)})
            if wrote == 0:
                # substitute write: place the block on any healthy device
                # (read path scans healthy devices for replica keys)
                pool = self.pools[meta.layout.tier]
                key0 = self._block_key(meta.oid, version, idx, 0)
                for j, dev in enumerate(pool.healthy):
                    try:
                        pool.healthy[(idx + j) % len(pool.healthy)].write_block(
                            key0, blk)
                        wrote += 1
                        break
                    except (IOError, OSError) as e:
                        last_err = e
                if wrote == 0:
                    raise IOError(f"no replica written for {oid}[{idx}]: "
                                  f"{last_err}")
        if meta.layout.kind == lay.PARITY:
            self._write_parity(meta, version, start_block, nblocks, data)

        def commit():
            with self._lock:
                # carry forward untouched blocks from the previous version
                for idx in range(meta.nblocks):
                    if start_block <= idx < start_block + nblocks:
                        continue
                    blk = self._read_block(meta, idx, meta.version)
                    for dev, key in self._placements(meta, idx, version):
                        dev.write_block(key, blk)
                old_version = meta.version
                meta.version = version
                meta.nblocks = max(meta.nblocks, start_block + nblocks)
                meta.checksums.update(new_checksums)
                meta.last_access = time.time()
                self._persist_meta(meta)
                self._gc_version(meta, old_version)
            self._emit("write", oid, {"blocks": nblocks, "version": version})
            self._notify_write(oid, len(data))

        if txn is None:
            commit()
        else:
            txn._on_commit = _chain(txn._on_commit, commit)
            txn._on_abort = _chain(
                txn._on_abort, lambda: self._gc_version(meta, version))

    def _parity_width(self, meta: ObjectMeta) -> int:
        """Effective parity group width: the parity unit must land on a
        device outside the group, so cap at n_devices - 1."""
        n = len(self._devices(meta.layout))
        return max(1, min(meta.layout.width, n - 1))

    def _write_parity(self, meta: ObjectMeta, version: int, start: int,
                      nblocks: int, data: bytes):
        # parity layouts are written whole-object (checkpoint/archive use),
        # so groups always start at block 0
        bs = meta.block_size
        devs = self._devices(meta.layout)
        w = self._parity_width(meta)
        for g0 in range(0, nblocks, w):
            group = [data[(g0 + j) * bs: (g0 + j + 1) * bs]
                     for j in range(min(w, nblocks - g0))]
            parity = lay.xor_parity(group)
            gidx = (start + g0) // w
            # data blocks of group g sit on devices (g*w+j) % n, j<w;
            # (g*w + w) % n is guaranteed outside the group (w < n)
            pdev = devs[(gidx * w + w) % len(devs)]
            pdev.write_block(self._block_key(meta.oid, version, gidx,
                                             parity=True), parity)

    def _read_block(self, meta: ObjectMeta, idx: int, version: int,
                    record: bool = True) -> bytes:
        last_err: Optional[Exception] = None
        for dev, key in self._placements(meta, idx, version):
            try:
                t0 = time.time()
                blk = dev.read_block(key)
                if record:
                    self.addb.record("get", meta.oid, dev.name, len(blk),
                                     time.time() - t0)
                if idx in meta.checksums and zlib.crc32(blk) != meta.checksums[idx]:
                    raise IOError(f"checksum mismatch {meta.oid}[{idx}]")
                return blk
            except (IOError, OSError) as e:
                last_err = e
                self._emit("device_error", meta.oid,
                           {"device": dev.name, "block": idx,
                            "error": str(e)})
                continue
        # substitute scan: HA repair may have re-created a replica on any
        # healthy device under the same key
        pool = self.pools[meta.layout.tier]
        n_rep = len(meta.layout.replicas_for(idx, len(pool.devices)))
        for dev in pool.healthy:
            for r in range(n_rep):
                key = self._block_key(meta.oid, version, idx, r)
                if dev.has_block(key):
                    try:
                        blk = dev.read_block(key)
                        if (idx in meta.checksums and
                                zlib.crc32(blk) != meta.checksums[idx]):
                            continue
                        return blk
                    except (IOError, OSError):
                        continue
        if meta.layout.kind == lay.PARITY:
            blk = self._parity_rebuild_block(meta, idx, version)
            if blk is not None:
                return blk
        raise IOError(f"unreadable block {meta.oid}[{idx}]: {last_err}")

    def _parity_rebuild_block(self, meta: ObjectMeta, idx: int,
                              version: int) -> Optional[bytes]:
        devs = self._devices(meta.layout)
        w = self._parity_width(meta)
        gidx = idx // w
        g0 = gidx * w
        try:
            pdev = devs[(gidx * w + w) % len(devs)]
            parity = pdev.read_block(
                self._block_key(meta.oid, version, gidx, parity=True))
            siblings: Dict[int, bytes] = {}
            sizes: Dict[int, int] = {}
            for j in range(w):
                bidx = g0 + j
                if bidx >= meta.nblocks:
                    continue
                sizes[bidx] = meta.block_size
                if bidx == idx:
                    continue
                for dev, key in self._placements(meta, bidx, version):
                    try:
                        siblings[bidx] = dev.read_block(key)
                        break
                    except (IOError, OSError):
                        continue
            return lay.reconstruct_from_parity(siblings, parity, idx,
                                               w, sizes)
        except (IOError, OSError):
            return None

    def append(self, oid: str, data: bytes):
        """Block-aligned append fast path (stream ingest): new blocks land
        at the object's current version with no version bump and no
        carry-forward copy — O(appended bytes), not O(object size)."""
        meta = self._meta[oid]
        bs = meta.block_size
        start = meta.nblocks
        nblocks = -(-len(data) // bs)
        t0 = time.time()
        version = max(meta.version, 1)
        for i in range(nblocks):
            idx = start + i
            blk = data[i * bs: (i + 1) * bs]
            meta.checksums[idx] = zlib.crc32(blk)
            wrote = 0
            for dev, key in self._placements(meta, idx, version):
                try:
                    dev.write_block(key, blk)
                    wrote += 1
                    self.addb.record("put", oid, dev.name, len(blk),
                                     time.time() - t0)
                except (IOError, OSError):
                    continue
            if wrote == 0:
                raise IOError(f"append failed for {oid}[{idx}]")
        with self._lock:
            meta.version = version
            meta.nblocks = start + nblocks
            meta.attrs["size"] = meta.attrs.get("size", start * bs) + len(data)
            meta.last_access = time.time()
            self._persist_meta(meta)
        self._emit("write", oid, {"blocks": nblocks, "version": version,
                                  "append": True})
        self._notify_write(oid, len(data))

    def read(self, oid: str, start_block: int = 0,
             nblocks: Optional[int] = None, _notify: bool = True) -> bytes:
        """Read blocks.  ``_notify=False`` marks an internal read
        (migration): no read hooks, no ADDB records, no access-count /
        last-access bookkeeping — internal traffic must not register as
        demand access or it feeds back into percipience heat scoring.
        """
        meta = self._meta[oid]
        if nblocks is None:
            nblocks = meta.nblocks - start_block
        last_err: Optional[IOError] = None
        for _attempt in range(2):
            # one retry: a concurrent migration may bump meta.version
            # mid-read; the second pass sees the settled version
            try:
                out = bytearray()
                for i in range(start_block, start_block + nblocks):
                    out += self._read_block(meta, i, meta.version,
                                            record=_notify)
                break
            except IOError as e:
                last_err = e
        else:
            raise last_err
        if _notify:
            with self._lock:
                meta.last_access = time.time()
                meta.access_count += 1
            self._notify_read(oid, len(out))
        return bytes(out)

    def read_size(self, oid: str) -> int:
        meta = self._meta[oid]
        return int(meta.attrs.get("size", meta.nblocks * meta.block_size))

    def delete_object(self, oid: str):
        with self._lock:
            meta = self._meta.pop(oid)
            self._containers.get(meta.container, {}).pop(oid, None)
            self._gc_version(meta, meta.version)
            p = self._meta_path(oid)
            if p.exists():
                p.unlink()
        self._emit("delete", oid)

    def _gc_version(self, meta: ObjectMeta, version: int):
        if version <= 0:
            return
        for pool in self.pools.values():
            for dev in pool.devices:
                if dev.failed:
                    continue
                prefix = f"{meta.oid.replace('/', '__')}/v{version}/"
                for key in dev.list_blocks():
                    if key.startswith(prefix):
                        try:
                            dev.delete_block(key)
                        except (IOError, OSError):
                            pass

    # ------------------------------------------------------------------
    # transactions / recovery
    # ------------------------------------------------------------------

    def transaction(self, entities: List[str]) -> Transaction:
        return Transaction(self.txn_mgr, entities)

    def recover(self) -> int:
        """Garbage-collect orphaned next-version blocks of crashed txns."""
        n = 0
        for txn in self.txn_mgr.incomplete():
            for oid in txn.entities:
                meta = self._meta.get(oid)
                if meta is not None:
                    self._gc_version(meta, meta.version + 1)
                    n += 1
        return n

    # ------------------------------------------------------------------
    # migration (HSM backend) and repair (HA backend)
    # ------------------------------------------------------------------

    def migrate(self, oid: str, new_layout: lay.Layout):
        """Move an object to a different tier/layout (HSM)."""
        meta = self._meta[oid]
        data = self.read(oid, _notify=False)   # internal read, not a demand access
        old_layout, old_version = meta.layout, meta.version
        with self._lock:
            meta.layout = new_layout
            meta.version += 1
            meta.checksums.clear()
        version = meta.version
        bs = meta.block_size
        for idx in range(meta.nblocks):
            blk = data[idx * bs: (idx + 1) * bs]
            meta.checksums[idx] = zlib.crc32(blk)
            for dev, key in self._placements(meta, idx, version):
                dev.write_block(key, blk)
        if new_layout.kind == lay.PARITY:
            self._write_parity(meta, version, 0, meta.nblocks, data)
        with self._lock:
            self._persist_meta(meta)
            # GC old placement
            meta_old = ObjectMeta(meta.oid, bs, old_layout)
            self._gc_version(meta_old, old_version)
        self._emit("migrate", oid, {"tier": new_layout.tier})

    def scrub_object(self, oid: str) -> Tuple[int, int]:
        """Integrity scrub (HA backend): verify every replica of every
        block against the recorded checksum and rewrite corrupt or
        missing replicas from an intact copy (falling back to the
        substitute-scan / parity-rebuild read path when no placement
        replica is clean).  Internal reads — no demand-access
        bookkeeping.  Returns ``(blocks_checked, replicas_repaired)``."""
        meta = self._meta[oid]
        repaired = 0
        for idx in range(meta.nblocks):
            want = meta.checksums.get(idx)
            good: Optional[bytes] = None
            bad: List[Tuple[TierDevice, str]] = []
            for dev, key in self._placements(meta, idx, meta.version):
                if dev.failed:
                    continue
                try:
                    if not dev.has_block(key):
                        bad.append((dev, key))
                        continue
                    blk = dev.read_block(key)
                except (IOError, OSError):
                    bad.append((dev, key))
                    continue
                if want is not None and zlib.crc32(blk) != want:
                    bad.append((dev, key))
                    continue
                if good is None:
                    good = blk
            if good is None:
                try:
                    good = self._read_block(meta, idx, meta.version,
                                            record=False)
                except IOError:
                    continue            # unrecoverable block: leave as-is
            for dev, key in bad:
                try:
                    dev.write_block(key, good)
                    repaired += 1
                except (IOError, OSError):
                    continue
        if repaired:
            self._emit("repair", oid, {"scrub": True, "replicas": repaired})
        return meta.nblocks, repaired

    def repair_object(self, oid: str, failed_device: str) -> bool:
        """Re-silver replicas / rebuild parity after a device failure."""
        meta = self._meta[oid]
        pool = self.pools[meta.layout.tier]
        healthy = pool.healthy
        if not healthy:
            return False
        repaired = False
        for idx in range(meta.nblocks):
            placements = self._placements(meta, idx, meta.version)
            missing = []
            for r, (dev, key) in enumerate(placements):
                if dev.failed or not dev.has_block(key):
                    # replica lost unless some healthy device carries it
                    if not any(h.has_block(key) for h in healthy):
                        missing.append((r, key))
            if not missing:
                continue
            try:
                blk = self._read_block(meta, idx, meta.version)
            except IOError:
                continue
            for j, (r, key) in enumerate(missing):
                # prefer a device not already holding a replica of this block
                all_keys = [k for _, k in placements]
                candidates = sorted(
                    healthy,
                    key=lambda d: sum(d.has_block(k) for k in all_keys))
                wrote_rep = False
                for target in candidates:
                    try:
                        target.write_block(key, blk)
                        repaired = wrote_rep = True
                        break
                    except (IOError, OSError):
                        continue
                if not wrote_rep:
                    continue
        if repaired:
            self._emit("repair", oid, {"device": failed_device})
        return repaired

    def objects_on_device(self, device_name: str) -> List[str]:
        out = []
        for oid, meta in self._meta.items():
            try:
                devs = self._devices(meta.layout)
            except IOError:
                devs = self.pools[meta.layout.tier].devices
            names = {d.name for d in self.pools[meta.layout.tier].devices}
            if device_name in names:
                out.append(oid)
        return out


def _chain(f: Optional[Callable[[], None]], g: Callable[[], None]):
    if f is None:
        return g

    def h():
        f()
        g()
    return h

"""Clovis — the transactional access API on top of the object store
(paper §3.2.2).

Access interface:  object create/read/write/delete at block granularity,
containers and layouts, transactional write groups.
Index interface:   KV indices with GET / PUT / DEL / NEXT (records are
key-value pairs, keys unique within an index, NEXT iterates in key order).
Management interface:  ADDB telemetry access and the FDMI extension bus
(HSM, integrity checking, compression plug in through it).

Arrays: ``put_array`` / ``get_array`` serialise numpy arrays into
objects with dtype/shape attrs — the bridge the checkpoint layer and the
data pipeline use.  The on-disk format is the reference package's byte
for byte, so this port opens a store root ``repro`` wrote
(``open_reference_store`` checks that it reads the same arrays).

The stack carries a ``device`` (``cuda`` unless the caller asks for the
CPU); the analytics engines it builds and the percipience loop
(``enable_percipience``) run their kernels there.  Manifests, compaction
and serving wait for later slices of the port: without them the engine
behaves as on an unmanaged store.
"""
from __future__ import annotations

import bisect
import io
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import layouts as lay
from repro_torch.core.addb import Addb
from repro_torch.core.object_store import ObjectStore
from repro_torch.core.tiers import TierPool, make_tier_pools
from repro_torch.core.transactions import Transaction
from repro_torch.device import DeviceLike, resolve_device


class ClovisIndex:
    """A Clovis index: ordered KV store with GET/PUT/DEL/NEXT.

    Persisted as an append-only log object in the store (replayed on open),
    so indices survive restart and inherit the object layer's layout-based
    fault tolerance.
    """

    def __init__(self, store: ObjectStore, name: str,
                 layout: Optional[lay.Layout] = None):
        self.store = store
        self.name = name
        self.oid = f"idx/{name}"
        self._kv: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []
        self._log = io.BytesIO()
        self._lock = threading.RLock()
        if store.exists(self.oid):
            self._replay(store.read(self.oid))
        else:
            store.create_object(self.oid, block_size=1 << 16,
                                layout=layout or lay.DEFAULT_LAYOUTS["telemetry"],
                                container="indices",
                                attrs={"kind": "index"})

    # -- log format: [klen u32][k][vlen i32 (-1=del)][v] --

    def _replay(self, data: bytes):
        size = self.store.read_size(self.oid)
        data = data[:size]
        off = 0
        while off + 8 <= len(data):
            klen = int.from_bytes(data[off: off + 4], "little")
            off += 4
            k = data[off: off + klen]
            off += klen
            vlen = int.from_bytes(data[off: off + 4], "little", signed=True)
            off += 4
            if vlen < 0:
                self._kv.pop(k, None)
            else:
                self._kv[k] = data[off: off + vlen]
                off += max(vlen, 0)
        self._keys = sorted(self._kv)
        self._log = io.BytesIO(data)
        self._log.seek(0, io.SEEK_END)

    def _append_log(self, k: bytes, v: Optional[bytes]):
        self._log.write(len(k).to_bytes(4, "little"))
        self._log.write(k)
        if v is None:
            self._log.write((-1).to_bytes(4, "little", signed=True))
        else:
            self._log.write(len(v).to_bytes(4, "little", signed=True))
            self._log.write(v)

    def _persist(self):
        raw = self._log.getvalue()
        self.store.write(self.oid, raw)
        self.store.meta(self.oid).attrs["size"] = len(raw)

    # -- Clovis index ops (batched, like the paper's GET/PUT/DEL/NEXT) --

    def put(self, records: Dict[bytes, bytes], persist: bool = True):
        with self._lock:
            for k, v in records.items():
                if k not in self._kv:
                    bisect.insort(self._keys, k)
                self._kv[k] = v
                self._append_log(k, v)
            if persist:
                self._persist()

    def get(self, keys: Sequence[bytes]) -> List[Optional[bytes]]:
        with self._lock:
            return [self._kv.get(k) for k in keys]

    def delete(self, keys: Sequence[bytes], persist: bool = True):
        with self._lock:
            for k in keys:
                if k in self._kv:
                    del self._kv[k]
                    i = bisect.bisect_left(self._keys, k)
                    if i < len(self._keys) and self._keys[i] == k:
                        self._keys.pop(i)
                    self._append_log(k, None)
            if persist:
                self._persist()

    def next(self, keys: Sequence[bytes]) -> List[Optional[Tuple[bytes, bytes]]]:
        """For each key, the first record with key strictly greater."""
        out: List[Optional[Tuple[bytes, bytes]]] = []
        with self._lock:
            for k in keys:
                i = bisect.bisect_right(self._keys, k)
                if i < len(self._keys):
                    nk = self._keys[i]
                    out.append((nk, self._kv[nk]))
                else:
                    out.append(None)
        return out

    def __len__(self) -> int:
        return len(self._kv)


class Clovis:
    """Access + management interface facade."""

    def __init__(self, root: Path, pools: Optional[Dict[str, TierPool]] = None,
                 addb: Optional[Addb] = None, devices_per_tier: int = 2,
                 throttle: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        root = Path(root)
        self.pools = pools or make_tier_pools(root / "tiers",
                                              devices_per_tier,
                                              throttle=throttle)
        self.store = ObjectStore(root / "store", self.pools, addb)
        self.addb = self.store.addb
        self._indices: Dict[str, ClovisIndex] = {}
        self.percipience = None   # set by enable_percipience
        self._stats_catalog = None   # shared by analytics() engines
        self._lock = threading.RLock()

    # ---- access interface: objects ----

    def create(self, oid: str, block_size: int = 1 << 20,
               layout: Optional[lay.Layout] = None,
               container: str = "default", attrs: Optional[Dict] = None):
        return self.store.create_object(oid, block_size, layout, container,
                                        attrs)

    def put(self, oid: str, data: bytes, txn: Optional[Transaction] = None):
        self.store.meta(oid).attrs["size"] = len(data)
        self.store.write(oid, data, txn=txn)

    def get(self, oid: str, _notify: bool = True) -> bytes:
        data = self.store.read(oid, _notify=_notify)
        return data[: self.store.read_size(oid)]

    def delete(self, oid: str):
        self.store.delete_object(oid)

    def exists(self, oid: str) -> bool:
        return self.store.exists(oid)

    def transaction(self, entities: List[str]) -> Transaction:
        return self.store.transaction(entities)

    def container(self, name: str) -> List[str]:
        return self.store.list_container(name)

    # ---- access interface: arrays (checkpoint / data-pipeline bridge) ----

    def put_array(self, oid: str, arr, container: str = "default",
                  layout: Optional[lay.Layout] = None,
                  txn: Optional[Transaction] = None):
        arr = np.asarray(arr)
        raw = arr.tobytes()
        if not self.exists(oid):
            self.create(oid, block_size=1 << 20, layout=layout,
                        container=container,
                        attrs={"dtype": _dtype_name(arr.dtype),
                               "shape": list(arr.shape), "kind": "array"})
        meta = self.store.meta(oid)
        meta.attrs.update({"dtype": _dtype_name(arr.dtype),
                           "shape": list(arr.shape), "size": len(raw)})
        self.store.write(oid, raw, txn=txn)

    def append_array(self, oid: str, arr):
        """Row-append to an existing array object through the store's
        block-aligned append fast path, keeping the dtype/shape attrs
        coherent (a raw ``store.append`` grows ``size`` but not
        ``shape``, which would break ``get_array``).  The appended rows
        must match the object's dtype and trailing dimensions."""
        arr = np.ascontiguousarray(np.asarray(arr))
        meta = self.store.meta(oid)
        if meta.attrs.get("kind") != "array":
            raise ValueError(f"{oid}: append_array needs an array object")
        if _dtype_name(arr.dtype) != meta.attrs["dtype"]:
            raise ValueError(
                f"{oid}: dtype {arr.dtype} != stored {meta.attrs['dtype']}")
        shape = list(meta.attrs["shape"])
        if list(arr.shape[1:]) != shape[1:]:
            raise ValueError(
                f"{oid}: trailing dims {list(arr.shape[1:])} != "
                f"stored {shape[1:]}")
        # mutate attrs before the store op (the ``put`` idiom): append
        # persists meta only after the blocks land, so a crash mid-way
        # reopens to the old shape and the old size together
        shape[0] += arr.shape[0]
        meta.attrs["shape"] = shape
        self.store.append(oid, arr.tobytes())

    def get_array(self, oid: str, _notify: bool = True) -> np.ndarray:
        meta = self.store.meta(oid)
        raw = self.get(oid, _notify=_notify)
        dtype = _dtype_from_name(meta.attrs["dtype"])
        return np.frombuffer(raw, dtype=dtype).reshape(meta.attrs["shape"])

    # ---- access interface: columnar blocks (core/columnar.py) ----

    def put_columnar(self, oid: str, data, container: str = "default",
                     layout: Optional[lay.Layout] = None,
                     block_size: Optional[int] = None,
                     txn: Optional[Transaction] = None):
        """Store a 2-D row array (or list of 1-D columns) in the
        columnar block layout: each column a contiguous typed run on a
        block boundary, so ``read_columns`` fetches just the columns a
        scan needs with ranged block reads."""
        from repro_torch.core import columnar as colb
        bs = block_size or colb.DEFAULT_COL_BLOCK
        payload, attrs = colb.encode_columns(data, bs)
        if not self.exists(oid):
            self.create(oid, block_size=bs, layout=layout,
                        container=container, attrs=attrs)
        meta = self.store.meta(oid)
        if meta.block_size != bs:
            raise ValueError(f"{oid}: existing block_size "
                             f"{meta.block_size} != colblock {bs}")
        meta.attrs.update(attrs)
        self.store.write(oid, payload, txn=txn)

    def read_columns(self, oid: str, cols: Optional[Sequence[int]] = None,
                     _notify: bool = True) -> "ColumnBatch":
        """Pruned columnar read: only the selected columns' blocks are
        fetched for ``kind == 'colblock'`` objects (ranged reads).  Row-
        major array objects materialize whole and slice — same result,
        no I/O saving — so callers need not care how the partition is
        laid out."""
        from repro_torch.core import columnar as colb
        attrs = self.store.meta(oid).attrs
        if attrs.get("kind") == colb.COLBLOCK_KIND:
            rows, ncols = attrs["shape"]
            sel = list(range(ncols)) if cols is None else list(cols)
            out = {c: colb.read_column(self.store, oid, c, attrs,
                                       _notify=_notify) for c in sel}
            return colb.ColumnBatch(out, rows, ncols)
        arr = self.materialize(oid, _notify=_notify)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
        sel = list(range(arr.shape[1])) if cols is None else list(cols)
        return colb.ColumnBatch({c: np.ascontiguousarray(arr[:, c])
                                 for c in sel}, arr.shape[0], arr.shape[1])

    def materialize(self, oid: str, _notify: bool = True) -> np.ndarray:
        """Object payload as a numpy array: typed (``get_array``) for
        ``kind == 'array'`` objects, column-reassembled rows for
        ``kind == 'colblock'``, raw uint8 otherwise — the single
        materialization rule shared by function shipping (storage-side)
        and the analytics fetch-all path (caller-side), so the two can
        never diverge.  ``_notify=False`` marks an internal read (stats
        analysis): no read hooks, no heat/access bookkeeping."""
        kind = self.store.meta(oid).attrs.get("kind")
        if kind == "array":
            return self.get_array(oid, _notify=_notify)
        if kind == "colblock":
            return self.read_columns(oid, _notify=_notify).to_rows()
        return np.frombuffer(self.get(oid, _notify=_notify), dtype=np.uint8)

    # ---- index interface ----

    def index(self, name: str) -> ClovisIndex:
        with self._lock:
            if name not in self._indices:
                self._indices[name] = ClovisIndex(self.store, name)
            return self._indices[name]

    # ---- management interface ----

    def fdmi_register(self, fn):
        self.store.fdmi_register(fn)

    def addb_report(self) -> Dict:
        return self.addb.throughput_report()

    def migrate(self, oid: str, layout: lay.Layout):
        self.store.migrate(oid, layout)

    def enable_percipience(self, **kw):
        """Wire the percipience loop (feature extraction, prefetch,
        learned placement) onto this stack, heat scoring on its
        ``device``; see repro_torch.percipience.attach_percipience for
        knobs.  Returns (extractor, prefetcher, policy); the tuple is
        kept on ``self.percipience`` so downstream layers (analytics
        scheduling, HSM eviction) can consult heat without
        re-plumbing."""
        from repro_torch.percipience import attach_percipience
        self.percipience = attach_percipience(self, **kw)
        return self.percipience

    def analytics(self, *, engine_cls=None, **kw) -> "AnalyticsEngine":
        """Entry point to the percipient analytics engine — declarative
        pushdown dataflow queries over containers and streams (see
        repro_torch.analytics and docs/analytics.md), with kernels on
        this stack's device.  All
        engines created through this facade share one StatsCatalog, so
        selectivity statistics harvested by one query benefit every
        later one (pass ``stats=`` to override).  ``engine_cls`` swaps in
        an AnalyticsEngine subclass."""
        from repro_torch.analytics import AnalyticsEngine, StatsCatalog
        if "stats" not in kw:
            with self._lock:
                if self._stats_catalog is None:
                    self._stats_catalog = StatsCatalog().attach(self.store)
            kw["stats"] = self._stats_catalog
        cls = engine_cls or AnalyticsEngine
        return cls(self, **kw)


def _dtype_name(dt) -> str:
    try:
        import ml_dtypes
        if dt == np.dtype(ml_dtypes.bfloat16):
            return "bfloat16"
    except (ImportError, TypeError):
        pass
    return np.dtype(dt).name


def _dtype_from_name(name: str):
    if name == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def open_reference_store(root: Path,
                         expected: Optional[Dict[str, np.ndarray]] = None,
                         **kw) -> Clovis:
    """Open a store root the reference package wrote and check that this
    port reads it as written.

    Every array and colblock object is materialized; its bytes must fill
    exactly the dtype and shape its attrs record, and a colblock's
    per-column dtypes, offsets and pruned column reads must agree with
    its whole-row read.  ``expected`` maps oids to the numpy arrays the
    writer stored: each must read back with the same dtype, shape and
    bytes.  Raises ValueError on the first disagreement; keywords pass
    to ``Clovis`` (``devices_per_tier`` must match the writer's)."""
    from repro_torch.core import columnar as colb
    cl = Clovis(root, **kw)
    store = cl.store
    oids = [o for c in store.containers() for o in store.list_container(c)]
    for oid in sorted(set(oids) | set(expected or {})):
        if not store.exists(oid):
            raise ValueError(f"{oid}: missing from the store")
        attrs = store.meta(oid).attrs
        kind = attrs.get("kind")
        if kind not in ("array", colb.COLBLOCK_KIND):
            continue
        arr = cl.materialize(oid, _notify=False)
        shape = tuple(attrs["shape"])
        if arr.shape != shape:
            raise ValueError(f"{oid}: read shape {arr.shape} != {shape}")
        if kind == "array":
            want = _dtype_from_name(attrs["dtype"])
            if arr.dtype != want or arr.nbytes != attrs["size"]:
                raise ValueError(f"{oid}: read {arr.dtype} x {arr.nbytes} B,"
                                 f" attrs say {want} x {attrs['size']} B")
        else:
            nblocks = store.meta(oid).nblocks
            if any(start < 0 or start + n > nblocks
                   for start, n in attrs["colblocks"]):
                raise ValueError(f"{oid}: colblocks outside the object")
            batch = cl.read_columns(oid, _notify=False)
            for c, name in enumerate(attrs["coldtypes"]):
                col = batch.col(c)
                if col.dtype != np.dtype(name) or not np.array_equal(
                        col, arr[:, c]) or col.shape != (shape[0],):
                    raise ValueError(f"{oid}: column {c} disagrees with "
                                     f"its attrs or the row read")
        if expected is not None and oid in expected:
            ref = np.asarray(expected[oid])
            if (arr.dtype != ref.dtype or arr.shape != ref.shape
                    or arr.tobytes() != ref.tobytes()):
                raise ValueError(f"{oid}: read {arr.dtype}{arr.shape} "
                                 f"differs from the written "
                                 f"{ref.dtype}{ref.shape}")
    return cl

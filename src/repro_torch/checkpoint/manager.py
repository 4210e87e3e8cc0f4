"""Checkpoint/restart over the SAGE stack — the HACC-IO use case (paper §4.1)
as a first-class training feature.

Three strategies, benchmarked against each other in
benchmarks/bench_checkpoint.py (paper Fig. 5):

  * ``collective`` — synchronous blocking write of every shard through
    Clovis (the MPI-I/O baseline the paper compares against).
  * ``window``     — shards land in storage windows (mmap on the NVRAM
    tier) and are sealed into the object store; write path is load/store +
    msync, the paper's MPI-storage-windows checkpointing.
  * ``stream``     — shards are pushed into a StreamContext; consumer
    workers drain them to Clovis in the background while training
    continues (paper §4.2's decoupled I/O, 1 consumer : N producers).

Every strategy commits through a Clovis *transaction* spanning all shards
plus the manifest: a crash mid-checkpoint leaves the previous checkpoint
intact (crash-consistency test in tests/test_checkpoint.py).

The port's copy of ``repro.checkpoint.manager``.  Object ids
(``ckpt/<step>/h<host>/<leaf>``), leaf bytes, window files and manifest
JSON are the reference's, so either package restores a checkpoint the
other wrote.  What differs:

  * the state is a tree of tensors (or numpy arrays): dicts, lists,
    tuples and NamedTuples, flattened by ``repro_torch.tree`` into the
    names and order ``jax.tree_util`` gives the reference's trees;
  * ``save`` first copies every leaf into host memory the manager owns
    (one device-to-host copy of a CUDA tensor, a clone of a CPU one).
    The reference's arrays are immutable; the port's optimizer updates
    in place, and a CPU tensor's ``numpy()`` shares its memory, so
    without the copy the next step would rewrite a checkpoint that a
    non-blocking stream save is still writing;
  * ``restore(like=)`` takes a tree of tensors, of
    ``torch.empty(..., device="meta")`` or of arrays for the structure
    and returns tensors on ``device`` (default: the Clovis stack's).
    Arrays are saved whole, so a later sharded run can re-shard them.

On a mesh (the reference's mesh-elastic restore, ``:20-25``): a
``DTensor`` leaf is gathered whole (``full_tensor()``, a collective that
every rank of the mesh enters: ``gather_state``), and only the rank that
owns the Clovis store writes, so the bytes on disk are those of a
one-device run.  ``restore(..., mesh=, specs=)`` places what it read on
any mesh by the specs, scattering from the reading rank, while the
other ranks call ``CheckpointManager.receive`` for their shards.  A
checkpoint saved on a 2 x 2 mesh restores on one device, on 4 x 1, and
in the reference.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import layouts as lay
from repro_torch.core.clovis import Clovis
from repro_torch.core.storage_window import WindowAllocator
from repro_torch.core.streams import StreamContext
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import flatten_with_names, leaves, tree_map, unflatten

CKPT_CONTAINER = "checkpoints"


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf that nothing else writes to (a
    ``DTensor`` leaf is gathered whole first: a collective)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).to("cpu", copy=True).numpy().view(
                ml_dtypes.bfloat16)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A restored leaf as a tensor (via a writable host copy: the store
    hands out read-only buffers)."""
    arr = np.array(arr)
    if _dt_name(arr.dtype) == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def gather_state(tree):
    """The tree with every leaf gathered whole into host memory, leaf by
    leaf; on a mesh every rank must call it (``full_tensor`` is a
    collective), and the rank that owns the store then saves the
    result."""
    return unflatten(tree, [_host(leaf) for leaf in leaves(tree)])


def _flatten(tree) -> List[Tuple[str, np.ndarray]]:
    """[(leaf name, host copy)] in the reference's order."""
    return [(name, _host(leaf)) for name, leaf in flatten_with_names(tree)]


@dataclass
class CheckpointInfo:
    step: int
    n_leaves: int
    bytes: int
    seconds: float
    strategy: str


class CheckpointManager:
    def __init__(self, clovis: Clovis, *, strategy: str = "stream",
                 host: int = 0, n_stream_producers: int = 8,
                 consumer_ratio: int = 15, keep: int = 2,
                 layout: Optional[lay.Layout] = None):
        assert strategy in ("collective", "window", "stream")
        self.clovis = clovis
        self.strategy = strategy
        self.host = host
        self.keep = keep
        self.layout = layout or lay.Layout(lay.MIRRORED, "t1_nvram", 2)
        self.windows = WindowAllocator(clovis)
        self.history: List[CheckpointInfo] = []
        self._stream: Optional[StreamContext] = None
        self._stream_err: List[str] = []
        self._n_producers = n_stream_producers
        self._consumer_ratio = consumer_ratio
        self._pending_txns: Dict[int, Any] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------

    def _oid(self, step: int, leaf: str) -> str:
        return f"ckpt/{step}/h{self.host}/{leaf}"

    def _manifest_oid(self, step: int) -> str:
        return f"ckpt/{step}/manifest"

    def _write_leaf(self, oid: str, arr: np.ndarray, txn=None):
        self.clovis.put_array(oid, arr, container=CKPT_CONTAINER,
                              layout=self.layout, txn=txn)
        self.clovis.store.meta(oid).attrs["pinned"] = True

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------

    def save(self, step: int, state, *, block: bool = True) -> CheckpointInfo:
        """Write ``state`` (a tree of tensors or arrays) as checkpoint
        ``step``.  Every leaf is copied to the host before this returns,
        so the caller may update ``state`` in place at once, even while a
        ``block=False`` stream save is still writing."""
        t0 = time.time()
        leaves = _flatten(state)
        total = 0
        if self.strategy == "collective":
            total = self._save_collective(step, leaves)
        elif self.strategy == "window":
            total = self._save_window(step, leaves)
        else:
            total = self._save_stream(step, leaves, block=block)
        info = CheckpointInfo(step, len(leaves), total, time.time() - t0,
                              self.strategy)
        self.history.append(info)
        self._retire_old()
        return info

    def _manifest(self, step: int, leaves, window_paths=None) -> bytes:
        entries = {}
        for name, leaf in leaves:
            arr = np.asarray(leaf)
            entries[name] = {"shape": list(arr.shape),
                             "dtype": _dt_name(arr.dtype)}
            if window_paths and name in window_paths:
                entries[name]["window"] = window_paths[name]
        return json.dumps({"step": step, "host": self.host,
                           "leaves": entries, "strategy": self.strategy,
                           "ts": time.time()}).encode()

    def _commit_manifest(self, step: int, leaves, txn, window_paths=None):
        moid = self._manifest_oid(step)
        if not self.clovis.exists(moid):
            self.clovis.create(moid, block_size=1 << 16,
                               container=CKPT_CONTAINER, layout=self.layout,
                               attrs={"kind": "manifest"})
        self.clovis.put(moid, self._manifest(step, leaves, window_paths),
                        txn=txn)
        self.clovis.store.meta(moid).attrs["pinned"] = True

    def _save_collective(self, step: int, leaves) -> int:
        """Synchronous MPI-I/O-like path: block until every shard is on
        storage, all under one transaction."""
        oids = [self._oid(step, n) for n, _ in leaves]
        total = 0
        with self.clovis.transaction(oids + [self._manifest_oid(step)]) as txn:
            for name, leaf in leaves:
                arr = np.asarray(leaf)
                self._write_leaf(self._oid(step, name), arr, txn=txn)
                total += arr.nbytes
            self._commit_manifest(step, leaves, txn)
        return total

    def _save_window(self, step: int, leaves) -> int:
        """Storage-window path (the paper's HACC-IO checkpointing): each
        shard is stored *directly* through an mmap window on the NVRAM
        tier — the synced window file IS the checkpoint (load/store +
        msync; the OS page cache is the write buffer).  Only the manifest
        goes through the object store, committing the checkpoint
        atomically once every window is synced.  Trade-off vs the
        collective/stream paths: window checkpoints are single-copy
        (no layout redundancy), exactly like file-per-process HACC-IO."""
        total = 0
        paths = {}
        for name, leaf in leaves:
            arr = np.asarray(leaf)
            wname = self._win_name(step, name)
            win = self.windows.alloc(wname, arr.shape or (1,),
                                     arr.dtype, tier="t1_nvram")
            win.put(arr if arr.shape else arr.reshape(1))
            win.sync()                       # msync: durable on the tier
            paths[name] = str(win.path)
            self.windows.free(wname)
            total += arr.nbytes
        with self.clovis.transaction([self._manifest_oid(step)]) as txn:
            self._commit_manifest(step, leaves, txn, window_paths=paths)
        return total

    def _win_name(self, step: int, name: str) -> str:
        return f"ckpt_{step}_{name}".replace("/", "_")

    def _ensure_stream(self):
        if self._stream is not None:
            return

        def attach(el):
            try:
                kind, step, name, arr, txn = el.payload
                self._write_leaf(self._oid(step, name), arr, txn=txn)
            except Exception as e:       # resilient consumer
                self._stream_err.append(f"{type(e).__name__}: {e}")

        self._stream = StreamContext(
            n_producers=self._n_producers,
            consumer_ratio=self._consumer_ratio, attach=attach)

    def _save_stream(self, step: int, leaves, block: bool) -> int:
        """Decoupled path: producers enqueue shards and return; stream
        consumers write them concurrently.  The transaction commits when
        ``wait()`` (or a blocking save) observes the drain."""
        self._ensure_stream()
        oids = [self._oid(step, n) for n, _ in leaves]
        txn = self.clovis.transaction(oids + [self._manifest_oid(step)])
        txn.__enter__()
        total = 0
        for i, (name, leaf) in enumerate(leaves):
            arr = np.asarray(leaf)
            self._stream.push(i % self._n_producers, f"ckpt{step}",
                              ("leaf", step, name, arr, txn))
            total += arr.nbytes
        with self._lock:
            self._pending_txns[step] = (txn, leaves)
        if block:
            self.wait(step)
        return total

    def wait(self, step: Optional[int] = None, deadline_s: float = 120.0) -> bool:
        """Drain the stream and commit pending transactions."""
        if self._stream is None:
            return True
        ok = self._stream.flush(deadline_s)
        with self._lock:
            steps = sorted(self._pending_txns) if step is None else [step]
            for s in steps:
                txn, leaves = self._pending_txns.pop(s, (None, None))
                if txn is None:
                    continue
                if ok and not self._stream_err:
                    self._commit_manifest(s, leaves, txn)
                    txn.__exit__(None, None, None)
                else:
                    txn.__exit__(IOError, IOError("stream drain failed"), None)
        return ok and not self._stream_err

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = set()
        for oid in self.clovis.container(CKPT_CONTAINER):
            parts = oid.split("/")
            if len(parts) >= 3 and parts[0] == "ckpt" and parts[-1] == "manifest":
                steps.add(int(parts[1]))
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, like=None, *,
                device: DeviceLike = None, mesh=None, specs=None):
        """Rebuild the state tree.  ``like`` (a tree of tensors, meta
        tensors or arrays) supplies the structure; the leaves come back as
        tensors on ``device`` (default: the Clovis stack's device).  With
        ``mesh`` and ``specs`` (a tree of ``distributed.sharding`` specs
        like ``like``) they come back as ``DTensor``s on that mesh,
        scattered from this rank: the mesh's other ranks call
        ``receive`` at the same time."""
        out = self._restore(step, like, device)
        if mesh is None:
            return out
        from repro_torch.distributed.sharding import distribute
        return distribute(out, specs, mesh,
                          src_data_rank=torch.distributed.get_rank())

    def leaf_names(self, step: int) -> List[str]:
        """The leaf names checkpoint ``step`` holds."""
        return sorted(json.loads(
            self.clovis.get(self._manifest_oid(step)))["leaves"])

    @staticmethod
    def receive(like, specs, mesh, device: DeviceLike = None):
        """The shards of a state that the rank holding the store (rank 0)
        restores with ``restore(..., mesh=, specs=)``: a rank without the
        store calls this at the same time."""
        from repro_torch.distributed.sharding import distribute
        dev = resolve_device(device)
        empty = tree_map(lambda t: torch.empty(tuple(t.shape),
                                               dtype=t.dtype, device=dev),
                         like)
        return distribute(empty, specs, mesh, src_data_rank=0)

    def _restore(self, step, like, device):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        manifest = json.loads(self.clovis.get(self._manifest_oid(step)))
        if like is None:
            raise ValueError("restore requires a `like` pytree")
        dev = (self.clovis.device if device is None
               else resolve_device(device))
        leaves_out = []
        for name, leaf in flatten_with_names(like):
            entry = manifest["leaves"].get(name, {})
            if "window" in entry:      # window-strategy leaf: mmap read
                arr = np.array(np.memmap(
                    entry["window"], dtype=_np_dtype(entry["dtype"]),
                    mode="r", shape=tuple(entry["shape"])))
            else:
                arr = self.clovis.get_array(self._oid(step, name))
            want = manifest["leaves"].get(name)
            if want and list(arr.shape) != want["shape"]:
                raise ValueError(f"shape mismatch for {name}")
            if hasattr(leaf, "shape") and tuple(leaf.shape) != tuple(arr.shape):
                raise ValueError(
                    f"leaf {name}: checkpoint {arr.shape} vs target {leaf.shape}")
            leaves_out.append(_tensor(arr, dev))
        return unflatten(like, leaves_out)

    # ------------------------------------------------------------------

    def _retire_old(self):
        steps = sorted({i.step for i in self.history})
        done_steps = [s for s in steps
                      if self.clovis.exists(self._manifest_oid(s))]
        for s in done_steps[:-self.keep] if self.keep else []:
            try:
                manifest = json.loads(self.clovis.get(self._manifest_oid(s)))
                for entry in manifest.get("leaves", {}).values():
                    wp = entry.get("window")
                    if wp:
                        if os.path.exists(wp):
                            os.unlink(wp)
            except (KeyError, IOError, ValueError):
                pass
            for oid in list(self.clovis.container(CKPT_CONTAINER)):
                if oid.startswith(f"ckpt/{s}/"):
                    try:
                        self.clovis.delete(oid)
                    except KeyError:
                        pass

    def close(self):
        self.wait()
        if self._stream is not None:
            self._stream.close()
            self._stream = None


def _np_dtype(name: str):
    if name == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def _dt_name(dt) -> str:
    try:
        import ml_dtypes
        if dt == np.dtype(ml_dtypes.bfloat16):
            return "bfloat16"
    except (ImportError, TypeError):
        pass
    return np.dtype(dt).name

"""Storage windows — PGAS I/O (paper §4.1, "MPI storage windows").

A *window* exposes one array through PUT/GET/ACCUMULATE + SYNC epochs,
regardless of whether it lives in memory or on a storage tier:

  * ``MemoryWindow``  — plain DRAM ndarray (the paper's "MPI window").
  * ``StorageWindow`` — np.memmap over a file placed on a tier device
    (the paper's "MPI storage window"): load/store semantics with the OS
    page cache as the automatic caching layer, ``sync()`` = msync flush.

Semantics follow the paper: writes inside an epoch become durable at
``sync()``; the window is the *same programming surface* either way, so
code written against memory windows runs unchanged on storage (STREAM /
DHT / HACC-IO benchmarks do exactly this).  ``to_torch``/``from_torch``
give single-copy hand-off for tensors on a named device, and ``ingest``
moves a sealed window into the object store for layout-protected
durability.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.clovis import Clovis
from repro_torch.core.tiers import TierDevice
from repro_torch.device import DeviceLike, resolve_device


class BaseWindow:
    """The paper's one-sided window surface (§4.1, "MPI storage
    windows"): PUT/GET/ACCUMULATE inside an epoch, made durable at
    ``sync()``.  Both backends expose exactly this API — code written
    against a memory window runs unchanged on a storage tier, which is
    the paper's central PGAS-I/O claim (its STREAM/DHT/HACC-IO
    benchmarks exercise the same surface on both)."""

    array: np.ndarray

    def put(self, value, index=slice(None)):
        self.array[index] = value

    def get(self, index=slice(None)) -> np.ndarray:
        return np.asarray(self.array[index])

    def accumulate(self, value, index=slice(None)):
        self.array[index] += value

    def sync(self):
        raise NotImplementedError

    # -- PyTorch hand-off --

    def from_torch(self, t: torch.Tensor, index=slice(None)):
        self.put(t.detach().cpu().numpy(), index)

    def to_torch(self, index=slice(None), *,
                 device: DeviceLike = None) -> torch.Tensor:
        """A copy of the window (or ``index`` of it) as a tensor on
        ``device`` (default ``cuda``)."""
        return torch.tensor(self.get(index), device=resolve_device(device))

    @property
    def nbytes(self) -> int:
        return self.array.nbytes

    def close(self):
        pass


class MemoryWindow(BaseWindow):
    """The paper's plain "MPI window" (§4.1): a DRAM ndarray behind the
    window surface — the baseline the storage-backed variant is measured
    against (paper Fig. 3's memory bars)."""

    def __init__(self, shape: Sequence[int], dtype="float32"):
        self.array = np.zeros(tuple(shape), dtype=dtype)

    def sync(self):   # memory window: nothing to flush
        pass


class StorageWindow(BaseWindow):
    """The paper's "MPI storage window" (§4.1): the same load/store
    surface mapped over a file on a tier device — np.memmap stands in
    for the mmap'ed storage target, the OS page cache is the paper's
    transparent caching layer, and ``sync()`` is the MPI_Win_sync →
    msync durability point that ends an epoch."""

    def __init__(self, path: Union[str, Path], shape: Sequence[int],
                 dtype="float32", device: Optional[TierDevice] = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.device = device
        mode = "r+" if self.path.exists() else "w+"
        self.array = np.memmap(self.path, dtype=dtype, mode=mode,
                               shape=tuple(shape))
        self._lock = threading.Lock()

    def sync(self):
        with self._lock:
            self.array.flush()
            if self.device is not None:
                self.device.op_count += 1
                self.device.bytes_written += self.array.nbytes

    def close(self):
        self.sync()
        # release the mmap
        del self.array

    def unlink(self):
        if self.path.exists():
            self.path.unlink()


class WindowAllocator:
    """MPI_Win_allocate analogue (§4.1): the allocation call where the
    paper's applications choose memory vs a storage tier — the *only*
    line that changes when moving a code from DRAM to percipient
    storage.

    ``alloc(..., tier=None)`` -> MemoryWindow; ``tier='t1_nvram'`` etc. ->
    StorageWindow on the first healthy device of that tier (round-robin
    over devices for striped-ish bandwidth aggregation).  ``ingest``
    seals a window into the object store (durable, layout-protected)
    and ``restore`` materialises it back — the checkpoint/restart path
    of the paper's HACC-IO scenario.
    """

    def __init__(self, clovis: Clovis):
        self.clovis = clovis
        self._rr: Dict[str, int] = {}
        self._open: Dict[str, BaseWindow] = {}

    def alloc(self, name: str, shape: Sequence[int], dtype="float32",
              tier: Optional[str] = None) -> BaseWindow:
        if tier is None:
            win: BaseWindow = MemoryWindow(shape, dtype)
        else:
            pool = self.clovis.pools[tier]
            devs = pool.healthy
            if not devs:
                raise IOError(f"no healthy devices in tier {tier}")
            i = self._rr.get(tier, 0) % len(devs)
            self._rr[tier] = i + 1
            dev = devs[i]
            win = StorageWindow(dev.root / "windows" / f"{name}.win",
                                shape, dtype, device=dev)
        self._open[name] = win
        return win

    def free(self, name: str):
        win = self._open.pop(name, None)
        if win is not None:
            win.close()

    def ingest(self, name: str, container: str = "windows") -> str:
        """Seal a window into the object store (durable, layout-protected)."""
        win = self._open[name]
        win.sync()
        oid = f"win/{name}"
        self.clovis.put_array(oid, np.asarray(win.array), container=container)
        return oid

    def restore(self, name: str, oid: str, tier: Optional[str] = None
                ) -> BaseWindow:
        """Materialise an object back into a window (restart path)."""
        arr = self.clovis.get_array(oid)
        win = self.alloc(name, arr.shape, arr.dtype, tier=tier)
        win.put(arr)
        win.sync()
        return win

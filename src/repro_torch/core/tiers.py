"""Storage tiers — SAGE's deep I/O hierarchy (paper §2.1, §3.1).

Four tier classes mirroring the SAGE prototype:

  T1_NVRAM   — 3D-XPoint / NVDIMM class (highest perf, lowest capacity)
  T2_FLASH   — SSD class
  T3_DISK    — fast SAS disk
  T4_ARCHIVE — SMR/SATA archival

Each tier is backed by a directory (tmpfs for NVRAM when available) plus a
*device performance model* (bandwidth/latency/capacity) used by HSM/RTHMS
placement decisions and by the benchmark harness to model tier behaviour
deterministically.  ``throttle=True`` additionally enforces the modelled
bandwidth on real I/O so tier differences are observable on a single box —
the same emulation strategy the paper's own evaluation uses (Blackdog /
Tegner stand-ins for SAGE hardware).
"""
from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

T1_NVRAM = "t1_nvram"
T2_FLASH = "t2_flash"
T3_DISK = "t3_disk"
T4_ARCHIVE = "t4_archive"

TIER_ORDER = (T1_NVRAM, T2_FLASH, T3_DISK, T4_ARCHIVE)


@dataclass(frozen=True)
class DeviceModel:
    """RTHMS-style device characteristics (paper §3.2.3)."""

    read_bw: float            # bytes/s
    write_bw: float           # bytes/s
    latency: float            # seconds per op
    capacity: int             # bytes


# Defaults loosely calibrated to the SAGE prototype classes.
DEFAULT_MODELS: Dict[str, DeviceModel] = {
    T1_NVRAM: DeviceModel(read_bw=6e9, write_bw=2e9, latency=2e-6,
                          capacity=1 << 34),
    T2_FLASH: DeviceModel(read_bw=2e9, write_bw=1e9, latency=8e-5,
                          capacity=1 << 36),
    T3_DISK: DeviceModel(read_bw=2.5e8, write_bw=2e8, latency=8e-3,
                         capacity=1 << 38),
    T4_ARCHIVE: DeviceModel(read_bw=1e8, write_bw=5e7, latency=1.5e-2,
                            capacity=1 << 40),
}


class TierDevice:
    """One device in a tier: directory backend + performance model.

    Thread-safe; tracks ADDB-style op counters, supports fault injection
    (``fail()``) for HA tests, and optional bandwidth throttling.
    """

    def __init__(self, name: str, tier: str, root: Path,
                 model: Optional[DeviceModel] = None,
                 throttle: bool = False):
        self.name = name
        self.tier = tier
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.model = model or DEFAULT_MODELS[tier]
        self.throttle = throttle
        self.failed = False
        self.used_bytes = 0
        self.op_count = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self._lock = threading.Lock()

    # -- fault injection (HA subsystem drives these) --
    def fail(self):
        self.failed = True

    def recover(self):
        self.failed = False

    def _check(self):
        if self.failed:
            raise IOError(f"device {self.name} ({self.tier}) has failed")

    def _pace(self, nbytes: int, bw: float):
        if self.throttle and bw > 0:
            time.sleep(self.model.latency + nbytes / bw)

    def _path(self, key: str) -> Path:
        p = self.root / key
        p.parent.mkdir(parents=True, exist_ok=True)
        return p

    # -- block I/O --
    def write_block(self, key: str, data: bytes):
        self._check()
        if self.used_bytes + len(data) > self.model.capacity:
            raise IOError(f"device {self.name} over capacity")
        self._pace(len(data), self.model.write_bw)
        p = self._path(key)
        existed = p.stat().st_size if p.exists() else 0
        with open(p, "wb") as f:
            f.write(data)
        with self._lock:
            self.used_bytes += len(data) - existed
            self.op_count += 1
            self.bytes_written += len(data)

    def read_block(self, key: str) -> bytes:
        self._check()
        p = self._path(key)
        self._pace(p.stat().st_size, self.model.read_bw)
        with open(p, "rb") as f:
            data = f.read()
        with self._lock:
            self.op_count += 1
            self.bytes_read += len(data)
        return data

    def delete_block(self, key: str):
        self._check()
        p = self._path(key)
        if p.exists():
            sz = p.stat().st_size
            p.unlink()
            with self._lock:
                self.used_bytes -= sz
                self.op_count += 1

    def has_block(self, key: str) -> bool:
        return self._path(key).exists()

    def list_blocks(self, prefix: str = "") -> List[str]:
        """Keys of the blocks on this device; with a ``prefix`` that ends
        in "/" (an object version's directory) only that directory is
        walked, so garbage collection of one version does not scan the
        whole device."""
        top = self.root / prefix if prefix.endswith("/") else self.root
        return [key for key in (str(p.relative_to(self.root))
                                for p in top.rglob("*") if p.is_file())
                if key.startswith(prefix)]

    def wipe(self):
        shutil.rmtree(self.root, ignore_errors=True)
        self.root.mkdir(parents=True, exist_ok=True)
        self.used_bytes = 0


@dataclass
class TierPool:
    """All devices of one tier (striping targets)."""

    tier: str
    devices: List[TierDevice] = field(default_factory=list)

    @property
    def healthy(self) -> List[TierDevice]:
        return [d for d in self.devices if not d.failed]

    def device(self, name: str) -> TierDevice:
        for d in self.devices:
            if d.name == name:
                return d
        raise KeyError(name)


def make_tier_pools(root: Path, devices_per_tier: int = 2,
                    throttle: bool = False,
                    models: Optional[Dict[str, DeviceModel]] = None
                    ) -> Dict[str, TierPool]:
    """Standard 4-tier hierarchy under ``root``.

    NVRAM prefers /dev/shm when available (byte-addressable emulation,
    matching the paper's emulated-NVDIMM Tier-1).
    """
    root = Path(root)
    pools: Dict[str, TierPool] = {}
    shm = Path("/dev/shm")
    # key the shm dirs by the full root path so distinct stores never share
    # NVRAM state (restarts of the same root still find their data)
    import hashlib
    tag = hashlib.sha1(str(root.resolve()).encode()).hexdigest()[:12]
    for tier in TIER_ORDER:
        pool = TierPool(tier)
        for i in range(devices_per_tier):
            if tier == T1_NVRAM and shm.is_dir() and os.access(shm, os.W_OK):
                dev_root = shm / f"sage_{tag}_{tier}_{i}"
            else:
                dev_root = root / tier / f"dev{i}"
            model = (models or DEFAULT_MODELS)[tier]
            pool.devices.append(
                TierDevice(f"{tier}/dev{i}", tier, dev_root, model, throttle))
        pools[tier] = pool
    return pools

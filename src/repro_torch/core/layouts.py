"""Layouts — how a storage entity maps onto devices and tiers (paper §3.2.1).

A layout determines the performance and fault-tolerance properties of an
object: striped (RAID-0), mirrored (RAID-1), and parity (RAID-5-like,
single-device-failure tolerant via XOR parity), each bound to a tier.
Different byte-ranges of one object may carry different layouts on
different tiers (the paper's per-extent layout), realised here by HSM
moving whole objects with a layout change.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

STRIPED = "striped"
MIRRORED = "mirrored"
PARITY = "parity"


@dataclass(frozen=True)
class Layout:
    kind: str                 # striped | mirrored | parity
    tier: str                 # repro_torch.core.tiers tier id
    width: int = 2            # stripe width / mirror copies
    # parity layouts use `width` data units + 1 parity unit

    def replicas_for(self, unit_idx: int, n_devices: int) -> List[int]:
        """Device indices holding (copies of) a given unit."""
        if self.kind == MIRRORED:
            return [(unit_idx + r) % n_devices for r in range(min(self.width, n_devices))]
        return [unit_idx % n_devices]

    def tolerates_failures(self) -> int:
        if self.kind == MIRRORED:
            return self.width - 1
        if self.kind == PARITY:
            return 1
        return 0


def xor_parity(blocks: Sequence[bytes]) -> bytes:
    """XOR parity over equal-length blocks (shorter ones zero-padded)."""
    size = max(len(b) for b in blocks)
    out = bytearray(size)
    for b in blocks:
        for i, byte in enumerate(b):
            out[i] ^= byte
    return bytes(out)


def reconstruct_from_parity(blocks: Dict[int, bytes], parity: bytes,
                            missing: int, n: int, sizes: Dict[int, int]) -> bytes:
    """Rebuild the missing data block of a parity group."""
    acc = bytearray(parity)
    for i, b in blocks.items():
        if i == missing:
            continue
        for j, byte in enumerate(b):
            acc[j] ^= byte
    return bytes(acc[: sizes[missing]])


DEFAULT_LAYOUTS: Dict[str, Layout] = {
    # checkpoint shards: fast tier, mirrored for availability
    "checkpoint": Layout(MIRRORED, "t1_nvram", width=2),
    # bulk training data: flash, striped for bandwidth
    "data": Layout(STRIPED, "t2_flash", width=2),
    # telemetry: disk, striped
    "telemetry": Layout(STRIPED, "t3_disk", width=2),
    # archival snapshots: archive tier with parity
    "archive": Layout(PARITY, "t4_archive", width=2),
}

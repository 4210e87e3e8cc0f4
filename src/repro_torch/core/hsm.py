"""HSM — hierarchical storage management (paper §3.2.3) + RTHMS placement.

Moves objects between tiers based on access history and capacity
watermarks, exactly the paper's usage-driven data movement:

  * hot objects (recent, frequent access) promote toward T1 (NVRAM);
  * cold objects demote toward T4 (archive), switching to parity layouts;
  * high-watermark pressure on a tier force-demotes its coldest objects;
  * RTHMS-style placement: ``recommend_tier`` scores tiers from device
    characteristics (bandwidth/latency) against an access-pattern hint,
    mirroring the RTHMS tool's binary+memory-model recommendation.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core import layouts as lay
from repro_torch.core.object_store import ObjectStore
from repro_torch.core.tiers import TIER_ORDER


@dataclass
class HsmPolicy:
    hot_access_count: int = 3          # accesses within hot_window -> promote
    hot_window_s: float = 60.0
    cold_age_s: float = 600.0          # no access for this long -> demote
    high_watermark: float = 0.85       # tier fill fraction forcing demotion
    promote_layout_kind: str = lay.MIRRORED
    demote_layout_kind: str = lay.PARITY


PROMOTE = "promote"
DEMOTE = "demote"


class CountingScorer:
    """Default promote/demote decision: raw recent-access counts against
    the HsmPolicy thresholds (the daemon's historical behaviour)."""

    def __init__(self, policy: HsmPolicy):
        self.policy = policy

    def decide(self, meta, now: float) -> Optional[str]:
        pol = self.policy
        age = now - meta.last_access
        if (meta.access_count >= pol.hot_access_count
                and age <= pol.hot_window_s):
            return PROMOTE
        if age >= pol.cold_age_s:
            return DEMOTE
        return None


class HsmDaemon:
    """Single-shot or background-thread migration engine.

    Scoring is pluggable: ``scorer`` is any object with
    ``decide(meta, now) -> "promote" | "demote" | None``; the default
    CountingScorer reproduces the original raw-count/watermark policy,
    while percipience.PercipientPolicy substitutes predicted heat.
    """

    def __init__(self, store: ObjectStore, policy: Optional[HsmPolicy] = None,
                 scorer=None):
        self.store = store
        self.policy = policy or HsmPolicy()
        self.scorer = scorer or CountingScorer(self.policy)
        self.migrations: List[Tuple[str, str, str]] = []   # (oid, from, to)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------

    def _tier_up(self, tier: str) -> Optional[str]:
        i = TIER_ORDER.index(tier)
        return TIER_ORDER[i - 1] if i > 0 else None

    def _tier_down(self, tier: str) -> Optional[str]:
        i = TIER_ORDER.index(tier)
        return TIER_ORDER[i + 1] if i < len(TIER_ORDER) - 1 else None

    def _tier_fill(self, tier: str) -> float:
        pool = self.store.pools[tier]
        used = sum(d.used_bytes for d in pool.devices)
        cap = sum(d.model.capacity for d in pool.devices)
        return used / cap if cap else 0.0

    def _migrate(self, oid: str, target_tier: str, kind: str):
        meta = self.store.meta(oid)
        src = meta.layout.tier
        layout = lay.Layout(kind, target_tier, meta.layout.width)
        self.store.migrate(oid, layout)
        with self._lock:
            self.migrations.append((oid, src, target_tier))

    # ------------------------------------------------------------------

    def scan_once(self) -> int:
        """One policy pass over all objects; returns migrations performed."""
        now = time.time()
        pol = self.policy
        n = 0
        for oid in list(self.store._meta):
            try:
                meta = self.store.meta(oid)
            except KeyError:
                continue
            if meta.attrs.get("pinned"):
                continue
            tier = meta.layout.tier
            decision = self.scorer.decide(meta, now)
            if decision == PROMOTE:
                up = self._tier_up(tier)
                if up is not None:
                    self._migrate(oid, up, pol.promote_layout_kind)
                    n += 1
            elif decision == DEMOTE:
                down = self._tier_down(tier)
                if down is not None:
                    self._migrate(oid, down, pol.demote_layout_kind)
                    n += 1
        n += self._relieve_pressure()
        return n

    def _victim_rank(self, oid: str, now: float) -> float:
        """Demotion rank under watermark pressure (lowest evicts first).

        Percipient scorers expose ``victim_rank`` (preferred: handles
        never-observed objects) or ``heat_of``: rank by predicted heat so
        the object least likely to be re-read goes first, even when its
        raw last-access time looks recent (e.g. one straggler touch on an
        otherwise idle object).  Scorers without heat fall back to the
        historical LRU order.
        """
        rank = getattr(self.scorer, "victim_rank", None)
        if rank is not None:
            return rank(self.store.meta(oid), now)
        heat_of = getattr(self.scorer, "heat_of", None)
        if heat_of is not None:
            return heat_of(oid, now)
        return self.store.meta(oid).last_access

    def _relieve_pressure(self) -> int:
        n = 0
        now = time.time()
        for tier in TIER_ORDER[:-1]:
            while self._tier_fill(tier) > self.policy.high_watermark:
                victims = sorted(
                    (oid for oid, m in self.store._meta.items()
                     if m.layout.tier == tier and not m.attrs.get("pinned")),
                    key=lambda o: self._victim_rank(o, now))
                if not victims:
                    break
                down = self._tier_down(tier)
                self._migrate(victims[0], down, self.policy.demote_layout_kind)
                n += 1
        return n

    # ------------------------------------------------------------------

    def start(self, interval_s: float = 5.0):
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.scan_once()
                except Exception:
                    pass
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)


@dataclass(frozen=True)
class TierParams:
    """The HSM tier map entry for one tier: the device performance model
    plus live capacity state.  This is the single latency/bandwidth
    parameter source shared by RTHMS ``recommend_tier`` and the
    analytics cost-based optimizer (pushdown-vs-fetch per partition)."""

    tier: str
    latency: float            # seconds per op
    read_bw: float            # bytes/s
    write_bw: float           # bytes/s
    capacity: int             # bytes, across all devices
    used: int                 # bytes, across all devices

    def read_s(self, size_bytes: int) -> float:
        """Modelled time to scan ``size_bytes`` off this tier."""
        return self.latency + size_bytes / max(self.read_bw, 1.0)


def tier_params(store: ObjectStore) -> Dict[str, TierParams]:
    """The HSM tier map: per-tier latency/bandwidth/capacity parameters
    derived from the live device pools."""
    out: Dict[str, TierParams] = {}
    for tier, pool in store.pools.items():
        devs = pool.healthy or pool.devices
        if not devs:
            continue
        m = devs[0].model
        out[tier] = TierParams(
            tier, m.latency, m.read_bw, m.write_bw,
            capacity=sum(d.model.capacity for d in pool.devices),
            used=sum(d.used_bytes for d in pool.devices))
    return out


def recommend_tier(store: ObjectStore, *, size_bytes: int,
                   read_fraction: float, random_access: bool,
                   exclude: Tuple[str, ...] = ()) -> str:
    """RTHMS-style placement: score tiers by modelled access time."""
    best, best_t = None, float("inf")
    ops = 1000 if random_access else 1
    per_op = size_bytes / ops
    params = tier_params(store)
    for tier, p in params.items():
        if tier in exclude or not store.pools[tier].healthy:
            continue
        if p.used + size_bytes > p.capacity:
            continue
        t = ops * (p.latency +
                   per_op * (read_fraction / p.read_bw +
                             (1 - read_fraction) / p.write_bw))
        if t < best_t:
            best, best_t = tier, t
    return best or TIER_ORDER[-1]

"""Learned tier placement — predicted heat instead of raw access
counts, SAGE's percipience applied to HSM (paper §3.2.3: usage-driven
data movement steered by what the store learns about its workload).

``PercipientPolicy`` is a drop-in scorer for ``HsmDaemon`` (its pluggable
``decide`` hook): promote objects whose *predicted* heat — the
exponentially-decayed access intensity from the percipience heat kernel —
clears ``promote_heat``, demote those that fall below ``demote_heat``.
Unlike the default CountingScorer (total access count within a window),
heat decays continuously, so an object that was hammered an hour ago but
is idle now scores cold even though its lifetime count is large.

Heat for all tracked objects is computed in one batched kernel call (on
``device``: the CUDA heat-scan kernel on ``cuda``, its plain PyTorch
version on ``cpu``) and cached for ``refresh_s`` so a daemon scan over N
objects costs one kernel launch, not N.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.core.hsm import DEMOTE, PROMOTE
from repro_torch.device import DeviceLike, resolve_device

from repro_torch.percipience.heat import heat_scores
from repro_torch.percipience.telemetry import FeatureExtractor


class PercipientPolicy:
    def __init__(self, extractor: FeatureExtractor, *,
                 half_life_s: float = 120.0, promote_heat: float = 1.5,
                 demote_heat: float = 0.05, refresh_s: float = 1.0,
                 device: DeviceLike = None):
        self.extractor = extractor
        self.half_life_s = half_life_s
        self.promote_heat = promote_heat
        self.demote_heat = demote_heat
        self.refresh_s = refresh_s
        self.device = resolve_device(device)     # where heat_scores runs
        self._heat: Dict[str, float] = {}
        self._heat_ts = 0.0

    # ------------------------------------------------------------------

    def refresh(self, now: Optional[float] = None) -> Dict[str, float]:
        """Recompute the heat table (one batched kernel call)."""
        now = time.time() if now is None else now
        oids, ts, _, mask = self.extractor.history_tensors()
        if oids:
            heat = heat_scores(ts, mask, now, self.half_life_s,
                               device=self.device)
            self._heat = dict(zip(oids, heat.tolist()))
        else:
            self._heat = {}
        self._heat_ts = now
        return self._heat

    def heat_of(self, oid: str, now: Optional[float] = None) -> float:
        now = time.time() if now is None else now
        if now - self._heat_ts > self.refresh_s:
            self.refresh(now)
        return self._heat.get(oid, 0.0)

    def heat_map(self, oids, now: Optional[float] = None) -> Dict[str, float]:
        """Batch heat query (one kernel call via the refresh cache) — the
        analytics executor's tier-aware scheduling hook."""
        now = time.time() if now is None else now
        if now - self._heat_ts > self.refresh_s:
            self.refresh(now)
        return {oid: self._heat.get(oid, 0.0) for oid in oids}

    def load_factor(self, oids, now: Optional[float] = None
                    ) -> Dict[str, float]:
        """Predicted storage-side contention per object, as saturating
        heat in [0, 1): heat h maps to h / (1 + h).  The analytics cost
        model uses this to discount in-storage compute for partitions
        whose storage node is predicted busy serving demand reads —
        percipience steering computation *away* from overloaded storage,
        the flip side of shipping it there."""
        return {oid: h / (1.0 + h)
                for oid, h in self.heat_map(oids, now).items()}

    # ------------------------------------------------------------------
    # HsmDaemon scorer hook
    # ------------------------------------------------------------------

    def decide(self, meta, now: float) -> Optional[str]:
        if self.extractor.access_count(meta.oid) == 0:
            # never observed (e.g. pre-attach object): no evidence either
            # way — measured-cold and unknown must not be conflated, or
            # enabling percipience on a warm store demotes everything
            return None
        heat = self.heat_of(meta.oid, now)
        if heat >= self.promote_heat:
            return PROMOTE
        if heat <= self.demote_heat:
            return DEMOTE
        return None

    def victim_rank(self, meta, now: float) -> float:
        """Watermark-eviction rank (HsmDaemon pressure path; lowest
        evicts first).  Never-observed objects must not score 0 — that
        would conflate unknown with measured-cold and evict a just-read
        pre-attach object first — so they get the heat a single access
        at ``meta.last_access`` would carry, keeping every object on the
        same decayed-heat scale."""
        import math
        if self.extractor.access_count(meta.oid) == 0:
            lam = math.log(2.0) / self.half_life_s
            return math.exp(-lam * max(now - meta.last_access, 0.0))
        return self.heat_of(meta.oid, now)

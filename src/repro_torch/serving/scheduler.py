"""Serving-side query scheduler pieces: cross-query fragment
single-flight and a warm plan cache.

Two queries from two tenants scanning the same partition with the same
fragment should ship **one** fragment to the store and share the
partial — SAGE's in-storage compute is a shared resource, and at front-
door concurrency identical work is the common case (zipfian query
mixes).  Two layers make sharing happen:

  * **after completion** — the executor's version-keyed partial
    cache: a later identical query plans the partition as ``cached``;
  * **in flight** — the ``FlightTable`` here: while a fragment
    execution is still running, concurrent identical requests (same
    fragment spec, same object, same version — exactly the partial-
    cache key) wait on the leader's result instead of shipping again
    (single flight: N waiters, one ship).

``PlanCache`` keeps compiled/optimized ``PhysicalPlan``s warm, keyed by
the plan fingerprint (canonical op-spec JSON), the scheduled partition
list, the ``StatsCatalog`` version (any stats observe/invalidate bumps
it, so a write or a fresher summary re-plans), and the set of
partitions with fresh cached partials (so ``cached`` placements stay
current).  Served query mixes repeat heavily, so most queries skip
optimization entirely — the warm path behind the p50.

``ServingEngine`` / ``ClusterServingEngine`` are the standard analytics
engines with both layers mixed in via the executor's ``_ship_fragment``
/ ``_make_plan`` hooks — execution, merging, spill, and ADDB decision
traces are untouched.
"""
from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from repro_torch.analytics.executor import AnalyticsEngine
from repro_torch.analytics.plan import op_to_spec
from repro_torch.cluster.cluster import ClusterAnalyticsEngine


class _Flight:
    __slots__ = ("event", "result")

    def __init__(self):
        self.event = threading.Event()
        self.result = None


class FlightTable:
    """Single-flight dedup of in-flight fragment executions.

    Keyed by (fragment key, oid, object version) — the partial-cache
    key — so a concurrent write simply starts a separate flight for the
    new version; stale sharing is impossible by construction.
    """

    def __init__(self, wait_timeout_s: float = 120.0):
        self.wait_timeout_s = wait_timeout_s
        self._lock = threading.Lock()
        self._flights: Dict[Tuple, _Flight] = {}
        self.ships = 0            # fragments actually shipped (leaders)
        self.dedup_hits = 0       # waiters served from a leader's flight

    def run(self, key: Optional[Tuple], ship) -> Tuple[Any, bool]:
        """Execute ``ship()`` once per key across concurrent callers;
        returns ``(result, deduped)`` where ``deduped`` says whether
        THIS call rode another query's flight.

        The first caller (leader) ships and publishes; concurrent
        callers with the same key block on the leader and share its
        result.  ``key=None`` (no stable version) always ships.  A
        waiter whose leader takes longer than ``wait_timeout_s`` ships
        for itself — dedup is an optimization, never a hostage.
        """
        if key is None:
            with self._lock:
                self.ships += 1
            return ship(), False
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                leader = True
                self.ships += 1
            else:
                leader = False
                self.dedup_hits += 1
        if not leader:
            if flight.event.wait(self.wait_timeout_s):
                return flight.result, True
            with self._lock:
                self.ships += 1              # leader wedged: go alone
                self.dedup_hits -= 1
            return ship(), False
        try:
            flight.result = ship()
        finally:
            with self._lock:
                self._flights.pop(key, None)
            flight.event.set()
        return flight.result, False

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"ships": self.ships, "dedup_hits": self.dedup_hits,
                    "in_flight": len(self._flights)}


class PlanCache:
    """LRU of optimized PhysicalPlans keyed by plan fingerprint +
    catalog version + cached-partition signature.  Entries are shared
    read-only across queries (the executor never mutates a plan after
    optimization)."""

    def __init__(self, size: int = 64):
        self.size = size
        self._lock = threading.Lock()
        self._plans: "OrderedDict[Tuple, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple):
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return plan

    def put(self, key: Tuple, plan):
        if self.size <= 0:
            return
        with self._lock:
            self._plans[key] = plan
            self._plans.move_to_end(key)
            while len(self._plans) > self.size:
                self._plans.popitem(last=False)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._plans)}


class ServingMixin:
    """Mixes fragment single-flight + plan caching into an analytics
    engine through the executor's ``_ship_fragment`` / ``_make_plan``
    hooks.  One engine instance is shared by all of a service's worker
    threads — the base engine is already safe for concurrent ``run``
    calls (per-query pools, locked caches)."""

    def __init__(self, *args, plan_cache_size: int = 64,
                 flight_wait_s: float = 120.0, **kw):
        super().__init__(*args, **kw)
        self.flights = FlightTable(wait_timeout_s=flight_wait_s)
        self.plan_cache = PlanCache(plan_cache_size)

    # -- cross-query fragment single-flight ----------------------------

    def _ship_fragment(self, name: str, frag_key: str, oid: str,
                       stats=None, columns=None):
        # columns derive deterministically from frag_key's spec, so the
        # flight key needs no extra component: every waiter on this key
        # wants the same pruned (or full) fragment result
        key = self._cache_key(frag_key, oid)
        res, deduped = self.flights.run(
            key, lambda: (self.shipper.ship_columns(name, oid, columns)
                          if columns is not None
                          else self.shipper.ship(name, oid)))
        if stats is not None and deduped:
            with self._lock:
                stats.dedup_hits += 1
        return res

    # -- warm plan cache -----------------------------------------------

    def _plan_fingerprint(self, ds) -> Optional[str]:
        try:
            return json.dumps([op_to_spec(o) for o in ds.ops],
                              sort_keys=True, default=str)
        except TypeError:
            return None               # map() closure: not fingerprintable

    def _make_plan(self, ds, oids):
        fp = self._plan_fingerprint(ds)
        if fp is None or self.plan_cache.size <= 0:
            return super()._make_plan(ds, oids)
        # the cached-partition signature keeps `cached` placements
        # honest: a partial landing in (or falling out of) the
        # engine's partial cache changes the key, not the cached plan
        cached_sig = frozenset(o for o in oids if self._cache_probe(fp, o))
        container = getattr(ds.source, "container", "?")
        # keyed on the *container-scoped* catalog version: sustained
        # ingest into one container re-derives only that container's
        # plans; every other tenant's warm plans keep hitting
        key = (container, fp, tuple(oids),
               self.stats.container_version(container), cached_sig)
        plan = self.plan_cache.get(key)
        if plan is None:
            plan = super()._make_plan(ds, oids)
            self.plan_cache.put(key, plan)
        return plan

    def serving_stats(self) -> Dict[str, Dict[str, int]]:
        return {"flights": self.flights.stats(),
                "plans": self.plan_cache.stats()}


class ServingEngine(ServingMixin, AnalyticsEngine):
    """Single-node serving engine (``Clovis.serving()``)."""


class ClusterServingEngine(ServingMixin, ClusterAnalyticsEngine):
    """Cluster serving engine (``ClusterClovis.serving()``): node-aware
    cost planning from ClusterAnalyticsEngine plus the serving layers.
    Note the plan fingerprint does not include node placement — the
    catalog version covers it, since per-node bandwidth observations
    bump the catalog exactly like partition stats do."""

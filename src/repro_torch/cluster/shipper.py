"""Cluster-wide function shipping — route each shipped fragment to a
node that owns the partition, falling back across replicas on failure.

``ClusterShipper`` presents the exact ``FunctionShipper`` surface the
analytics engine and StatsCatalog already consume (register / ship /
observers / partial aggregates), so the single-store engine runs over a
cluster unchanged.  Per shipped invocation it:

  1. orders the partition's live replica holders freshest-first
     (cluster placement, cluster.py);
  2. ships to each in turn via the *owning node's* local shipper —
     the computation runs on that node's executors against that node's
     devices;
  3. records the route taken in ADDB (op ``cluster_route``, including
     whether it was the ring primary or a failover re-route) and feeds
     the observed wall time into the StatsCatalog's per-node bandwidth
     estimate (the cost model's learned TierParams).

A node that dies mid-query simply fails step 2 and the next replica
serves the fragment — replicas hold identical bytes and partials merge
in deterministic partition order, so results are byte-identical to a
failure-free run.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.function_shipping import PartialAgg, ShipResult


class ClusterShipper:
    def __init__(self, cluster, max_workers: int = 16):
        self.cluster = cluster
        self.stats = None            # StatsCatalog, set by analytics()
        self._functions: Dict[str, Callable[[np.ndarray], Any]] = {}
        self._partials: Dict[str, PartialAgg] = {}
        self._observers: List[Callable[[ShipResult], None]] = []
        self._pool = cf.ThreadPoolExecutor(max_workers=max_workers,
                                           thread_name_prefix="sage-cship")
        self._lock = threading.Lock()

    # -- registry (fanned out to every node's local shipper) -----------

    def register(self, name: str, fn: Callable[[np.ndarray], Any]):
        with self._lock:
            self._functions[name] = fn
            nodes = self.cluster.all_nodes()
        for node in nodes:
            node.shipper.register(name, fn)

    def unregister(self, name: str):
        with self._lock:
            self._functions.pop(name, None)
            nodes = self.cluster.all_nodes()
        for node in nodes:
            node.shipper.unregister(name)

    def register_partial(self, name: str, partial, combine):
        with self._lock:
            self._partials[name] = PartialAgg(partial, combine)
            nodes = self.cluster.all_nodes()
        for node in nodes:
            node.shipper.register_partial(name, partial, combine)

    def partial_agg(self, name: str) -> PartialAgg:
        with self._lock:
            if name in self._partials:
                return self._partials[name]
        # builtins live in every node's local registry
        return self.cluster.any_alive_node().shipper.partial_agg(name)

    def sync_node(self, node):
        """Replay cluster-level registrations onto a node that joined
        after they were made."""
        with self._lock:
            fns = dict(self._functions)
            partials = dict(self._partials)
        for name, fn in fns.items():
            node.shipper.register(name, fn)
        for name, agg in partials.items():
            node.shipper.register_partial(name, agg.partial, agg.combine)

    # -- observers (the StatsCatalog attaches here) --------------------

    def add_observer(self, fn: Callable[[ShipResult], None]):
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)

    def remove_observer(self, fn: Callable[[ShipResult], None]):
        with self._lock:
            if fn in self._observers:
                self._observers.remove(fn)

    def _notify(self, res: ShipResult) -> ShipResult:
        with self._lock:
            obs = list(self._observers)
        for fn in obs:
            try:
                fn(res)
            except Exception:
                pass   # observers must not break the shipping path
        return res

    # -- routed shipping -----------------------------------------------

    def _route(self, oid: str, run: Callable[["object"], ShipResult],
               fn_name: str) -> ShipResult:
        """Try the partition's replica holders freshest-first until one
        serves; record every successful route (and terminal failure) in
        ADDB and feed the node's observed bandwidth to the catalog."""
        addb = self.cluster.addb
        try:
            candidates = self.cluster.route_candidates(oid)
        except KeyError:
            return self._notify(ShipResult(oid, fn_name, False,
                                           error="object unknown to cluster"))
        primary = self.cluster.primary_of(oid)
        last = ShipResult(oid, fn_name, False, error="no live replica")
        for node in candidates:
            t0 = time.perf_counter()
            res = run(node)
            wall = time.perf_counter() - t0
            if res.ok:
                try:
                    nbytes = node.store.read_size(oid)
                except KeyError:
                    nbytes = 0
                addb.record_route(oid, node.node_id,
                                  rerouted=node.node_id != primary,
                                  nbytes=nbytes, latency_s=wall)
                if self.stats is not None:
                    self.stats.observe_node_latency(node.node_id, nbytes,
                                                    wall)
                return self._notify(res)
            last = res
        addb.record_route(oid, "-", rerouted=True, ok=False)
        return self._notify(last)

    def ship(self, fn_name: str, oid: str) -> ShipResult:
        return self._route(oid, lambda n: n.shipper.ship(fn_name, oid),
                           fn_name)

    def ship_async(self, fn_name: str, oid: str) -> "cf.Future[ShipResult]":
        return self._pool.submit(self.ship, fn_name, oid)

    def ship_blocks(self, fn_name: str, oid: str) -> ShipResult:
        return self._route(oid,
                           lambda n: n.shipper.ship_blocks(fn_name, oid),
                           fn_name)

    def ship_to_container(self, fn_name: str, container: str
                          ) -> List[ShipResult]:
        futs = [self.ship_async(fn_name, oid)
                for oid in self.cluster.container(container)]
        return [f.result() for f in futs]

    def ship_partial(self, agg_name: str, container: str
                     ) -> Tuple[Any, List[ShipResult]]:
        agg = self.partial_agg(agg_name)
        oids = self.cluster.container(container)
        futs = [self._pool.submit(
                    self._route, oid,
                    lambda n, o=oid: n.shipper._ship_with(agg.partial,
                                                          agg_name, o),
                    agg_name)
                for oid in oids]
        results = [f.result() for f in futs]
        partials = [r.value for r in results if r.ok]
        combined = agg.combine(partials) if partials else None
        return combined, results

    def shutdown(self):
        self._pool.shutdown(wait=True)

"""Scale-out storage cluster — DHT placement, K-way replication, and
HA-driven query failover (paper §3.1: SAGE is a *cluster* of percipient
storage nodes; Mero places and replicates objects across it).

``ClusterClovis`` is the front end: the same access surface a single
``Clovis`` exposes (``put_array`` / ``get_array`` / ``container`` /
``delete`` / ``analytics``), backed by N ``StorageNode``s.

  * **Placement** — a consistent-hash ring with virtual nodes
    (ring.py) maps every container partition (object) to K owner nodes
    across distinct failure domains.
  * **Replication** — every put writes all K owners and stamps a
    cluster-wide monotonic ``cluster_version``; reads serve from the
    freshest live replica and *read-repair* divergent or missing ones.
  * **Rebalance** — join/leave recomputes ownership and moves exactly
    the ring-delta partitions (``plan_rebalance``), never a reshuffle.
  * **Failover** — each node's HAMonitor escalates device-failure
    bursts; the cluster subscribes and turns a multi-device burst into
    a ring eviction + re-replication from surviving replicas, while the
    ClusterShipper re-routes in-flight query fragments to replicas.
    Results are byte-identical to a failure-free run: replicas hold
    identical bytes and partials merge in deterministic partition
    order.

``ClusterStore`` duck-types the ObjectStore surface the analytics
engine consumes (meta / read_size / migrate / hooks), routing each call
to the freshest live replica holder, so ``AnalyticsEngine`` — and the
cost-based optimizer under it — run over the cluster unchanged.
``ClusterAnalyticsEngine`` only overrides planning: each partition is
costed with the *owning node's* tier parameters, blended with that
node's observed fragment bandwidth (StatsCatalog per-node EWMA).

The cluster resolves its ``device`` once (``cuda`` unless the caller
asks for the CPU) and hands it to every node, those that join later
included; the engines it builds run their kernels there.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.analytics.cost import CostContext
from repro_torch.analytics.executor import AnalyticsEngine
from repro_torch.analytics.plan import optimize
from repro_torch.cluster.node import StorageNode
from repro_torch.cluster.ring import HashRing, Move, plan_rebalance
from repro_torch.cluster.shipper import ClusterShipper
from repro_torch.core import layouts as lay
from repro_torch.core.addb import Addb
from repro_torch.core.hsm import TierParams, tier_params
from repro_torch.device import DeviceLike, resolve_device


class ClusterStore:
    """ObjectStore-shaped facade over the cluster: metadata and
    migration route to the freshest live replica holder; write/FDMI
    hooks are cluster-level (fired by ClusterClovis mutations), so the
    engine's partial-cache invalidation and the StatsCatalog attach
    here exactly as they would to a single store."""

    def __init__(self, cluster: "ClusterClovis"):
        self._c = cluster
        self.addb = cluster.addb
        self._write_hooks: List = []
        self._fdmi: List = []
        self._lock = threading.Lock()

    @property
    def pools(self):
        # representative device pools (nodes are homogeneous); per-node
        # capacity/latency differences enter planning via
        # ClusterClovis.tier_params_of, not this map
        return self._c.any_alive_node().store.pools

    # -- metadata (freshest live replica) ------------------------------

    def meta(self, oid: str):
        return self._c.freshest_holder(oid).store.meta(oid)

    def read_size(self, oid: str) -> int:
        return self._c.freshest_holder(oid).store.read_size(oid)

    def exists(self, oid: str) -> bool:
        return self._c.exists(oid)

    def migrate(self, oid: str, new_layout: lay.Layout):
        for node in self._c.live_holders(oid):
            node.store.migrate(oid, new_layout)
        self._emit("migrate", oid, {"tier": new_layout.tier})

    # -- hooks (cluster-level; ClusterClovis mutations fire them) ------

    def register_write_hook(self, fn):
        with self._lock:
            if fn not in self._write_hooks:
                self._write_hooks.append(fn)

    def unregister_write_hook(self, fn):
        with self._lock:
            if fn in self._write_hooks:
                self._write_hooks.remove(fn)

    def fdmi_register(self, fn):
        with self._lock:
            if fn not in self._fdmi:
                self._fdmi.append(fn)

    def fdmi_unregister(self, fn):
        with self._lock:
            if fn in self._fdmi:
                self._fdmi.remove(fn)

    def _notify_write(self, oid: str, nbytes: int):
        with self._lock:
            hooks = list(self._write_hooks)
        for fn in hooks:
            try:
                fn(oid, nbytes)
            except Exception:
                pass   # hooks must not break the write path

    def _emit(self, event: str, oid: str, info: Optional[Dict] = None):
        with self._lock:
            fns = list(self._fdmi)
        for fn in fns:
            try:
                fn(event, oid, info or {})
            except Exception:
                pass   # plugins must not break the store

    def fdmi_emit(self, event: str, oid: str, info: Optional[Dict] = None):
        """Public FDMI emit (cluster-level) — same contract as
        ``ObjectStore.fdmi_emit``."""
        self._emit(event, oid, info)


NodeSpec = Union[str, Tuple[str, str]]


def _node_specs(nodes: Union[int, Sequence[NodeSpec]]
                ) -> List[Tuple[str, Optional[str]]]:
    if isinstance(nodes, int):
        return [(f"node{i:02d}", None) for i in range(nodes)]
    out: List[Tuple[str, Optional[str]]] = []
    for spec in nodes:
        if isinstance(spec, str):
            out.append((spec, None))
        else:
            nid, dom = spec
            out.append((nid, dom))
    return out


class ClusterClovis:
    """Clovis-shaped front end over a simulated scale-out cluster.

    ``nodes`` is a count (each node its own failure domain) or a list
    of ``node_id`` / ``(node_id, domain)`` specs.  ``replicas`` is K —
    every partition lives on K nodes across distinct domains where the
    domain count allows.  ``device`` is where every node's kernels run.
    """

    def __init__(self, root: Path, nodes: Union[int, Sequence[NodeSpec]] = 3,
                 *, replicas: int = 2, vnodes: int = 64,
                 addb: Optional[Addb] = None, devices_per_tier: int = 2,
                 throttle: bool = False, ship_workers: int = 2,
                 ha_error_threshold: int = 2,
                 node_fail_device_evictions: int = 2,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.root = Path(root)
        self.addb = addb or Addb()
        self.replicas = replicas
        self.devices_per_tier = devices_per_tier
        self.throttle = throttle
        self.ship_workers = ship_workers
        self.ha_error_threshold = ha_error_threshold
        # distinct HA-evicted devices on one node before the cluster
        # declares the *node* failed (a single device failure is
        # repaired locally by the node's own HA — no ring change)
        self.node_fail_device_evictions = node_fail_device_evictions
        self.ring = HashRing(vnodes=vnodes)
        self._nodes: Dict[str, StorageNode] = {}
        self._objects: Dict[str, str] = {}          # oid -> container
        self._vclock = itertools.count(1)
        self._lock = threading.RLock()
        self._rebalance_lock = threading.Lock()
        self._dev_evictions: Dict[str, set] = {}
        self.store = ClusterStore(self)
        self.shipper = ClusterShipper(self)
        self.percipience = None       # per-node percipience only
        self._stats_catalog = None
        self._manifests = None        # shared ManifestRegistry
        for node_id, domain in _node_specs(nodes):
            self.add_node(node_id, domain)

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------

    def add_node(self, node_id: str, domain: Optional[str] = None) -> Dict:
        """Join a node: build its stack, extend the ring, and move only
        the ring-delta partitions onto it.  Returns the rebalance
        summary {partitions, bytes}."""
        with self._lock:
            if node_id in self._nodes:
                raise KeyError(f"node {node_id} already in cluster")
            before = self._ownership()
            node = StorageNode(node_id, domain or node_id,
                               self.root / node_id, addb=self.addb,
                               devices_per_tier=self.devices_per_tier,
                               throttle=self.throttle,
                               ship_workers=self.ship_workers,
                               ha_error_threshold=self.ha_error_threshold,
                               device=self.device)
            self._nodes[node_id] = node
            self.ring.add_node(node_id, domain)
            moves = plan_rebalance(before, self._ownership())
        node.ha.subscribe(self._make_ha_handler(node_id))
        self.shipper.sync_node(node)
        summary = self._execute_moves(moves)
        self.addb.record_ha("join", node_id,
                            detail=f"partitions={summary['partitions']}",
                            nbytes=summary["bytes"])
        return summary

    def remove_node(self, node_id: str) -> Dict:
        """Graceful leave: the node is still alive, so its partitions
        copy off it (ring-delta only) before it stops serving."""
        with self._lock:
            if node_id not in self._nodes:
                raise KeyError(f"node {node_id} not in cluster")
            before = self._ownership()
            self.ring.remove_node(node_id)
            moves = plan_rebalance(before, self._ownership())
        summary = self._execute_moves(moves)
        node = self._nodes[node_id]
        node.alive = False
        node.close()
        self.addb.record_ha("leave", node_id,
                            detail=f"partitions={summary['partitions']}",
                            nbytes=summary["bytes"])
        return summary

    def evict_node(self, node_id: str) -> Dict:
        """Failure eviction: the node's data is *gone* — drop it from
        the ring and re-replicate its partitions from surviving
        replicas.  Idempotent (HA can report the same dead node from
        several device bursts)."""
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                return {"partitions": 0, "bytes": 0, "moves": []}
            node.alive = False
            if node_id not in self.ring:
                return {"partitions": 0, "bytes": 0, "moves": []}
            before = self._ownership()
            self.ring.remove_node(node_id)
            moves = plan_rebalance(before, self._ownership())
        summary = self._execute_moves(moves)
        self.addb.record_ha("evict", node_id,
                            detail=f"node partitions={summary['partitions']}",
                            nbytes=summary["bytes"])
        return summary

    def kill_node(self, node_id: str):
        """Simulate abrupt node loss.  The node is NOT proactively
        evicted: its devices fail, the next reads that route to it
        raise, its own HAMonitor digests the burst, and the cluster's
        HA subscription evicts it from the ring — the organic failure
        path a benchmark kill-mid-scan exercises."""
        self._nodes[node_id].kill()

    def _make_ha_handler(self, node_id: str):
        def handler(kind: str, subject: str, info: Dict):
            if kind != "evict":
                return
            # a device eviction whose local repair re-silvered *nothing*
            # means the node had no healthy devices to absorb the data —
            # the whole node is down, not one device (a healthy node
            # repairs a single device failure locally, no ring change)
            repair_dead = (info.get("affected", 0) > 0
                           and not info.get("repaired", 0))
            with self._lock:
                devs = self._dev_evictions.setdefault(node_id, set())
                devs.add(subject)
                node_dead = (repair_dead
                             or len(devs) >= self.node_fail_device_evictions)
            if node_dead:
                self.evict_node(node_id)
        return handler

    # ------------------------------------------------------------------
    # node / placement queries
    # ------------------------------------------------------------------

    def node(self, node_id: str) -> StorageNode:
        return self._nodes[node_id]

    def all_nodes(self) -> List[StorageNode]:
        with self._lock:
            return list(self._nodes.values())

    def alive_nodes(self) -> List[StorageNode]:
        with self._lock:
            return [n for n in self._nodes.values() if n.alive]

    def any_alive_node(self) -> StorageNode:
        nodes = self.alive_nodes()
        if not nodes:
            raise IOError("no live storage nodes")
        return nodes[0]

    def owners_of(self, oid: str) -> List[str]:
        with self._lock:
            return self.ring.owners(oid, self.replicas)

    def primary_of(self, oid: str) -> Optional[str]:
        with self._lock:
            try:
                return self.ring.owners(oid, 1)[0]
            except IOError:
                return None

    def _cluster_version(self, node: StorageNode, oid: str) -> int:
        try:
            return node.store.meta(oid).attrs.get("cluster_version", 0)
        except KeyError:
            return -1

    def route_candidates(self, oid: str) -> List[StorageNode]:
        """Live nodes holding ``oid``, freshest replica first (ring
        owners break ties ahead of stray holders mid-rebalance).  A
        killed-but-not-yet-evicted node still appears — routing to it is
        what surfaces the failure to its HAMonitor.  Raises KeyError
        when no live node holds the object.

        Steady state short-circuits on the ring owners alone (every
        owner alive, holding, version-agreed); any anomaly — a missing,
        dead, or diverged owner — widens to a scan of every live node so
        stray replicas mid-rebalance still serve."""
        with self._lock:
            try:
                owner_ids = self.ring.owners(oid, self.replicas)
            except IOError:
                owner_ids = []
            owners = [self._nodes[nid] for nid in owner_ids
                      if nid in self._nodes and self._nodes[nid].alive]
        rank = {nid: i for i, nid in enumerate(owner_ids)}
        holders = [(n, self._cluster_version(n, oid)) for n in owners
                   if n.store.exists(oid)]
        settled = (len(holders) == len(owner_ids) and holders
                   and len({v for _, v in holders}) == 1)
        if not settled:
            with self._lock:
                rest = [n for n in self._nodes.values()
                        if n.alive and n.node_id not in rank]
            holders += [(n, self._cluster_version(n, oid)) for n in rest
                        if n.store.exists(oid)]
        if not holders:
            raise KeyError(oid)
        holders.sort(key=lambda t: (-t[1],
                                    rank.get(t[0].node_id, len(rank)),
                                    t[0].node_id))
        return [n for n, _ in holders]

    def freshest_holder(self, oid: str) -> StorageNode:
        return self.route_candidates(oid)[0]

    def live_holders(self, oid: str) -> List[StorageNode]:
        with self._lock:
            nodes = [n for n in self._nodes.values() if n.alive]
        return [n for n in nodes if n.store.exists(oid)]

    # ------------------------------------------------------------------
    # replicated data path
    # ------------------------------------------------------------------

    def put_array(self, oid: str, arr, container: str = "default",
                  layout: Optional[lay.Layout] = None, txn=None):
        arr = np.asarray(arr)
        owners = self.owners_of(oid)
        version = next(self._vclock)
        wrote = 0
        for nid in owners:
            node = self._nodes[nid]
            if not node.alive:
                continue
            node.clovis.put_array(oid, arr, container=container,
                                  layout=layout)
            node.store.meta(oid).attrs["cluster_version"] = version
            wrote += 1
        if not wrote:
            raise IOError(f"no live replica target for {oid}")
        with self._lock:
            self._objects[oid] = container
        self.store._emit("write", oid, {"container": container})
        self.store._notify_write(oid, arr.nbytes)

    def put(self, oid: str, data: bytes, container: str = "default",
            layout: Optional[lay.Layout] = None):
        owners = self.owners_of(oid)
        version = next(self._vclock)
        wrote = 0
        for nid in owners:
            node = self._nodes[nid]
            if not node.alive:
                continue
            if not node.clovis.exists(oid):
                node.clovis.create(oid, layout=layout, container=container)
            node.clovis.put(oid, data)
            node.store.meta(oid).attrs["cluster_version"] = version
            wrote += 1
        if not wrote:
            raise IOError(f"no live replica target for {oid}")
        with self._lock:
            self._objects[oid] = container
        self.store._emit("write", oid, {"container": container})
        self.store._notify_write(oid, len(data))

    def _read_via(self, oid: str, reader) -> Any:
        last_err: Optional[Exception] = None
        for node in self.route_candidates(oid):
            try:
                value = reader(node)
            except (IOError, OSError, KeyError) as e:
                last_err = e
                continue
            self._read_repair(oid, node)
            return value
        raise last_err or IOError(f"no live replica served {oid}")

    def get_array(self, oid: str, _notify: bool = True) -> np.ndarray:
        return self._read_via(
            oid, lambda n: n.clovis.get_array(oid, _notify=_notify))

    def get(self, oid: str, _notify: bool = True) -> bytes:
        return self._read_via(
            oid, lambda n: n.clovis.get(oid, _notify=_notify))

    def materialize(self, oid: str, _notify: bool = True) -> np.ndarray:
        if self.store.meta(oid).attrs.get("kind") == "array":
            return self.get_array(oid, _notify=_notify)
        return np.frombuffer(self.get(oid, _notify=_notify), dtype=np.uint8)

    def delete(self, oid: str):
        for node in self.all_nodes():
            if node.alive and node.store.exists(oid):
                try:
                    node.clovis.delete(oid)
                except KeyError:
                    pass
        with self._lock:
            self._objects.pop(oid, None)
        self.store._emit("delete", oid, {})

    def exists(self, oid: str) -> bool:
        with self._lock:
            return oid in self._objects

    def container(self, name: str) -> List[str]:
        with self._lock:
            return sorted(o for o, c in self._objects.items() if c == name)

    def _read_repair(self, oid: str, fresh: StorageNode):
        """Bring the ring owners' replicas up to the copy just served:
        missing or version-stale owners get re-silvered from it.  Runs
        inline on the read path (replica divergence is only observable
        at read time), recorded as ``read_repair`` in the HA trace."""
        try:
            owners = self.owners_of(oid)
        except IOError:
            return
        fresh_v = self._cluster_version(fresh, oid)
        for nid in owners:
            node = self._nodes.get(nid)
            if node is None or node is fresh or not node.alive:
                continue
            if self._cluster_version(node, oid) >= fresh_v:
                continue
            try:
                nbytes = self._copy_object(oid, fresh, node)
            except (IOError, OSError, KeyError):
                continue
            self.addb.record_ha("read_repair", oid, detail=nid,
                                nbytes=nbytes)

    # ------------------------------------------------------------------
    # rebalance execution (ring-delta partition movement)
    # ------------------------------------------------------------------

    def _ownership(self) -> Dict[str, List[str]]:
        if not len(self.ring) or not self._objects:
            return {}
        return self.ring.owner_map(list(self._objects), self.replicas)

    def _copy_object(self, oid: str, src: StorageNode, dst: StorageNode
                     ) -> int:
        """Replicate one object src -> dst, preserving logical bytes,
        layout, and attrs (including the cluster version stamp).
        Internal reads: replication must not pollute heat/stats."""
        smeta = src.store.meta(oid)
        raw = src.clovis.get(oid, _notify=False)
        if not dst.store.exists(oid):
            dst.store.create_object(oid, block_size=smeta.block_size,
                                    layout=smeta.layout,
                                    container=smeta.container,
                                    attrs=dict(smeta.attrs))
        dst.store.write(oid, raw)
        dst.store.meta(oid).attrs.update(smeta.attrs)
        return len(raw)

    def _execute_moves(self, moves: List[Move]) -> Dict:
        """Apply a rebalance plan: copy each moved partition to its new
        owners from a surviving source, then drop replicas that lost
        ownership.  Exactly the plan's keys move — nothing else."""
        partitions = 0
        nbytes = 0
        with self._rebalance_lock:
            for mv in moves:
                src = None
                for nid in mv.keep:
                    cand = self._nodes.get(nid)
                    if (cand is not None and cand.alive
                            and cand.store.exists(mv.key)):
                        src = cand
                        break
                if src is None:
                    # e.g. graceful leave where the leaving node was the
                    # only keeper: any live holder (it is still alive)
                    try:
                        src = self.freshest_holder(mv.key)
                    except KeyError:
                        continue        # partition lost beyond K failures
                moved = False
                for nid in mv.add:
                    dst = self._nodes.get(nid)
                    if dst is None or not dst.alive:
                        continue
                    try:
                        nbytes += self._copy_object(mv.key, src, dst)
                        moved = True
                    except (IOError, OSError, KeyError):
                        continue
                for nid in mv.drop:
                    gone = self._nodes.get(nid)
                    if gone is None or not gone.alive:
                        continue
                    try:
                        gone.store.delete_object(mv.key)
                        moved = True
                    except KeyError:
                        pass
                if moved:
                    partitions += 1
        return {"partitions": partitions, "bytes": nbytes,
                "moves": moves}

    # ------------------------------------------------------------------
    # analytics (node-aware cost planning)
    # ------------------------------------------------------------------

    def tier_params_of(self, oid: str) -> Optional[TierParams]:
        """Per-partition TierParams for the cost model: the *owning*
        node's tier map entry for the tier the partition lives on,
        with read bandwidth replaced by the node's observed effective
        fragment bandwidth once the StatsCatalog has samples."""
        try:
            node = self.freshest_holder(oid)
            tier = node.store.meta(oid).layout.tier
        except KeyError:
            return None
        base = tier_params(node.store).get(tier)
        catalog = self._stats_catalog
        if base is None or catalog is None:
            return base
        observed = catalog.node_read_bw(node.node_id)
        if observed is None:
            return base
        return dataclasses.replace(base, read_bw=observed)

    def analytics(self, *, engine_cls=None,
                  **kw) -> "ClusterAnalyticsEngine":
        """Cluster analytics engine: the standard AnalyticsEngine over
        the ClusterStore facade and the routed ClusterShipper, with
        per-partition node-aware cost planning.  All engines share one
        StatsCatalog (pass ``stats=`` to override).  ``engine_cls``
        swaps in a ClusterAnalyticsEngine subclass (the serving front
        door uses it)."""
        from repro_torch.analytics import StatsCatalog
        if "stats" not in kw:
            with self._lock:
                if self._stats_catalog is None:
                    self._stats_catalog = StatsCatalog().attach(self.store)
                    self.shipper.stats = self._stats_catalog
            kw["stats"] = self._stats_catalog
        kw.setdefault("shipper", self.shipper)
        kw.setdefault("max_workers", 4 * max(len(self.ring), 1))
        cls = engine_cls or ClusterAnalyticsEngine
        return cls(self, **kw)

    @property
    def manifests(self) -> "ManifestRegistry":
        """Shared per-container manifest registry (see
        ``Clovis.manifests``) — manifest objects are plain cluster
        objects, so commits replicate K-way like any other write."""
        from repro_torch.compaction import ManifestRegistry
        with self._lock:
            if self._manifests is None:
                self._manifests = ManifestRegistry(self)
            return self._manifests

    def compaction(self, **kw) -> "CompactionService":
        """Log-structured compaction over the cluster (see
        ``Clovis.compaction`` and docs/compaction.md): delta and merged
        blocks replicate K-way, and every manifest commit is itself a
        replicated write — a dead node never loses the container's
        snapshot identity."""
        from repro_torch.compaction import CompactionService
        kw.setdefault("catalog", self._stats_catalog)
        return CompactionService(self, **kw)

    def serving(self, tenants=(), **kw) -> "QueryService":
        """Multi-tenant serving front door over the cluster: the same
        QueryService as ``Clovis.serving`` but executing through the
        routed ClusterShipper with node-aware cost planning and
        replica failover (see docs/serving.md)."""
        from repro_torch.serving import QueryService
        return QueryService(self, tenants, **kw)

    # ------------------------------------------------------------------

    def addb_report(self) -> Dict:
        return self.addb.throughput_report()

    def close(self):
        self.shipper.shutdown()
        for node in self.all_nodes():
            node.close()


class ClusterAnalyticsEngine(AnalyticsEngine):
    """AnalyticsEngine specialised for a cluster: identical execution
    machinery, but each partition is costed with the owning node's
    (observed-bandwidth-blended) TierParams via CostContext.tier_of."""

    def __init__(self, cluster: ClusterClovis, **kw):
        super().__init__(cluster, **kw)
        self.cluster = cluster

    def _make_plan(self, ds, oids):
        push = self._can_push(ds)
        ctx = None
        if push and self.cost_based:
            ctx = CostContext(model=self.cost_model, store=self.clovis.store,
                              oids=oids, catalog=self.stats,
                              load=self._load(oids),
                              cache_probe=self._cache_probe,
                              tier_of=self.cluster.tier_params_of)
        return optimize(ds.ops, pushdown=push, cost_ctx=ctx)

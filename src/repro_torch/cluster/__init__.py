"""repro_torch.cluster — scale-out storage cluster (docs/cluster.md).

DHT placement over a consistent-hash ring with virtual nodes and
failure domains, K-way replication with read-repair, ring-delta
rebalance on join/leave, and HA-driven query failover: a node killed
mid-scan is evicted from the ring by its own HAMonitor's device-burst
escalation while the ClusterShipper re-routes in-flight fragments to
replicas — results stay byte-identical.
"""
from repro_torch.cluster.cluster import (ClusterAnalyticsEngine, ClusterClovis,
                                         ClusterStore)
from repro_torch.cluster.node import StorageNode
from repro_torch.cluster.ring import (HashRing, Move, plan_rebalance,
                                      stable_hash)
from repro_torch.cluster.shipper import ClusterShipper

__all__ = [
    "ClusterAnalyticsEngine", "ClusterClovis", "ClusterShipper",
    "ClusterStore", "HashRing", "Move", "StorageNode", "plan_rebalance",
    "stable_hash",
]

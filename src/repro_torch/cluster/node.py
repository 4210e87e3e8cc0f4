"""One simulated storage node — a complete single-node SAGE stack.

A node owns its own tier pools (devices on its own directory subtree),
its own ObjectStore + Clovis facade, a FunctionShipper whose executors
model the node's local CPUs, and an HAMonitor watching the node's
devices.  Its fragments' kernels run on the ``device`` the cluster hands
it (every node of one process shares the card).  Only the ADDB is shared
cluster-wide: telemetry from every node lands in one trace, which is
what lets a benchmark (or operator) see a query's fragments re-route
across nodes.

``kill()`` models abrupt whole-node loss: every device fails at once,
so in-flight local reads raise and escalate through the node's own
HAMonitor — the cluster layer subscribes to those decisions and turns
a burst of device evictions into a ring eviction (cluster.py).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

from repro_torch.core.addb import Addb
from repro_torch.core.clovis import Clovis
from repro_torch.core.function_shipping import FunctionShipper
from repro_torch.core.ha import HAMonitor
from repro_torch.device import DeviceLike


class StorageNode:
    def __init__(self, node_id: str, domain: str, root: Path, *,
                 addb: Optional[Addb] = None, devices_per_tier: int = 2,
                 throttle: bool = False, ship_workers: int = 2,
                 ha_error_threshold: int = 2, device: DeviceLike = None):
        self.node_id = node_id
        self.domain = domain
        self.root = Path(root)
        self.clovis = Clovis(self.root, addb=addb,
                             devices_per_tier=devices_per_tier,
                             throttle=throttle, device=device)
        self.store = self.clovis.store
        self.shipper = FunctionShipper(self.clovis, max_workers=ship_workers)
        self.ha = HAMonitor(self.store, error_threshold=ha_error_threshold)
        # True until the cluster evicts the node from the placement ring;
        # a freshly-killed node keeps alive=True so reads still route to
        # it, fail, and drive the organic HA eviction chain
        self.alive = True

    def kill(self):
        """Abrupt node failure: every device fails.  Metadata stays in
        memory (routing still *finds* the node), but any read raises —
        the failure is discovered by traffic, exactly how a real node
        loss surfaces."""
        for pool in self.store.pools.values():
            for d in pool.devices:
                d.fail()

    def close(self):
        self.shipper.shutdown()

    def __repr__(self):
        return (f"StorageNode({self.node_id!r}, domain={self.domain!r}, "
                f"alive={self.alive})")

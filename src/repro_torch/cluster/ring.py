"""Consistent-hash ring — DHT object placement across storage nodes
(paper §3.2.1: Mero places objects via hashing over the cluster, and
containers are replicated across failure domains).

Every node is projected onto the ring ``vnodes`` times (virtual nodes
smooth the load split when node counts are small or nodes join/leave),
and a key's owners are the first K *distinct* nodes found walking
clockwise from the key's hash — preferring distinct failure domains, so
a K-way replicated partition survives the loss of a whole domain (rack /
PSU / switch), not just a single device.

Consistent hashing's defining property — join/leave moves only the
ring-delta keys, ~1/N of the data, never a full reshuffle — is what
``plan_rebalance`` computes: the exact per-key replica additions and
removals between two ownership maps.
"""
from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


def stable_hash(s: str) -> int:
    """Deterministic 64-bit hash (process-seed independent, unlike
    ``hash()``) — placement must be identical across runs and hosts."""
    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(),
                          "big")


class HashRing:
    """Consistent-hash ring with virtual nodes and failure domains."""

    def __init__(self, vnodes: int = 64):
        if vnodes <= 0:
            raise ValueError("vnodes must be positive")
        self.vnodes = vnodes
        self._domains: Dict[str, str] = {}          # node_id -> domain
        self._points: List[int] = []                # sorted vnode hashes
        self._owners_at: Dict[int, str] = {}        # vnode hash -> node_id
        # owners() memo — placement is looked up several times per
        # partition per query (planner, scheduler, router); membership
        # changes invalidate it wholesale
        self._owner_cache: Dict[Tuple[str, int], List[str]] = {}

    # -- membership ----------------------------------------------------

    def add_node(self, node_id: str, domain: Optional[str] = None):
        if node_id in self._domains:
            raise KeyError(f"node {node_id} already on the ring")
        self._domains[node_id] = domain or node_id
        for v in range(self.vnodes):
            h = stable_hash(f"{node_id}#{v}")
            while h in self._owners_at:              # vanishing-probability
                h = (h + 1) & (2 ** 64 - 1)          # collision: nudge
            self._owners_at[h] = node_id
            bisect.insort(self._points, h)
        self._owner_cache.clear()

    def remove_node(self, node_id: str):
        if node_id not in self._domains:
            raise KeyError(f"node {node_id} not on the ring")
        del self._domains[node_id]
        dead = [h for h, n in self._owners_at.items() if n == node_id]
        for h in dead:
            del self._owners_at[h]
        self._points = sorted(self._owners_at)
        self._owner_cache.clear()

    def nodes(self) -> List[str]:
        return sorted(self._domains)

    def domain_of(self, node_id: str) -> str:
        return self._domains[node_id]

    def __contains__(self, node_id: str) -> bool:
        return node_id in self._domains

    def __len__(self) -> int:
        return len(self._domains)

    # -- placement -----------------------------------------------------

    def owners(self, key: str, k: int = 1) -> List[str]:
        """The K replica owners of ``key``: walk clockwise from the
        key's hash, taking the first node of each not-yet-used failure
        domain; if fewer than K domains exist, a second pass fills the
        remainder with distinct nodes regardless of domain.  The first
        owner is the primary."""
        if not self._points:
            raise IOError("ring is empty — no storage nodes")
        k = min(k, len(self._domains))
        cached = self._owner_cache.get((key, k))
        if cached is not None:
            return list(cached)
        n_nodes = len(self._domains)
        n_domains = len(set(self._domains.values()))
        start = bisect.bisect_right(self._points, stable_hash(key))
        npts = len(self._points)
        # single incremental walk: pass-1 picks the first node of each
        # new failure domain, nodes from already-used domains queue as
        # pass-2 fill in walk order — identical selection to collecting
        # all distinct nodes first, but it stops as soon as the outcome
        # is decided (the walk is O(ring) in the worst case and a few
        # steps in the common one)
        chosen: List[str] = []
        fill: List[str] = []
        used_domains = set()
        seen = set()
        for i in range(npts):
            node = self._owners_at[self._points[(start + i) % npts]]
            if node in seen:
                continue
            seen.add(node)
            dom = self._domains[node]
            if dom not in used_domains:
                used_domains.add(dom)
                chosen.append(node)
                if len(chosen) == k:
                    break
            else:
                fill.append(node)
            if (len(used_domains) == n_domains
                    and len(chosen) + len(fill) >= k):
                break
            if len(seen) == n_nodes:
                break
        chosen = (chosen + fill)[:k]
        self._owner_cache[(key, k)] = chosen
        return list(chosen)

    def owner_map(self, keys: Sequence[str], k: int = 1
                  ) -> Dict[str, List[str]]:
        return {key: self.owners(key, k) for key in keys}


@dataclass(frozen=True)
class Move:
    """One key's replica-set change between two ring states."""
    key: str
    add: Tuple[str, ...]        # nodes that must gain a copy
    drop: Tuple[str, ...]       # nodes that no longer own a copy
    keep: Tuple[str, ...]       # surviving owners (copy sources)


def plan_rebalance(before: Dict[str, List[str]],
                   after: Dict[str, List[str]]) -> List[Move]:
    """The exact delta between two ownership maps — the only data a
    join/leave may move.  Keys whose replica set is unchanged do not
    appear (consistent hashing guarantees that is ~(N-1)/N of them on a
    single-node change)."""
    moves: List[Move] = []
    for key in sorted(after):
        old = before.get(key, [])
        new = after[key]
        add = tuple(n for n in new if n not in old)
        drop = tuple(n for n in old if n not in new)
        if add or drop:
            moves.append(Move(key, add, drop,
                              tuple(n for n in old if n in new)))
    return moves

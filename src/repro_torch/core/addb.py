"""ADDB — Analysis and Diagnostics Data Base (paper §3.2.2).

Structured telemetry records for every store operation, consumed by the
benchmark harness (the paper feeds these to ARM Forge) and by the HA /
HSM subsystems (latency percentiles drive straggler detection and
placement demotion).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional


@dataclass(frozen=True)
class AddbRecord:
    ts: float
    op: str                # put | get | delete | idx_put | idx_get | ...
    entity: str            # object / index id
    device: str            # device name or '-'
    nbytes: int
    latency_s: float
    ok: bool = True


class Addb:
    """Bounded in-memory record store with per-device aggregation."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = capacity
        self._records: Deque[AddbRecord] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._subscribers: List[Callable[[AddbRecord], None]] = []

    def record(self, op: str, entity: str, device: str, nbytes: int,
               latency_s: float, ok: bool = True):
        rec = AddbRecord(time.time(), op, entity, device, nbytes, latency_s, ok)
        with self._lock:
            self._records.append(rec)
            subs = list(self._subscribers)
        for fn in subs:
            try:
                fn(rec)
            except Exception:
                pass   # subscribers must not break the I/O path

    def subscribe(self, fn: Callable[[AddbRecord], None]):
        with self._lock:
            self._subscribers.append(fn)

    def records(self, op: Optional[str] = None) -> List[AddbRecord]:
        with self._lock:
            recs = list(self._records)
        if op:
            recs = [r for r in recs if r.op == op]
        return recs

    def window(self, since_s: float, op: Optional[str] = None
               ) -> List[AddbRecord]:
        """Records from the trailing ``since_s`` seconds (newest last)."""
        cutoff = time.time() - since_s
        return [r for r in self.records(op) if r.ts >= cutoff]

    def to_arrays(self, since_s: Optional[float] = None,
                  op: Optional[str] = None) -> Dict[str, "np.ndarray"]:
        """Columnar view of (optionally time-windowed) records as numpy
        arrays — the percipience feature extractor and benchmark reports
        consume this instead of iterating AddbRecord objects."""
        import numpy as np
        recs = (self.window(since_s, op) if since_s is not None
                else self.records(op))
        return {
            "ts": np.array([r.ts for r in recs], np.float64),
            "op": np.array([r.op for r in recs], dtype=object),
            "entity": np.array([r.entity for r in recs], dtype=object),
            "device": np.array([r.device for r in recs], dtype=object),
            "nbytes": np.array([r.nbytes for r in recs], np.int64),
            "latency_s": np.array([r.latency_s for r in recs], np.float64),
            "ok": np.array([r.ok for r in recs], bool),
        }

    # ---- analytics plan decision trace ----

    def record_decision(self, query: str, oid: str, mode: str,
                        est_bytes: int, est_s: float):
        """Record one per-partition placement decision of the analytics
        cost-based optimizer (op ``analytics_plan``): ``mode`` is
        ship | fetch | cached, ``est_bytes`` the predicted bytes crossing
        to the caller, ``est_s`` the predicted partition cost.  The
        decision trace is how chosen-plan quality is audited after the
        fact (bench_analytics compares it against the always-push and
        always-fetch oracles)."""
        self.record("analytics_plan", f"{query}:{oid}", mode,
                    int(est_bytes), float(est_s))

    def plan_trace(self, query: Optional[str] = None) -> List[Dict]:
        """Decision-trace records as dicts (optionally for one query tag),
        oldest first: {query, oid, mode, est_bytes, est_s}."""
        out: List[Dict] = []
        for r in self.records("analytics_plan"):
            q, _, oid = r.entity.partition(":")
            if query is not None and q != query:
                continue
            out.append({"query": q, "oid": oid, "mode": r.device,
                        "est_bytes": r.nbytes, "est_s": r.latency_s})
        return out

    # ---- HA repair-engine decision trace ----

    def record_ha(self, kind: str, subject: str, detail: str = "-",
                  nbytes: int = 0, latency_s: float = 0.0, ok: bool = True):
        """Record one HA repair-engine decision (op ``ha_decision``):
        ``kind`` is repair | evict | scrub | straggler, ``subject`` the
        device (repair/evict/straggler) or object (scrub) acted on.
        The trace is how automated repair stays auditable — the cluster
        layer reads it next to the analytics plan trace when diagnosing
        a failover (docs/cluster.md)."""
        self.record("ha_decision", f"{kind}:{subject}", detail,
                    int(nbytes), float(latency_s), ok)

    def ha_trace(self, kind: Optional[str] = None) -> List[Dict]:
        """HA decision records as dicts (optionally one kind), oldest
        first: {kind, subject, detail, n, latency_s, ok}."""
        out: List[Dict] = []
        for r in self.records("ha_decision"):
            k, _, subject = r.entity.partition(":")
            if kind is not None and k != kind:
                continue
            out.append({"kind": k, "subject": subject, "detail": r.device,
                        "n": r.nbytes, "latency_s": r.latency_s, "ok": r.ok})
        return out

    # ---- cluster fragment-routing trace ----

    def record_route(self, oid: str, node: str, *, rerouted: bool,
                     nbytes: int = 0, latency_s: float = 0.0,
                     ok: bool = True):
        """Record one cluster-routed fragment/read (op
        ``cluster_route``): which node actually served object ``oid``,
        and whether it was the ring primary or a replica reached by
        failover re-routing.  Together with ``plan_trace`` this is the
        evidence a kill-a-node-mid-scan run really took the replica
        path (bench_cluster asserts on it)."""
        self.record("cluster_route", oid,
                    f"{'reroute' if rerouted else 'primary'}:{node}",
                    int(nbytes), float(latency_s), ok)

    def route_trace(self, oid: Optional[str] = None) -> List[Dict]:
        """Cluster routing records as dicts (optionally one object),
        oldest first: {oid, node, rerouted, nbytes, latency_s, ok}."""
        out: List[Dict] = []
        for r in self.records("cluster_route"):
            if oid is not None and r.entity != oid:
                continue
            mode, _, node = r.device.partition(":")
            out.append({"oid": r.entity, "node": node,
                        "rerouted": mode == "reroute", "nbytes": r.nbytes,
                        "latency_s": r.latency_s, "ok": r.ok})
        return out

    # ---- continuous-query window trace ----

    def record_window(self, query: str, stream_id: str, window_start: float,
                      rows: int, latency_s: float):
        """Record one emitted window of a continuous query (op
        ``stream_window``): ``rows`` is how many elements the window
        aggregated and ``latency_s`` the emit latency — emit wall time
        minus the wall time the merged watermark crossed the window's
        close threshold.  Percipience reads this trace the same way it
        reads I/O latencies: consistently slow window emits mean the
        incremental operator (or its delta kernels) cannot keep up with
        the stream and lateness budgets need retuning.  (Late elements
        are per query, not per emitted window — the continuous query's
        late side channel accounts them.)"""
        self.record("stream_window", f"{query}:{stream_id}:{window_start!r}",
                    "emit", int(rows), float(latency_s))

    def window_trace(self, query: Optional[str] = None) -> List[Dict]:
        """Emitted-window records as dicts (optionally for one query
        tag), oldest first: {query, stream_id, window_start, rows,
        emit_latency_s}."""
        out: List[Dict] = []
        for r in self.records("stream_window"):
            q, _, rest = r.entity.partition(":")
            if query is not None and q != query:
                continue
            sid, _, start = rest.rpartition(":")
            out.append({"query": q, "stream_id": sid,
                        "window_start": float(start),
                        "rows": r.nbytes,
                        "emit_latency_s": r.latency_s})
        return out

    # ---- edge-ingestion trace ----

    def record_edge(self, kind: str, source: str, detail: str = "-",
                    n: int = 0, latency_s: float = 0.0, ok: bool = True):
        """Record one edge-ingestion event (op ``edge_ingest``):
        ``kind`` is applied | duplicate | dlq | replay | backpressure |
        prune, ``source`` the durable producer buffer it came from.
        The dead-letter channel's poison-event count is *this* trace
        filtered to ``kind="dlq"`` — undecodable instrument data is
        routed and visible, never silently shed (docs/ingestion.md)."""
        self.record("edge_ingest", f"{kind}:{source}", detail,
                    int(n), float(latency_s), ok)

    def edge_trace(self, kind: Optional[str] = None) -> List[Dict]:
        """Edge-ingestion records as dicts (optionally one kind),
        oldest first: {kind, source, detail, n, latency_s, ok}."""
        out: List[Dict] = []
        for r in self.records("edge_ingest"):
            k, _, source = r.entity.partition(":")
            if kind is not None and k != kind:
                continue
            out.append({"kind": k, "source": source, "detail": r.device,
                        "n": r.nbytes, "latency_s": r.latency_s,
                        "ok": r.ok})
        return out

    # ---- compaction trace ----

    def record_compaction(self, kind: str, container: str,
                          detail: str = "-", nbytes: int = 0,
                          latency_s: float = 0.0, ok: bool = True):
        """Record one compaction-subsystem event (op ``compaction``):
        ``kind`` is append | merge | gc | recover, ``container`` the
        manifest-managed container, ``detail`` the block oid (append /
        merge) or a count (gc / recover).  The trace is the compactor's
        runbook surface: merged bytes, GC churn, and crash-recovery
        sweeps read straight out of ADDB (docs/compaction.md)."""
        self.record("compaction", f"{kind}:{container}", detail,
                    int(nbytes), float(latency_s), ok)

    def compaction_trace(self, kind: Optional[str] = None) -> List[Dict]:
        """Compaction records as dicts (optionally one kind), oldest
        first: {kind, container, detail, nbytes, latency_s, ok}."""
        out: List[Dict] = []
        for r in self.records("compaction"):
            k, _, container = r.entity.partition(":")
            if kind is not None and k != kind:
                continue
            out.append({"kind": k, "container": container,
                        "detail": r.device, "nbytes": r.nbytes,
                        "latency_s": r.latency_s, "ok": r.ok})
        return out

    # ---- serving front-door trace ----

    def record_serving(self, query: str, stage: str, tenant: str,
                       nbytes: int = 0, latency_s: float = 0.0,
                       ok: bool = True):
        """Record one stage of a front-door query's lifecycle (op
        ``serving``): ``stage`` is admit | queue | plan | execute |
        merge | done | shed, ``tenant`` the charged tenant, ``nbytes``
        the stage's bytes (estimate at admit, moved at execute, actual
        scanned at done).  The per-stage trace is what makes a p99
        attributable: queue time vs plan time vs store time read
        straight out of ADDB (docs/serving.md)."""
        self.record("serving", f"{query}:{stage}", tenant,
                    int(nbytes), float(latency_s), ok)

    def serving_trace(self, query: Optional[str] = None) -> List[Dict]:
        """Serving-stage records as dicts (optionally for one query
        tag), oldest first: {query, stage, tenant, nbytes, latency_s,
        ok}."""
        out: List[Dict] = []
        for r in self.records("serving"):
            q, _, stage = r.entity.rpartition(":")
            if query is not None and q != query:
                continue
            out.append({"query": q, "stage": stage, "tenant": r.device,
                        "nbytes": r.nbytes, "latency_s": r.latency_s,
                        "ok": r.ok})
        return out

    # ---- aggregations (ARM-Forge-style performance report) ----

    def device_latency_percentile(self, pct: float = 0.99
                                  ) -> Dict[str, float]:
        by_dev: Dict[str, List[float]] = defaultdict(list)
        for r in self.records():
            if r.device != "-":
                by_dev[r.device].append(r.latency_s)
        out = {}
        for dev, lats in by_dev.items():
            lats.sort()
            out[dev] = lats[min(int(pct * len(lats)), len(lats) - 1)]
        return out

    def throughput_report(self) -> Dict[str, Dict[str, float]]:
        agg: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"ops": 0, "bytes": 0, "time": 0.0})
        for r in self.records():
            a = agg[r.op]
            a["ops"] += 1
            a["bytes"] += r.nbytes
            a["time"] += r.latency_s
        for a in agg.values():
            a["bw_bytes_per_s"] = a["bytes"] / a["time"] if a["time"] else 0.0
        return dict(agg)


GLOBAL_ADDB = Addb()

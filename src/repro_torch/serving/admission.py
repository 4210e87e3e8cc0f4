"""Admission control for the query front door — per-tenant token-bucket
quotas and a deficit-round-robin weighted-fair queue.

Bell/Gray/Szalay's balance argument (cs/0701165) applied to SAGE: a
data-centric system is only as good as the front door that rations its
bandwidth.  Every query is charged **at admit time** against the cost
model's estimates (bytes the store will scan, seconds of store compute)
and **reconciled at completion** against the actual ``QueryStats`` —
over-estimates are refunded, under-estimates debited, so buckets track
reality without trusting either side alone.

Two typed shed paths keep overload from smearing across tenants:

  * ``QuotaExceeded``   — the tenant's own token bucket is dry; only
    that tenant waits for refill, everyone else is untouched;
  * ``AdmissionRejected`` — the tenant's queue bound is hit (or the
    service is shutting down); backlog is bounded per tenant, so one
    flooding tenant cannot grow everyone's tail.

``FairQueue`` is a classic deficit round-robin scheduler over per-
tenant FIFOs: each round a tenant's deficit grows by
``quantum * priority`` and it drains queries while the deficit covers
their estimated byte cost — long-run service is proportional to
priority regardless of per-query sizes (measured as a Jain index in
``bench_serving``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serving.schema import ServingError, TenantConfig

DEFAULT_BURST_S = 4.0             # bucket capacity: this many seconds of refill


class AdmissionRejected(ServingError):
    """Load shed: per-tenant queue bound hit (or service closed)."""


class QuotaExceeded(AdmissionRejected):
    """The tenant's byte or compute token bucket cannot cover the
    query's estimated cost right now."""


class DeadlineExceeded(ServingError):
    """The query's deadline passed while it sat in the queue."""


class TokenBucket:
    """Monotonic-clock token bucket.  ``inf`` rate means unmetered.

    ``reconcile`` settles estimate-vs-actual at completion: refunds cap
    at the burst size, debits may push the level negative — a tenant
    that under-estimated pays it back out of future refill before
    admitting anything new.
    """

    def __init__(self, rate: float, burst: Optional[float] = None):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None
                           else (rate * DEFAULT_BURST_S
                                 if rate != float("inf") else float("inf")))
        self._level = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self):
        now = time.monotonic()
        if self.rate != float("inf"):
            self._level = min(self.burst,
                              self._level + (now - self._t) * self.rate)
        self._t = now

    @property
    def level(self) -> float:
        with self._lock:
            self._refill()
            return self._level

    def try_charge(self, n: float) -> bool:
        """Debit ``n`` tokens if the bucket covers them; False otherwise
        (never blocks — admission sheds instead of queueing on quota)."""
        if self.rate == float("inf"):
            return True
        with self._lock:
            self._refill()
            if self._level < n:
                return False
            self._level -= n
            return True

    def reconcile(self, estimated: float, actual: float):
        """Settle a completed (or shed) query: refund ``estimated -
        actual`` (negative refund = extra debit)."""
        if self.rate == float("inf"):
            return
        with self._lock:
            self._refill()
            self._level = min(self.burst, self._level + estimated - actual)


@dataclass
class _TenantState:
    cfg: TenantConfig
    bytes_bucket: TokenBucket
    compute_bucket: TokenBucket
    queue: deque = field(default_factory=deque)
    deficit: float = 0.0
    shed: Dict[str, int] = field(default_factory=lambda: {
        "quota": 0, "queue_full": 0, "deadline": 0})
    admitted: int = 0
    completed: int = 0
    bytes_served: float = 0.0


def _make_state(cfg: TenantConfig) -> _TenantState:
    return _TenantState(
        cfg,
        TokenBucket(cfg.byte_quota_per_s, cfg.byte_burst),
        TokenBucket(cfg.compute_quota_per_s, cfg.compute_burst))


class FairQueue:
    """Deficit-round-robin weighted-fair queue over per-tenant FIFOs.

    ``push`` enqueues an item with its byte cost; ``pop`` serves one
    item per call (latency fairness across worker threads) choosing the
    tenant whose deficit covers its head-of-line cost, topping deficits
    by ``quantum * priority`` per visited round.  Items must expose
    nothing — cost is passed explicitly; the queue never inspects them.
    """

    def __init__(self, tenants: Dict[str, _TenantState],
                 quantum: float = 256 << 10):
        if not quantum > 0:
            raise ValueError("quantum must be > 0")
        self._tenants = tenants
        self.quantum = float(quantum)
        self._active: deque = deque()          # tenant ids with backlog
        self._cond = threading.Condition()
        self._closed = False

    def push(self, tenant: str, item: Any, cost: float):
        with self._cond:
            if self._closed:
                raise AdmissionRejected("service is shutting down")
            st = self._tenants[tenant]
            st.queue.append((item, max(float(cost), 1.0)))
            if tenant not in self._active:
                self._active.append(tenant)
            self._cond.notify()

    def _select(self) -> Optional[Any]:
        while self._active:
            tid = self._active[0]
            st = self._tenants.get(tid)
            if st is None or not st.queue:
                self._active.popleft()
                if st is not None:
                    st.deficit = 0.0
                continue
            item, cost = st.queue[0]
            if st.deficit >= cost:
                st.queue.popleft()
                st.deficit -= cost
                self._active.rotate(-1)
                if not st.queue:
                    # drop idle tenants from the round and zero their
                    # deficit: an empty queue must not bank credit
                    st.deficit = 0.0
                    try:
                        self._active.remove(tid)
                    except ValueError:
                        pass
                return item
            st.deficit += self.quantum * st.cfg.priority
            self._active.rotate(-1)
        return None

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Next item by DRR order; None on timeout or after close()
        drains empty."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while True:
                item = self._select()
                if item is not None:
                    return item
                if self._closed:
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        if not any(s.queue for s in self._tenants.values()):
                            return None

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._cond:
            return sum(len(s.queue) for s in self._tenants.values())


class AdmissionController:
    """Per-tenant quota charging, backlog bounds, and shed accounting.

    ``admit`` charges both buckets with the query's estimates and
    enforces the queue bound; ``reconcile`` settles against actuals at
    completion (or refunds fully on a shed).  All shed decisions raise
    typed errors at *submit* time — a shed query never consumes a
    worker.
    """

    def __init__(self, tenants: Dict[str, TenantConfig]):
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {
            tid: _make_state(cfg) for tid, cfg in tenants.items()}

    def register(self, cfg: TenantConfig):
        with self._lock:
            self._tenants[cfg.tenant_id] = _make_state(cfg)

    @property
    def tenants(self) -> Dict[str, _TenantState]:
        return self._tenants

    def state(self, tenant: str) -> _TenantState:
        return self._tenants[tenant]

    def config(self, tenant: str) -> TenantConfig:
        return self._tenants[tenant].cfg

    def admit(self, tenant: str, est_bytes: float, est_compute_s: float):
        """Charge the tenant's buckets for one query or raise a typed
        shed error.  Charges are atomic: a compute-quota failure rolls
        the byte charge back."""
        st = self._tenants[tenant]
        if len(st.queue) >= st.cfg.max_queue:
            st.shed["queue_full"] += 1
            raise AdmissionRejected(
                f"tenant {tenant!r} queue full "
                f"({st.cfg.max_queue} queries backlogged)")
        if not st.bytes_bucket.try_charge(est_bytes):
            st.shed["quota"] += 1
            raise QuotaExceeded(
                f"tenant {tenant!r} byte quota exhausted "
                f"(need {est_bytes:.0f}, have "
                f"{st.bytes_bucket.level:.0f})")
        if not st.compute_bucket.try_charge(est_compute_s):
            st.bytes_bucket.reconcile(est_bytes, 0.0)   # roll back
            st.shed["quota"] += 1
            raise QuotaExceeded(
                f"tenant {tenant!r} compute quota exhausted "
                f"(need {est_compute_s:.4f}s)")
        st.admitted += 1

    def reconcile(self, tenant: str, *, est_bytes: float, actual_bytes: float,
                  est_compute_s: float, actual_compute_s: float,
                  completed: bool = True):
        """Settle a finished query (or fully refund a shed one by
        passing actuals of 0)."""
        st = self._tenants[tenant]
        st.bytes_bucket.reconcile(est_bytes, actual_bytes)
        st.compute_bucket.reconcile(est_compute_s, actual_compute_s)
        if completed:
            st.completed += 1
            st.bytes_served += actual_bytes

    def shed_deadline(self, tenant: str):
        self._tenants[tenant].shed["deadline"] += 1

    def summary(self) -> Dict[str, Dict]:
        """Per-tenant admission counters (bench_serving reports them
        next to latency percentiles)."""
        out = {}
        for tid, st in self._tenants.items():
            out[tid] = {"admitted": st.admitted, "completed": st.completed,
                        "bytes_served": st.bytes_served,
                        "queued": len(st.queue), "shed": dict(st.shed),
                        "byte_level": st.bytes_bucket.level,
                        "compute_level": st.compute_bucket.level}
        return out

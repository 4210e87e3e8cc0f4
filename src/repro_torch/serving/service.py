"""QueryService — the multi-tenant serving front door over the
analytics engine.

The request lifecycle (each stage stamped into the ADDB serving trace,
so tail latency is attributable after the fact):

    submit ── validate (schema.py: reject malformed plans before the
       │       store sees them)
       │   ── estimate (plan through the warm PlanCache; per-partition
       │       CostModel estimates give admission its price)
       │   ── admit (admission.py: token buckets charge the estimates;
       │       typed QuotaExceeded / AdmissionRejected sheds)
       ▼
    FairQueue (deficit round-robin across tenants, weighted by
       │       priority — one flooding tenant cannot starve the rest)
       ▼
    worker ── deadline check (queued past deadline → shed + refund)
       │   ── ServingEngine.run (single-flight fragment dedup, partial
       │       cache, cost-based placement — scheduler.py)
       │   ── reconcile (actual QueryStats bytes/seconds settle the
       │       admission charge)
       ▼
    QueryResponse (value, stats, admit→queue→plan→execute→merge trace)

Entry points: ``Clovis.serving(...)`` and ``ClusterClovis.serving(...)``
— the cluster variant serves replicated reads through the routed
ClusterShipper with node-aware cost planning, unchanged.

This is the *query* front door over the storage/analytics stack; the
model-inference driver in ``launch/serve.py`` (token generation) is a
separate serving path that merely logs through Clovis.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.analytics.dataset import ContainerSource, Dataset
from repro_torch.serving.admission import (AdmissionController,
                                           AdmissionRejected, DeadlineExceeded,
                                           FairQueue, QuotaExceeded)
from repro_torch.serving.schema import (QueryRequest, QueryResponse,
                                        TenantConfig, ValidationError,
                                        validate_request)
from repro_torch.serving.scheduler import ClusterServingEngine, ServingEngine

_SERVICE_SEQ = itertools.count(1)


class _Submission:
    """Handle for an admitted query: ``result()`` blocks for the
    QueryResponse (engine failures and deadline sheds come back as
    ``ok=False`` responses, not exceptions — shed-at-submit raises
    typed errors synchronously instead)."""

    def __init__(self, tag: str):
        self.tag = tag
        self._future: "Future[QueryResponse]" = Future()

    def result(self, timeout: Optional[float] = None) -> QueryResponse:
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()


class _Queued:
    __slots__ = ("req", "ops", "sub", "est_bytes", "est_s", "deadline_ts",
                 "t_submit", "t_admitted", "admit_s")

    def __init__(self, req, ops, sub, est_bytes, est_s, deadline_ts,
                 t_submit, admit_s):
        self.req = req
        self.ops = ops
        self.sub = sub
        self.est_bytes = est_bytes
        self.est_s = est_s
        self.deadline_ts = deadline_ts
        self.t_submit = t_submit
        self.t_admitted = time.monotonic()
        self.admit_s = admit_s


class QueryService:
    """Multi-tenant front door over one (cluster-)analytics engine.

    ``tenants`` seeds the admission table (more can join later via
    ``register_tenant``); ``workers`` is the concurrent executor pool
    depth; ``quantum_bytes`` the DRR quantum; ``engine_kw`` passes
    through to the engine (``use_kernels``, ``max_workers``,
    ``partial_cache_size``, ``plan_cache_size``, ...).
    """

    def __init__(self, clovis, tenants: Sequence[TenantConfig] = (), *,
                 workers: int = 4, quantum_bytes: float = 256 << 10,
                 **engine_kw):
        self.clovis = clovis
        self.addb = clovis.addb
        engine_cls = (ClusterServingEngine if hasattr(clovis, "ring")
                      else ServingEngine)
        self.engine = clovis.analytics(engine_cls=engine_cls, **engine_kw)
        self.admission = AdmissionController(
            {cfg.tenant_id: cfg for cfg in tenants})
        self.queue = FairQueue(self.admission.tenants, quantum=quantum_bytes)
        self._tag = f"serving/s{next(_SERVICE_SEQ)}"
        self._qid = itertools.count(1)
        self._lock = threading.Lock()
        self._closed = False
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"sage-serve-{i}")
            for i in range(workers)]
        for t in self._workers:
            t.start()

    # ------------------------------------------------------------------
    # front door
    # ------------------------------------------------------------------

    def register_tenant(self, cfg: TenantConfig):
        self.admission.register(cfg)

    def submit(self, req: QueryRequest) -> _Submission:
        """Validate, price, and admit one query; returns a submission
        handle.  Raises ``ValidationError`` for malformed requests and
        ``QuotaExceeded`` / ``AdmissionRejected`` sheds synchronously —
        a shed query never reaches the store."""
        t0 = time.monotonic()
        if self._closed:
            raise AdmissionRejected("service is shut down")
        ops = validate_request(req, self.admission.tenants)
        tag = req.tag or f"{self._tag}/q{next(self._qid)}"
        est_bytes, est_s = self._estimate(req.container, ops)
        try:
            self.admission.admit(req.tenant, est_bytes, est_s)
        except AdmissionRejected:
            self.addb.record_serving(tag, "shed", req.tenant,
                                     nbytes=int(est_bytes), ok=False)
            raise
        admit_s = time.monotonic() - t0
        self.addb.record_serving(tag, "admit", req.tenant,
                                 nbytes=int(est_bytes), latency_s=admit_s)
        cfg = self.admission.config(req.tenant)
        deadline_s = (req.deadline_s if req.deadline_s is not None
                      else cfg.deadline_s)
        deadline_ts = (t0 + deadline_s) if deadline_s else None
        sub = _Submission(tag)
        item = _Queued(req, ops, sub, est_bytes, est_s, deadline_ts,
                       t0, admit_s)
        try:
            self.queue.push(req.tenant, item, est_bytes)
        except AdmissionRejected:
            self.admission.reconcile(
                req.tenant, est_bytes=est_bytes, actual_bytes=0.0,
                est_compute_s=est_s, actual_compute_s=0.0, completed=False)
            raise
        return sub

    def query(self, req: QueryRequest,
              timeout: Optional[float] = None) -> QueryResponse:
        """Synchronous submit + wait."""
        return self.submit(req).result(timeout)

    def dataset(self, req_or_ops: Union[QueryRequest, Sequence],
                container: Optional[str] = None) -> Dataset:
        """The Dataset a request's op specs describe (for explain())."""
        if isinstance(req_or_ops, QueryRequest):
            ops = validate_request(req_or_ops)
            container = req_or_ops.container
        else:
            from repro_torch.serving.schema import validate_ops
            ops = validate_ops(list(req_or_ops))
        return Dataset(self.engine, ContainerSource(container), tuple(ops))

    # ------------------------------------------------------------------
    # admission pricing
    # ------------------------------------------------------------------

    def _estimate(self, container: str, ops: List) -> Tuple[float, float]:
        """Price one query with the cost model: planned through the
        warm PlanCache, so repeated mixes pay ~one dict lookup.  Bytes
        are the store-side scan the query will cause (cached partitions
        scan nothing); seconds are the summed per-partition cost
        estimates.  Falls back to raw container bytes when the plan has
        no costed decisions (cost_based=False engines)."""
        eng = self.engine
        oids = eng._schedule(self.clovis.container(container))
        if not oids:
            raise ValidationError(
                f"container {container!r} is empty or unknown")
        ds = Dataset(eng, ContainerSource(container), tuple(ops))
        plan = eng._make_plan(ds, oids)
        est_bytes = 0.0
        est_s = 0.0
        decisions = plan.decisions or {}
        for oid in oids:
            d = decisions.get(oid)
            if d is not None and d.mode == "cached":
                continue
            try:
                est_bytes += eng.clovis.store.read_size(oid)
            except KeyError:
                pass
            if d is not None:
                est_s += d.est_s
        if not decisions:
            est_s = est_bytes / eng.cost_model.compute.store_bps
        return est_bytes, est_s

    # ------------------------------------------------------------------
    # worker pool
    # ------------------------------------------------------------------

    def _worker_loop(self):
        while True:
            item = self.queue.pop(timeout=0.2)
            if item is None:
                if self._closed:
                    return
                continue
            try:
                self._serve(item)
            except Exception as e:   # belt-and-braces: never kill a worker
                item.sub._future.set_result(QueryResponse(
                    item.req.tenant, item.sub.tag, ok=False,
                    error=f"{type(e).__name__}: {e}"))

    def _serve(self, item: _Queued):
        req, sub = item.req, item.sub
        now = time.monotonic()
        queue_s = now - item.t_admitted
        self.addb.record_serving(sub.tag, "queue", req.tenant,
                                 latency_s=queue_s)
        if item.deadline_ts is not None and now > item.deadline_ts:
            # shed: refund the full admission charge — the store did
            # no work, and the tenant should not pay for our backlog
            self.admission.reconcile(
                req.tenant, est_bytes=item.est_bytes, actual_bytes=0.0,
                est_compute_s=item.est_s, actual_compute_s=0.0,
                completed=False)
            self.admission.shed_deadline(req.tenant)
            self.addb.record_serving(sub.tag, "shed", req.tenant,
                                     latency_s=queue_s, ok=False)
            sub._future.set_result(QueryResponse(
                req.tenant, sub.tag, ok=False, shed=True,
                error=f"deadline exceeded after {queue_s:.3f}s in queue",
                trace={"admit_s": item.admit_s, "queue_s": queue_s}))
            return
        ds = Dataset(self.engine, ContainerSource(req.container),
                     tuple(item.ops))
        ok, value, error, stats = True, None, "", None
        try:
            res = self.engine.run(ds)
            value, stats = res.value, res.stats
        except Exception as e:
            ok, error = False, f"{type(e).__name__}: {e}"
        total_s = time.monotonic() - item.t_submit
        actual_bytes = float(stats.bytes_scanned) if stats else 0.0
        actual_s = float(stats.wall_s) if stats else 0.0
        self.admission.reconcile(
            req.tenant, est_bytes=item.est_bytes, actual_bytes=actual_bytes,
            est_compute_s=item.est_s, actual_compute_s=actual_s,
            completed=ok)
        trace = {"admit_s": item.admit_s, "queue_s": queue_s,
                 "plan_s": stats.plan_s if stats else 0.0,
                 "execute_s": stats.exec_s if stats else 0.0,
                 "merge_s": stats.merge_s if stats else 0.0,
                 "total_s": total_s}
        addb = self.addb
        if stats is not None:
            addb.record_serving(sub.tag, "plan", req.tenant,
                                latency_s=stats.plan_s)
            addb.record_serving(sub.tag, "execute", req.tenant,
                                nbytes=stats.bytes_moved,
                                latency_s=stats.exec_s)
            addb.record_serving(sub.tag, "merge", req.tenant,
                                latency_s=stats.merge_s)
        addb.record_serving(sub.tag, "done", req.tenant,
                            nbytes=int(actual_bytes), latency_s=total_s,
                            ok=ok)
        sub._future.set_result(QueryResponse(
            req.tenant, sub.tag, ok=ok, value=value, error=error,
            stats=stats, trace=trace))

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Service-wide counters: per-tenant admission summary plus the
        engine's single-flight / plan-cache stats."""
        out = {"tenants": self.admission.summary(),
               "queued": len(self.queue)}
        out.update(self.engine.serving_stats())
        return out

    def close(self):
        """Drain-free shutdown: stop admitting, wake the workers, fail
        any still-queued submissions, and close the engine."""
        self._closed = True
        self.queue.close()
        for t in self._workers:
            t.join(timeout=10.0)
        for st in self.admission.tenants.values():
            while st.queue:
                item, _cost = st.queue.popleft()
                item.sub._future.set_result(QueryResponse(
                    item.req.tenant, item.sub.tag, ok=False, shed=True,
                    error="service shut down before execution"))
        self.engine.close()

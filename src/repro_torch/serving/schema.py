"""Request/response schemas for the multi-tenant query front door.

SAGE's premise is that exascale storage *serves* analysis — many
concurrent consumers hitting one percipient store, not a single batch
job (paper §1; the ROADMAP's "millions of users" north star).  A front
door needs a wire-shaped contract: queries arrive as **declarative op
specs** (the same JSON-able specs shipped fragments already use, see
analytics/plan.py), never as closures, so a request can be validated —
and rejected — before it touches a single object.

``QueryRequest`` carries the tenant, the target container, the op-spec
chain, and an optional deadline.  ``validate_request`` replays the
Dataset API's chain rules over the specs (aggregate must be terminal,
nothing but an aggregate may follow key_by/window, histogram needs a
fixed vrange, ...) and raises a typed ``ValidationError`` on any
malformed plan.  ``TenantConfig`` is the admission contract: priority
(weighted-fair share), byte + compute token-bucket quotas, queue bound,
and a default deadline (admission.py charges and enforces them).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analytics.plan import (AGGS, Aggregate, KeyBy, MapRows, Op,
                                        Window, op_from_spec, op_to_spec,
                                        optimize)

MAX_OPS = 64                      # longest accepted op chain (abuse bound)


class ServingError(RuntimeError):
    """Base class for every typed front-door error."""


class ValidationError(ServingError):
    """Malformed request: rejected before touching the store."""


@dataclass(frozen=True)
class TenantConfig:
    """Admission contract of one tenant.

    ``priority`` weights the deficit-round-robin fair queue (a tenant
    with priority 2.0 drains twice the bytes per round of a tenant with
    1.0).  ``byte_quota_per_s`` / ``compute_quota_per_s`` refill the
    tenant's token buckets (bytes scanned at the store, and estimated
    store-compute seconds); ``*_burst`` caps the bucket (defaults to
    4 s of refill).  ``max_queue`` bounds the tenant's admitted-but-
    unexecuted backlog — beyond it, submissions shed with
    ``AdmissionRejected``.  ``deadline_s`` is the default per-query
    deadline (a queued query past its deadline sheds instead of
    executing — tail-latency protection for everyone behind it).
    """
    tenant_id: str
    priority: float = 1.0
    byte_quota_per_s: float = float("inf")
    byte_burst: Optional[float] = None
    compute_quota_per_s: float = float("inf")
    compute_burst: Optional[float] = None
    max_queue: int = 256
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if not self.tenant_id or not isinstance(self.tenant_id, str):
            raise ValidationError("tenant_id must be a non-empty string")
        if not self.priority > 0:
            raise ValidationError("priority must be > 0")
        if self.max_queue < 1:
            raise ValidationError("max_queue must be >= 1")
        for q in (self.byte_quota_per_s, self.compute_quota_per_s):
            if not q > 0:
                raise ValidationError("quotas must be > 0 (use inf for "
                                      "unmetered)")


@dataclass(frozen=True)
class QueryRequest:
    """One front-door query: tenant + container + op-spec chain.

    ``ops`` is a tuple of JSON-able op specs (``plan.op_to_spec``
    shapes) — the declarative form lets the front door validate, admit,
    fingerprint (plan cache), and dedup (fragment single-flight)
    without executing anything.  ``deadline_s`` overrides the tenant's
    default; ``tag`` labels the ADDB serving trace.
    """
    tenant: str
    container: str
    ops: Tuple[Dict, ...] = ()
    deadline_s: Optional[float] = None
    tag: str = ""

    @staticmethod
    def from_dataset(tenant: str, ds, *, deadline_s: Optional[float] = None,
                     tag: str = "") -> "QueryRequest":
        """Build a request from a Dataset chain.  Only spec-able ops
        survive the wire: ``map()`` closures raise ValidationError (a
        remote front door cannot ship arbitrary Python)."""
        from repro_torch.analytics.dataset import ContainerSource
        if not isinstance(ds.source, ContainerSource):
            raise ValidationError(
                "front-door queries scan a container — stream/join "
                "sources have no serializable request form")
        specs = []
        for op in ds.ops:
            if isinstance(op, MapRows):
                raise ValidationError(
                    "map() closures cannot cross the front door; "
                    "express the query with spec-able ops "
                    "(filter/select/key_by/window/aggregate)")
            specs.append(op_to_spec(op))
        return QueryRequest(tenant, ds.source.container, tuple(specs),
                            deadline_s=deadline_s, tag=tag)


@dataclass
class QueryResponse:
    """Front-door result envelope: the value (or typed failure), the
    engine's QueryStats, and the per-stage latency trace
    (admit/queue/plan/execute/merge/total seconds) that makes tail
    latency attributable — the same numbers land in ADDB
    (``Addb.serving_trace``)."""
    tenant: str
    tag: str
    ok: bool
    value: Any = None
    error: str = ""
    shed: bool = False
    stats: Any = None                       # analytics QueryStats (or None)
    trace: Dict[str, float] = field(default_factory=dict)


def validate_ops(ops_spec: Sequence[Dict]) -> List[Op]:
    """Parse + validate an op-spec chain, returning the logical ops.

    Raises ``ValidationError`` for anything the Dataset API itself
    would refuse: unknown ops/aggregates, non-terminal aggregates,
    transforms after key_by/window, grouped histograms, missing
    histogram vrange, windows with non-positive size/slide.  Runs
    entirely on the specs — no store access.
    """
    if not isinstance(ops_spec, (list, tuple)):
        raise ValidationError("ops must be a list of op specs")
    if len(ops_spec) > MAX_OPS:
        raise ValidationError(f"op chain too long (> {MAX_OPS})")
    ops: List[Op] = []
    for i, spec in enumerate(ops_spec):
        if not isinstance(spec, dict) or "op" not in spec:
            raise ValidationError(f"ops[{i}] is not an op spec dict")
        try:
            op = op_from_spec(spec)
        except (KeyError, ValueError, TypeError, IndexError) as e:
            raise ValidationError(f"ops[{i}] malformed: {e}") from e
        ops.append(op)
    grouped = False
    for i, op in enumerate(ops):
        if grouped and not isinstance(op, Aggregate):
            raise ValidationError(
                "only an aggregate may follow key_by/window")
        if isinstance(op, (KeyBy, Window)):
            grouped = True
        if isinstance(op, Window) and (
                op.size <= 0 or (op.slide is not None and op.slide <= 0)):
            raise ValidationError("window size/slide must be positive")
        if isinstance(op, Aggregate):
            if i != len(ops) - 1:
                raise ValidationError("aggregate must be the terminal op")
            if op.agg not in AGGS:
                raise ValidationError(f"unknown aggregate {op.agg!r}")
            if op.agg == "histogram":
                if op.bins <= 0:
                    raise ValidationError("histogram needs bins > 0")
                if op.vrange is None or not op.vrange[0] < op.vrange[1]:
                    raise ValidationError(
                        "histogram needs vrange=(lo, hi) with lo < hi")
    try:
        # reuses the optimizer's own grouping checks (key_by/window
        # require a terminal aggregate, no grouped histograms)
        optimize(ops, pushdown=True)
    except ValueError as e:
        raise ValidationError(str(e)) from e
    return ops


def validate_request(req: QueryRequest,
                     tenants: Optional[Dict[str, TenantConfig]] = None
                     ) -> List[Op]:
    """Full request validation; returns the parsed logical ops.  With a
    tenant table, unknown tenants are rejected here (before any quota
    or store interaction)."""
    if not isinstance(req, QueryRequest):
        raise ValidationError("expected a QueryRequest")
    if not req.tenant or not isinstance(req.tenant, str):
        raise ValidationError("request needs a non-empty tenant id")
    if tenants is not None and req.tenant not in tenants:
        raise ValidationError(f"unknown tenant {req.tenant!r}")
    if not req.container or not isinstance(req.container, str):
        raise ValidationError("request needs a non-empty container name")
    if req.deadline_s is not None and not req.deadline_s > 0:
        raise ValidationError("deadline_s must be > 0")
    return validate_ops(req.ops)

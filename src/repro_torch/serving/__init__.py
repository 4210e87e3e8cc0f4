"""Multi-tenant query serving front door over the SAGE analytics stack.

``Clovis.serving()`` / ``ClusterClovis.serving()`` construct a
:class:`QueryService`: schema-validated declarative requests, token-
bucket admission control charged against cost-model estimates and
reconciled against actual QueryStats, a deficit-round-robin weighted-
fair queue, cross-query fragment single-flight, a warm plan cache, and
per-query ADDB serving traces.  See ``docs/serving.md``.
"""
from repro_torch.serving.admission import (AdmissionController,
                                           AdmissionRejected, DeadlineExceeded,
                                           FairQueue, QuotaExceeded,
                                           TokenBucket)
from repro_torch.serving.scheduler import (ClusterServingEngine, FlightTable,
                                           PlanCache, ServingEngine,
                                           ServingMixin)
from repro_torch.serving.schema import (QueryRequest, QueryResponse,
                                        ServingError, TenantConfig,
                                        ValidationError, validate_ops,
                                        validate_request)
from repro_torch.serving.service import QueryService

__all__ = [
    "AdmissionController", "AdmissionRejected", "ClusterServingEngine",
    "DeadlineExceeded", "FairQueue", "FlightTable", "PlanCache",
    "QueryRequest", "QueryResponse", "QueryService", "QuotaExceeded",
    "ServingEngine", "ServingError", "ServingMixin", "TenantConfig",
    "TokenBucket", "ValidationError", "validate_ops", "validate_request",
]

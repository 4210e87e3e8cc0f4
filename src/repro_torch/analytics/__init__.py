"""Percipient analytics — pushdown dataflow queries over the object
store (paper §4.1's Data Analytics layer: 'move the computation to the
data'), ported to PyTorch with hand-written CUDA kernels.

Architecture:

    Dataset (declarative plan)          exprs.col / filter / select /
        │  optimize(cost_ctx)           key_by / window / aggregate / join
        ▼
    PhysicalPlan  = storage fragment ++ caller tail ++ merge
        │            ++ per-partition placement (cost.py: ship / fetch /
        │  AnalyticsEngine.run()           cached, from tier models,
        ▼                                  heat, selectivity stats)
    FunctionShipper  ── fragment per object, partials back ──▶ merge
        (tier/heat-aware schedule via percipience; spill via Clovis;
         shipped fragments piggyback StatsCatalog summaries)

Aggregation hot paths run on the CUDA kernels of kernels.py (built on
first use from ``repro_torch/csrc``) on a ``cuda`` device, on their
plain PyTorch versions on ``cpu``, and on the numpy ``*_ref`` oracles
with ``use_kernels=False``.

Live streams additionally run as *continuous queries*
(streaming.py): ``from_stream(StreamContext)`` +
``run_continuous(ds, EventWindow(...))`` gives incremental watermarked
event-time windows emitting while the stream is live — see
docs/streaming.md.

Entry point: ``Clovis.analytics()`` or ``AnalyticsEngine(clovis)``.
"""
from repro_torch.analytics.cost import (CostModel, Decision,  # noqa: F401
                                        PartitionStats, StatsCatalog,
                                        summarize_rows)
from repro_torch.analytics.dataset import Dataset  # noqa: F401
from repro_torch.analytics.executor import (AnalyticsEngine,  # noqa: F401
                                            AnalyticsError, QueryResult,
                                            QueryStats)
from repro_torch.analytics.exprs import Expr, col, lit  # noqa: F401
from repro_torch.analytics.kernels import (histogram,  # noqa: F401
                                           histogram_ref, kernel_mode,
                                           segment_reduce,
                                           segment_reduce_ref,
                                           window_reduce, window_reduce_ref)
from repro_torch.analytics.streaming import (ContinuousQuery,  # noqa: F401
                                             EventWindow, LateElement,
                                             SessionWindow, WatermarkTracker,
                                             WindowResult)

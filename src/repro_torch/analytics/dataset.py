"""Dataset — the Flink-shaped declarative query API of SAGE's Data
Analytics layer (paper §4.1: Big Data frameworks programming directly
against percipient storage, the ALF/Spectre/Savu use cases).

A Dataset is an immutable (source, op-chain) pair; every fluent call
returns a new Dataset.  Nothing executes until ``collect()`` /
``count()`` / ``engine.run()`` — the chain is a logical plan the
optimizer splits into a storage-side fragment and a caller-side tail,
then places per partition with the cost model (cost.py).

    eng = clovis.analytics()
    res = (eng.scan("events")
              .filter(col(1) > 0.5)
              .select(0, 2)
              .key_by(col(0))
              .aggregate("sum", value=col(1))
              .collect())

Sources: ``engine.scan(container)`` (one partition per object),
``engine.from_stream(tap_or_ctx)`` (a drained StreamTap batches one
partition per stream id; a live StreamContext makes the chain a
*continuous query* executed via ``engine.run_continuous`` — see
docs/streaming.md), and ``a.join(b, on=(lc, rc))`` (inner equi-join).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.analytics.exprs import Expr, as_expr
from repro_torch.analytics.plan import (AGGS, Aggregate, Filter, KeyBy,
                                        MapRows, Op, Select, Window)


@dataclass(frozen=True)
class ContainerSource:
    container: str


@dataclass(frozen=True)
class StreamSource:
    tap: object          # anything with .partitions() -> Dict[str, ndarray]


@dataclass(frozen=True)
class LiveStreamSource:
    """A live StreamContext: the dataset is an *unbounded* element flow,
    so the chain executes as a continuous query
    (``engine.run_continuous``) with event-time windows and watermark
    semantics — ``run()``/``collect()`` on it raise, there is no finite
    batch result to return."""
    ctx: object          # StreamContext (has .subscribe / .push)


@dataclass(frozen=True)
class JoinSource:
    left: "Dataset"
    right: "Dataset"
    on: Tuple[int, int]


class Dataset:
    def __init__(self, engine, source, ops: Tuple[Op, ...] = ()):
        self.engine = engine
        self.source = source
        self.ops = ops

    # ------------------------------------------------------------------
    # transforms
    # ------------------------------------------------------------------

    def _extend(self, op: Op) -> "Dataset":
        self._check_open(type(op).__name__.lower())
        return Dataset(self.engine, self.source, self.ops + (op,))

    def _check_open(self, what: str):
        if self.ops and isinstance(self.ops[-1], Aggregate):
            raise ValueError(f"cannot apply {what} after aggregate")
        if any(isinstance(o, (KeyBy, Window)) for o in self.ops) \
                and what != "aggregate":
            raise ValueError(f"{what} cannot follow key_by/window "
                             "(only aggregate can)")

    def filter(self, pred: Expr) -> "Dataset":
        """Keep rows where ``pred`` (an Expr over columns) is true."""
        return self._extend(Filter(as_expr(pred)))

    def select(self, *cols: int) -> "Dataset":
        """Project to the given column indices (in order)."""
        return self._extend(Select(tuple(int(c) for c in cols)))

    def map(self, fn, name: str = "map") -> "Dataset":
        """Arbitrary rows->rows transform.  Not pushable: this op and
        everything after it run caller-side."""
        return self._extend(MapRows(fn, name))

    def key_by(self, key) -> "Dataset":
        """Group subsequent aggregation by an integer key column/Expr."""
        return self._extend(KeyBy(as_expr(key)))

    def window(self, size: int, slide: Optional[int] = None) -> "Dataset":
        """Tumbling (or sliding) row windows, per partition; only
        complete windows emit."""
        if size <= 0:
            raise ValueError("window size must be positive")
        if slide is not None and slide <= 0:
            raise ValueError("window slide must be positive")
        return self._extend(Window(int(size), slide))

    def aggregate(self, agg: str, value=None, *, bins: int = 32,
                  vrange: Optional[Tuple[float, float]] = None) -> "Dataset":
        """Terminal aggregation: sum | count | mean | min | max |
        histogram (histogram needs fixed ``vrange``).  Applies per
        group after key_by, per window after window, else globally."""
        if agg not in AGGS:
            raise ValueError(f"agg must be one of {AGGS}")
        if self.ops and isinstance(self.ops[-1], Aggregate):
            raise ValueError("already aggregated")
        if agg == "histogram":
            if bins <= 0:
                raise ValueError("histogram needs bins > 0")
            if vrange is None or not vrange[0] < vrange[1]:
                raise ValueError("histogram needs vrange=(lo, hi) with "
                                 "lo < hi")
            if any(isinstance(o, (KeyBy, Window)) for o in self.ops):
                raise ValueError("per-group/per-window histograms are not "
                                 "supported; histogram aggregates globally")
        v = None if value is None else as_expr(value)
        return Dataset(self.engine, self.source,
                       self.ops + (Aggregate(agg, v, bins, vrange),))

    def join(self, other: "Dataset", on: Tuple[int, int]) -> "Dataset":
        """Inner equi-join on (left_col, right_col); both sides must be
        row-shaped (not aggregated).  Joined rows are left columns then
        right columns; ops chained after the join run caller-side."""
        for side, name in ((self, "left"), (other, "right")):
            if side.ops and isinstance(side.ops[-1], Aggregate):
                raise ValueError(f"{name} side of join is aggregated")
        return Dataset(self.engine, JoinSource(self, other,
                                               (int(on[0]), int(on[1]))))

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def collect(self):
        """Execute and return the result (rows array, scalar,
        (keys, values) for grouped, per-window array, or bin counts)."""
        return self.engine.run(self).value

    def count(self) -> int:
        if any(isinstance(o, (KeyBy, Window)) for o in self.ops):
            raise ValueError("count() is a global row count; use "
                             "aggregate('count') for grouped/windowed "
                             "counts")
        return int(self.aggregate("count").collect() or 0)

    def explain(self) -> str:
        """The optimized physical plan as text."""
        return self.engine.explain(self)

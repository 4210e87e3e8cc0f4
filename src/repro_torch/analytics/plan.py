"""Logical plan, optimizer, and fragment execution for dataflow queries
— SAGE's in-storage analytics (paper §4.1) with the paper's
'decide-where-computation-runs' claim implemented as a cost-based
optimizer.

A ``Dataset`` builds a linear chain of logical ops over a source
(container scan or join).  The optimizer splits the chain
into:

  * a **fragment** — the maximal pushable prefix (filters, projections,
    key-by, windows, partial aggregation), serialised to a JSON-able
    spec and shipped *to the store* via FunctionShipper, so only reduced
    partials cross back to the caller;
  * **local ops** — the non-pushable suffix (arbitrary ``map_rows``
    functions and anything after them), run caller-side per partition;
  * a **merge** describing how per-partition partials combine (row
    concat, grouped segmented re-reduce, windowed concat, scalar
    combine, histogram sum).

Both the shipped fragment and the caller-side path execute through the
same ``apply_ops`` interpreter, so pushdown and fetch-all produce
identical results by construction.  Stage fusion falls out of the same
design: one fragment evaluates the whole prefix in a single pass over
the partition instead of materialising per-stage intermediates.

When a ``cost_ctx`` (analytics.cost.CostContext) is supplied, fragment
*placement* additionally becomes a costed decision **per partition**:
each object independently ships the fragment, fetches raw bytes, or
reuses a cached prior partial, based on tier latency/bandwidth,
percipience heat, and selectivity statistics (see cost.py).

Kernels run on ``KernelCfg.device``: the hand-written CUDA kernels on a
``cuda`` device, their plain PyTorch versions on ``cpu`` (kernels.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analytics import kernels as K
from repro_torch.analytics.exprs import Expr, from_spec

AGGS = ("sum", "count", "mean", "min", "max", "histogram")


# ---------------------------------------------------------------------------
# logical ops
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Filter:
    expr: Expr


@dataclass(frozen=True)
class Select:
    cols: Tuple[int, ...]


@dataclass(frozen=True)
class MapRows:
    """Arbitrary rows->rows python function — never pushed down."""
    fn: Callable[[np.ndarray], np.ndarray]
    name: str = "map"


@dataclass(frozen=True)
class KeyBy:
    key: Expr


@dataclass(frozen=True)
class Window:
    size: int
    slide: Optional[int] = None


@dataclass(frozen=True)
class Aggregate:
    agg: str
    value: Optional[Expr] = None
    bins: int = 32
    vrange: Optional[Tuple[float, float]] = None


Op = Any                     # Filter | Select | MapRows | KeyBy | Window | Aggregate


def op_to_spec(op: Op) -> Dict:
    if isinstance(op, Filter):
        return {"op": "filter", "expr": op.expr.to_spec()}
    if isinstance(op, Select):
        return {"op": "select", "cols": list(op.cols)}
    if isinstance(op, KeyBy):
        return {"op": "key_by", "key": op.key.to_spec()}
    if isinstance(op, Window):
        return {"op": "window", "size": op.size, "slide": op.slide}
    if isinstance(op, Aggregate):
        return {"op": "aggregate", "agg": op.agg,
                "value": None if op.value is None else op.value.to_spec(),
                "bins": op.bins, "vrange": op.vrange}
    raise TypeError(f"op {op!r} is not pushable")


def op_from_spec(spec: Dict) -> Op:
    kind = spec["op"]
    if kind == "filter":
        return Filter(from_spec(spec["expr"]))
    if kind == "select":
        return Select(tuple(spec["cols"]))
    if kind == "key_by":
        return KeyBy(from_spec(spec["key"]))
    if kind == "window":
        return Window(spec["size"], spec.get("slide"))
    if kind == "aggregate":
        # optional keys may be omitted on the wire (serving front door)
        v = spec.get("value")
        vrange = spec.get("vrange")
        return Aggregate(spec["agg"], None if v is None else from_spec(v),
                         spec.get("bins", 32),
                         None if vrange is None else tuple(vrange))
    raise ValueError(f"bad op spec {spec!r}")


def is_pushable(op: Op) -> bool:
    return not isinstance(op, MapRows)


# ---------------------------------------------------------------------------
# physical plan
# ---------------------------------------------------------------------------

@dataclass
class PhysicalPlan:
    frag_spec: List[Dict]               # pushable prefix (ships to storage)
    local_ops: List[Op]                 # non-pushable suffix (caller-side)
    merge: str                          # rows | scalar | group | window | histogram
    agg: Optional[str] = None           # aggregate op for merged kinds
    pushdown: bool = True
    decisions: Optional[Dict[str, Any]] = None   # oid -> cost.Decision

    def describe(self) -> str:
        lines = []
        if self.decisions:
            where = "costed"
        else:
            where = "store" if (self.pushdown and self.frag_spec) else "caller"
        for s in self.frag_spec:
            lines.append(f"  [{where}] {s['op']}"
                         + (f" {s.get('agg')}" if s["op"] == "aggregate" else ""))
        for op in self.local_ops:
            lines.append(f"  [caller] {type(op).__name__.lower()}")
        lines.append(f"  [merge] {self.merge}"
                     + (f"({self.agg})" if self.agg else ""))
        if self.decisions:
            modes = [d.mode for d in self.decisions.values()]
            counts = " ".join(f"{m}={modes.count(m)}"
                              for m in ("ship", "fetch", "cached"))
            lines.append(f"  [placement] {counts} (cost-based, "
                         f"{len(modes)} partitions)")
        return "\n".join(lines)


def optimize(ops: Sequence[Op], *, pushdown: bool = True,
             cost_ctx=None) -> PhysicalPlan:
    """Split the op chain at the first non-pushable op and derive the
    merge kind from the terminal op.  With a ``cost_ctx``
    (analytics.cost.CostContext), fragment placement additionally
    becomes a per-partition costed decision — ship / fetch / cached —
    stored on ``plan.decisions``."""
    ops = list(ops)
    if any(isinstance(o, (KeyBy, Window)) for o in ops):
        if not (ops and isinstance(ops[-1], Aggregate)):
            raise ValueError("key_by/window requires a terminal aggregate "
                             "— the grouping would otherwise be silently "
                             "dropped")
        if ops[-1].agg == "histogram":
            raise ValueError("per-group/per-window histograms are not "
                             "supported; histogram aggregates globally")
    split = len(ops)
    for i, op in enumerate(ops):
        if not is_pushable(op):
            split = i
            break
    frag, local = ops[:split], ops[split:]

    merge, agg = "rows", None
    if ops and isinstance(ops[-1], Aggregate):
        last = ops[-1]
        agg = last.agg
        if last.agg == "histogram":
            merge = "histogram"
        elif any(isinstance(o, KeyBy) for o in ops):
            merge = "group"
        elif any(isinstance(o, Window) for o in ops):
            merge = "window"
        else:
            merge = "scalar"
    plan = PhysicalPlan([op_to_spec(o) for o in frag], local, merge,
                        agg, pushdown)
    if cost_ctx is not None and pushdown and plan.frag_spec:
        plan.decisions = cost_ctx.place(plan)
    return plan


# ---------------------------------------------------------------------------
# op interpreter (runs store-side inside a shipped fragment AND
# caller-side — identical code path, so modes agree by construction)
# ---------------------------------------------------------------------------

def as_rows(arr: np.ndarray) -> np.ndarray:
    """Normalise an object/stream payload to (rows, ncols)."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        return arr.reshape(-1, 1)
    if arr.ndim == 2:
        return arr
    return arr.reshape(arr.shape[0], -1)


@dataclass
class KernelCfg:
    use_kernel: bool = True
    device: Optional[torch.device] = None    # None: cuda (kernels.py)
    fuse: bool = True            # fused filter->aggregate when chain allows


def _seg_reduce(vals, ids, n, op, kcfg: KernelCfg):
    if kcfg.use_kernel:
        return K.segment_reduce(vals, ids, n, op=op, device=kcfg.device)
    return K.segment_reduce_ref(vals, ids, n, op=op)


def _win_reduce(vals, size, slide, op, kcfg: KernelCfg):
    if kcfg.use_kernel:
        return K.window_reduce(vals, size, op=op, slide=slide,
                               device=kcfg.device)
    return K.window_reduce_ref(vals, size, op=op, slide=slide)


def _agg_values(rows: np.ndarray, agg: Aggregate) -> np.ndarray:
    if agg.value is not None:
        return np.asarray(agg.value(rows))
    if agg.agg == "count":
        return np.ones(rows.shape[0], np.int32)
    if rows.shape[1] == 1:
        return rows[:, 0]
    raise ValueError(f"aggregate {agg.agg!r} over {rows.shape[1]} columns "
                     "needs an explicit value expression")


def _grouped_partial(key: np.ndarray, vals: np.ndarray, agg: Aggregate,
                     kcfg: KernelCfg):
    keys, inv = np.unique(key.astype(np.int64), return_inverse=True)
    n = len(keys)
    if agg.agg == "mean":
        sums = _seg_reduce(vals.astype(np.float32), inv, n, "sum", kcfg)
        counts = _seg_reduce(np.ones_like(vals, np.int32), inv, n,
                             "count", kcfg)
        return ("group", "mean", keys, (sums, counts))
    op = "sum" if agg.agg == "count" else agg.agg
    v = np.ones_like(vals, np.int32) if agg.agg == "count" else vals
    return ("group", agg.agg, keys, _seg_reduce(v, inv, n, op, kcfg))


def _scalar_partial(vals: np.ndarray, agg: Aggregate):
    if vals.size == 0:
        return ("scalar", agg.agg, None)
    if agg.agg == "sum":
        return ("scalar", "sum", vals.sum(dtype=np.float64))
    if agg.agg == "count":
        return ("scalar", "count", int(vals.size))
    if agg.agg == "mean":
        return ("scalar", "mean", (vals.sum(dtype=np.float64),
                                   int(vals.size)))
    if agg.agg == "min":
        return ("scalar", "min", vals.min())
    return ("scalar", "max", vals.max())


# ---------------------------------------------------------------------------
# fused filter -> aggregate (single kernel pass, no mask materialisation)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedChain:
    """A fusible op chain, normalised to *original* column indices:
    all filters ANDed into one predicate spec, the optional group key
    and aggregate value specs, and the set of columns the whole chain
    reads (what a pruned colblock scan must fetch)."""
    pred_spec: Optional[Dict]
    key_spec: Optional[Dict]
    value_spec: Optional[Dict]
    agg: str
    columns: Tuple[int, ...]


def _remap_spec(spec: Dict, colmap: Optional[List[int]]) -> Dict:
    """Rewrite a spec's column refs through the current projection map
    so it addresses the partition's original columns."""
    if colmap is None:
        return spec
    t = spec["t"]
    if t == "col":
        return {"t": "col", "i": colmap[spec["i"]]}
    if t == "bin":
        return {"t": "bin", "op": spec["op"],
                "l": _remap_spec(spec["l"], colmap),
                "r": _remap_spec(spec["r"], colmap)}
    if t == "not":
        return {"t": "not", "e": _remap_spec(spec["e"], colmap)}
    return spec


def fuse_chain(ops: Sequence[Op]) -> Optional[FusedChain]:
    """Recognise a Filter*/Select*/KeyBy?/Aggregate chain the fused
    kernel can run in one pass.  Returns None when the chain doesn't
    qualify (window, map_rows, histogram, mid-chain aggregates, ops
    after key_by) — callers fall back to the unfused interpreter."""
    ops = list(ops)
    if not ops or not isinstance(ops[-1], Aggregate):
        return None
    agg = ops[-1]
    if agg.agg not in ("sum", "count", "mean", "min", "max"):
        return None
    colmap: Optional[List[int]] = None       # current idx -> original idx
    preds: List[Dict] = []
    key_spec: Optional[Dict] = None
    try:
        for op in ops[:-1]:
            if key_spec is not None:
                return None                  # only the aggregate follows key_by
            if isinstance(op, Filter):
                preds.append(_remap_spec(op.expr.to_spec(), colmap))
            elif isinstance(op, Select):
                colmap = [colmap[c] for c in op.cols] if colmap is not None \
                    else list(op.cols)
            elif isinstance(op, KeyBy):
                key_spec = _remap_spec(op.key.to_spec(), colmap)
            else:
                return None
        if agg.value is not None:
            value_spec = _remap_spec(agg.value.to_spec(), colmap)
        elif agg.agg == "count":
            value_spec = None
        elif colmap is not None and len(colmap) == 1:
            value_spec = {"t": "col", "i": colmap[0]}   # single-col rule
        else:
            return None                      # column count unknown until run
    except (IndexError, KeyError):
        return None                          # bad col ref: unfused path errors
    pred_spec = None
    for p in preds:
        pred_spec = p if pred_spec is None else \
            {"t": "bin", "op": "&", "l": pred_spec, "r": p}
    cols = (K.spec_columns(pred_spec) | K.spec_columns(key_spec)
            | K.spec_columns(value_spec))
    return FusedChain(pred_spec, key_spec, value_spec, agg.agg,
                      tuple(sorted(cols)))


_DENSE_KEY_SPAN = 1 << 16          # identity seg-id map below this key range


def _fuse_dtype_ok(fc: FusedChain, coldt) -> bool:
    """Whether the fused kernel's int32/float32 accumulators reproduce
    the unfused path bit-for-bit at these column dtypes.  Grouped
    aggregates always qualify (the unfused segment reduce applies the
    same casts); scalar aggregates must match ``_scalar_partial``'s
    float64/native payloads exactly."""
    if fc.key_spec is not None or fc.agg == "count":
        return True
    vdt = K._spec_dtype(fc.value_spec, coldt)
    if fc.agg in ("sum", "mean"):
        # unfused scalar sums accumulate in float64; int32 is the only
        # kernel dtype that converts back exactly — and mean's payload
        # is the (f64 sum, count) pair the kernel doesn't produce
        return (fc.agg == "sum"
                and np.issubdtype(vdt, np.integer)
                and np.can_cast(vdt, np.int32))
    # min/max: lossless accumulator dtypes only
    return (vdt == np.float32
            or (np.issubdtype(vdt, np.integer)
                and np.can_cast(vdt, np.int32)))


def _apply_fused(fc: FusedChain, data, kcfg: KernelCfg):
    """Run a FusedChain over one partition (row array or pruned
    ColumnBatch) through the fused kernel.  Returns the same tagged
    partial the unfused interpreter yields, or None when this partition
    must fall back (dtype the kernel's int32/float32 accumulators can't
    reproduce bit-for-bit against the unfused path)."""
    from repro_torch.core.columnar import ColumnBatch
    if isinstance(data, ColumnBatch):
        if any(c not in data for c in fc.columns):
            return None                      # pruned without our columns
        nrows = data.rows
        cols = {i: data.col(i) for i in fc.columns}
    else:
        rows = as_rows(data)
        if any(c >= rows.shape[1] for c in fc.columns):
            return None                      # unfused path raises the error
        nrows = rows.shape[0]
        cols = {i: np.ascontiguousarray(rows[:, i]) for i in fc.columns}
    coldt = {i: c.dtype for i, c in cols.items()}

    if not _fuse_dtype_ok(fc, coldt):
        return None

    if fc.key_spec is not None:
        if nrows == 0:
            return ("group", fc.agg, np.zeros(0, np.int64),
                    _empty_group_payload(fc, coldt))
        key = np.asarray(K.eval_spec(fc.key_spec,
                                     lambda i: cols[i])).reshape(-1)
        k64 = key.astype(np.int64)
        kmin, kmax = int(k64.min()), int(k64.max())
        if kmax - kmin < _DENSE_KEY_SPAN:
            n = kmax - kmin + 1
            ids = (k64 - kmin).astype(np.int32)
            keys_all = np.arange(kmin, kmax + 1, dtype=np.int64)
        else:
            keys_all, inv = np.unique(k64, return_inverse=True)
            n = len(keys_all)
            ids = inv.astype(np.int32)
        op = "sum" if fc.agg in ("count", "mean") else fc.agg
        value_spec = None if fc.agg == "count" else fc.value_spec
        out_dtype = np.float32 if fc.agg == "mean" else None
        acc, cnt = K.fused_filter_aggregate(
            cols, fc.pred_spec, value_spec, ids, n, op=op,
            device=kcfg.device, out_dtype=out_dtype)
        live = cnt > 0                       # drop keys with no survivors
        keys = keys_all[live]
        if fc.agg == "mean":
            return ("group", "mean", keys, (acc[live], cnt[live]))
        return ("group", fc.agg, keys, acc[live])

    # scalar: one segment, every surviving row folds into lane 0
    ids = np.zeros(nrows, np.int32)
    value_spec = None if fc.agg == "count" else fc.value_spec
    acc, cnt = K.fused_filter_aggregate(cols, fc.pred_spec, value_spec,
                                        ids, 1, op=fc.agg,
                                        device=kcfg.device)
    if int(cnt[0]) == 0:
        return ("scalar", fc.agg, None)
    if fc.agg == "count":
        return ("scalar", "count", int(acc[0]))
    if fc.agg == "sum":
        return ("scalar", "sum", np.float64(acc[0]))
    return ("scalar", fc.agg, acc[0])


def _empty_group_payload(fc: FusedChain, coldt):
    dt = K.fused_out_dtype(None if fc.agg == "count" else fc.value_spec,
                           coldt)
    if fc.agg == "mean":
        return (np.zeros(0, np.float32), np.zeros(0, np.int32))
    return np.zeros(0, dt)


def frag_columns(frag_spec: List[Dict]) -> Optional[Tuple[int, ...]]:
    """Original column indices a fragment needs, when the chain is
    fusible (= statically known) — what the executor passes to a pruned
    colblock read.  None means the fragment may touch any column."""
    try:
        ops = [op_from_spec(s) for s in frag_spec]
    except (ValueError, KeyError, TypeError):
        return None
    fc = fuse_chain(ops)
    return fc.columns if fc is not None else None


def prunable_columns(frag_spec: List[Dict],
                     attrs: Dict) -> Optional[Tuple[int, ...]]:
    """Columns for a *safe* pruned colblock read of this fragment at
    this object: non-None only when the fused path is guaranteed to run
    at the object's column dtypes.  A pruned ColumnBatch cannot rebuild
    rows, so the unfused fallback must be statically unreachable before
    the executor drops any column from the read."""
    from repro_torch.core.columnar import COLBLOCK_KIND
    if attrs.get("kind") != COLBLOCK_KIND:
        return None
    try:
        ops = [op_from_spec(s) for s in frag_spec]
    except (ValueError, KeyError, TypeError):
        return None
    fc = fuse_chain(ops)
    if fc is None:
        return None
    names = attrs.get("coldtypes") or []
    ncols = (attrs.get("shape") or [0, 0])[1]
    if len(names) != ncols or any(c >= ncols for c in fc.columns):
        return None
    try:
        coldt = {i: np.dtype(n) for i, n in enumerate(names)}
    except TypeError:
        return None                    # exotic dtype name (e.g. bfloat16)
    return fc.columns if _fuse_dtype_ok(fc, coldt) else None


def apply_ops(ops: Sequence[Op], arr: np.ndarray,
              kcfg: Optional[KernelCfg] = None):
    """Run an op chain over one partition; returns a tagged partial:
    ("rows", ndarray) | ("scalar", agg, payload) |
    ("group", agg, keys, payload) | ("histogram", counts) |
    ("window", agg, ndarray).

    Filter-prefix + aggregate chains route through the fused kernel
    (one pass, no materialized mask) when ``kcfg.use_kernel`` and
    ``kcfg.fuse``; every other chain — and every partition the fused
    path can't reproduce bit-for-bit — runs the unfused interpreter.
    ``arr`` may be a pruned ``ColumnBatch`` (colblock scan); unfused
    chains rebuild rows from it, which requires every column."""
    kcfg = kcfg or KernelCfg()
    if kcfg.use_kernel and kcfg.fuse:
        fc = fuse_chain(ops)
        if fc is not None:
            out = _apply_fused(fc, arr, kcfg)
            if out is not None:
                return out
    from repro_torch.core.columnar import ColumnBatch
    if isinstance(arr, ColumnBatch):
        arr = arr.to_rows()
    rows = as_rows(arr)
    key: Optional[np.ndarray] = None
    window: Optional[Window] = None
    for op in ops:
        if isinstance(op, Filter):
            rows = rows[np.asarray(op.expr(rows), bool)]
        elif isinstance(op, Select):
            rows = rows[:, list(op.cols)]
        elif isinstance(op, MapRows):
            rows = as_rows(op.fn(rows))
        elif isinstance(op, KeyBy):
            key = np.asarray(op.key(rows))
        elif isinstance(op, Window):
            window = op
        elif isinstance(op, Aggregate):
            vals = _agg_values(rows, op)
            if op.agg == "histogram":
                if op.vrange is None:
                    raise ValueError("histogram pushdown needs a fixed "
                                     "vrange=(lo, hi)")
                ids = K.histogram_bin_ids(vals, op.bins, op.vrange)
                counts = _seg_reduce(np.ones(ids.shape, np.int32), ids,
                                     op.bins, "count", kcfg)
                return ("histogram", counts)
            if key is not None:
                return _grouped_partial(key, vals, op, kcfg)
            if window is not None:
                wop = "sum" if op.agg in ("mean", "count") else op.agg
                if op.agg == "count":
                    vals = np.ones_like(vals, np.int32)
                red = _win_reduce(vals, window.size, window.slide, wop,
                                  kcfg)
                if op.agg == "mean":
                    red = red.astype(np.float64) / window.size
                return ("window", op.agg, red)
            return _scalar_partial(vals, op)
        else:
            raise TypeError(f"unknown op {op!r}")
    return ("rows", rows)


def compile_fragment(frag_spec: List[Dict], kcfg: KernelCfg,
                     collect_stats: bool = False
                     ) -> Callable[[np.ndarray], Any]:
    """Build the storage-side executor function for a fragment spec —
    this is what gets registered with FunctionShipper.

    ``collect_stats=True`` piggybacks a partition-stats summary on the
    result (``{cost.STATS_KEY: summary, "partial": ...}``): the store
    already has the raw rows in hand, so summarizing them is nearly
    free, and the StatsCatalog's shipper observer harvests the summary
    to feed the next query's cost decisions."""
    ops = [op_from_spec(s) for s in frag_spec]

    def fragment(arr: np.ndarray):
        return apply_ops(ops, arr, kcfg)

    if not collect_stats:
        return fragment

    from repro_torch.analytics.cost import STATS_KEY, summarize_rows

    def fragment_with_stats(arr: np.ndarray):
        return {STATS_KEY: summarize_rows(as_rows(arr)),
                "partial": apply_ops(ops, arr, kcfg)}

    return fragment_with_stats


# ---------------------------------------------------------------------------
# merging per-partition partials
# ---------------------------------------------------------------------------

def merge_partials(plan: PhysicalPlan, partials: List[Any],
                   kcfg: Optional[KernelCfg] = None):
    """Combine per-partition partials into the query result."""
    kcfg = kcfg or KernelCfg()
    partials = [p for p in partials if p is not None]
    if plan.merge == "rows":
        mats = [p[1] for p in partials if p[1].shape[0]]
        if not mats:
            return np.zeros((0, 0))
        return np.vstack(mats)
    if plan.merge == "histogram":
        counts = [p[1] for p in partials]
        return np.sum(counts, axis=0) if counts else np.zeros(0, np.int32)
    if plan.merge == "window":
        parts = [p[2] for p in partials if p[2].size]
        return np.concatenate(parts) if parts else np.zeros(0)
    if plan.merge == "scalar":
        return _merge_scalar(plan.agg, [p[2] for p in partials
                                        if p[2] is not None])
    if plan.merge == "group":
        return _merge_group(plan.agg, partials, kcfg)
    raise ValueError(f"bad merge kind {plan.merge!r}")


def _merge_scalar(agg: str, payloads: List[Any]):
    if not payloads:
        return None
    if agg == "sum":
        return float(np.sum(payloads))
    if agg == "count":
        return int(np.sum(payloads))
    if agg == "mean":
        s = sum(p[0] for p in payloads)
        c = sum(p[1] for p in payloads)
        return s / c if c else None
    return float(np.min(payloads) if agg == "min" else np.max(payloads))


def _merge_group(agg: str, partials: List[Any], kcfg: KernelCfg
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Re-reduce per-partition (keys, payload) partials over the union
    key set — the caller-side half of the two-phase grouped aggregate."""
    partials = [p for p in partials if len(p[2])]
    if not partials:
        return np.zeros(0, np.int64), np.zeros(0)
    all_keys = np.concatenate([p[2] for p in partials])
    keys, inv = np.unique(all_keys, return_inverse=True)
    n = len(keys)
    if agg == "mean":
        sums = np.concatenate([p[3][0] for p in partials])
        counts = np.concatenate([p[3][1] for p in partials])
        s = _seg_reduce(sums.astype(np.float32), inv, n, "sum", kcfg)
        c = _seg_reduce(counts, inv, n, "sum", kcfg)
        return keys, s.astype(np.float64) / np.maximum(c, 1)
    vals = np.concatenate([p[3] for p in partials])
    op = "sum" if agg in ("sum", "count") else agg
    return keys, _seg_reduce(vals, inv, n, op, kcfg)

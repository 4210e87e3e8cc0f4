"""Partition-parallel query executor — SAGE's in-storage analytics run
loop: costed pushdown, tier-aware scheduling, spill (paper §4.1).

Execution of a container query:

  1. the optimizer places each partition independently (cost.py): the
     fused fragment **ships** to the store via ``FunctionShipper``, the
     raw bytes **fetch** to the caller, or a **cached** prior partial is
     reused — chosen from tier latency/bandwidth, percipience heat, and
     selectivity statistics, with cold-start partitions defaulting to
     ship (the uncosted always-push behaviour);
  2. per-object tasks are scheduled tier-aware: partitions already on
     fast tiers (and, when percipience is attached, with high predicted
     heat) run first, while cold slow-tier partitions are promoted in the
     background so their migration overlaps the hot partitions' compute;
  3. per-partition partials merge caller-side (segmented re-reduce for
     group-bys, concat for rows/windows, partial combine for scalars);
  4. join intermediates larger than ``spill_bytes`` grace-partition into
     a spill container placed by RTHMS ``recommend_tier``.

Every placement decision lands in ADDB (op ``analytics_plan``; see
``Addb.plan_trace``) so chosen-plan quality is auditable against the
always-push / always-fetch oracles.  Shipped fragments piggyback
partition-stats summaries when the catalog is stale, so statistics
accrue as a side effect of running queries.

``pushdown=False`` fetches whole objects to the caller and runs the
identical op interpreter locally — the fetch-all baseline the benchmark
compares bytes-moved against.  ``cost_based=False`` restores uniform
always-push (the always-push oracle).

Kernels run on the Clovis stack's ``device``: the hand-written CUDA
kernels on ``cuda``, their plain PyTorch versions on ``cpu``.
``use_kernels=False`` runs the numpy reference oracles instead (the
port's yardstick on the card).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch._ext import KernelBuildError, KernelLaunchError
from repro_torch.analytics.cost import (CACHED, FETCH, SHIP, STATS_KEY,
                                        ComputeModel, CostContext, CostModel,
                                        NetworkModel, StatsCatalog,
                                        frag_cache_key)
from repro_torch.analytics.dataset import (ContainerSource, Dataset,
                                           JoinSource, LiveStreamSource,
                                           StreamSource)
from repro_torch.analytics.plan import (KernelCfg, PhysicalPlan, apply_ops,
                                        compile_fragment, merge_partials,
                                        optimize, optimize_streaming,
                                        prunable_columns)
from repro_torch.analytics.streaming import ContinuousQuery
from repro_torch.core import layouts as lay
from repro_torch.core.function_shipping import FunctionShipper
from repro_torch.core.hsm import recommend_tier
from repro_torch.core.tiers import T2_FLASH, T3_DISK, T4_ARCHIVE, TIER_ORDER

_TIER_RANK = {t: i for i, t in enumerate(TIER_ORDER)}
_SLOW_TIERS = (T3_DISK, T4_ARCHIVE)

# distinguishes ADDB decision-trace tags across engines sharing one ADDB
_ENGINE_SEQ = itertools.count(1)


class AnalyticsError(RuntimeError):
    """A partition failed (after the shipper's retry policy)."""


@dataclass
class QueryStats:
    pushdown: bool = True
    partitions: int = 0
    bytes_scanned: int = 0          # raw object bytes read at the store
    bytes_moved: int = 0            # bytes crossing to the caller
    spilled_bytes: int = 0
    prefetched: int = 0             # cold partitions staged during the run
    cache_hits: int = 0             # partitions served from cached partials
    schedule: List[str] = field(default_factory=list)
    decisions: Dict[str, str] = field(default_factory=dict)  # oid -> mode
    query_tag: str = ""             # ADDB decision-trace key (plan_trace)
    plan: str = ""
    wall_s: float = 0.0
    plan_s: float = 0.0             # optimizer/placement time
    exec_s: float = 0.0             # partition execution time
    merge_s: float = 0.0            # caller-side partial merge time
    dedup_hits: int = 0             # fragments shared with an in-flight
                                    # identical query (serving engines)
    pruned_reads: int = 0           # colblock partitions read column-pruned
    double_buffered: int = 0        # fetches overlapped with another
                                    # partition's compute (read-ahead)
    snapshot_version: int = -1      # pinned manifest version (-1: the
                                    # container is not manifest-managed)


@dataclass
class QueryResult:
    value: Any
    stats: QueryStats


def _nbytes(v) -> int:
    """Modelled wire size of a partial crossing store -> caller."""
    if v is None:
        return 0
    if isinstance(v, np.ndarray):
        return v.nbytes
    if isinstance(v, (tuple, list)):
        return sum(_nbytes(x) for x in v)
    if isinstance(v, dict):
        return sum(_nbytes(x) for x in v.values())
    if isinstance(v, str):
        return len(v)
    return 8                       # scalar


class AnalyticsEngine:
    def __init__(self, clovis, *, shipper: Optional[FunctionShipper] = None,
                 pushdown: bool = True, cost_based: bool = True,
                 stats: Optional[StatsCatalog] = None,
                 net: Optional[NetworkModel] = None,
                 compute: Optional[ComputeModel] = None,
                 use_kernels: bool = True,
                 max_workers: int = 4,
                 spill_bytes: int = 4 << 20,
                 spill_container: str = "analytics_spill",
                 prefetch_cold: bool = True,
                 partial_cache_size: int = 128):
        self.clovis = clovis
        self.device = clovis.device      # where the kernels run
        self.shipper = shipper or FunctionShipper(clovis,
                                                  max_workers=max_workers)
        self._own_shipper = shipper is None
        self.pushdown = pushdown
        self.cost_based = cost_based
        self._own_stats = stats is None
        self.stats = (stats if stats is not None
                      else StatsCatalog().attach(clovis.store))
        self.stats.attach_shipper(self.shipper)
        self.cost_model = CostModel(net=net, compute=compute)
        self.kcfg = KernelCfg(use_kernel=use_kernels, device=self.device)
        self.max_workers = max_workers
        self.spill_bytes = spill_bytes
        self.spill_container = spill_container
        self.prefetch_cold = prefetch_cold
        self._qid = 0
        self._etag = f"analytics/e{next(_ENGINE_SEQ)}"
        self._lock = threading.Lock()
        self._partial_cache: "OrderedDict[Tuple[str, str, int], Any]" = \
            OrderedDict()
        self._partial_cache_size = partial_cache_size
        self._cache_lock = threading.Lock()
        # content can change without a version increase (append keeps the
        # version; delete+recreate resets it), so the version-keyed cache
        # additionally invalidates on store writes and deletes
        clovis.store.register_write_hook(self._cache_invalidate)
        clovis.store.fdmi_register(self._cache_on_fdmi)

    # ------------------------------------------------------------------
    # dataset constructors
    # ------------------------------------------------------------------

    def scan(self, container: str) -> Dataset:
        """Dataset over a Clovis container, one partition per object."""
        return Dataset(self, ContainerSource(container))

    def from_stream(self, tap) -> Dataset:
        """Dataset over a stream source.  A StreamTap (or anything with
        ``partitions()``) batches the drained rows, one partition per
        stream id in sequence order.  A live StreamContext (anything
        with ``subscribe``/``push``) makes the chain a *continuous
        query*: execute it with ``run_continuous``, not ``run``."""
        if hasattr(tap, "subscribe") and hasattr(tap, "push"):
            return Dataset(self, LiveStreamSource(tap))
        return Dataset(self, StreamSource(tap))

    def explain(self, ds: Dataset) -> str:
        src = ds.source
        if isinstance(src, ContainerSource):
            head = f"scan({src.container})"
            oids = self._schedule(self.clovis.container(src.container))
            plan = self._make_plan(ds, oids)
        elif isinstance(src, LiveStreamSource):
            head = "from_stream(live)"
            plan = optimize_streaming(ds.ops)
        elif isinstance(src, StreamSource):
            head = "from_stream"
            plan = optimize(ds.ops, pushdown=False)
        else:
            head = f"join(on={src.on})"
            plan = optimize(ds.ops, pushdown=False)
        return f"{head}\n{plan.describe()}"

    def _can_push(self, ds: Dataset) -> bool:
        return self.pushdown and isinstance(ds.source, ContainerSource)

    # ------------------------------------------------------------------
    # planning (cost-based placement)
    # ------------------------------------------------------------------

    def _make_plan(self, ds: Dataset, oids: List[str]) -> PhysicalPlan:
        push = self._can_push(ds)
        ctx = None
        if push and self.cost_based:
            ctx = CostContext(model=self.cost_model,
                              store=self.clovis.store, oids=oids,
                              catalog=self.stats,
                              load=self._load(oids),
                              cache_probe=self._cache_probe)
        return optimize(ds.ops, pushdown=push, cost_ctx=ctx)

    def _policy_map(self, oids: List[str], method: str) -> Dict[str, float]:
        """Query the percipience policy (clovis.percipience[2]) for a
        per-oid map; {} when percipience is absent or the policy errors
        (prediction is advisory, never load-bearing).  A heat kernel that
        fails to build or launch raises: the port never hides a kernel
        fault behind the advisory fallback."""
        percip = getattr(self.clovis, "percipience", None)
        if not percip:
            return {}
        try:
            return getattr(percip[2], method)(oids)
        except (KernelBuildError, KernelLaunchError):
            raise
        except Exception:
            return {}

    def _load(self, oids: List[str]) -> Dict[str, float]:
        """Per-partition storage-side contention from percipience heat
        (empty when percipience is not attached)."""
        return self._policy_map(oids, "load_factor")

    # -- manifest snapshot pinning -------------------------------------

    def _pin_snapshot(self, container: str):
        """Pin the container's current manifest version for the whole
        query, so the partition list and every block stay immutable
        while appends and compactions commit underneath (pinned blocks
        survive GC).  None for containers without a manifest — they
        behave exactly as before the compaction subsystem existed."""
        registry = getattr(self.clovis, "manifests", None)
        if registry is None:
            return None
        manifest = registry.lookup(container)
        if manifest is None:
            return None
        return (manifest, manifest.pin())

    @staticmethod
    def _unpin_snapshot(pin):
        if pin is not None:
            pin[0].unpin(pin[1])

    # -- partial cache (fragment results keyed by object version) ------

    def _cache_invalidate(self, oid: str, nbytes: int = 0):
        """Drop every cached partial for ``oid`` — store write hook
        (append keeps the version) and FDMI delete (recreate resets it)
        both punch through the version key."""
        with self._cache_lock:
            for key in [k for k in self._partial_cache if k[1] == oid]:
                del self._partial_cache[key]

    def _cache_on_fdmi(self, event: str, oid: str, info: Dict):
        if event == "delete":
            self._cache_invalidate(oid)

    def _cache_key(self, frag_key: str, oid: str
                   ) -> Optional[Tuple[str, str, int]]:
        try:
            return (frag_key, oid, self.clovis.store.meta(oid).version)
        except KeyError:
            return None

    def _cache_probe(self, frag_key: str, oid: str) -> bool:
        key = self._cache_key(frag_key, oid)
        if key is None:
            return False
        with self._cache_lock:
            return key in self._partial_cache

    def _cache_get(self, frag_key: str, oid: str):
        key = self._cache_key(frag_key, oid)
        if key is None:
            return None
        with self._cache_lock:
            val = self._partial_cache.get(key)
            if val is not None:
                self._partial_cache.move_to_end(key)
            return val

    def _cache_put(self, frag_key: str, oid: str, partial, version: int):
        """Insert under the version captured *before* the data was read
        (versions are monotonic, so the entry can never claim a newer
        version than the bytes it was computed from — a concurrent
        write just strands the entry at the old, unreachable key)."""
        if version < 0 or partial is None:
            return
        key = (frag_key, oid, version)
        with self._cache_lock:
            self._partial_cache[key] = partial
            self._partial_cache.move_to_end(key)
            while len(self._partial_cache) > self._partial_cache_size:
                self._partial_cache.popitem(last=False)

    # -- fragment shipping hook (serving engines override) -------------

    def _ship_fragment(self, name: str, frag_key: str, oid: str,
                       stats: Optional[QueryStats] = None,
                       columns: Optional[Tuple[int, ...]] = None):
        """Ship one compiled fragment at one object.  ``columns``
        non-None routes through the shipper's pruned columnar read
        (ranged block fetches of just those columns).  The serving
        mixin overrides this with cross-query single-flight dedup; the
        base engine just ships."""
        if columns is not None:
            return self.shipper.ship_columns(name, oid, columns)
        return self.shipper.ship(name, oid)

    def _observe_selectivity(self, frag_key: str, oid: str, partial):
        """Feed the selectivity a shipped fragment actually delivered
        back into the stats catalog (rows-shaped partials only — the
        row count is the signal the ship-vs-fetch estimate hinges on)."""
        if not (isinstance(partial, tuple) and len(partial) == 2
                and partial[0] == "rows"):
            return
        st = self.stats.get(oid)
        if st is None or st.rows <= 0:
            return
        rows_out = np.asarray(partial[1]).shape[0]
        self.stats.observe_selectivity(frag_key, oid, rows_out / st.rows)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def run(self, ds: Dataset) -> QueryResult:
        t0 = time.perf_counter()
        stats = QueryStats(pushdown=self._can_push(ds))
        if isinstance(ds.source, LiveStreamSource):
            raise ValueError(
                "dataset reads a live StreamContext — an unbounded flow "
                "has no batch result; execute it with run_continuous() "
                "(incremental watermarked windows), or drain through a "
                "StreamTap for a batch query")
        if isinstance(ds.source, JoinSource):
            value = self._run_join(ds, stats)
        elif isinstance(ds.source, StreamSource):
            plan = optimize(ds.ops, pushdown=False)
            stats.plan = plan.describe()
            partials = self._run_stream(ds, stats)
            value = merge_partials(plan, partials, self.kcfg)
        else:
            pin = self._pin_snapshot(ds.source.container)
            try:
                if pin is not None:
                    snap = pin[1]
                    stats.snapshot_version = snap.version
                    listing = snap.oids
                else:
                    listing = self.clovis.container(ds.source.container)
                oids = self._schedule(listing)
                plan = self._make_plan(ds, oids)
                stats.plan_s = time.perf_counter() - t0
                stats.plan = plan.describe()
                t1 = time.perf_counter()
                partials = self._run_container(ds, plan, oids, stats)
                stats.exec_s = time.perf_counter() - t1
                t2 = time.perf_counter()
                value = merge_partials(plan, partials, self.kcfg)
                stats.merge_s = time.perf_counter() - t2
            finally:
                self._unpin_snapshot(pin)
        stats.wall_s = time.perf_counter() - t0
        return QueryResult(value, stats)

    def run_continuous(self, ds: Dataset, window,
                       **kw) -> ContinuousQuery:
        """Execute a live-stream dataset as a continuous query:
        incremental watermarked event-time windows emitting results
        while the stream is still live (docs/streaming.md).

        ``window`` is the window spec — an ``EventWindow`` (tumbling /
        sliding, size / slide / allowed lateness) or a ``SessionWindow``
        (gap windows whose extents are data-defined); remaining
        keywords pass through to ContinuousQuery (``on_result``
        callback, ``max_results`` bounded queue size, ``delta_rows``
        incremental batch size, ``idle_timeout_s``, and
        ``retraction=True`` for speculative emit + late-data
        re-emission on fixed windows).
        Closed-window partials combine through the FunctionShipper
        partial-aggregate registry (scalars) and ``merge_partials``
        (grouped) — the exact merge code batch queries use, so the two
        modes agree by construction."""
        if not isinstance(ds.source, LiveStreamSource):
            raise ValueError(
                "run_continuous needs a live stream source — build the "
                "dataset with from_stream(StreamContext)")
        splan = optimize_streaming(ds.ops)
        with self._lock:
            self._qid += 1
            tag = f"{self._etag}/cq{self._qid}"
        return ContinuousQuery(ds.source.ctx, splan, window,
                               shipper=self.shipper, kcfg=self.kcfg,
                               addb=self.clovis.addb, tag=tag, **kw)

    # -- partition execution -------------------------------------------

    def _run_stream(self, ds: Dataset, stats: QueryStats) -> List[Any]:
        parts = ds.source.tap.partitions()
        out = []
        for sid in sorted(parts):
            arr = parts[sid]
            stats.partitions += 1
            stats.bytes_scanned += arr.nbytes
            stats.bytes_moved += arr.nbytes      # already caller-side
            stats.schedule.append(sid)
            out.append(apply_ops(ds.ops, arr, self.kcfg))
        return out

    def _run_container(self, ds: Dataset, plan: PhysicalPlan,
                       oids: List[str], stats: QueryStats) -> List[Any]:
        store = self.clovis.store
        stats.schedule = list(oids)
        stats.partitions = len(oids)
        use_ship = plan.pushdown and bool(plan.frag_spec)
        decisions = plan.decisions or {}
        frag_key = frag_cache_key(plan.frag_spec) if plan.frag_spec else ""

        with self._lock:
            self._qid += 1
            qtag = f"{self._etag}/q{self._qid}"
        frag_name = f"{qtag}/frag"
        frag_stats_name = f"{qtag}/frag+stats"
        if use_ship:
            self.shipper.register(
                frag_name, compile_fragment(plan.frag_spec, self.kcfg))
            self.shipper.register(
                frag_stats_name,
                compile_fragment(plan.frag_spec, self.kcfg,
                                 collect_stats=True))

        if decisions:
            stats.query_tag = qtag
            for oid, d in decisions.items():
                self.clovis.addb.record_decision(qtag, oid, d.mode,
                                                 d.est_moved, d.est_s)

        # never stage a CACHED partition: its plan needs zero I/O, and
        # migration would bump the version and defeat the cache hit
        stageable = [o for o in oids
                     if o not in decisions or decisions[o].mode != CACHED]
        staged = (self._stage_cold(stageable, stats)
                  if self.prefetch_cold else {})
        errors: List[str] = []
        lock = threading.Lock()
        prune_ok = use_ship and hasattr(self.clovis, "read_columns")

        # double-buffered block streaming (fetch-mode partitions): a
        # side pool reads the next partition's bytes while the current
        # one's kernel runs, keeping the store's read path and the
        # caller's compute overlapped instead of strictly alternating
        if use_ship:
            fetch_oids = [o for o in oids if o in decisions
                          and decisions[o].mode == FETCH]
        else:
            fetch_oids = [o for o in oids
                          if decisions.get(o) is None
                          or decisions[o].mode != CACHED]
        dbl: Dict[str, Any] = {}
        dbl_lock = threading.Lock()
        dbl_iter = iter(fetch_oids)
        dbl_pool = (ThreadPoolExecutor(
                        max_workers=min(len(fetch_oids),
                                        self.max_workers + 1),
                        thread_name_prefix="sage-dblbuf")
                    if len(fetch_oids) > 1 else None)

        def _dbl_read(o: str):
            fut = staged.get(o)
            if fut is not None:
                fut.result()             # promotion finished (or failed)
            try:
                ver = store.meta(o).version
            except KeyError:
                ver = -1
            return ver, self._fetch(o)

        def _dbl_advance():
            """Submit the next not-yet-read fetch partition (one per
            consumed buffer, so at most depth reads are in flight)."""
            if dbl_pool is None:
                return
            with dbl_lock:
                for nxt in dbl_iter:
                    dbl[nxt] = dbl_pool.submit(_dbl_read, nxt)
                    return

        if dbl_pool is not None:
            for _ in range(self.max_workers + 1):
                _dbl_advance()

        def task(oid: str):
            d = decisions.get(oid)
            mode = d.mode if d is not None else (SHIP if use_ship else FETCH)
            if mode == CACHED:
                partial = self._cache_get(frag_key, oid)
                if partial is not None:
                    with lock:
                        stats.cache_hits += 1
                        stats.decisions[oid] = CACHED
                    if plan.local_ops:
                        partial = apply_ops(plan.local_ops, partial[1],
                                            self.kcfg)
                    return partial
                mode = SHIP if use_ship else FETCH   # raced invalidation
            fut = staged.get(oid)
            if fut is not None:
                fut.result()                 # promotion finished (or failed)
            size = store.read_size(oid)
            pruned = pipelined = False
            if mode == SHIP and use_ship:
                name = frag_name
                if self.cost_based and not self.stats.fresh(oid):
                    name = frag_stats_name   # piggyback a stats refresh
                cols = None
                if prune_ok and name is frag_name:
                    # (the stats piggyback summarizes whole rows, so it
                    # always reads the full object)
                    try:
                        attrs = store.meta(oid).attrs
                    except KeyError:
                        attrs = {}
                    cols = prunable_columns(plan.frag_spec, attrs)
                    if cols is not None:
                        from repro_torch.core.columnar import column_nbytes
                        size = column_nbytes(attrs, cols)
                        pruned = True
                res = self._ship_fragment(name, frag_key, oid, stats,
                                          columns=cols)
                if not res.ok:
                    with lock:
                        errors.append(f"{oid}: {res.error}")
                    return None
                partial = res.value
                moved = _nbytes(partial)
                if isinstance(partial, dict) and STATS_KEY in partial:
                    partial = partial["partial"]
                self._cache_put(frag_key, oid, partial, res.version)
                self._observe_selectivity(frag_key, oid, partial)
                if plan.local_ops:
                    # the fragment never aggregates when a caller tail
                    # exists, so its output is always rows
                    partial = apply_ops(plan.local_ops, partial[1],
                                        self.kcfg)
            else:
                # whole chain runs caller-side on the fetched object
                fut2 = None
                if dbl_pool is not None:
                    with dbl_lock:
                        fut2 = dbl.pop(oid, None)
                if fut2 is not None:
                    _dbl_advance()       # next fetch overlaps our kernel
                    version, arr = fut2.result()
                    pipelined = True
                else:
                    try:
                        version = store.meta(oid).version
                    except KeyError:
                        version = -1
                    arr = self._fetch(oid)
                moved = arr.nbytes
                partial = apply_ops(ds.ops, arr, self.kcfg)
                if use_ship and not plan.local_ops:
                    # no caller tail: the full-chain result IS the
                    # fragment partial, so it is cacheable
                    self._cache_put(frag_key, oid, partial, version)
            with lock:
                stats.bytes_scanned += size
                stats.bytes_moved += moved
                stats.decisions[oid] = mode
                if pruned:
                    stats.pruned_reads += 1
                if pipelined:
                    stats.double_buffered += 1
            return partial

        try:
            with ThreadPoolExecutor(max_workers=self.max_workers,
                                    thread_name_prefix="sage-analytics"
                                    ) as pool:
                partials = list(pool.map(task, oids))
        finally:
            if dbl_pool is not None:
                dbl_pool.shutdown(wait=False)
            if use_ship:
                self.shipper.unregister(frag_name)
                self.shipper.unregister(frag_stats_name)
        if errors:
            raise AnalyticsError("; ".join(errors))
        return partials

    def _fetch(self, oid: str) -> np.ndarray:
        """Fetch path: the whole object crosses to the caller (same
        materialization rule the storage-side shipper uses)."""
        return self.clovis.materialize(oid)

    # -- tier/heat-aware scheduling ------------------------------------

    def _heat(self, oids: List[str]) -> Dict[str, float]:
        return self._policy_map(oids, "heat_map")

    def _schedule(self, oids: List[str]) -> List[str]:
        """Hot/fast-tier partitions first: they run while cold ones are
        still being promoted (or are simply slower to read)."""
        store = self.clovis.store
        heat = self._heat(oids)
        return sorted(oids, key=lambda o: (
            _TIER_RANK[store.meta(o).layout.tier], -heat.get(o, 0.0), o))

    def _stage_cold(self, oids: List[str], stats: QueryStats) -> Dict:
        """Kick slow-tier partitions' promotion onto a background pool so
        migration overlaps execution of the hot partitions (which sort
        first and drain the task queue while these stage)."""
        store = self.clovis.store
        cold = [o for o in oids
                if store.meta(o).layout.tier in _SLOW_TIERS]
        if not cold:
            return {}
        pool = ThreadPoolExecutor(max_workers=2,
                                  thread_name_prefix="sage-stage")

        def promote(oid: str):
            try:
                meta = store.meta(oid)
                store.migrate(oid, lay.Layout(meta.layout.kind, T2_FLASH,
                                              meta.layout.width))
                with self._lock:
                    stats.prefetched += 1
            except Exception:
                pass                      # staging is advisory

        futs = {oid: pool.submit(promote, oid) for oid in cold}
        pool.shutdown(wait=False)
        return futs

    # -- join ----------------------------------------------------------

    def _run_join(self, ds: Dataset, stats: QueryStats):
        src: JoinSource = ds.source
        lres = self.run(src.left)
        rres = self.run(src.right)
        for side in (lres, rres):
            stats.partitions += side.stats.partitions
            stats.bytes_scanned += side.stats.bytes_scanned
            stats.bytes_moved += side.stats.bytes_moved
            stats.cache_hits += side.stats.cache_hits
            stats.schedule.extend(side.stats.schedule)
            stats.decisions.update(side.stats.decisions)
        lrows, rrows = np.atleast_2d(lres.value), np.atleast_2d(rres.value)
        joined = self._join_rows(lrows, rrows, src.on, stats)
        if not ds.ops:
            return joined
        plan = optimize(ds.ops, pushdown=False)
        stats.plan = plan.describe()
        return merge_partials(plan, [apply_ops(ds.ops, joined, self.kcfg)],
                              self.kcfg)

    def _join_rows(self, lrows, rrows, on: Tuple[int, int],
                   stats: QueryStats) -> np.ndarray:
        if (lrows.size and rrows.size
                and lrows.nbytes + rrows.nbytes > self.spill_bytes):
            return self._grace_join(lrows, rrows, on, stats)
        return _hash_join(lrows, rrows, on)

    def _grace_join(self, lrows, rrows, on: Tuple[int, int],
                    stats: QueryStats) -> np.ndarray:
        """Grace hash join: both sides hash-partition into spill objects
        (tier picked by RTHMS recommend_tier), then join bucket-wise so
        peak memory is ~1/P of the input."""
        store = self.clovis.store
        nb = 8
        with self._lock:
            self._qid += 1
            qtag = f"{self.spill_container}/q{self._qid}"
        spilled: List[str] = []
        buckets: Dict[Tuple[str, int], str] = {}
        for name, rows, kc in (("l", lrows, on[0]), ("r", rrows, on[1])):
            keys = rows[:, kc].astype(np.int64) % nb
            for b in range(nb):
                sub = rows[keys == b]
                if not sub.shape[0]:
                    continue
                tier = recommend_tier(store, size_bytes=sub.nbytes,
                                      read_fraction=0.5, random_access=False)
                oid = f"{qtag}/{name}{b}"
                self.clovis.put_array(oid, sub,
                                      container=self.spill_container,
                                      layout=lay.Layout(lay.STRIPED, tier, 2))
                buckets[(name, b)] = oid
                spilled.append(oid)
                stats.spilled_bytes += sub.nbytes
        try:
            outs = []
            for b in range(nb):
                lo = buckets.get(("l", b))
                ro = buckets.get(("r", b))
                if lo is None or ro is None:
                    continue
                outs.append(_hash_join(self.clovis.get_array(lo),
                                       self.clovis.get_array(ro), on))
            outs = [o for o in outs if o.shape[0]]
            if not outs:
                return np.zeros((0, lrows.shape[1] + rrows.shape[1]))
            return np.vstack(outs)
        finally:
            for oid in spilled:
                try:
                    self.clovis.delete(oid)
                except KeyError:
                    pass

    def close(self):
        if self._own_stats:
            # engine-private catalog: unhook it everywhere so
            # short-lived engines don't accrete hooks on a long-lived
            # stack.  A shared catalog's shipper observer stays: other
            # engines on the same shipper still harvest through it, and
            # the catalog outlives its engines by design.
            self.shipper.remove_observer(self.stats._on_ship)
            self.stats.detach()
        self.clovis.store.unregister_write_hook(self._cache_invalidate)
        self.clovis.store.fdmi_unregister(self._cache_on_fdmi)
        if self._own_shipper:
            self.shipper.shutdown()


def _hash_join(lrows: np.ndarray, rrows: np.ndarray,
               on: Tuple[int, int]) -> np.ndarray:
    """In-memory inner equi-join; output rows are left cols ++ right
    cols, ordered by left row then right row (deterministic)."""
    lc, rc = on
    ncols = lrows.shape[1] + rrows.shape[1]
    if not lrows.size or not rrows.size:
        return np.zeros((0, ncols))
    rk = rrows[:, rc].astype(np.int64)
    index: Dict[int, List[int]] = {}
    for j, k in enumerate(rk):
        index.setdefault(int(k), []).append(j)
    li, ri = [], []
    for i, k in enumerate(lrows[:, lc].astype(np.int64)):
        for j in index.get(int(k), ()):
            li.append(i)
            ri.append(j)
    if not li:
        return np.zeros((0, ncols))
    return np.hstack([lrows[li], rrows[ri]])

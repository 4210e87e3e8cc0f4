"""Cost-based pushdown optimizer — SAGE's 'decide where computation
runs' claim made concrete.

The paper's central argument is that percipient storage should *choose*
whether a computation moves to the data or the data moves to the
computation, per piece of data, from what the system knows about tiers
and workload.  An uncosted engine always pushes the pushable prefix down;
this module makes fragment placement a costed decision **per
partition**, from three inputs:

  * **tier parameters** — latency/bandwidth of the tier each partition
    lives on, from the HSM tier map (``core.hsm.tier_params``);
  * **percipience heat** — predicted storage-side contention
    (``PercipientPolicy.load_factor``): pushing compute at a partition
    whose storage node is busy serving demand reads is discounted;
  * **selectivity statistics** — per-partition row counts, per-column
    min/max, and KMV distinct-estimate sketches held by the
    ``StatsCatalog``, collected incrementally: ObjectStore write hooks
    invalidate, and shipped fragments piggyback a fresh summary on
    their partials (the store already has the bytes in hand, so stats
    are free), harvested through a FunctionShipper result observer.

Per partition the optimizer picks one of three modes:

  * ``ship``   — push the fused fragment to the store; only the
    (estimated-small) partial crosses back;
  * ``fetch``  — move the raw bytes and compute caller-side; wins when
    estimated selectivity ≈ 1 makes pushdown pointless (same bytes
    cross either way, and the caller's CPUs are faster/less contended);
  * ``cached`` — reuse a prior partial for the identical fragment over
    the identical object version (zero I/O; correct by construction
    since the cache key includes the version).

Cold start is safe by design: a partition with no statistics always
ships (the uncosted always-push behaviour), never crashes, and the
shipped fragment's piggybacked summary fills the catalog for next time.
Every decision is recorded in ADDB (op ``analytics_plan``) so chosen-
plan quality is auditable against the always-push / always-fetch
oracles (``bench_analytics``).
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from repro_torch.core.hsm import TierParams, tier_params

SHIP = "ship"
FETCH = "fetch"
CACHED = "cached"

STATS_KEY = "__sage_stats__"      # piggyback marker in shipped partials
DEFAULT_SEL = 0.5                 # selectivity of an inestimable predicate
KMV_K = 64                        # k-minimum-values sketch size
HIST_BINS = 16                    # equi-width per-column histogram bins


# ---------------------------------------------------------------------------
# partition statistics
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ColumnStats:
    lo: float
    hi: float
    distinct: float               # KMV estimate (exact when small)
    # equi-width counts over [lo, hi] — range-predicate selectivity
    # interpolates the real distribution instead of assuming uniform.
    # None on summaries from before histograms existed (still decodes).
    hist: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class PartitionStats:
    oid: str
    version: int
    rows: int
    ncols: int
    nbytes: int
    cols: List[ColumnStats]

    @property
    def itemsize(self) -> float:
        return self.nbytes / max(self.rows * self.ncols, 1)

    @staticmethod
    def from_summary(oid: str, version: int, d: Dict) -> "PartitionStats":
        return PartitionStats(
            oid, version, int(d["rows"]), int(d["ncols"]), int(d["nbytes"]),
            [ColumnStats(c["lo"], c["hi"], c["distinct"],
                         tuple(c["hist"]) if c.get("hist") else None)
             for c in d["cols"]])


def _kmv_distinct(v: np.ndarray, k: int = KMV_K) -> float:
    """Distinct-count estimate via a k-minimum-values sketch: hash every
    value to [0, 1), keep the k smallest; est = (k-1) / kth-smallest.
    Exact (modulo hash collisions) when there are fewer than k distinct
    hashes.  O(n) time, O(k) summary — the sketch the paper-scale stats
    substrate needs, since partitions can be arbitrarily wide."""
    x = np.ascontiguousarray(v)
    if x.size == 0:
        return 0.0
    if x.dtype.kind == "f":
        h = x.astype(np.float64).view(np.int64)
    else:
        h = x.astype(np.int64)
    # splitmix64-style mixing; numpy int64 arithmetic wraps, which is
    # exactly what the hash wants
    h = h * np.int64(-7046029254386353131)
    h = h ^ (h >> 33)
    h = h * np.int64(-4417276706812531889)
    h = h ^ (h >> 29)
    u = (h.astype(np.uint64) >> np.uint64(11)).astype(np.float64) / (1 << 53)
    u = np.unique(u)
    if u.size <= k:
        return float(u.size)
    kth = float(np.partition(u, k - 1)[k - 1])
    return (k - 1) / max(kth, 1e-12)


def summarize_rows(arr: np.ndarray) -> Dict:
    """JSON-able stats summary of one partition's row array — computed
    store-side (piggybacked on fragments) or caller-side (analyze)."""
    rows = np.asarray(arr)
    if rows.ndim == 1:
        rows = rows.reshape(-1, 1)
    elif rows.ndim > 2:
        rows = rows.reshape(rows.shape[0], -1)
    n, ncols = rows.shape
    cols = []
    for c in range(ncols):
        if n == 0:
            cols.append({"lo": 0.0, "hi": 0.0, "distinct": 0.0})
        else:
            v = rows[:, c]
            lo, hi = float(np.min(v)), float(np.max(v))
            col = {"lo": lo, "hi": hi, "distinct": _kmv_distinct(v)}
            if hi > lo:
                col["hist"] = np.histogram(
                    v.astype(np.float64), bins=HIST_BINS,
                    range=(lo, hi))[0].tolist()
            cols.append(col)
    return {"rows": int(n), "ncols": int(ncols),
            "nbytes": int(rows.nbytes), "cols": cols}


class StatsCatalog:
    """Per-partition selectivity statistics, collected incrementally.

    Freshness is version-based: stats carry the object version they were
    computed at; ``get`` returns None when the live version moved on.
    Three feeds keep the catalog current:

      * ``attach(store)`` — ObjectStore write hooks invalidate on every
        committed write/append, FDMI deletes drop entries;
      * ``attach_shipper(shipper)`` — a FunctionShipper observer
        harvests summaries piggybacked on shipped fragment results
        (``{STATS_KEY}: summary`` alongside the partial);
      * ``analyze(clovis, container)`` — eager scan (internal reads: no
        heat/access pollution) for benchmarks and warm starts.

    ``version`` is a monotonic change counter bumped on every observe /
    invalidate / feedback fold — anything caching decisions derived from
    the catalog (the serving plan cache) keys on it and re-derives when
    it moves.
    """

    def __init__(self, max_partitions: int = 8192,
                 max_sel_obs: int = 4096):
        self.max_partitions = max_partitions
        self.max_sel_obs = max_sel_obs
        self.version = 0              # bumped (under _lock) on any change
        # per-container change counters + a global component: anything
        # caching per-container derivations (the serving plan cache)
        # keys on container_version() so a write to one container never
        # invalidates another container's cached plans
        self._cver: Dict[str, int] = {}
        self._gver = 0                # cross-container feedback (node bw)
        self._stats: Dict[str, PartitionStats] = {}
        self._node_obs: Dict[str, Dict[str, float]] = {}
        # (frag_key, oid) -> EWMA of actually-observed selectivity
        self._sel_obs: Dict[Any, float] = {}
        self._store = None
        self._lock = threading.Lock()

    # -- feeds ---------------------------------------------------------

    def attach(self, store) -> "StatsCatalog":
        with self._lock:
            if store is self._store:
                return self
            self._store = store
        store.register_write_hook(self._on_write)
        store.fdmi_register(self._on_fdmi)
        return self

    def detach(self):
        """Unhook from the store (engines that default-created their
        catalog call this on close so short-lived engines don't leave
        hooks behind on a long-lived store)."""
        with self._lock:
            store, self._store = self._store, None
        if store is None:
            return
        store.unregister_write_hook(self._on_write)
        store.fdmi_unregister(self._on_fdmi)

    def attach_shipper(self, shipper) -> "StatsCatalog":
        shipper.add_observer(self._on_ship)
        return self

    def _on_write(self, oid: str, nbytes: int):
        self.invalidate(oid)

    def _container_of(self, oid: str) -> str:
        """The container an oid-scoped change belongs to — live store
        metadata when available (computed outside ``_lock``; store
        facades may take their own locks), oid prefix as the fallback
        (the repo-wide ``<container>/<name>`` naming), else a shared
        bucket."""
        with self._lock:
            store = self._store
        if store is not None:
            try:
                return store.meta(oid).container
            except KeyError:
                pass
        if "/" in oid:
            return oid.split("/", 1)[0]
        return "default"

    def _on_fdmi(self, event: str, oid: str, info: Dict):
        if event == "delete":
            self.invalidate(oid)
        elif event == "migrate":
            # migration moves bytes, not content: re-stamp the stored
            # version so stats survive HSM tier changes
            with self._lock:
                store = self._store
            if store is None:
                return
            try:
                meta = store.meta(oid)
                version, container = meta.version, meta.container
            except KeyError:
                return
            # re-read and replace in ONE critical section: a concurrent
            # invalidate-then-observe must not be clobbered by a stale
            # re-stamp (the entry is skipped if it already carries the
            # live version)
            with self._lock:
                st = self._stats.get(oid)
                if st is not None and st.version != version:
                    self._stats[oid] = PartitionStats(
                        st.oid, version, st.rows, st.ncols, st.nbytes,
                        st.cols)
                    self.version += 1
                    self._cver[container] = \
                        self._cver.get(container, 0) + 1

    def _on_ship(self, res):
        """FunctionShipper observer: harvest piggybacked summaries,
        stamped with the version the shipped read actually saw (not the
        live version, which a concurrent write may have moved past)."""
        if not res.ok or not isinstance(res.value, dict):
            return
        summary = res.value.get(STATS_KEY)
        if summary is None or res.version < 0:
            return
        self.observe(res.oid, res.version, summary)

    # -- catalog -------------------------------------------------------

    def observe(self, oid: str, version: int, summary: Dict):
        st = PartitionStats.from_summary(oid, version, summary)
        container = self._container_of(oid)
        with self._lock:
            if (len(self._stats) >= self.max_partitions
                    and oid not in self._stats):
                # drop an arbitrary entry: the catalog is a cache, and a
                # miss only costs one always-push partition
                self._stats.pop(next(iter(self._stats)))
            self._stats[oid] = st
            self.version += 1
            self._cver[container] = self._cver.get(container, 0) + 1

    def invalidate(self, oid: str):
        container = self._container_of(oid)
        with self._lock:
            dropped = self._stats.pop(oid, None) is not None
            stale = [k for k in self._sel_obs if k[1] == oid]
            for k in stale:
                del self._sel_obs[k]
            if dropped or stale:
                self.version += 1
                self._cver[container] = self._cver.get(container, 0) + 1

    # -- observed-selectivity feedback (estimate correction) -----------

    def observe_selectivity(self, frag_key: str, oid: str, actual: float,
                            alpha: float = 0.5):
        """Fold the selectivity a shipped fragment *actually* delivered
        (rows out / rows in) into an EWMA keyed by (fragment, object).
        The cost model prefers this over the uniform-range estimate for
        repeats of the same fragment — mis-estimates self-correct from
        real executions instead of compounding (ROADMAP's observed-
        feedback item, scoped to the per-fragment selectivity the
        ship-vs-fetch decision hinges on)."""
        actual = float(min(max(actual, 0.0), 1.0))
        key = (frag_key, oid)
        container = self._container_of(oid)
        with self._lock:
            prev = self._sel_obs.get(key)
            if prev is None:
                if len(self._sel_obs) >= self.max_sel_obs:
                    self._sel_obs.pop(next(iter(self._sel_obs)))
                self._sel_obs[key] = actual
                self.version += 1
                self._cver[container] = self._cver.get(container, 0) + 1
            else:
                self._sel_obs[key] = prev + alpha * (actual - prev)
                # re-observing a stable selectivity must not thrash
                # version-keyed plan caches: bump only on material drift
                if abs(self._sel_obs[key] - prev) > 0.02:
                    self.version += 1
                    self._cver[container] = \
                        self._cver.get(container, 0) + 1

    def observed_selectivity(self, frag_key: str, oid: str
                             ) -> Optional[float]:
        with self._lock:
            return self._sel_obs.get((frag_key, oid))

    def container_version(self, container: str) -> int:
        """Change counter scoped to one container (plus the global
        feedback component): bumps when *that* container's stats,
        selectivity feedback, or any node-bandwidth estimate move —
        and stays put when unrelated containers take writes.  The
        serving plan cache keys on this instead of ``version`` so
        sustained ingest into one container cannot evict every other
        container's warm plans."""
        with self._lock:
            return self._cver.get(container, 0) + self._gver

    def get(self, oid: str) -> Optional[PartitionStats]:
        """Fresh stats for ``oid`` or None (missing or stale)."""
        with self._lock:
            st = self._stats.get(oid)
        if st is None:
            return None
        if self._store is not None:
            try:
                if self._store.meta(oid).version != st.version:
                    return None
            except KeyError:
                return None
        return st

    def fresh(self, oid: str) -> bool:
        return self.get(oid) is not None

    def analyze(self, clovis, container: str) -> int:
        """Eagerly compute stats for every object in ``container`` via
        internal reads (no demand-access bookkeeping).  Returns the
        number of partitions summarized."""
        n = 0
        for oid in clovis.container(container):
            try:
                arr = clovis.materialize(oid, _notify=False)
                version = clovis.store.meta(oid).version
            except (KeyError, IOError):
                continue
            self.observe(oid, version, summarize_rows(arr))
            n += 1
        return n

    def __len__(self) -> int:
        with self._lock:
            return len(self._stats)

    # -- per-node fragment-latency feedback (cluster cost model) -------

    def observe_node_latency(self, node: str, nbytes: int, wall_s: float,
                             alpha: float = 0.25):
        """Fold one observed shipped-fragment execution into the node's
        effective-bandwidth estimate (EWMA of bytes scanned / wall
        seconds).  The cluster shipper reports every routed fragment
        here, so the cost model's per-node TierParams converge from the
        device model's nameplate numbers toward what each node actually
        delivers — a busy or degraded node gets discounted without any
        explicit signal (ROADMAP's observed-feedback item, scoped to
        the per-node timing the placement decision needs)."""
        bw = nbytes / max(wall_s, 1e-9)
        with self._lock:
            obs = self._node_obs.setdefault(
                node, {"read_bw": bw, "samples": 0.0, "bytes": 0.0,
                       "wall_s": 0.0})
            prev_bw = obs["read_bw"]
            obs["read_bw"] += alpha * (bw - obs["read_bw"])
            obs["samples"] += 1
            obs["bytes"] += nbytes
            obs["wall_s"] += wall_s
            # only a *material* bandwidth shift (>10%) invalidates
            # version-keyed plan caches — every ship nudges the EWMA,
            # and bumping per ship would make cached plans unhittable
            if abs(obs["read_bw"] - prev_bw) > 0.1 * max(prev_bw, 1e-9):
                self.version += 1
                # node bandwidth shifts re-cost every container's plans
                self._gver += 1

    def node_read_bw(self, node: str) -> Optional[float]:
        """Learned effective scan bandwidth of a node (bytes/s), or
        None before the first observation."""
        with self._lock:
            obs = self._node_obs.get(node)
            return obs["read_bw"] if obs else None

    def node_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-node observation summary: {node: {read_bw, samples,
        bytes, wall_s}} — bench_cluster reports it next to throughput."""
        with self._lock:
            return {n: dict(o) for n, o in self._node_obs.items()}


# ---------------------------------------------------------------------------
# selectivity estimation over fragment specs
# ---------------------------------------------------------------------------

def _hist_frac_below(cs: ColumnStats, v: float) -> Optional[float]:
    """Approximate fraction of rows with value < v from the equi-width
    histogram (linear interpolation inside v's bin), or None when the
    column carries no histogram."""
    if not cs.hist:
        return None
    total = float(sum(cs.hist))
    if total <= 0 or cs.hi <= cs.lo:
        return None
    if v <= cs.lo:
        return 0.0
    if v >= cs.hi:
        return 1.0
    width = (cs.hi - cs.lo) / len(cs.hist)
    pos = (v - cs.lo) / width
    b = min(int(pos), len(cs.hist) - 1)
    below = sum(cs.hist[:b]) + cs.hist[b] * (pos - b)
    return float(np.clip(below / total, 0.0, 1.0))


def _cmp_selectivity(op: str, cs: ColumnStats, v: float) -> float:
    """Selectivity of ``col <op> v`` — from the per-column equi-width
    histogram when the summary carries one (real distribution, so skew
    stops fooling the ship-vs-fetch decision), falling back to a
    uniform-range assumption; the distinct sketch handles equality."""
    span = cs.hi - cs.lo
    if op in (">", ">="):
        if span <= 0:
            return 1.0 if (cs.lo > v or (op == ">=" and cs.lo >= v)) else 0.0
        below = _hist_frac_below(cs, v)
        if below is not None:
            return 1.0 - below
        return float(np.clip((cs.hi - v) / span, 0.0, 1.0))
    if op in ("<", "<="):
        if span <= 0:
            return 1.0 if (cs.lo < v or (op == "<=" and cs.lo <= v)) else 0.0
        below = _hist_frac_below(cs, v)
        if below is not None:
            return below
        return float(np.clip((v - cs.lo) / span, 0.0, 1.0))
    if op == "==":
        if v < cs.lo or v > cs.hi:
            return 0.0
        return 1.0 / max(cs.distinct, 1.0)
    if op == "!=":
        if v < cs.lo or v > cs.hi:
            return 1.0
        return 1.0 - 1.0 / max(cs.distinct, 1.0)
    raise ValueError(op)

_FLIP = {">": "<", ">=": "<=", "<": ">", "<=": ">=", "==": "==", "!=": "!="}
_CMPS = tuple(_FLIP)


def expr_selectivity(spec: Dict, stats: PartitionStats,
                     colmap: Sequence[int]) -> Optional[float]:
    """Estimated fraction of rows a predicate spec keeps, or None when
    the shape is inestimable (col-vs-col compares, arithmetic
    predicates).  ``colmap`` maps the expr's column indices back to the
    original partition columns (projections upstream re-number them)."""

    def col_of(s: Dict) -> Optional[int]:
        if s.get("t") == "col" and 0 <= s["i"] < len(colmap):
            orig = colmap[s["i"]]
            if 0 <= orig < stats.ncols:
                return orig
        return None

    def lit_of(s: Dict) -> Optional[float]:
        if s.get("t") == "lit" and isinstance(
                s["v"], (int, float, bool, np.integer, np.floating)):
            return float(s["v"])
        return None

    t = spec["t"]
    if t == "not":
        inner = expr_selectivity(spec["e"], stats, colmap)
        return None if inner is None else 1.0 - inner
    if t == "lit":
        return 1.0 if spec["v"] else 0.0
    if t != "bin":
        return None
    op = spec["op"]
    if op == "&":
        l = expr_selectivity(spec["l"], stats, colmap)
        r = expr_selectivity(spec["r"], stats, colmap)
        return None if l is None or r is None else l * r
    if op == "|":
        l = expr_selectivity(spec["l"], stats, colmap)
        r = expr_selectivity(spec["r"], stats, colmap)
        return None if l is None or r is None else l + r - l * r
    if op not in _CMPS:
        return None
    c, v = col_of(spec["l"]), lit_of(spec["r"])
    if c is None or v is None:         # try  lit <op> col  →  col <flip> lit
        c2, v2 = col_of(spec["r"]), lit_of(spec["l"])
        if c2 is None or v2 is None:
            return None
        c, v, op = c2, v2, _FLIP[op]
    return _cmp_selectivity(op, stats.cols[c], v)


@dataclass(frozen=True)
class FragEstimate:
    selectivity: float            # estimated fraction of rows surviving
    out_bytes: int                # estimated partial size crossing back
    rows_out: float
    exact: bool                   # False when any predicate fell back


def estimate_fragment(frag_spec: Sequence[Dict], stats: PartitionStats
                      ) -> FragEstimate:
    """Walk a fragment spec against partition stats: track the column
    mapping through projections, multiply filter selectivities, and
    size the output partial by the terminal op's merge kind."""
    colmap = list(range(stats.ncols))
    sel, exact = 1.0, True
    key_distinct: Optional[float] = None
    grouped = False
    window: Optional[Dict] = None
    agg: Optional[Dict] = None
    for s in frag_spec:
        kind = s["op"]
        if kind == "filter":
            e = expr_selectivity(s["expr"], stats, colmap)
            if e is None:
                e, exact = DEFAULT_SEL, False
            sel *= e
        elif kind == "select":
            colmap = [colmap[c] if 0 <= c < len(colmap) else -1
                      for c in s["cols"]]
        elif kind == "key_by":
            grouped = True
            k = s["key"]
            if (k.get("t") == "col" and 0 <= k["i"] < len(colmap)
                    and 0 <= colmap[k["i"]] < stats.ncols):
                key_distinct = stats.cols[colmap[k["i"]]].distinct
        elif kind == "window":
            window = s
        elif kind == "aggregate":
            agg = s
    rows_out = sel * stats.rows
    if agg is None:
        out = rows_out * max(len(colmap), 1) * stats.itemsize
    elif agg["agg"] == "histogram":
        out = agg["bins"] * 4
    elif grouped:
        groups = min(key_distinct if key_distinct else 64.0,
                     max(rows_out, 1.0))
        # int64 keys + payload (mean ships (sum, count) pairs)
        out = groups * (8 + (12 if agg["agg"] == "mean" else 8))
    elif window is not None:
        slide = window["slide"] or window["size"]
        out = max(rows_out / max(slide, 1), 1.0) * 8
    else:
        out = 24                   # scalar partial
    return FragEstimate(sel, int(out), rows_out, exact)


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NetworkModel:
    """Caller↔store interconnect (same parameters bench_analytics
    models latency with)."""
    bw: float = 1e9               # bytes/s
    latency_s: float = 50e-6      # per-partition RPC


@dataclass(frozen=True)
class ComputeModel:
    """Relative compute throughput: storage-side executors are the
    store's (weaker, shared) CPUs; the caller is the compute cluster."""
    store_bps: float = 2e9        # bytes/s a store node filters/reduces
    caller_bps: float = 8e9       # bytes/s the caller does
    contention_beta: float = 1.0  # how strongly heat discounts the store


@dataclass(frozen=True)
class Decision:
    """One partition's costed placement."""
    mode: str                     # ship | fetch | cached
    est_ship_s: float
    est_fetch_s: float
    est_moved: int                # predicted bytes crossing to caller
    selectivity: Optional[float]  # None = no stats (cold start)
    reason: str

    @property
    def est_s(self) -> float:
        if self.mode == CACHED:
            return 0.0
        return self.est_ship_s if self.mode == SHIP else self.est_fetch_s


class CostModel:
    """Per-partition ship-vs-fetch decision from tier parameters,
    contention, and selectivity statistics.

        scan_s  = tier.latency + size / tier.read_bw          (both modes)
        ship_s  = scan_s + size / (store_bps / (1 + β·load))
                  + net.latency + est_out / net.bw
        fetch_s = scan_s + net.latency + size / net.bw
                  + size / caller_bps

    No stats → ship (cold-start fallback: the always-push behaviour,
    and the shipped fragment piggybacks stats for next time).
    """

    def __init__(self, net: Optional[NetworkModel] = None,
                 compute: Optional[ComputeModel] = None):
        self.net = net or NetworkModel()
        self.compute = compute or ComputeModel()

    def decide(self, frag_spec: Sequence[Dict], *,
               stats: Optional[PartitionStats], size: int,
               tier: Optional[TierParams], load: float = 0.0,
               observed_sel: Optional[float] = None) -> Decision:
        net, comp = self.net, self.compute
        scan_s = tier.read_s(size) if tier else size / 1e9
        store_bps = comp.store_bps / (1.0 + comp.contention_beta
                                      * max(load, 0.0))
        fetch_s = (scan_s + net.latency_s + size / net.bw
                   + size / comp.caller_bps)
        if stats is None:
            ship_s = scan_s + size / store_bps + net.latency_s
            return Decision(SHIP, ship_s, fetch_s, 0, None,
                            "cold start: no partition stats, "
                            "defaulting to pushdown")
        est = estimate_fragment(frag_spec, stats)
        sel, how = est.selectivity, "sel"
        if observed_sel is not None:
            # an actually-observed selectivity for this exact fragment
            # beats the uniform-range estimate: rescale the predicted
            # partial size by observed/estimated
            sel, how = observed_sel, "obs_sel"
            scale = observed_sel / max(est.selectivity, 1e-9)
            out = min(int(est.out_bytes * min(scale, 1e6)), max(size, 1))
        else:
            out = min(est.out_bytes, max(size, 1))
        ship_s = scan_s + size / store_bps + net.latency_s + out / net.bw
        if ship_s <= fetch_s:
            return Decision(
                SHIP, ship_s, fetch_s, out, sel,
                f"{how}={sel:.3f} est_out={out}B: "
                "partial is cheaper to move than raw bytes")
        return Decision(
            FETCH, ship_s, fetch_s, size, sel,
            f"{how}={sel:.3f} est_out={out}B: pushdown "
            "pointless, raw bytes cross either way and caller computes "
            "faster")


# ---------------------------------------------------------------------------
# placement context (plan.optimize hook)
# ---------------------------------------------------------------------------

@dataclass
class CostContext:
    """Everything ``plan.optimize`` needs to place a query's partitions:
    the cost model, the stats catalog, the live store (tier map +
    sizes), per-partition contention, and a probe into the engine's
    partial cache.  Built by the executor per query; ``place`` is pure
    (the executor records the ADDB trace after planning)."""

    model: CostModel
    store: Any
    oids: Sequence[str]
    catalog: Optional[StatsCatalog] = None
    load: Dict[str, float] = field(default_factory=dict)
    cache_probe: Optional[Callable[[str, str], bool]] = None
    tiers: Optional[Dict[str, TierParams]] = None
    # per-partition TierParams override — the cluster planner maps each
    # partition to the *owning node's* tier parameters (blended with the
    # node's observed fragment bandwidth), which a store-global tier map
    # cannot express
    tier_of: Optional[Callable[[str], Optional[TierParams]]] = None

    def place(self, plan) -> Dict[str, Decision]:
        """Per-partition decisions for a PhysicalPlan (duck-typed:
        anything with ``frag_spec``)."""
        tiers = self.tiers or tier_params(self.store)
        frag_key = frag_cache_key(plan.frag_spec)
        # fusible fragments scan only the columns they read: on colblock
        # partitions the ranged read prices in at the pruned byte count
        from repro_torch.analytics.plan import frag_columns, prunable_columns
        frag_cols = frag_columns(plan.frag_spec)
        out: Dict[str, Decision] = {}
        for oid in self.oids:
            if self.cache_probe is not None and self.cache_probe(frag_key,
                                                                 oid):
                out[oid] = Decision(CACHED, 0.0, 0.0, 0, None,
                                    "fresh cached partial for this "
                                    "fragment + object version")
                continue
            try:
                if self.tier_of is not None:
                    tier = self.tier_of(oid)
                else:
                    tier = tiers.get(self.store.meta(oid).layout.tier)
                size = self.store.read_size(oid)
                if frag_cols is not None:
                    attrs = self.store.meta(oid).attrs
                    cols = prunable_columns(plan.frag_spec, attrs)
                    if cols is not None:
                        from repro_torch.core.columnar import column_nbytes
                        size = column_nbytes(attrs, cols)
            except KeyError:
                out[oid] = Decision(SHIP, 0.0, 0.0, 0, None,
                                    "object meta unavailable")
                continue
            stats = self.catalog.get(oid) if self.catalog else None
            obs_sel = (self.catalog.observed_selectivity(frag_key, oid)
                       if self.catalog else None)
            out[oid] = self.model.decide(plan.frag_spec, stats=stats,
                                         size=size, tier=tier,
                                         load=self.load.get(oid, 0.0),
                                         observed_sel=obs_sel)
        return out


def frag_cache_key(frag_spec: Sequence[Dict]) -> str:
    """Canonical identity of a fragment — the partial-cache key prefix
    (full key adds object id + version)."""
    return json.dumps(list(frag_spec), sort_keys=True, default=str)

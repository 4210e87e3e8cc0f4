"""Function shipping — move the computation to the data (paper §3.2.1).

Instead of fetching raw objects to the compute cluster, registered
functions are invoked *at the store* via an RPC-shaped API: the executor
reads blocks locally, runs a function on them (the builtins in PyTorch
on the Clovis stack's device), and returns only the (small) result.

Shipped computations are *resilient*: failures are caught, retried per
policy, and reported — matching the paper's requirement that offloaded
computations tolerate errors.

Built-in library: reductions (sum/mean/min/max/norm), histogram,
quantize (int8 compression stats), checksum, top-k — the data-analytics
primitives the paper's ALF/Spectre/Savu use cases need; also
``ship_to_container`` for the paper's one-shot per-container operations.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.clovis import Clovis


def _histogram32(x: torch.Tensor) -> np.ndarray:
    """32-bin histogram over the data's own [min, max] range with
    ``jnp.histogram``'s edges and edge rule (not ``torch.histc``'s: a
    value on an inner edge counts in the bin above it, the maximum in
    the last bin): edges ``lo * (1 - i/32) + hi * i/32`` in float32,
    then a right-sided search."""
    lo, hi = x.min(), x.max()
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    step = torch.arange(32, dtype=torch.float32, device=x.device) / 32.0
    edges = torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], torch.full_like(idx, 32), idx)
    return torch.bincount(idx, minlength=33)[1:33].to(torch.float32) \
        .cpu().numpy()


@dataclass
class ShipResult:
    oid: str
    fn: str
    ok: bool
    value: Any = None
    error: str = ""
    retries: int = 0
    version: int = -1       # object version the shipped read saw (-1 n/a)


@dataclass
class PartialAgg:
    """A distributive/algebraic aggregate: ``partial`` runs *at the
    store* per object and returns a small partial state; ``combine``
    merges the per-object partials at the caller.  Only the partials
    cross the wire — the pushdown contract the analytics engine builds
    on (paper's 'move the computation to the data')."""
    partial: Callable[[np.ndarray], Any]
    combine: Callable[[List[Any]], Any]


class FunctionShipper:
    def __init__(self, clovis: Clovis, max_workers: int = 4,
                 max_retries: int = 2):
        self.clovis = clovis
        self.device = clovis.device      # where the torch builtins run
        self.max_retries = max_retries
        self._registry: Dict[str, Callable[[np.ndarray], Any]] = {}
        self._partials: Dict[str, PartialAgg] = {}
        self._observers: List[Callable[[ShipResult], None]] = []
        self._pool = cf.ThreadPoolExecutor(max_workers=max_workers,
                                           thread_name_prefix="sage-ship")
        self._lock = threading.Lock()
        self._register_builtins()

    def register(self, name: str, fn: Callable[[np.ndarray], Any]):
        with self._lock:
            self._registry[name] = fn

    def unregister(self, name: str):
        with self._lock:
            self._registry.pop(name, None)

    def add_observer(self, fn: Callable[[ShipResult], None]):
        """fn(ShipResult) after every shipped invocation settles — the
        analytics StatsCatalog harvests piggybacked partition statistics
        here, so every fragment that already touched the data store-side
        refreshes selectivity stats for free."""
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)

    def remove_observer(self, fn: Callable[[ShipResult], None]):
        with self._lock:
            if fn in self._observers:
                self._observers.remove(fn)

    def _notify(self, res: ShipResult) -> ShipResult:
        with self._lock:
            obs = list(self._observers)
        for fn in obs:
            try:
                fn(res)
            except Exception:
                pass   # observers must not break the shipping path
        return res

    def register_partial(self, name: str, partial: Callable[[np.ndarray], Any],
                         combine: Callable[[List[Any]], Any]):
        """Register a partial aggregate under the partial-agg namespace
        (separate from ``register`` so existing whole-result functions
        keep their semantics)."""
        with self._lock:
            self._partials[name] = PartialAgg(partial, combine)

    def partial_agg(self, name: str) -> PartialAgg:
        """Look up a registered partial aggregate.  Batch pushdown
        (``ship_partial``) and the streaming continuous-query operator
        (analytics/streaming.py) resolve aggregates through this one
        registry, so a window's partial/combine semantics cannot drift
        from the batch engine's."""
        with self._lock:
            if name not in self._partials:
                raise KeyError(f"unknown partial aggregate {name!r}")
            return self._partials[name]

    def _register_builtins(self):
        dev = self.device

        def f32(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(
                np.ascontiguousarray(a, np.float32)).to(dev)

        def red(op):
            return lambda arr: op(f32(arr)).item()

        self.register("sum", red(torch.sum))
        self.register("mean", red(torch.mean))
        self.register("min", red(torch.min))
        self.register("max", red(torch.max))
        self.register("l2norm", red(lambda x: torch.sqrt(torch.sum(x * x))))
        self.register("histogram", lambda a: _histogram32(f32(a)))

        def quant(a):
            x = f32(a)
            scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            return {"int8": q.cpu().numpy(), "scale": float(scale)}

        self.register("quantize_int8", quant)
        self.register("checksum", lambda a: zlib.crc32(a.tobytes()))
        self.register(
            "topk_abs",
            lambda a: np.sort(np.abs(a.reshape(-1)))[-8:][::-1].copy())

        # distributive/algebraic partial aggregates: each object yields a
        # tiny partial, combined caller-side — the pushdown primitives
        self.register_partial("sum", lambda a: float(np.sum(a, dtype=np.float64)),
                              lambda ps: float(np.sum(ps)))
        self.register_partial("count", lambda a: int(a.size),
                              lambda ps: int(np.sum(ps)))
        self.register_partial(
            "mean",
            lambda a: (float(np.sum(a, dtype=np.float64)), int(a.size)),
            lambda ps: (sum(s for s, _ in ps) / max(sum(c for _, c in ps), 1)))
        self.register_partial("min", lambda a: float(np.min(a)),
                              lambda ps: float(np.min(ps)))
        self.register_partial("max", lambda a: float(np.max(a)),
                              lambda ps: float(np.max(ps)))

    # ------------------------------------------------------------------

    def _run_once(self, fn_name: str, oid: str) -> Any:
        fn = self._registry[fn_name]
        return fn(self.clovis.materialize(oid))

    def _version_of(self, oid: str) -> int:
        """Object version captured *before* the read: versions are
        monotonic, so data materialized afterwards is at least this
        version — stats/caches stamped with it can never claim a newer
        version than the bytes they describe."""
        try:
            return self.clovis.store.meta(oid).version
        except KeyError:
            return -1

    def ship(self, fn_name: str, oid: str) -> ShipResult:
        """Synchronous shipped invocation with retries."""
        if fn_name not in self._registry:
            return ShipResult(oid, fn_name, False, error="unknown function")
        err = ""
        for attempt in range(self.max_retries + 1):
            try:
                ver = self._version_of(oid)
                val = self._run_once(fn_name, oid)
                return self._notify(
                    ShipResult(oid, fn_name, True, val, retries=attempt,
                               version=ver))
            except Exception as e:     # resilient offload: catch & retry
                err = f"{type(e).__name__}: {e}"
        return self._notify(ShipResult(oid, fn_name, False, error=err,
                                       retries=self.max_retries))

    def ship_columns(self, fn_name: str, oid: str,
                     columns: Sequence[int]) -> ShipResult:
        """Shipped invocation over a column-pruned read: the registered
        function receives a ``ColumnBatch`` holding only ``columns``,
        read with ranged block fetches (colblock objects) instead of a
        whole-object materialisation.  Same retry/version/observer
        contract as ``ship``."""
        if fn_name not in self._registry:
            return ShipResult(oid, fn_name, False, error="unknown function")
        fn = self._registry[fn_name]
        err = ""
        for attempt in range(self.max_retries + 1):
            try:
                ver = self._version_of(oid)
                batch = self.clovis.read_columns(oid, list(columns))
                return self._notify(
                    ShipResult(oid, fn_name, True, fn(batch),
                               retries=attempt, version=ver))
            except Exception as e:     # resilient offload: catch & retry
                err = f"{type(e).__name__}: {e}"
        return self._notify(ShipResult(oid, fn_name, False, error=err,
                                       retries=self.max_retries))

    def ship_async(self, fn_name: str, oid: str) -> "cf.Future[ShipResult]":
        return self._pool.submit(self.ship, fn_name, oid)

    def ship_to_container(self, fn_name: str, container: str
                          ) -> List[ShipResult]:
        """One-shot operation over every object in a container (paper's
        container-level function shipping)."""
        futs = [self.ship_async(fn_name, oid)
                for oid in self.clovis.container(container)]
        return [f.result() for f in futs]

    # ------------------------------------------------------------------
    # partial-aggregate shipping (analytics pushdown substrate)
    # ------------------------------------------------------------------

    def ship_partial(self, agg_name: str, container: str
                     ) -> Tuple[Any, List[ShipResult]]:
        """Run a registered partial aggregate at the store for every
        object in ``container`` and combine the partials caller-side.

        Returns ``(combined, per_object_results)``; objects whose shipped
        partial failed (after retries) are excluded from the combine and
        reported in their ShipResult.
        """
        agg = self.partial_agg(agg_name)
        oids = self.clovis.container(container)
        futs = [self._pool.submit(self._ship_with, agg.partial, agg_name, oid)
                for oid in oids]
        results = [f.result() for f in futs]
        partials = [r.value for r in results if r.ok]
        combined = agg.combine(partials) if partials else None
        return combined, results

    def _ship_with(self, fn: Callable[[np.ndarray], Any], fn_name: str,
                   oid: str) -> ShipResult:
        """Ship an unregistered callable (retry loop shared with ship)."""
        err = ""
        for attempt in range(self.max_retries + 1):
            try:
                ver = self._version_of(oid)
                return self._notify(
                    ShipResult(oid, fn_name, True,
                               fn(self.clovis.materialize(oid)),
                               retries=attempt, version=ver))
            except Exception as e:      # resilient offload: catch & retry
                err = f"{type(e).__name__}: {e}"
        return self._notify(ShipResult(oid, fn_name, False, error=err,
                                       retries=self.max_retries))

    def ship_blocks(self, fn_name: str, oid: str) -> ShipResult:
        """Per-block shipped invocation: the executor streams the object
        block-by-block through ``fn`` instead of materialising it whole
        — ``value`` is the list of per-block results, in block order.
        Blocks are raw bytes views (uint8), since a block boundary need
        not align with the object's logical element type.
        """
        if fn_name not in self._registry:
            return ShipResult(oid, fn_name, False, error="unknown function")
        fn = self._registry[fn_name]
        err = ""
        for attempt in range(self.max_retries + 1):
            try:
                meta = self.clovis.store.meta(oid)
                size = self.clovis.store.read_size(oid)
                out = []
                for idx in range(meta.nblocks):
                    blk = self.clovis.store.read(oid, idx, 1)
                    lo = idx * meta.block_size
                    blk = blk[: max(0, min(len(blk), size - lo))]
                    out.append(fn(np.frombuffer(blk, dtype=np.uint8)))
                return ShipResult(oid, fn_name, True, out, retries=attempt)
            except Exception as e:      # resilient offload: catch & retry
                err = f"{type(e).__name__}: {e}"
        return ShipResult(oid, fn_name, False, error=err,
                          retries=self.max_retries)

    def shutdown(self):
        self._pool.shutdown(wait=True)

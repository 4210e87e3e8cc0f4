"""The port's serving front door against the reference's.

Request validation, the wire form of a query (the JSON the plan cache
and single-flight key on), token buckets, the deficit-round-robin queue
and admission run through ``repro.serving`` and ``repro_torch.serving``
side by side and must agree.  ``QueryService`` over the port
(``device="cpu"``: the kernels' plain PyTorch versions) must answer the
same requests with the reference's values, on one node and on a
cluster; int results byte for byte.
"""
import json
import threading
import time

import numpy as np
import pytest

import repro.serving as jsv
from repro.analytics import col as jcol
from repro.analytics import lit as jlit
from repro.analytics.cost import frag_cache_key as jfrag_key
from repro.cluster import ClusterClovis as JCluster
from repro.core.addb import Addb as JAddb
from repro.core.clovis import Clovis as JClovis
from repro_torch._ext import KernelLaunchError
from repro_torch.analytics import col, lit
from repro_torch.analytics import kernels as K
from repro_torch.analytics.cost import frag_cache_key
from repro_torch.cluster import ClusterClovis
from repro_torch.core.addb import Addb
from repro_torch.core.clovis import Clovis
from repro_torch.core.function_shipping import FunctionShipper
from repro_torch.serving import (AdmissionController, AdmissionRejected,
                                 ClusterServingEngine, FairQueue,
                                 QueryRequest, QuotaExceeded, ServingEngine,
                                 TenantConfig, TokenBucket, ValidationError,
                                 validate_ops)

FILTER_GT0 = {"op": "filter", "expr": {"t": "bin", "op": ">",
                                       "l": {"t": "col", "i": 0},
                                       "r": {"t": "lit", "v": 0}}}
COUNT = {"op": "aggregate", "agg": "count"}
SUM1 = {"op": "aggregate", "agg": "sum", "value": {"t": "col", "i": 1}}
KEY0 = {"op": "key_by", "key": {"t": "col", "i": 0}}

CHAINS = {
    "count": [FILTER_GT0, COUNT],
    "select count": [FILTER_GT0, {"op": "select", "cols": [0, 1]}, COUNT],
    "grouped sum": [FILTER_GT0, KEY0, {"op": "aggregate", "agg": "sum",
                                       "value": {"t": "col", "i": 2}}],
    "histogram": [{"op": "aggregate", "agg": "histogram", "bins": 8,
                   "vrange": [-50, 50], "value": {"t": "col", "i": 2}}],
    "window max": [{"op": "window", "size": 16, "slide": 16},
                   {"op": "aggregate", "agg": "max",
                    "value": {"t": "col", "i": 2}}],
    # malformed: each must raise ValidationError in both packages
    "unknown agg": [{"op": "aggregate", "agg": "nope"}],
    "aggregate not last": [COUNT, FILTER_GT0],
    "transform after key_by": [KEY0, FILTER_GT0],
    "histogram without vrange": [{"op": "aggregate", "agg": "histogram",
                                  "bins": 8}],
    "not an op": [{"nope": 1}],
    "key_by without aggregate": [KEY0],
    "too long": [FILTER_GT0] * 100,
    "not a list": "not a list",
}


def _events(cl, n_objects=4, rows=256, seed=0, container="events"):
    """(key, filter, value, part) int32 tables (tests/conftest.py's
    make_events with keys in [-50, 50))."""
    rng = np.random.default_rng(seed)
    arrs = []
    for i in range(n_objects):
        a = np.empty((rows, 4), np.int32)
        a[:, 0] = rng.integers(-50, 50, rows)
        a[:, 1] = rng.integers(0, 100, rows)
        a[:, 2] = rng.integers(-40, 40, rows)
        a[:, 3] = i
        cl.put_array(f"{container}/{i:02d}", a, container=container)
        arrs.append(a)
    return np.vstack(arrs)


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# validation and the wire form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CHAINS))
def test_validate_ops_agrees_with_reference(name):
    from repro.analytics.plan import op_to_spec as jspec
    from repro_torch.analytics.plan import op_to_spec
    chain = CHAINS[name]
    try:
        want = [jspec(o) for o in jsv.validate_ops(chain)]
    except jsv.ValidationError:
        with pytest.raises(ValidationError):
            validate_ops(chain)
        return
    got = [op_to_spec(o) for o in validate_ops(chain)]
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


QUERIES = {
    "a_mean": lambda e, c, L: e.scan("events").filter(c(1) >= 75).key_by(
        c(0)).aggregate("mean", value=c(2)),
    "b_count": lambda e, c, L: e.scan("events").filter(c(1) >= 75).key_by(
        c(0)).aggregate("count"),
    "c_histogram": lambda e, c, L: e.scan("events").aggregate(
        "histogram", value=c(2), bins=32, vrange=(-40, 40)),
    "d_window_max": lambda e, c, L: e.scan("events").window(16).aggregate(
        "max", value=c(2)),
    "count_gt0": lambda e, c, L: e.scan("events").filter(
        c(0) > L(0)).aggregate("count"),
}


@pytest.mark.parametrize("name", list(QUERIES))
def test_wire_form_and_flight_keys_match_reference(tmp_path, name):
    """A request built from the same Dataset chain serialises to the
    same JSON, so plan-cache fingerprints and single-flight keys (the
    fragment spec's JSON) are the reference's."""
    from repro.analytics.plan import optimize as joptimize
    from repro_torch.analytics.plan import optimize
    jc = JClovis(tmp_path / "ref", addb=JAddb(), devices_per_tier=3)
    pc = Clovis(tmp_path / "port", addb=Addb(), devices_per_tier=3,
                device="cpu")
    je, pe = jc.analytics(use_kernels=False), pc.analytics()
    try:
        jds = QUERIES[name](je, jcol, jlit)
        pds = QUERIES[name](pe, col, lit)
        jreq = jsv.QueryRequest.from_dataset("t", jds)
        preq = QueryRequest.from_dataset("t", pds)
        assert json.dumps(preq.ops, sort_keys=True) == \
            json.dumps(jreq.ops, sort_keys=True)
        jplan, pplan = joptimize(jds.ops), optimize(pds.ops)
        assert frag_cache_key(pplan.frag_spec) == \
            jfrag_key(jplan.frag_spec)
    finally:
        je.close()
        pe.close()


def test_tenant_config_validation():
    for bad in (dict(tenant_id=""), dict(tenant_id="t", priority=0.0),
                dict(tenant_id="t", byte_quota_per_s=0.0),
                dict(tenant_id="t", max_queue=0)):
        with pytest.raises(ValidationError):
            TenantConfig(**bad)
        with pytest.raises(jsv.ValidationError):
            jsv.TenantConfig(**bad)


# ---------------------------------------------------------------------------
# token buckets, fair queue, admission
# ---------------------------------------------------------------------------

def test_token_bucket_charge_refill_reconcile():
    b = TokenBucket(rate=1000.0, burst=100.0)
    assert b.try_charge(100.0)
    assert not b.try_charge(50.0)
    time.sleep(0.06)
    assert b.try_charge(40.0)
    b = TokenBucket(rate=10.0, burst=100.0)
    assert b.try_charge(80.0)
    b.reconcile(estimated=80.0, actual=20.0)      # refund 60
    assert b.level >= 79.0
    assert b.try_charge(80.0)
    b.reconcile(estimated=80.0, actual=300.0)     # under-estimate: debit
    assert b.level < 0 and not b.try_charge(1.0)
    unmetered = TokenBucket(rate=float("inf"))
    assert all(unmetered.try_charge(1e18) for _ in range(10))


def _serve_order(pkg, configs, pushes, quantum, n=None):
    adm = pkg.AdmissionController({c[0]: pkg.TenantConfig(*c)
                                   for c in configs})
    q = pkg.FairQueue(adm.tenants, quantum=quantum)
    for tid, i, cost in pushes:
        q.push(tid, (tid, i), cost)
    out = []
    while len(q) and (n is None or len(out) < n):
        out.append(q.pop(timeout=0.1))
    return out


FAIR_CASES = {
    "equal": ((("a",), ("b",)), [(t, i, 1024) for t in "ab"
                                 for i in range(20)], 1024),
    "weighted 3:1": ((("hi", 3.0), ("lo", 1.0)),
                     [(t, i, 1024) for t in ("hi", "lo")
                      for i in range(40)], 1024),
    "big and small": ((("big",), ("small",)),
                      [("big", i, 1000) for i in range(5)]
                      + [("small", i, 100) for i in range(50)], 100),
}


@pytest.mark.parametrize("case", list(FAIR_CASES))
def test_fair_queue_serves_in_reference_order(case):
    import repro_torch.serving as psv
    configs, pushes, quantum = FAIR_CASES[case]
    got = _serve_order(psv, configs, pushes, quantum)
    assert got == _serve_order(jsv, configs, pushes, quantum)
    first = [t for t, _ in got[:len(got) // 2]]
    if case == "equal":
        assert 6 <= first[:20].count("a") <= 14
    elif case == "weighted 3:1":
        assert first[:40].count("hi") >= 24
    else:
        assert [t for t, _ in got[:22]].count("small") >= 15


def test_fair_queue_close_wakes_poppers():
    adm = AdmissionController({"a": TenantConfig("a")})
    q = FairQueue(adm.tenants)
    out = []
    t = threading.Thread(target=lambda: out.append(q.pop(timeout=5.0)))
    t.start()
    q.close()
    t.join(timeout=2.0)
    assert not t.is_alive() and out == [None]


def test_admission_quota_rollback_and_queue_bound():
    adm = AdmissionController({"t": TenantConfig(
        "t", byte_quota_per_s=1000.0, byte_burst=1000.0,
        compute_quota_per_s=1.0, compute_burst=1.0)})
    adm.admit("t", 500.0, 0.5)
    with pytest.raises(QuotaExceeded):
        adm.admit("t", 400.0, 5.0)
    assert adm.state("t").bytes_bucket.level >= 499.0
    assert adm.state("t").shed["quota"] == 1
    adm = AdmissionController({"t": TenantConfig("t", max_queue=2)})
    st = adm.state("t")
    st.queue.extend([("x", 1.0), ("y", 1.0)])
    with pytest.raises(AdmissionRejected):
        adm.admit("t", 1.0, 0.0)
    assert st.shed["queue_full"] == 1


# ---------------------------------------------------------------------------
# single flight
# ---------------------------------------------------------------------------

def test_single_flight_n_waiters_one_ship(tmp_path, monkeypatch):
    pc = Clovis(tmp_path / "port", addb=Addb(), devices_per_tier=3,
                device="cpu")
    arrs = _events(pc, n_objects=2)
    eng = pc.analytics(engine_cls=ServingEngine, cost_based=False,
                       partial_cache_size=0)
    orig = FunctionShipper.ship

    def slow_ship(self, name, oid, **kw):
        time.sleep(0.3)                       # hold the flight open
        return orig(self, name, oid, **kw)
    monkeypatch.setattr(FunctionShipper, "ship", slow_ship)
    n, results, stats = 4, [], []
    lock = threading.Lock()

    def go():
        res = eng.run(eng.scan("events").filter(col(0) > lit(0))
                      .aggregate("count"))
        with lock:
            results.append(int(res.value))
            stats.append(res.stats)
    try:
        threads = [threading.Thread(target=go) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        fl = eng.flights.stats()
    finally:
        eng.close()
    assert results == [int((arrs[:, 0] > 0).sum())] * n
    assert fl["ships"] + fl["dedup_hits"] == n * 2
    assert 0 < fl["dedup_hits"] and fl["ships"] < n * 2
    assert sum(s.dedup_hits for s in stats) == fl["dedup_hits"]
    assert fl["in_flight"] == 0


# ---------------------------------------------------------------------------
# QueryService end to end
# ---------------------------------------------------------------------------

def _requests(pkg, eng, c, L):
    reqs = [pkg.QueryRequest.from_dataset(t, QUERIES[n](eng, c, L),
                                          tag=f"{t}/{n}/{rep}")
            for rep in range(2) for t in ("ops", "science") for n in QUERIES]
    return reqs + [pkg.QueryRequest("ops", "events", (FILTER_GT0, COUNT)),
                   pkg.QueryRequest("science", "events", (SUM1,))]


def _serve(pkg, cl, c, L, **kw):
    svc = cl.serving([pkg.TenantConfig("ops"),
                      pkg.TenantConfig("science", priority=2.0)],
                     workers=4, **kw)
    try:
        subs = [svc.submit(r) for r in _requests(pkg, svc.engine, c, L)]
        resps = [s.result(timeout=120) for s in subs]
        stages = {r.tag: {t["stage"] for t in svc.addb.serving_trace(r.tag)}
                  for r in resps}
        return svc.engine, resps, stages
    finally:
        svc.close()


@pytest.mark.parametrize("where", ["one node", "cluster"])
def test_query_service_matches_reference(tmp_path, where):
    if where == "one node":
        jc = JClovis(tmp_path / "ref", addb=JAddb(), devices_per_tier=3)
        pc = Clovis(tmp_path / "port", addb=Addb(), devices_per_tier=3,
                    device="cpu")
        engine_cls = ServingEngine
    else:
        jc = JCluster(tmp_path / "ref", nodes=3, replicas=2)
        pc = ClusterClovis(tmp_path / "port", nodes=3, replicas=2,
                           device="cpu")
        engine_cls = ClusterServingEngine
    want = _events(jc)
    assert np.array_equal(_events(pc), want)
    _, jresps, _ = _serve(jsv, jc, jcol, jlit, use_kernels=False)
    import repro_torch.serving as psv
    eng, resps, stages = _serve(psv, pc, col, lit)
    assert type(eng) is engine_cls
    assert len(resps) == len(jresps) == 2 * 2 * len(QUERIES) + 2
    shared = 0
    for r, j in zip(resps, jresps):
        assert r.ok and j.ok, (r.error, j.error)
        assert r.tag == j.tag and _same(r.value, j.value), r.tag
        shared += r.stats.dedup_hits + r.stats.cache_hits
        assert {"admit", "queue", "plan", "execute", "merge",
                "done"} <= stages[r.tag]
    assert shared > 0
    assert int(resps[-2].value) == int((want[:, 0] > 0).sum())
    assert int(resps[-1].value) == int(want[:, 1].sum())
    if where == "cluster":
        jc.close()
        pc.close()


def test_kernel_fault_is_an_error_response(tmp_path, monkeypatch):
    """A kernel fault fails the query it hit, named in the response;
    the service keeps serving."""
    pc = Clovis(tmp_path / "port", addb=Addb(), devices_per_tier=3,
                device="cpu")
    _events(pc)
    svc = pc.serving([TenantConfig("t")], workers=2, partial_cache_size=0)
    try:
        req = QueryRequest.from_dataset("t", QUERIES["a_mean"](
            svc.engine, col, lit))

        def broken(*a, **kw):
            raise KernelLaunchError("fused_filter_aggregate: launch failed")
        with monkeypatch.context() as m:
            m.setattr(K, "fused_filter_aggregate", broken)
            bad = svc.query(req, timeout=60)
        good = svc.query(req, timeout=60)
    finally:
        svc.close()
    assert not bad.ok and "KernelLaunchError" in bad.error
    assert good.ok and len(good.value[0]) > 0


def test_service_shutdown_rejects_new(tmp_path):
    pc = Clovis(tmp_path / "port", addb=Addb(), devices_per_tier=3,
                device="cpu")
    _events(pc)
    svc = pc.serving([TenantConfig("t")], workers=1)
    svc.close()
    with pytest.raises(AdmissionRejected):
        svc.submit(QueryRequest("t", "events", (COUNT,)))

"""The port's storage cluster against the reference's.

The same numpy-seeded puts go into ``repro.cluster.ClusterClovis`` and
``repro_torch.cluster.ClusterClovis`` (``device="cpu"``: the kernels'
plain PyTorch versions).  Placement and rebalance plans must be the
reference's, replicas must hold the same bytes under the same version
stamps, and cluster queries must give the reference cluster's results:
int aggregates byte for byte, f32 sums within ``F32_SUM_RTOL`` of the
sum of |v| (the card adds f32 sums over more than 32 segments in a
varying order).  A node killed mid-scan leaves the result byte-identical.
"""
import numpy as np
import pytest
import torch

from repro.analytics import col as jcol
from repro.cluster import ClusterClovis as JCluster
from repro.cluster import HashRing as JRing
from repro.cluster import plan_rebalance as jplan
from repro_torch._ext import KernelLaunchError
from repro_torch.analytics import col
from repro_torch.analytics import kernels as K
from repro_torch.analytics.executor import AnalyticsError
from repro_torch.cluster import ClusterClovis, HashRing, plan_rebalance
from repro_torch.core import Clovis
from repro_torch.device import NoCudaDeviceError

F32_SUM_RTOL = 1e-5
PARTS, ROWS, KEYS = 12, 256, 40
NODE_SPECS = {
    "4 nodes": 4,
    "5 nodes, 3 domains": [("a1", "rackA"), ("a2", "rackA"),
                           ("b1", "rackB"), ("b2", "rackB"),
                           ("c1", "rackC")],
}


def _tables(seed=3):
    """(key, quality, reading, shard) int32 tables and an f32 column
    table, as the analytics tour and the reference's cluster tests."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(PARTS):
        t = np.empty((ROWS, 4), np.int32)
        t[:, 0] = rng.integers(0, KEYS, ROWS)
        t[:, 1] = rng.integers(0, 100, ROWS)
        t[:, 2] = rng.integers(-500, 500, ROWS)
        t[:, 3] = i
        out[f"capture/{i:02d}"] = t
        out[f"events/{i:02d}"] = rng.normal(size=(ROWS, 3)).astype(
            np.float32)
    return out


def _fill(cluster, tables):
    for oid, t in tables.items():
        cluster.put_array(oid, t, container=oid.split("/")[0])


@pytest.fixture()
def pair(tmp_path):
    """A reference and a port cluster of 4 nodes, 2 replicas, holding
    the same tables."""
    tables = _tables()
    jc = JCluster(tmp_path / "ref", nodes=4, replicas=2)
    pc = ClusterClovis(tmp_path / "port", nodes=4, replicas=2, device="cpu")
    _fill(jc, tables)
    _fill(pc, tables)
    yield jc, pc, tables
    jc.close()
    pc.close()


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", list(NODE_SPECS), ids=list(NODE_SPECS))
@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_owners_match_reference(tmp_path, spec, replicas):
    nodes = NODE_SPECS[spec]
    jc = JCluster(tmp_path / "ref", nodes=nodes, replicas=replicas)
    pc = ClusterClovis(tmp_path / "port", nodes=nodes, replicas=replicas,
                       device="cpu")
    try:
        oids = [f"part/{i}" for i in range(1000)]
        assert [pc.owners_of(o) for o in oids] == \
            [jc.owners_of(o) for o in oids]
        assert [pc.primary_of(o) for o in oids] == \
            [jc.primary_of(o) for o in oids]
    finally:
        jc.close()
        pc.close()


@pytest.mark.parametrize("change", ["join", "leave", "join domain"])
def test_rebalance_plan_matches_reference(change):
    keys = [f"k/{i}" for i in range(1000)]
    plans = []
    for ring_cls, plan in ((JRing, jplan), (HashRing, plan_rebalance)):
        r = ring_cls(vnodes=32)
        for n, dom in (("a", "r1"), ("b", "r1"), ("c", "r2"), ("d", "r3")):
            r.add_node(n, dom)
        before = r.owner_map(keys, 2)
        if change == "join":
            r.add_node("e")
        elif change == "leave":
            r.remove_node("b")
        else:
            r.add_node("e", "r2")
        moves = plan(before, r.owner_map(keys, 2))
        plans.append([(m.key, m.add, m.drop, m.keep) for m in moves])
    assert plans[0] and plans[0] == plans[1]


# ---------------------------------------------------------------------------
# replication, reads, membership
# ---------------------------------------------------------------------------

def test_replicas_hold_reference_bytes_and_version_stamps(pair):
    jc, pc, tables = pair
    for oid in tables:
        jh = {n.node_id: n for n in jc.live_holders(oid)}
        ph = {n.node_id: n for n in pc.live_holders(oid)}
        assert sorted(ph) == sorted(jh) == sorted(pc.owners_of(oid))
        for nid, node in ph.items():
            jm, pm = jh[nid].store.meta(oid), node.store.meta(oid)
            assert pm.attrs == jm.attrs          # cluster_version included
            assert (pm.nblocks, pm.block_size, vars(pm.layout)) == \
                (jm.nblocks, jm.block_size, vars(jm.layout))
            assert node.clovis.get(oid, _notify=False) == \
                jh[nid].clovis.get(oid, _notify=False)
        assert len({n.store.meta(oid).attrs["cluster_version"]
                    for n in ph.values()}) == 1
    assert pc.container("capture") == jc.container("capture")


def test_read_fails_over_to_replica(pair):
    _, pc, tables = pair
    oid = "capture/00"
    pc.kill_node(pc.primary_of(oid))
    np.testing.assert_array_equal(pc.get_array(oid), tables[oid])


def test_read_repair_resyncs_stale_replica(pair):
    _, pc, tables = pair
    oid = "capture/01"
    stale = pc.live_holders(oid)[0]
    stale.store.meta(oid).attrs["cluster_version"] = 0
    np.testing.assert_array_equal(pc.get_array(oid), tables[oid])
    assert (stale.store.meta(oid).attrs["cluster_version"]
            == pc.store.meta(oid).attrs["cluster_version"] > 0)
    assert any(t["subject"] == oid and t["detail"] == stale.node_id
               for t in pc.addb.ha_trace("read_repair"))


def test_eviction_rereplicates_like_reference(pair):
    jc, pc, tables = pair
    victim = pc.primary_of("capture/00")
    summaries = []
    for c in (jc, pc):
        c.kill_node(victim)
        summaries.append(c.evict_node(victim))
    js, ps = summaries
    assert (ps["partitions"], ps["bytes"]) == (js["partitions"], js["bytes"])
    assert [(m.key, m.add, m.drop, m.keep) for m in ps["moves"]] == \
        [(m.key, m.add, m.drop, m.keep) for m in js["moves"]]
    assert victim not in pc.ring
    for oid, t in tables.items():
        holders = pc.live_holders(oid)
        assert len(holders) == 2 and victim not in {h.node_id
                                                   for h in holders}
        np.testing.assert_array_equal(pc.get_array(oid), t)
    assert pc.evict_node(victim)["partitions"] == 0


def test_join_hands_the_device_to_the_new_node(pair):
    _, pc, tables = pair
    summary = pc.add_node("node99")
    assert 0 < summary["partitions"] < len(tables)
    assert pc.node("node99").clovis.device == pc.device == \
        torch.device("cpu")
    assert pc.node("node99").shipper.device == pc.device
    for oid, t in tables.items():
        np.testing.assert_array_equal(pc.get_array(oid), t)
        assert len(pc.live_holders(oid)) == 2


def test_cluster_without_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default resolves to it")
    with pytest.raises(NoCudaDeviceError):
        ClusterClovis(tmp_path / "c", nodes=2)


# ---------------------------------------------------------------------------
# analytics over the cluster
# ---------------------------------------------------------------------------

QUERIES = {
    # (a)-(d) of chip_smoke.py over the int32 table
    "a_mean": lambda e, c: e.scan("capture").filter(c(1) >= 75).key_by(
        c(0)).aggregate("mean", value=c(2)),
    "b_count": lambda e, c: e.scan("capture").filter(c(1) >= 75).key_by(
        c(0)).aggregate("count"),
    "b_min": lambda e, c: e.scan("capture").filter(c(1) >= 75).key_by(
        c(0)).aggregate("min", value=c(2)),
    "b_max": lambda e, c: e.scan("capture").filter(c(1) >= 75).key_by(
        c(0)).aggregate("max", value=c(2)),
    "c_histogram": lambda e, c: e.scan("capture").aggregate(
        "histogram", value=c(2), bins=32, vrange=(-500, 500)),
    "d_window_max": lambda e, c: e.scan("capture").window(64).aggregate(
        "max", value=c(2)),
    "scalar_sum": lambda e, c: e.scan("capture").filter(
        c(1) < 50).aggregate("sum", value=c(2)),
}
F32_QUERIES = {
    # f32 sums: the reference cluster's _sum_query, grouped and scalar
    "f32_sum": lambda e, c: e.scan("events").filter(c(0) > 0.0).aggregate(
        "sum", value=c(1)),
    "f32_group_sum": lambda e, c: e.scan("events").filter(
        c(0) > 0.0).key_by(c(2) > 0.0).aggregate("sum", value=c(1)),
}


def _run(eng, query, c):
    return eng.run(query(eng, c)).value


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", list(QUERIES))
def test_cluster_int_queries_byte_identical(pair, tmp_path, name):
    """Against the reference cluster's numpy engine and the port's
    single-node engine over the same tables."""
    jc, pc, tables = pair
    single = Clovis(tmp_path / "single", device="cpu")
    for oid, t in tables.items():
        single.put_array(oid, t, container=oid.split("/")[0])
    engines = (jc.analytics(use_kernels=False), pc.analytics(),
               single.analytics())
    try:
        ref, got, one = (_run(e, QUERIES[name], c)
                         for e, c in zip(engines, (jcol, col, col)))
    finally:
        for e in engines:
            e.close()
    assert _same(got, ref)
    assert _same(got, one)


@pytest.mark.parametrize("name", list(F32_QUERIES))
def test_cluster_f32_sums_within_tolerance(pair, name):
    jc, pc, tables = pair
    je, pe = jc.analytics(use_kernels=False), pc.analytics()
    try:
        ref = _run(je, F32_QUERIES[name], jcol)
        got = _run(pe, F32_QUERIES[name], col)
    finally:
        je.close()
        pe.close()
    rows = np.vstack([t for o, t in tables.items()
                      if o.startswith("events/")])
    scale = np.abs(rows[rows[:, 0] > 0.0, 1].astype(np.float64)).sum()
    if isinstance(ref, tuple):
        assert np.array_equal(got[0], ref[0])
        ref, got = ref[1], got[1]
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=0, atol=F32_SUM_RTOL * scale)


def test_kill_node_mid_query_is_byte_identical(pair):
    """The reference's failover test on the port: the node that is
    primary for the most partitions dies after the second shipped
    fragment; its fragments reroute, HA evicts it, and the result is
    byte for byte the healthy run's."""
    _, pc, _ = pair
    eng = pc.analytics(partial_cache_size=0, max_workers=2)
    ref = _run(eng, QUERIES["a_mean"], col)
    counts = {}
    for oid in pc.container("capture"):
        p = pc.primary_of(oid)
        counts[p] = counts.get(p, 0) + 1
    victim = max(sorted(counts), key=counts.get)
    ships = [0]

    def killer(_res):
        ships[0] += 1
        if ships[0] == 2:
            pc.kill_node(victim)
    pc.shipper.add_observer(killer)
    got = _run(eng, QUERIES["a_mean"], col)
    pc.shipper.remove_observer(killer)
    eng.close()
    assert _same(got, ref)
    assert any(t["rerouted"] for t in pc.addb.route_trace())
    assert victim not in pc.ring
    assert all(len(pc.live_holders(o)) == 2 for o in pc.container("capture"))


def test_kernel_fault_raises_and_evicts_no_node(pair, monkeypatch):
    """A kernel that fails to launch is not a node failure: the query
    raises naming the fault, and the ring keeps every node."""
    _, pc, _ = pair

    def broken(*a, **kw):
        raise KernelLaunchError("fused_filter_aggregate: launch failed")
    monkeypatch.setattr(K, "fused_filter_aggregate", broken)
    eng = pc.analytics(partial_cache_size=0)
    try:
        with pytest.raises(AnalyticsError, match="KernelLaunchError"):
            _run(eng, QUERIES["a_mean"], col)
    finally:
        eng.close()
    assert len(pc.ring) == 4 and not pc.addb.ha_trace("evict")

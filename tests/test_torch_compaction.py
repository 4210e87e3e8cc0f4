"""The port's compaction subsystem against the reference's.

The same appends and compactions run through ``repro.compaction`` and
``repro_torch.compaction`` over their own ``Clovis`` stacks (the port on
``device="cpu"``): manifest objects and blocks must come out byte for
byte the same, the port must read a container the reference compacted,
every crash point must reopen byte-identical on the port's classes, and
the reference's seeded chaos schedules must hold on them too
(``tests/chaos.py``'s harness with the port's stack).
"""
import numpy as np
import pytest

from chaos import CompactionChaosHarness, make_compaction_schedule
from repro.analytics import col as jcol
from repro.compaction import CompactionPolicy as JPolicy
from repro.core.addb import Addb as JAddb
from repro.core.clovis import Clovis as JClovis
from repro_torch.analytics import col
from repro_torch.cluster import ClusterClovis
from repro_torch.compaction import (CRASH_POINTS, CompactionPolicy,
                                    CompactionService, CompactorCrash,
                                    manifest_oid)
from repro_torch.core.addb import Addb
from repro_torch.core.clovis import Clovis

# every delta is "small" so two suffice to form a merge group
POLICY = dict(small_bytes=1 << 20, min_group=2)


def _rows(n, base=0):
    ids = np.arange(base, base + n, dtype=np.int64)
    return np.stack([ids, ids * 7 + 1], axis=1)


def _fill(svc, container="c", batches=6, per=8):
    out = []
    for i in range(batches):
        rows = _rows(per, base=i * per)
        svc.append_rows(container, rows)
        out.append(rows)
    return np.vstack(out)


def _ref(root):
    return JClovis(root, addb=JAddb(), devices_per_tier=3)


def _port(root):
    return Clovis(root, addb=Addb(), devices_per_tier=3, device="cpu")


def _objects(cl, container):
    """Every object of the container and its manifest: oid -> (raw
    bytes, attrs)."""
    oids = cl.container(container) + [manifest_oid(container)]
    return {o: (cl.get(o, _notify=False), cl.store.meta(o).attrs)
            for o in oids}


@pytest.mark.parametrize("columnar", [True, False])
def test_manifest_and_blocks_byte_identical(tmp_path, columnar):
    jc, pc = _ref(tmp_path / "ref"), _port(tmp_path / "port")
    js = jc.compaction(policy=JPolicy(columnar=columnar, **POLICY))
    ps = pc.compaction(policy=CompactionPolicy(columnar=columnar, **POLICY))
    for svc in (js, ps):
        _fill(svc, batches=5)
    assert _objects(pc, "c") == _objects(jc, "c")
    reports = [svc.compact("c")["c"] for svc in (js, ps)]
    assert vars(reports[1]) == vars(reports[0])
    for svc in (js, ps):
        _fill(svc, batches=3, per=5)
        svc.gc("c")
    assert _objects(pc, "c") == _objects(jc, "c")
    assert ps.manifest("c").versions() == js.manifest("c").versions()
    js.close()
    ps.close()


def test_port_reads_a_container_the_reference_compacted(tmp_path):
    jc = _ref(tmp_path / "sage")
    js = jc.compaction(policy=JPolicy(**POLICY))
    want = _fill(js, batches=6)
    js.compact("c")
    want = np.vstack([want, _fill(js, batches=2, per=3)])
    jeng = jc.analytics(use_kernels=False)
    ref = jeng.run(jeng.scan("c").aggregate("sum", value=jcol(1)))
    jeng.close()
    js.close()

    pc = _port(tmp_path / "sage")             # reopen the same root
    ps = pc.compaction(policy=CompactionPolicy(**POLICY))
    assert ps.manifest("c").version == js.manifest("c").version
    assert np.array_equal(ps.read_rows("c"), want)
    eng = pc.analytics(use_kernels=False)
    got = eng.run(eng.scan("c").aggregate("sum", value=col(1)))
    eng.close()
    assert int(got.value) == int(ref.value) == int(want[:, 1].sum())
    assert got.stats.snapshot_version == ref.stats.snapshot_version
    ps.close()


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_crash_mid_merge_reopens_byte_identical(tmp_path, point):
    def hook(p):
        if p == point:
            raise CompactorCrash(p)

    svc = _port(tmp_path / "sage").compaction(
        policy=CompactionPolicy(**POLICY), crash_hook=hook)
    want = _fill(svc, batches=8)
    with pytest.raises(CompactorCrash):
        svc.compact("c")

    clovis2 = _port(tmp_path / "sage")        # restart + auto-recover
    svc2 = clovis2.compaction(policy=CompactionPolicy(**POLICY))
    m = svc2.manifest("c")
    assert np.array_equal(svc2.read_rows("c"), want)
    if point == "after_commit":
        assert m.version == 9 and len(m.snapshot().entries) == 1
    else:
        assert m.version == 8 and len(m.snapshot().entries) == 8
        assert not [o for o in clovis2.container("c") if "/blk-" in o]
    svc2.compact("c")
    assert np.array_equal(svc2.read_rows("c"), want)


class PortCompactionHarness(CompactionChaosHarness):
    """The reference's chaos harness over the port's stack: the same
    schedule, ground truth and invariants; only the classes change."""

    def _build_stack(self):
        self.close()                  # the old process is gone
        self.clovis = _port(self.root)
        self.service = CompactionService(
            self.clovis,
            policy=CompactionPolicy(small_bytes=self.SMALL_BYTES,
                                    min_group=self.min_group),
            crash_hook=self._crash_hook, auto_recover=True)
        self.engine = self.clovis.analytics(use_kernels=False)
        if self.service.registry.lookup(self.container) is not None:
            self._check_version()

    def _query_check(self):
        want = self.expected
        if not want.size:
            return
        res = self.engine.run(self.engine.scan(self.container).aggregate(
            "sum", value=col(1)))
        assert res.stats.snapshot_version == self.last_version
        assert int(res.value) == int(want[:, 1].sum())
        self.counts["queries"] += 1


@pytest.mark.parametrize("seed", [7, 11, 23])
def test_chaos_gauntlet_on_the_port(tmp_path, seed):
    h = PortCompactionHarness(tmp_path / "chaos")
    try:
        counts = h.run(make_compaction_schedule(seed))
    finally:
        h.close()
    assert counts["appends"] >= 3
    assert counts["compactions"] >= 1
    assert counts["pinned_reads"] >= 1
    assert counts["queries"] >= 1


def test_pinned_snapshot_blocks_gc_until_unpin(tmp_path):
    pc = _port(tmp_path / "sage")
    svc = pc.compaction(policy=CompactionPolicy(**POLICY))
    want = _fill(svc, batches=4)
    pin = svc.pin("c")
    old = pin.oids
    svc.compact("c")
    assert all(pc.exists(o) for o in old)
    assert np.array_equal(svc.read_rows("c", snapshot=pin), want)
    assert svc.gc("c") == []
    svc.unpin(pin)
    assert sorted(svc.gc("c")) == sorted(old)
    assert not any(pc.exists(o) for o in old)


def test_query_pins_snapshot_and_matches_reference(tmp_path):
    """Query (a)'s chain over an int32 stream, before and after a
    compaction, through the port's kernel path (plain versions on the
    CPU) and the reference's numpy engine."""
    rng = np.random.default_rng(0)
    deltas = [np.stack([rng.integers(0, 16, 64), rng.integers(0, 100, 64),
                        rng.integers(-500, 500, 64), np.full(64, i)],
                       axis=1).astype(np.int32) for i in range(6)]
    values = []
    for cl, policy, c in ((_ref(tmp_path / "ref"), JPolicy, jcol),
                          (_port(tmp_path / "port"), CompactionPolicy, col)):
        svc = cl.compaction(policy=policy(**POLICY))
        for d in deltas:
            svc.append_rows("ev", d)
        eng = cl.analytics(use_kernels=c is col)
        q = eng.scan("ev").filter(c(1) >= 75).key_by(c(0)).aggregate(
            "mean", value=c(2))
        before = eng.run(q)
        svc.compact("ev")
        after = eng.run(q)
        assert after.stats.snapshot_version > before.stats.snapshot_version
        values.append([before.value, after.value])
        eng.close()
        svc.close()
    (ref_before, ref_after), (before, after) = values
    for got, want in ((before, ref_before), (after, ref_after),
                      (after, before)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_cluster_manifests_replicate_and_survive_node_loss(tmp_path):
    cluster = ClusterClovis(tmp_path / "cluster", nodes=4, replicas=2,
                            device="cpu")
    try:
        svc = cluster.compaction(policy=CompactionPolicy(**POLICY))
        want = _fill(svc, batches=6)
        assert len(cluster.live_holders(manifest_oid("c"))) == 2
        for e in svc.manifest("c").snapshot().entries:
            assert len(cluster.live_holders(e.oid)) == 2
        assert svc.compact("c")["c"].blocks_out == 1
        eng = cluster.analytics()
        res = eng.run(eng.scan("c").aggregate("count"))
        assert int(res.value) == want.shape[0]
        assert res.stats.snapshot_version == svc.manifest("c").version
        eng.close()
        victim = cluster.live_holders(manifest_oid("c"))[0].node_id
        cluster.kill_node(victim)
        assert np.array_equal(np.sort(svc.read_rows("c"), axis=0),
                              np.sort(want, axis=0))
    finally:
        cluster.close()

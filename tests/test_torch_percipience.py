"""The port's percipience loop against the reference, on the CPU.

The same seeded inputs go through ``repro.percipience`` (the Pallas heat
kernel with ``interpret=True``, jitted ``lax.top_k``) and
``repro_torch.percipience`` (``device="cpu"``: the heat scan's plain
PyTorch version, ``torch.topk``).  Heat is held to ``rtol=1e-5`` (f32
scan, f64 pre- and post-processing); the scan itself to
``rtol=atol=1e-6`` (the interpreter and the plain loop round the same
multiply-add in f32, up to 4.8e-7 apart on values near 2).  State
(histories, transitions, prefetch counters), HSM decisions and query
results must be equal.
"""
import math
import types
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.analytics import col as jcol
from repro.core import Clovis as JClovis
from repro.core import Layout as JLayout
from repro.core.addb import Addb as JAddb
from repro.core.addb import AddbRecord as JRecord
from repro.percipience import FeatureExtractor as JExtractor
from repro.percipience import PercipientPolicy as JPolicy
from repro.percipience import attach_percipience as jattach
from repro.percipience import heat as jheat
from repro_torch import _ext
from repro_torch.analytics import col
from repro_torch.core import Clovis, Layout, open_reference_store
from repro_torch.core import layouts as lay
from repro_torch.core.addb import Addb, AddbRecord
from repro_torch.core.tiers import T3_DISK
from repro_torch.percipience import (FeatureExtractor, PercipientPolicy,
                                     attach_percipience, heat_scan,
                                     heat_scan_plain, heat_scores,
                                     heat_scores_ref, markov_predict,
                                     markov_topk)

NOW = 1.7e9                          # epoch seconds: f32 cannot hold them


def _scan_inputs(rng, hist, nobj):
    """(hist, nobj) decay factors in [0, 1] with exact 0s and 1s, and
    weights in [0, 3) with some all-zero rows."""
    a = rng.uniform(0.0, 1.0, (hist, nobj)).astype(np.float32)
    a[rng.random((hist, nobj)) < 0.1] = 0.0
    a[rng.random((hist, nobj)) < 0.1] = 1.0
    x = rng.uniform(0.0, 3.0, (hist, nobj)).astype(np.float32)
    x[rng.random(hist) < 0.2] = 0.0
    return a, x


def _padded(a, x, ph, pn):
    """Pad with the identity step (a=1, x=0), as heat_scores did for the
    TPU's (8, 128) tiles."""
    return (np.pad(a, ((0, ph), (0, pn)), constant_values=1.0),
            np.pad(x, ((0, ph), (0, pn))))


@pytest.mark.parametrize("hist,nobj", [(24, 37), (8, 128), (64, 1000)])
def test_heat_scan_plain_matches_pallas_interpret(hist, nobj):
    rng = np.random.default_rng(hist * 10_000 + nobj)
    a, x = _scan_inputs(rng, hist, nobj)
    pa, px = _padded(a, x, (-hist) % 8, (-nobj) % 128)
    want = np.asarray(jheat.heat_scan_pallas(pa, px, interpret=True))
    got = heat_scan(a, x, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (nobj,)
    np.testing.assert_allclose(got.numpy(), want[:nobj], rtol=1e-6,
                               atol=1e-6)
    # padded inputs give the same values, bit for bit
    got_pad = heat_scan(torch.from_numpy(pa), torch.from_numpy(px),
                        device="cpu")
    assert torch.equal(got_pad[:nobj], got)


def test_heat_scan_plain_is_the_sequential_recurrence():
    rng = np.random.default_rng(3)
    a, x = _scan_inputs(rng, 5, 7)
    h = np.zeros(7, np.float32)
    for t in range(5):
        h = (a[t] * h).astype(np.float32) + x[t]
    got = heat_scan_plain(torch.from_numpy(a), torch.from_numpy(x))
    assert np.array_equal(got.numpy(), h)
    assert heat_scan(np.zeros((0, 3)), np.zeros((0, 3)),
                     device="cpu").tolist() == [0.0, 0.0, 0.0]
    assert heat_scan(np.zeros((4, 0)), np.zeros((4, 0)),
                     device="cpu").shape == (0,)
    with pytest.raises(ValueError):
        heat_scan(np.zeros((4, 3)), np.zeros((4, 2)), device="cpu")


def _histories(rng, n, hist):
    """Right-aligned, contiguous access histories (as history_tensors
    makes them), some empty, with per-access weights."""
    ts = np.sort(NOW - rng.uniform(0, 900, (n, hist)), axis=1)
    mask = np.ones((n, hist))
    for i in range(n):
        k = int(rng.integers(0, hist + 1))
        mask[i, :hist - k] = 0.0
        ts[i, :hist - k] = 0.0
    w = rng.uniform(0.5, 4.0, (n, hist))
    return ts, mask, w


@pytest.mark.parametrize("n,hist", [(37, 24), (300, 64), (1, 1)])
@pytest.mark.parametrize("weighted", [False, True])
def test_heat_scores_match_reference(n, hist, weighted):
    rng = np.random.default_rng(n + hist)
    ts, mask, w = _histories(rng, n, hist)
    w = w if weighted else None
    got = heat_scores(ts, mask, NOW, 120.0, weights=w, device="cpu")
    want = jheat.heat_scores(ts, mask, NOW, 120.0, weights=w,
                             interpret=True)
    ref = heat_scores_ref(ts, mask, NOW, 120.0, weights=w)
    assert got.dtype == np.float64 and got.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)
    np.testing.assert_array_equal(
        ref, jheat.heat_scores_ref(ts, mask, NOW, 120.0, weights=w))
    assert (got[mask.sum(axis=1) == 0] == 0.0).all()


def test_heat_scores_empty_and_all_masked():
    assert heat_scores(np.zeros((0, 4)), np.zeros((0, 4)), NOW,
                       device="cpu").shape == (0,)
    got = heat_scores(np.zeros((3, 5)), np.zeros((3, 5)), NOW,
                      device="cpu")
    assert got.tolist() == [0.0, 0.0, 0.0]
    ts = np.array([[NOW - 1.0]])
    fresh = heat_scores(ts, np.ones((1, 1)), NOW, 10.0, device="cpu")[0]
    stale = heat_scores(ts, np.ones((1, 1)), NOW + 100.0, 10.0,
                        device="cpu")[0]
    assert fresh > 0.9 and stale < 1e-3


def test_markov_topk_and_predict_match_reference():
    rng = np.random.default_rng(5)
    probs = rng.random((16, 16))
    probs /= probs.sum(axis=1, keepdims=True)
    probs[3] = 0.0                                  # a zero row
    cur = np.array([0, 3, 7, 15, 7])
    vals, idxs = markov_topk(torch.tensor(probs, dtype=torch.float32),
                             torch.from_numpy(cur), k=4)
    jvals, jidxs = jheat.markov_topk(probs.astype(np.float32), cur, k=4)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    untied = [i for i, c in enumerate(cur) if c != 3]
    np.testing.assert_array_equal(idxs.numpy()[untied],
                                  np.asarray(jidxs)[untied])
    for b in range(16):
        for k, min_p in ((1, 0.0), (3, 0.07)):
            assert markov_predict(probs, b, k=k, min_p=min_p,
                                  device="cpu") == \
                jheat.markov_predict(probs, b, k=k, min_p=min_p)


# ---------------------------------------------------------------------------
# extractor, policy, prefetcher
# ---------------------------------------------------------------------------

def _records(rng, n_obj=12, n_rec=400):
    """ADDB get/put records (and noise ops) with fixed timestamps, plus a
    demand-read sequence."""
    t = NOW - 600.0
    recs = []
    for _ in range(n_rec):
        t += float(rng.exponential(1.5))
        if rng.random() < 0.15:                     # block fan-out
            t += 0.001
        op = str(rng.choice(["get", "put", "get", "stat"]))
        recs.append((t, op, f"o/{int(rng.integers(0, n_obj))}",
                     f"dev{int(rng.integers(0, 3))}",
                     int(rng.integers(1, 1 << 16)), 1e-4))
    reads = [f"o/{int(i)}" for i in rng.integers(0, n_obj, 300)]
    return recs, reads


def _feed(ex, rec_cls, recs, reads):
    for r in recs:
        ex.on_record(rec_cls(*r))
    for oid in reads:
        ex.on_read(oid, 100)
    ex.on_event("delete", "o/5", {})
    return ex


def _extractors():
    recs, reads = _records(np.random.default_rng(11))
    kw = dict(hist_len=16, max_objects=8)
    return (_feed(FeatureExtractor(**kw), AddbRecord, recs, reads),
            _feed(JExtractor(**kw), JRecord, recs, reads))


def test_feature_extractor_state_matches_reference():
    ex, jex = _extractors()
    for got, want in zip(ex.history_tensors(), jex.history_tensors()):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(ex.inter_arrival_gaps(), jex.inter_arrival_gaps()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ex.transitions, jex.transitions)
    np.testing.assert_array_equal(ex.transition_matrix(0.5),
                                  jex.transition_matrix(0.5))
    for i in range(12):
        oid = f"o/{i}"
        assert ex.access_count(oid) == jex.access_count(oid)
        assert ex.predict_next(oid, k=3, min_p=0.05) == \
            jex.predict_next(oid, k=3, min_p=0.05)
        b = ex.bucket_of(oid)
        assert b == jex.bucket_of(oid)
        assert ex.oids_in_bucket(b) == jex.oids_in_bucket(b)


def test_percipient_policy_matches_reference():
    ex, jex = _extractors()
    kw = dict(half_life_s=60.0, promote_heat=1.2, demote_heat=0.1)
    pol = PercipientPolicy(ex, device="cpu", **kw)
    jpol = JPolicy(jex, interpret=True, **kw)
    oids = [f"o/{i}" for i in range(12)] + ["never/seen"]
    for dt in (0.0, 30.0, 600.0):
        now = NOW + dt
        pol.refresh(now)
        jpol.refresh(now)
        for oid in oids:
            meta = types.SimpleNamespace(oid=oid, last_access=NOW - 50.0)
            assert pol.decide(meta, now) == jpol.decide(meta, now)
            assert math.isclose(pol.victim_rank(meta, now),
                                jpol.victim_rank(meta, now), rel_tol=1e-5)
        hm, jhm = pol.heat_map(oids, now), jpol.heat_map(oids, now)
        assert hm.keys() == jhm.keys()
        np.testing.assert_allclose(list(hm.values()), list(jhm.values()),
                                   rtol=1e-5)
        lf, jlf = pol.load_factor(oids, now), jpol.load_factor(oids, now)
        np.testing.assert_allclose(list(lf.values()), list(jlf.values()),
                                   rtol=1e-5)


def _populate(cl, layout, n, obj_bytes=4096, block=1024):
    for i in range(n):
        cl.create(f"o/{i}", block_size=block, layout=layout)
        cl.put(f"o/{i}", bytes(obj_bytes))


def test_prefetcher_stats_match_reference_on_zipf(tmp_path):
    """The zipf trace of tests/test_percipience.py (sync prefetch, no
    HSM daemon): the prefetcher stages and hits the same objects."""
    rng = np.random.default_rng(7)
    n, n_reads = 24, 200
    p = 1.0 / np.arange(1, n + 1) ** 1.2
    p /= p.sum()
    trace = rng.choice(n, size=n_reads, p=p)
    kw = dict(sync=True, byte_budget=16 << 20, top_k=3,
              min_confidence=0.05, half_life_s=60.0)

    cl = Clovis(tmp_path / "port", addb=Addb(), devices_per_tier=3,
                device="cpu")
    _populate(cl, Layout(lay.STRIPED, T3_DISK, 2), n)
    _, pf, pol = attach_percipience(cl, **kw)
    jcl = JClovis(tmp_path / "ref", addb=JAddb(), devices_per_tier=3)
    _populate(jcl, JLayout(lay.STRIPED, T3_DISK, 2), n)
    _, jpf, _ = jattach(jcl, **kw)
    assert pol.device == torch.device("cpu")
    for obj in trace:
        cl.get(f"o/{obj}")
        jcl.get(f"o/{obj}")
    assert pf.stats() == jpf.stats()
    assert pf.stats()["hits"] > 0
    tiers = [cl.store.meta(f"o/{i}").layout.tier for i in range(n)]
    assert tiers == [jcl.store.meta(f"o/{i}").layout.tier
                     for i in range(n)]
    # migrations collected the same old-version blocks on every device
    for tier, pool in cl.pools.items():
        for dev, jdev in zip(pool.devices, jcl.pools[tier].devices):
            assert sorted(dev.list_blocks()) == sorted(jdev.list_blocks())


# ---------------------------------------------------------------------------
# the percipient store and its analytics hooks
# ---------------------------------------------------------------------------

PARTS, ROWS = 4, 3000


@pytest.fixture()
def stores(tmp_path):
    """One store written by the reference, opened by both packages."""
    root = tmp_path / "store"
    jc = JClovis(root, devices_per_tier=3)
    rng = np.random.default_rng(0)
    for i in range(PARTS):
        t = np.empty((ROWS, 4), np.int32)
        t[:, 0] = rng.integers(0, 40, ROWS)
        t[:, 1] = rng.integers(0, 100, ROWS)
        t[:, 2] = rng.integers(-500, 500, ROWS)
        t[:, 3] = i
        jc.put_array(f"capture/{i}", t, container="capture")
    pc = open_reference_store(root, devices_per_tier=3, device="cpu")
    return jc, pc


def _query(eng, c):
    return eng.scan("capture").filter(c(1) >= 75).key_by(c(0)).aggregate(
        "mean", value=c(2))


def test_percipient_query_equals_plain_and_reference(stores):
    jc, pc = stores
    # no partial cache: every query reads its partitions
    je, pe = jc.analytics(interpret=True), pc.analytics(partial_cache_size=0)
    try:
        want = je.run(_query(je, jcol)).value
        plain = pe.run(_query(pe, col)).value
        _, _, policy = pc.enable_percipience(sync=True)
        assert pc.percipience[2] is policy
        assert policy.device == torch.device("cpu")
        first = pe.run(_query(pe, col)).value     # its reads feed the heat
        policy.refresh_s = 0.0                    # next query re-scores
        second = pe.run(_query(pe, col)).value
        assert policy._heat and set(policy._heat) >= {
            f"capture/{i}" for i in range(PARTS)}
        for got in (plain, first, second):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[1].dtype == want[1].dtype
    finally:
        je.close()
        pe.close()


def test_analytics_hooks_see_the_policy_as_the_reference_does(stores):
    """_policy_map (heat_map, load_factor) and the cost model's load
    input: same schedule and placement decisions as the reference on the
    same extractor state."""
    jc, pc = stores
    je = jc.analytics(interpret=True, partial_cache_size=0)
    pe = pc.analytics(partial_cache_size=0)
    try:
        je.run(_query(je, jcol))                  # warm the catalogs
        pe.run(_query(pe, col))
        assert pe._load(["capture/0"]) == {}      # percipience off
        ex, _, pol = pc.enable_percipience(sync=True)
        jex, _, jpol = jc.enable_percipience(sync=True)
        jpol.interpret = True
        # capture/2 hammered a second ago, capture/0 long ago, capture/1
        # twice recently, capture/3 never observed
        for oid, ages in (("capture/2", [8, 6, 4, 2, 1]),
                          ("capture/0", [3000, 2900]),
                          ("capture/1", [40, 20])):
            for age in ages:
                ex.on_record(AddbRecord(NOW - age, "get", oid, "d", 1, 0.0))
                jex.on_record(JRecord(NOW - age, "get", oid, "d", 1, 0.0))
        for p in (pol, jpol):
            p.refresh(NOW)
            p.refresh_s = float("inf")            # keep the NOW scores
        oids = [f"capture/{i}" for i in range(PARTS)]
        heat, jheat_ = pe._heat(oids), je._heat(oids)
        assert heat.keys() == jheat_.keys()
        np.testing.assert_allclose([heat[o] for o in oids],
                                   [jheat_[o] for o in oids], rtol=1e-5)
        load, jload = pe._load(oids), je._load(oids)
        np.testing.assert_allclose([load[o] for o in oids],
                                   [jload[o] for o in oids], rtol=1e-5)
        assert load["capture/2"] > load["capture/1"] > load["capture/0"]
        assert pe._schedule(oids) == je._schedule(oids)
        plan = pe._make_plan(_query(pe, col), pe._schedule(oids))
        jplan = je._make_plan(_query(je, jcol), je._schedule(oids))
        assert plan.decisions.keys() == jplan.decisions.keys()
        for oid, d in plan.decisions.items():
            got, want = asdict(d), asdict(jplan.decisions[oid])
            for k in ("est_ship_s", "est_fetch_s"):
                assert math.isclose(got.pop(k), want.pop(k), rel_tol=1e-5)
            assert got == want
        assert {d.mode for d in plan.decisions.values()} <= {"ship",
                                                             "fetch"}
        assert plan.describe() == jplan.describe()
    finally:
        je.close()
        pe.close()


class _Failing:
    def __init__(self, exc):
        self.exc = exc

    def heat_map(self, oids, now=None):
        raise self.exc

    load_factor = heat_map


@pytest.mark.parametrize("exc,raises", [
    (ValueError("advisory"), False),
    (_ext.KernelBuildError("nvcc not found"), True),
    (_ext.KernelLaunchError("heat_scan: CUDA error"), True)])
def test_policy_errors_are_advisory_but_kernel_faults_raise(stores, exc,
                                                             raises):
    _, pc = stores
    pe = pc.analytics()
    try:
        pc.percipience = (None, None, _Failing(exc))
        if raises:
            with pytest.raises(type(exc)):
                pe.run(_query(pe, col))
        else:
            assert len(pe.run(_query(pe, col)).value[0]) == 40
    finally:
        pe.close()


# ---------------------------------------------------------------------------
# device rules
# ---------------------------------------------------------------------------

def test_percipience_defaults_to_cuda_and_raises_without_a_card(
        monkeypatch, tmp_path):
    from repro_torch import NoCudaDeviceError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        PercipientPolicy(FeatureExtractor())
    with pytest.raises(NoCudaDeviceError):
        heat_scan(np.ones((2, 2)), np.ones((2, 2)))
    with pytest.raises(NoCudaDeviceError):
        heat_scores(np.ones((1, 2)), np.ones((1, 2)), NOW)
    with pytest.raises(NoCudaDeviceError):
        markov_predict(np.eye(3), 0)
    cl = Clovis(tmp_path / "s", device="cpu")
    ex, _, pol = cl.enable_percipience()
    assert pol.device == torch.device("cpu")


def test_heat_scan_on_cuda_never_falls_back(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with the build made to
    fail, heat_scan raises instead of running its plain version."""
    def broken():
        raise _ext.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_ext, "library", broken)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    _ext.reset_launch_counts()
    with pytest.raises(_ext.KernelBuildError):
        heat_scan(np.ones((2, 3)), np.ones((2, 3)), device="cpu")
    assert _ext.LAUNCHES["heat_scan"] == 0

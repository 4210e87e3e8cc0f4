"""The port's whole analytics path against the reference, on one store.

A store written by ``repro.core.Clovis`` is opened by the port
(``open_reference_store`` checks it reads back byte for byte) and the
same queries run through ``repro`` (Pallas kernels with
``interpret=True``) and ``repro_torch`` (``device="cpu"``: the kernels'
plain PyTorch versions).  Query values and plans must be equal; the
function-shipping builtins must match the JAX ones.
"""
import numpy as np
import pytest
import torch

from repro.analytics import col as jcol
from repro.core import Clovis as JClovis
from repro.core import FunctionShipper as JShipper
from repro_torch.analytics import col
from repro_torch.core import FunctionShipper, open_reference_store

PARTS, ROWS, KEYS = 4, 2000, 40


def _write_store(root):
    """(key, quality, reading, shard) int32 tables, as in
    examples/analytics_tour.py, in row-major and colblock layouts."""
    jc = JClovis(root, devices_per_tier=3)
    rng = np.random.default_rng(0)
    written = {}
    for i in range(PARTS):
        t = np.empty((ROWS, 4), np.int32)
        t[:, 0] = rng.integers(0, KEYS, ROWS)
        t[:, 1] = rng.integers(0, 100, ROWS)
        t[:, 2] = rng.integers(-500, 500, ROWS)
        t[:, 3] = i
        jc.put_array(f"capture/{i}", t, container="capture")
        jc.put_columnar(f"colcap/{i}", t, container="colcap")
        written[f"capture/{i}"] = written[f"colcap/{i}"] = t
    mixed = [rng.integers(0, 9, 500).astype(np.int64),
             rng.standard_normal(500).astype(np.float32)]
    jc.put_columnar("mixed/0", mixed, container="mixed")
    written["mixed/0"] = np.stack([mixed[0], mixed[1]], axis=1).astype(
        np.float64)
    return jc, written


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref_store")
    jc, written = _write_store(root)
    pc = open_reference_store(root, written, devices_per_tier=3,
                              device="cpu")
    je, pe = jc.analytics(interpret=True), pc.analytics()
    yield jc, pc, je, pe, written
    je.close()
    pe.close()


QUERIES = {
    # (a)-(d) of chip_smoke.py, then a scalar count and more chains
    "a_mean": lambda e, c, s: e.scan(s).filter(c(1) >= 75).key_by(c(0))
    .aggregate("mean", value=c(2)),
    "b_count": lambda e, c, s: e.scan(s).filter(c(1) >= 75).key_by(c(0))
    .aggregate("count"),
    "b_min": lambda e, c, s: e.scan(s).filter(c(1) >= 75).key_by(c(0))
    .aggregate("min", value=c(2)),
    "b_max": lambda e, c, s: e.scan(s).filter(c(1) >= 75).key_by(c(0))
    .aggregate("max", value=c(2)),
    "c_histogram": lambda e, c, s: e.scan(s).aggregate(
        "histogram", value=c(2), bins=32, vrange=(-500, 500)),
    "d_window_max": lambda e, c, s: e.scan(s).window(256).aggregate(
        "max", value=c(2)),
    "scalar_count": lambda e, c, s: e.scan(s).filter(
        ((c(2) % 7) == 3) | ~(c(1) < 50)).aggregate("count"),
    "scalar_sum": lambda e, c, s: e.scan(s).filter(c(1) < 10)
    .aggregate("sum", value=c(2)),
    "scalar_min_div": lambda e, c, s: e.scan(s).aggregate(
        "min", value=c(2) / 3),
    "window_sliding_mean": lambda e, c, s: e.scan(s).window(100, 37)
    .aggregate("mean", value=c(2)),
    "group_sum_select": lambda e, c, s: e.scan(s).select(2, 0)
    .key_by(c(1)).aggregate("sum", value=c(0) % -9),
    "empty_group": lambda e, c, s: e.scan(s).filter(c(1) > 1000)
    .key_by(c(0)).aggregate("max", value=c(2)),
    "rows": lambda e, c, s: e.scan(s).filter(c(2) > 490).select(0, 2),
}


def _equal(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if a is None or isinstance(a, (int, float)):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("container", ["capture", "colcap"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_query_matches_reference(stores, name, container):
    _, _, je, pe, _ = stores
    jds = QUERIES[name](je, jcol, container)
    pds = QUERIES[name](pe, col, container)
    assert pe.explain(pds) == je.explain(jds)
    jr, pr = je.run(jds), pe.run(pds)
    assert _equal(pr.value, jr.value), (pr.value, jr.value)
    assert pr.stats.partitions == jr.stats.partitions == PARTS
    assert pr.stats.bytes_scanned == jr.stats.bytes_scanned
    assert pr.stats.pruned_reads == jr.stats.pruned_reads


def test_fetch_all_and_reference_engines_agree(stores):
    _, pc, _, pe, _ = stores
    for kw in ({"pushdown": False}, {"use_kernels": False},
               {"cost_based": False}):
        eng = pc.analytics(**kw)
        try:
            for name in ("a_mean", "c_histogram", "d_window_max"):
                a = eng.run(QUERIES[name](eng, col, "capture")).value
                b = pe.run(QUERIES[name](pe, col, "capture")).value
                assert _equal(a, b), (kw, name)
        finally:
            eng.close()


def test_store_round_trip_is_byte_identical(stores):
    jc, pc, _, _, written = stores
    for oid, arr in written.items():
        mine, ref = pc.materialize(oid), jc.materialize(oid)
        assert mine.dtype == ref.dtype and mine.shape == ref.shape
        assert mine.tobytes() == ref.tobytes()
        assert pc.store.meta(oid).attrs == jc.store.meta(oid).attrs
    batch = pc.read_columns("mixed/0", [1])
    assert batch.col(1).dtype == np.float32 and 0 not in batch


def test_open_reference_store_rejects_a_different_array(stores, tmp_path):
    jc, _, _, _, written = stores
    root = tmp_path / "s"
    JClovis(root).put_array("x/0", np.arange(6, dtype=np.int32),
                            container="x")
    open_reference_store(root, {"x/0": np.arange(6, dtype=np.int32)},
                         device="cpu")
    for bad in (np.arange(6, dtype=np.int64), np.arange(1, 7,
                                                        dtype=np.int32),
                np.arange(6, dtype=np.int32).reshape(2, 3)):
        with pytest.raises(ValueError):
            open_reference_store(root, {"x/0": bad}, device="cpu")
    with pytest.raises(ValueError):
        open_reference_store(root, {"x/1": bad}, device="cpu")


def test_stream_sources_wait_for_their_slice(stores):
    _, _, _, pe, _ = stores
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pe.from_stream(object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pe.run_continuous(None, None)


BUILTIN_DATA = {
    "ints": np.arange(-500, 501, dtype=np.int32),       # histogram edges
    "normal": np.random.default_rng(3).standard_normal(3000).astype(
        np.float32),
    "constant": np.full(17, 4.0, np.float32),           # zero range
}


@pytest.mark.parametrize("data", list(BUILTIN_DATA))
@pytest.mark.parametrize("fn", ["sum", "mean", "min", "max", "l2norm",
                                "histogram", "quantize_int8", "checksum",
                                "topk_abs"])
def test_shipper_builtins_match_jax(stores, data, fn):
    jc, pc, _, _, _ = stores
    oid = f"builtin/{data}"
    if not jc.exists(oid):
        jc.put_array(oid, BUILTIN_DATA[data], container="builtin")
    pc2 = open_reference_store(jc.store.root.parent, devices_per_tier=3,
                               device="cpu")
    js, ps = JShipper(jc), FunctionShipper(pc2)
    try:
        want, got = js.ship(fn, oid), ps.ship(fn, oid)
        assert want.ok and got.ok, (want.error, got.error)
        w, g = want.value, got.value
        if fn == "quantize_int8":
            np.testing.assert_array_equal(g["int8"], w["int8"])
            assert g["scale"] == pytest.approx(w["scale"], rel=1e-6)
        elif fn in ("histogram", "checksum", "topk_abs", "min", "max"):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == pytest.approx(w, rel=1e-5, abs=1e-5)
    finally:
        js.shutdown()
        ps.shutdown()
    assert ps.device == torch.device("cpu")

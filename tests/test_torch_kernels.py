"""Each kernel's plain PyTorch version (what the port runs on the CPU)
against the reference: the JAX function with ``interpret=True``, so the
Pallas kernel body itself runs, and the numpy ``*_ref`` oracle.

Inputs are made with numpy from a seed and handed to both packages.
Integer results must be equal; float32 results within ``rtol=1e-5``
(the two sum in different orders).  Sizes stay at or below ~4k rows,
where the Pallas interpreter is quick.
"""
import numpy as np
import pytest
import torch

from repro.analytics import kernels as JK
from repro.analytics.exprs import col as jcol
from repro_torch.analytics import kernels as K

CPU = torch.device("cpu")
OPS = ("sum", "count", "min", "max")
RTOL = 1e-5


def _assert_same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL,
                                   err_msg=what)


def _values(rng, n, dtype):
    if dtype == np.int32:
        return rng.integers(-500, 500, n).astype(np.int32)
    return rng.standard_normal(n).astype(np.float32)


# ---------------------------------------------------------------------------
# B2: segment reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 1023, 1025])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_segment_reduce_matches_reference(n, op, dtype):
    rng = np.random.default_rng(n)
    n_seg = {1: 1, 7: 5, 1023: 130, 1025: 3}[n]
    v = _values(rng, n, dtype)
    ids = rng.integers(-1, n_seg, n).astype(np.int32)   # -1: dropped
    got = K.segment_reduce(v, ids, n_seg, op=op, device=CPU)
    _assert_same(got, JK.segment_reduce(v, ids, n_seg, op=op,
                                        interpret=True), "pallas")
    _assert_same(got, K.segment_reduce_ref(v, ids, n_seg, op=op), "ref")


def test_segment_reduce_int32_sum_wraps_like_numpy():
    v = np.full(8, 2**30, np.int32)
    ids = np.zeros(8, np.int32)
    got = K.segment_reduce(v, ids, 1, op="sum", device=CPU)
    _assert_same(got, K.segment_reduce_ref(v, ids, 1, op="sum"))
    _assert_same(got, JK.segment_reduce(v, ids, 1, op="sum",
                                        interpret=True))


@pytest.mark.parametrize("n_seg", [0, 3])
def test_segment_reduce_empty_inputs(n_seg):
    for op in OPS:
        got = K.segment_reduce(np.zeros(0, np.float32),
                               np.zeros(0, np.int32), n_seg, op=op,
                               device=CPU)
        _assert_same(got, JK.segment_reduce(np.zeros(0, np.float32),
                                            np.zeros(0, np.int32), n_seg,
                                            op=op, interpret=True))


def test_segment_reduce_nan_propagates_in_min_max():
    v = np.array([1.0, np.nan, 3.0, -2.0], np.float32)
    ids = np.array([0, 0, 1, 1], np.int32)
    for op in ("min", "max"):
        got = K.segment_reduce(v, ids, 2, op=op, device=CPU)
        want = JK.segment_reduce(v, ids, 2, op=op, interpret=True)
        np.testing.assert_array_equal(got, want)
        assert np.isnan(got[0]) and not np.isnan(got[1])


# ---------------------------------------------------------------------------
# B3: window reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,window,slide", [
    (1000, 8, None),          # tumbling, ragged tail dropped
    (1025, 64, 17),           # sliding (slide < window)
    (100, 128, None),         # shorter than one window: no output
    (4096, 4096, None),       # one full window
])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_window_reduce_matches_reference(n, window, slide, op, dtype):
    rng = np.random.default_rng(window)
    v = _values(rng, n, dtype)
    got = K.window_reduce(v, window, op=op, slide=slide, device=CPU)
    _assert_same(got, JK.window_reduce(v, window, op=op, slide=slide,
                                       interpret=True), "pallas")
    ref = K.window_reduce_ref(v, window, op=op, slide=slide)
    _assert_same(got, ref.astype(got.dtype), "ref")   # np.sum: int64


def test_window_reduce_rejects_bad_sizes():
    for w, s in ((0, None), (4, 0), (-1, 2)):
        with pytest.raises(ValueError):
            K.window_reduce(np.arange(8), w, slide=s, device=CPU)


# ---------------------------------------------------------------------------
# histogram (B2 counting bin ids)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bins,vrange", [(32, (-500, 500)), (7, (0.0, 1.0)),
                                         (10, (-3, 3))])
def test_histogram_bin_edges_match_reference(bins, vrange):
    lo, hi = vrange
    rng = np.random.default_rng(bins)
    edges = np.linspace(lo, hi, bins + 1)
    v = np.concatenate([edges, edges + 1e-9, edges - 1e-9,
                        [lo - 1, hi + 1, lo, hi],
                        rng.uniform(lo, hi, 2000)]).astype(np.float32)
    got = K.histogram(v, bins, vrange, device=CPU)
    _assert_same(got, JK.histogram(v, bins, vrange, interpret=True))
    assert got.sum() == int(((v >= lo) & (v <= hi)).sum())


def test_histogram_int_values_on_edges_match_numpy():
    v = np.arange(-500, 501, dtype=np.int32)       # every edge, both ends
    got = K.histogram(v, 32, (-500, 500), device=CPU)
    _assert_same(got, K.histogram_ref(v, 32, (-500, 500)))
    _assert_same(got, JK.histogram(v, 32, (-500, 500), interpret=True))


# ---------------------------------------------------------------------------
# B1: fused filter -> aggregate
# ---------------------------------------------------------------------------

# (name, predicate, value): specs built with the reference's DSL, so
# both packages see the same JSON
PRED_VALUE = [
    ("ge-int", jcol(1) >= 75, jcol(2)),
    ("mod-neg", (jcol(2) % 7) == 3, jcol(2) % -7),          # % sign rules
    ("int-div", (jcol(2) / 3) > 10.5, jcol(2) / jcol(1)),   # int / -> f32
    ("not-bool", ~(jcol(1) < 50) & (jcol(0) != 2), jcol(0)),
    ("not-int", (~jcol(2)) > 0, ~jcol(0)),                  # bitwise ~
    ("or-float", (jcol(3) > 0.5) | (jcol(1) == 7), jcol(3) * 2.5 - jcol(2)),
    ("float-mod", (jcol(3) % 0.75) < 0.3, jcol(3) % -1.5),
    ("none", None, jcol(3)),
    ("reject-all", jcol(1) > 1000, jcol(2)),                 # empty result
    ("int-pred", jcol(1) % 3, jcol(1) * jcol(2) + 7),        # int as bool
]


def _cols(rng, n):
    return {0: rng.integers(0, 5, n).astype(np.int32),
            1: rng.integers(0, 100, n).astype(np.int32),
            2: rng.integers(-500, 500, n).astype(np.int32),
            3: (rng.standard_normal(n) * 2).astype(np.float32)}


def _fused_case(n, n_seg, op, name, pred, value):
    rng = np.random.default_rng(n * 31 + n_seg)
    cols = _cols(rng, n)
    ids = rng.integers(-1, n_seg, n).astype(np.int32)
    ps = None if pred is None else pred.to_spec()
    vs = None if op == "count" else value.to_spec()
    used = K.spec_columns(ps) | K.spec_columns(vs) | {1}
    cols = {i: cols[i] for i in sorted(used)}
    got = K.fused_filter_aggregate(cols, ps, vs, ids, n_seg, op=op,
                                   device=CPU)
    want = JK.fused_filter_aggregate(cols, ps, vs, ids, n_seg, op=op,
                                     interpret=True)
    return cols, ps, vs, ids, got, want


@pytest.mark.parametrize("name,pred,value", PRED_VALUE,
                         ids=[p[0] for p in PRED_VALUE])
@pytest.mark.parametrize("op", OPS)
def test_fused_specs_match_pallas(name, pred, value, op):
    _, _, _, _, got, want = _fused_case(1025, 3, op, name, pred, value)
    _assert_same(got[0], want[0], f"{name} acc")
    _assert_same(got[1], want[1], f"{name} cnt")


@pytest.mark.parametrize("n", [1, 7, 1023, 1025, 2051])
@pytest.mark.parametrize("n_seg", [1, 130])
@pytest.mark.parametrize("op", OPS)
def test_fused_tiling_edges_match_pallas_and_ref(n, n_seg, op):
    name, pred, value = PRED_VALUE[1]
    cols, ps, vs, ids, got, want = _fused_case(n, n_seg, op, name, pred,
                                               value)
    _assert_same(got[0], want[0], "pallas acc")
    _assert_same(got[1], want[1], "pallas cnt")
    ra, rc = K.fused_filter_aggregate_ref(cols, ps, vs, ids, n_seg, op=op)
    _assert_same(got[0], ra, "ref acc")
    _assert_same(got[1], rc, "ref cnt")


def test_fused_grouped_mean_accumulates_ints_in_float32():
    rng = np.random.default_rng(5)
    cols = _cols(rng, 1500)
    ids = cols[0].copy()
    ps, vs = (jcol(1) >= 50).to_spec(), jcol(2).to_spec()
    got = K.fused_filter_aggregate(cols, ps, vs, ids, 5, op="sum",
                                   device=CPU, out_dtype=np.float32)
    want = JK.fused_filter_aggregate(cols, ps, vs, ids, 5, op="sum",
                                     interpret=True, out_dtype=np.float32)
    _assert_same(got[0], want[0])
    _assert_same(got[1], want[1])


def test_fused_empty_and_zero_segments():
    cols = {0: np.zeros(0, np.int32)}
    for n_seg in (0, 4):
        for op in OPS:
            got = K.fused_filter_aggregate(cols, None, jcol(0).to_spec(),
                                           np.zeros(0, np.int32), n_seg,
                                           op=op, device=CPU)
            want = JK.fused_filter_aggregate(cols, None, jcol(0).to_spec(),
                                             np.zeros(0, np.int32), n_seg,
                                             op=op, interpret=True)
            _assert_same(got[0], want[0])
            _assert_same(got[1], want[1])


def test_fused_padding_rows_never_match():
    """1025 rows pad to 2048 with id -1 and value 1; a spec dividing by
    the column must still see no pad row."""
    n = 1025
    cols = {0: np.arange(n, dtype=np.int32) % 4}
    ps = ((jcol(0) * 0 + 10) / jcol(0) > 0).to_spec()
    got = K.fused_filter_aggregate(cols, ps, None, np.zeros(n, np.int32),
                                   1, op="count", device=CPU)
    assert int(got[1][0]) == n and int(got[0][0]) == n


def test_spec_compiler_types_and_limits():
    kinds = ((0, "I"), (1, "F"))
    prog = K.compile_specs('{"i": 0, "t": "col"}', '{"i": 1, "t": "col"}',
                           kinds, "int32")
    assert prog.n_pred == 1 and prog.code[-1][0] == K._OPCODES["f2i"]
    with pytest.raises(TypeError):         # ~ on a float
        K.compile_specs('{"e": {"i": 1, "t": "col"}, "t": "not"}', "",
                        kinds, "int32")
    with pytest.raises(OverflowError):     # JAX's int32 literal range
        K.compile_specs("", '{"t": "lit", "v": 4294967296}', kinds, "int32")
    deep = jcol(0)
    for _ in range(K.MAX_CODE):
        deep = deep + 1
    import json
    with pytest.raises(ValueError):
        K.compile_specs("", json.dumps(deep.to_spec()), kinds, "int32")
    K.kernel_cache_clear()
    K.fused_program({0: np.zeros(2, np.int32)}, None, jcol(0).to_spec(),
                    np.int32)
    K.fused_program({0: np.zeros(5, np.int32)}, None, jcol(0).to_spec(),
                    np.int32)
    assert K.kernel_cache_info() == {"hits": 1, "misses": 1, "entries": 1}


@pytest.mark.parametrize("name", ["segment_reduce", "window_reduce",
                                  "fused_filter_aggregate"])
def test_host_api_matches_reference_signature(name):
    import inspect
    ours = inspect.signature(getattr(K, name))
    ref = inspect.signature(getattr(JK, name))
    swap = [p.replace(name="device") if p.name == "interpret" else p
            for p in ref.parameters.values()]
    assert [p.name for p in ours.parameters.values()] == \
        [p.name for p in swap]

"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips on a host without a
usable GPU; run them on one with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Integer results must be equal, f32 min/max equal and f32 sums within
``1e-4`` of the segment's sum of |v| (atomics add in another order).
``chip_smoke.py`` covers the same ground at the main path's sizes.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.analytics import col
from repro_torch.analytics import kernels as K

pytestmark = pytest.mark.cuda
OPS = ("sum", "count", "min", "max")


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _close(got, want, op, abs_sum=None):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32 and op == "sum":
        assert bool(((got - want).abs() <= 1e-4 * abs_sum + 1e-6).all())
    else:
        assert torch.equal(got, want)


def _data(dev, n, n_seg, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ids = torch.randint(-1, n_seg, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    ints = torch.randint(-500, 500, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    floats = torch.randn((n,), generator=g, device=dev)
    return ids, ints, floats


# B1 and B2 keep a table a thread up to 32 segments and one a block up to
# 8,192, with atomics into global memory above; their grid is a block
# per 16,384 rows up to one a multiprocessor: both sides of each of those
# thresholds, query (c)'s 32 bins and query (a)'s 4,096 segments at the
# main path's 4,194,304 rows
SEG_CASES = [(1, 1), (1025, 128), (70000, 4096), (70000, 60000),
             (70000, 32), (70000, 33), (100003, 8192), (100003, 8193),
             (16384, 4096), (16385, 4096), (4_194_304, 32),
             (4_194_304, 4096)]


@pytest.mark.parametrize("n,n_seg", SEG_CASES)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt", ["int32", "float32"])
def test_segment_kernel_matches_plain(dev, n, n_seg, op, dt):
    ids, ints, floats = _data(dev, n, n_seg, n + n_seg)
    v = ints if dt == "int32" else floats
    K.reset_launch_counts()
    got = K.segment_reduce_tensor(v, ids, n_seg, op)
    assert K.LAUNCHES["segment_reduce"] == 1
    want = K.segment_reduce_plain(v, ids, n_seg, op)
    _close(got, want, op, K.segment_reduce_plain(v.abs(), ids, n_seg, "sum"))


# B3 takes a block per window of 1,024 elements or more, a warp below:
# windows on both sides of that threshold, windows and slides that are not
# multiples of 4 (unaligned heads and tails), and more than 65,535 windows
WINDOW_CASES = [(1025, 64, 17), (70000, 4096, 4096), (4096, 4096, 1),
                (20000, 1024, 1024), (20000, 1023, 1023),
                (100003, 1031, 13), (1023, 7, 3), (70000, 3, 1),
                (300000, 2048, 3)]


@pytest.mark.parametrize("n,window,slide", WINDOW_CASES)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt", ["int32", "float32"])
def test_window_kernel_matches_plain(dev, n, window, slide, op, dt):
    _, ints, floats = _data(dev, n, 1, window)
    v = ints if dt == "int32" else floats
    got = K.window_reduce_tensor(v, window, slide, op)
    want = K.window_reduce_plain(v, window, slide, op)
    _close(got, want, op, K.window_reduce_plain(v.abs(), window, slide,
                                                "sum"))


@pytest.mark.parametrize("n,window,slide", WINDOW_CASES)
@pytest.mark.parametrize("op", ["min", "max"])
def test_window_kernel_propagates_nan(dev, n, window, slide, op):
    """f32 min/max over values with NaNs (about one window in ten holds
    one) equal plain amin/amax exactly, NaN where plain has NaN."""
    _, _, v = _data(dev, n, 1, window + 1)
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    v[torch.rand((n,), generator=g, device=dev) < 0.1 / window] = \
        float("nan")
    got = K.window_reduce_tensor(v, window, slide, op)
    want = K.window_reduce_plain(v, window, slide, op)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


SPECS = [((col(1) % 7) == 3) | ~(col(0) < 0), (col(0) / 3) > 10.5, None]


@pytest.mark.parametrize("n,n_seg", [(1, 1), (1025, 128), (70000, 60000),
                                     (70000, 32), (70000, 33),
                                     (100003, 8192), (100003, 8193),
                                     (16385, 4096), (4_194_304, 4096)])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_fused_kernel_matches_plain(dev, n, n_seg, op, spec):
    ids, ints, floats = _data(dev, n, n_seg, 7 * n + spec)
    pred = SPECS[spec]
    cols = {0: ints.cpu().numpy(), 1: (ints % 97).cpu().numpy(),
            2: floats.cpu().numpy()}
    for value, dt in ((col(1) % -7, np.int32), (col(2) * 0.5 + col(0) / 7,
                                                 np.float32)):
        prog = K.fused_program(cols, None if pred is None else
                               pred.to_spec(), value.to_spec(), dt)
        ts = [torch.from_numpy(cols[i]).to(dev) for i in sorted(cols)]
        tdt = torch.int32 if dt == np.int32 else torch.float32
        got = K.fused_filter_aggregate_tensor(ts, prog, ids, n_seg, op, tdt)
        want = K.fused_filter_aggregate_plain(ts, prog, ids, n_seg, op, tdt)
        val = K._run_program_plain(prog.code[prog.n_pred:], prog, ts)
        abs_sum = K.segment_reduce_plain(val.abs().float(), ids, n_seg,
                                         "sum")
        _close(got[0], want[0], op, abs_sum)
        _close(got[1], want[1], "count")


def _fused_sum(ts, ids, n_seg, op, dt, value=None):
    """B1 over columns ts (slot 0 the predicate's, slot 1 the value's):
    keep rows with col 0 >= 0, reduce col 1 (or ``value``)."""
    kinds = tuple((i, "F" if t.dtype == torch.float32 else "I")
                  for i, t in enumerate(ts))
    prog = K.compile_specs(json.dumps((col(0) >= 0).to_spec()),
                           json.dumps((value or col(1)).to_spec()), kinds,
                           str(dt).split(".")[1])
    return (K.fused_filter_aggregate_tensor(ts, prog, ids, n_seg, op, dt),
            K.fused_filter_aggregate_plain(ts, prog, ids, n_seg, op, dt))


@pytest.mark.parametrize("n_seg", [1, 32, 33, 4096, 8193])
@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_and_fused_kernels_propagate_nan(dev, n_seg, op):
    """f32 min/max over values with NaNs in some segments: B1 and B2 equal
    plain amin/amax exactly, NaN where plain has NaN."""
    ids, ints, v = _data(dev, 70000, n_seg, n_seg)
    v[torch.rand((70000,), device=dev) < 2.0 / n_seg] = float("nan")
    got = K.segment_reduce_tensor(v, ids, n_seg, op)
    want = K.segment_reduce_plain(v, ids, n_seg, op)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    (acc, cnt), (pacc, pcnt) = _fused_sum([ints, v], ids, n_seg, op,
                                          torch.float32)
    torch.testing.assert_close(acc, pacc, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(cnt, pcnt)


@pytest.mark.parametrize("n_seg", [1, 32, 33, 4096, 8193])
def test_segment_and_fused_int32_sums_wrap(dev, n_seg):
    """int32 sums past 2**31 wrap as np.add.at does, on every path."""
    ids, _, _ = _data(dev, 70000, n_seg, 5)
    v = torch.full((70000,), 2**30 + 12345, dtype=torch.int32, device=dev)
    got = K.segment_reduce_tensor(v, ids, n_seg, "sum")
    assert torch.equal(got, K.segment_reduce_plain(v, ids, n_seg, "sum"))
    (acc, cnt), (pacc, pcnt) = _fused_sum([v, v], ids, n_seg, "sum",
                                          torch.int32)
    assert torch.equal(acc, pacc) and torch.equal(cnt, pcnt)


@pytest.mark.parametrize("n_seg", [1, 4096])
@pytest.mark.parametrize("op", OPS)
def test_every_row_in_one_segment(dev, n_seg, op):
    """Worst contention: every row of 1,000,000 folds into segment 7 % n_seg
    (a thread table or a warp table, all lanes of every step peers)."""
    n = 1_000_000
    ids = torch.full((n,), 7 % n_seg, dtype=torch.int32, device=dev)
    _, ints, floats = _data(dev, n, 1, 11)
    for v in (ints, floats):
        got = K.segment_reduce_tensor(v, ids, n_seg, op)
        want = K.segment_reduce_plain(v, ids, n_seg, op)
        _close(got, want, op, K.segment_reduce_plain(v.abs(), ids, n_seg,
                                                     "sum"))
        dt = v.dtype
        (acc, cnt), (pacc, pcnt) = _fused_sum([ints, v], ids, n_seg, op, dt)
        keep = torch.where(ints >= 0, ids, -1)
        _close(acc, pacc, op, K.segment_reduce_plain(
            v.abs().to(dt), keep, n_seg, "sum") if dt == torch.float32
            else None)
        assert torch.equal(cnt, pcnt)


@pytest.mark.parametrize("n_seg", [1, 32])
def test_f32_sums_are_the_same_bits_every_run(dev, n_seg):
    """Up to 32 segments B1 and B2 fold in an order fixed by the data
    alone (a table a thread, a fixed flush, the blocks' partials folded in
    block order), so an f32 sum repeats bit for bit (ROADMAP C4; above 32
    segments a block table's atomics add in the order warps arrive)."""
    ids, ints, v = _data(dev, 4_194_304, n_seg, 17)
    runs = [K.segment_reduce_tensor(v, ids, n_seg, "sum") for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    fused = [_fused_sum([ints, v], ids, n_seg, "sum", torch.float32)[0][0]
             for _ in range(3)]
    assert all(torch.equal(fused[0], r) for r in fused[1:])


@pytest.mark.parametrize("n_seg", [32, 4096])
def test_calls_from_threads_on_one_stream(dev, n_seg):
    """The query executor calls B1 and B2 from a thread pool on one
    stream, and a launcher lets go of the interpreter lock between its
    two launches, so one call's launches can have another call's between
    them: every call keeps its own partials.  16 threads, each with its
    own values (so that any two calls whose partials met would show),
    call the wrappers alone, 50 times each, against results computed
    once."""
    from concurrent.futures import ThreadPoolExecutor
    n_threads, n_calls = 16, 50
    ids, ints, _ = _data(dev, 300_000, n_seg, 23)
    prog = K.compile_specs(json.dumps((col(0) >= 0).to_spec()),
                           json.dumps(col(1).to_spec()),
                           ((0, "I"), (1, "I")), "int32")
    vals = [ints + 1000 * t for t in range(n_threads)]
    want_b1 = [K.fused_filter_aggregate_plain([ints, v], prog, ids, n_seg,
                                              "sum", torch.int32)
               for v in vals]
    want_b2 = [K.segment_reduce_plain(v, ids, n_seg, "sum") for v in vals]

    def calls(t):
        return [K.fused_filter_aggregate_tensor([ints, vals[t]], prog, ids,
                                                n_seg, "sum", torch.int32)
                if (t + i) % 2 else
                K.segment_reduce_tensor(vals[t], ids, n_seg, "sum")
                for i in range(n_calls)]
    with ThreadPoolExecutor(n_threads) as pool:
        results = list(pool.map(calls, range(n_threads), timeout=300))
    torch.cuda.synchronize()
    for t, rs in enumerate(results):
        for i, r in enumerate(rs):
            if (t + i) % 2:
                assert torch.equal(r[0], want_b1[t][0]) and \
                    torch.equal(r[1], want_b1[t][1]), (t, i)
            else:
                assert torch.equal(r, want_b2[t]), (t, i)


@pytest.mark.parametrize("kernel", ["segment_reduce", "fused"])
@pytest.mark.parametrize("delta", [-1, 1])
def test_scratch_of_the_wrong_size_is_refused(dev, monkeypatch, kernel,
                                               delta):
    """A partials scratch of another row count than the launch's grid is
    refused before any launch, not written past."""
    from repro_torch import _ext
    rows = K._scratch_rows
    monkeypatch.setattr(K, "_scratch_rows",
                        lambda *a: max(rows(*a) + delta, 0))
    ids, ints, v = _data(dev, 70000, 4096, 3)
    _ext.reset_launch_counts()
    with pytest.raises(_ext.KernelLaunchError):
        if kernel == "segment_reduce":
            K.segment_reduce_tensor(v, ids, 4096, "sum")
        else:
            _fused_sum([ints, v], ids, 4096, "sum", torch.float32)
    assert sum(_ext.LAUNCHES.values()) == 0


def test_host_api_on_cuda_matches_cpu(dev):
    rng = np.random.default_rng(0)
    v = rng.integers(-500, 500, 5000).astype(np.int32)
    ids = rng.integers(-1, 50, 5000).astype(np.int32)
    for op in OPS:
        np.testing.assert_array_equal(
            K.segment_reduce(v, ids, 50, op=op, device=dev),
            K.segment_reduce(v, ids, 50, op=op, device="cpu"))
        np.testing.assert_array_equal(
            K.window_reduce(v, 64, op=op, slide=5, device=dev),
            K.window_reduce(v, 64, op=op, slide=5, device="cpu"))
    np.testing.assert_array_equal(
        K.histogram(v, 32, (-500, 500), device=dev),
        K.histogram_ref(v, 32, (-500, 500)))


def test_cluster_query_on_cuda_matches_cpu(dev, tmp_path):
    """Query (a) over a 3-node, 2-replica cluster on the card equals the
    same cluster on the CPU byte for byte, and launches B1."""
    from repro_torch.cluster import ClusterClovis
    rng = np.random.default_rng(0)
    tables = [np.stack([rng.integers(0, 64, 20000),
                        rng.integers(0, 100, 20000),
                        rng.integers(-500, 500, 20000),
                        np.full(20000, i)], axis=1).astype(np.int32)
              for i in range(6)]
    values, launched = [], []
    for where in (dev, torch.device("cpu")):
        cl = ClusterClovis(tmp_path / where.type, nodes=3, replicas=2,
                           device=where)
        for i, t in enumerate(tables):
            cl.put_array(f"capture/{i}", t, container="capture")
        eng = cl.analytics(partial_cache_size=0)
        before = K.LAUNCHES["fused_filter_aggregate"]
        values.append(eng.run(eng.scan("capture").filter(col(1) >= 75)
                              .key_by(col(0)).aggregate(
                                  "mean", value=col(2))).value)
        launched.append(K.LAUNCHES["fused_filter_aggregate"] - before)
        eng.close()
        cl.close()
    assert launched[0] > 0 and launched[1] == 0
    for got, want in zip(*values):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# heat scan (B4): built with --fmad=false, so kernel == plain bit for bit
# ---------------------------------------------------------------------------

HEAT_SHAPES = [(1, 1), (24, 37), (7, 129), (64, 1000), (64, 262_144)]


@pytest.mark.parametrize("hist,nobj", HEAT_SHAPES)
@pytest.mark.parametrize("weights", ["random", "zero"])
def test_heat_kernel_matches_plain(dev, hist, nobj, weights):
    from repro_torch import _ext
    from repro_torch.percipience import heat_scan, heat_scan_plain
    g = torch.Generator(device=dev)
    g.manual_seed(hist * 7 + nobj)
    a = torch.rand((hist, nobj), generator=g, device=dev)
    a[torch.rand((hist, nobj), generator=g, device=dev) < 0.1] = 0.0
    a[torch.rand((hist, nobj), generator=g, device=dev) < 0.1] = 1.0
    x = torch.rand((hist, nobj), generator=g, device=dev) * 3
    if weights == "zero":
        x.zero_()
    else:
        x[torch.rand(hist, generator=g, device=dev) < 0.2] = 0.0
    _ext.reset_launch_counts()
    got = heat_scan(a, x, device=dev)
    assert _ext.LAUNCHES["heat_scan"] == 1
    want = heat_scan_plain(a, x)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


def test_heat_scores_on_cuda_equal_cpu(dev):
    from repro_torch.percipience import heat_scores, heat_scores_ref
    rng = np.random.default_rng(1)
    n, hist, now = 3000, 64, 1.7e9
    ts = np.sort(now - rng.uniform(0, 900, (n, hist)), axis=1)
    mask = np.ones((n, hist))
    for i in range(n):
        k = int(rng.integers(0, hist + 1))
        mask[i, :hist - k] = 0.0
        ts[i, :hist - k] = 0.0
    w = rng.uniform(0.5, 4.0, (n, hist))
    for weights in (None, w):
        got = heat_scores(ts, mask, now, 60.0, weights=weights, device=dev)
        np.testing.assert_array_equal(
            got, heat_scores(ts, mask, now, 60.0, weights=weights,
                             device="cpu"))
        np.testing.assert_allclose(
            got, heat_scores_ref(ts, mask, now, 60.0, weights=weights),
            rtol=1e-5, atol=1e-12)
    assert heat_scores(np.zeros((0, 4)), np.zeros((0, 4)), now,
                       device=dev).shape == (0,)
    assert heat_scores(ts[:5], np.zeros((5, hist)), now,
                       device=dev).tolist() == [0.0] * 5


# ---------------------------------------------------------------------------
# model kernels: B5 flash attention within 1e-4 of each row's max |o|
# (f32 products summed in another order), B7 the RG-LRU scan bit for bit
# (--fmad=false)
# ---------------------------------------------------------------------------

ATTN_CASES = [(4, 16, 1, 4000, 4000, 256, True, 2048, 0.0),
              (1, 4, 4, 333, 333, 64, True, 0, 0.0),
              (2, 8, 2, 517, 517, 128, True, 100, 30.0),
              (1, 8, 1, 129, 129, 256, False, 0, 0.0),
              (2, 4, 2, 200, 200, 128, False, 50, 30.0),
              (1, 4, 1, 45, 300, 64, False, 0, 0.0),
              (1, 1, 1, 1, 1, 64, True, 0, 0.0),
              # sq/sk not multiples of the 16-key or 128-row tile, the
              # window's edge inside a key tile
              (1, 16, 1, 1000, 1000, 256, True, 333, 30.0),
              (2, 4, 2, 77, 1001, 256, False, 0, 30.0),
              (1, 8, 2, 250, 250, 256, True, 17, 0.0),
              # qwen2-moe-a2.7b's prefill: MHA, hd 128, causal, no window
              (4, 16, 16, 4000, 4000, 128, True, 0, 0.0),
              # smaller forms of the encoder / cross-attention shapes:
              # whisper's encoder (non-causal, hd 64) and decoder (causal
              # MHA), the encdec cross attention (sq < sk), vision's GQA
              # self attention (8 heads a kv head, hd 128) and its cross
              # attention (sq != sk, non-causal)
              (2, 4, 4, 300, 300, 64, False, 0, 0.0),
              (2, 4, 4, 96, 96, 64, True, 0, 0.0),
              (2, 4, 4, 96, 300, 64, False, 0, 0.0),
              (1, 16, 2, 256, 256, 128, True, 0, 0.0),
              (1, 16, 2, 256, 321, 128, False, 0, 0.0)]


@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal,window,softcap", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(dev, b, h, kv, sq, sk, hd,
                                              causal, window, softcap):
    from repro_torch import _ext
    from repro_torch.kernels import (flash_attention_kernel,
                                     flash_attention_plain)
    g = torch.Generator(device=dev)
    g.manual_seed(sq + hd)
    q = torch.randn((b, h, sq, hd), generator=g, device=dev)
    k = torch.randn((b, kv, sk, hd), generator=g, device=dev)
    v = torch.randn((b, kv, sk, hd), generator=g, device=dev)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap)
    _ext.reset_launch_counts()
    got = flash_attention_kernel(q, k, v, **kw)
    assert _ext.LAUNCHES["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    row = want.abs().amax(-1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-4 * row).all())


# every head_dim, MHA/GQA/MQA, windows (inside a key tile too), soft-caps,
# sq != sk with sk not a multiple of the key tile, one query row, and
# grids of one and two consumer warpgroups a block
BF16_ATTN_CASES = [(2, 4, 4, 300, 300, 64, False, 0, 0.0),
                   (1, 16, 2, 256, 256, 128, True, 0, 0.0),
                   (1, 16, 2, 256, 321, 128, False, 0, 0.0),
                   (2, 8, 2, 517, 517, 128, True, 100, 30.0),
                   (1, 8, 1, 129, 129, 256, False, 0, 0.0),
                   (1, 8, 2, 250, 250, 256, True, 17, 0.0),
                   (2, 4, 2, 77, 1001, 256, False, 0, 30.0),
                   (1, 4, 1, 45, 300, 64, False, 0, 0.0),
                   (3, 6, 3, 1000, 1000, 64, True, 256, 30.0),
                   (1, 1, 1, 1, 1, 64, True, 0, 0.0),
                   (2, 40, 8, 600, 600, 128, True, 0, 0.0),
                   (4, 16, 1, 1100, 1100, 256, True, 512, 0.0)]


@pytest.mark.parametrize("b,h,kv,sq,sk,hd,causal,window,softcap",
                         BF16_ATTN_CASES)
def test_flash_attention_kernel_takes_bf16(dev, b, h, kv, sq, sk, hd,
                                           causal, window, softcap):
    """bf16 q, k, v (the models' default dtype, C18): one launch of the
    bf16 kernel (attention_bf16.cu) and none of the f32 one, a bf16
    output within 1e-4 of the row's max |o| plus one bf16 rounding (2^-8
    of |o|) of the plain version's f32 result on the same values."""
    from repro_torch import _ext
    from repro_torch.kernels import (flash_attention_kernel,
                                     flash_attention_plain)
    g = torch.Generator(device=dev)
    g.manual_seed(sq + hd)
    q, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16()
               for shape in ((b, h, sq, hd), (b, kv, sk, hd),
                             (b, kv, sk, hd)))
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap)
    _ext.reset_launch_counts()
    got = flash_attention_kernel(q, k, v, **kw)
    assert _ext.LAUNCHES["flash_attention_bf16"] == 1
    assert _ext.LAUNCHES["flash_attention"] == 0
    assert got.dtype == torch.bfloat16
    assert flash_attention_plain(q, k, v, **kw).dtype == torch.bfloat16
    want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    row = want.abs().amax(-1, keepdim=True)
    err = (got.float() - want).abs()
    assert bool((err <= 1e-4 * row + 2.0 ** -8 * want.abs()).all())


def test_flash_attention_kernel_refuses_a_mix_of_types(dev):
    """No caller mixes f32 and bf16 q, k, v: a mix is refused before any
    launch, not cast."""
    from repro_torch import _ext
    from repro_torch.kernels import flash_attention_kernel
    q = torch.zeros((1, 2, 8, 64), device=dev)
    k = torch.zeros((1, 2, 8, 64), device=dev, dtype=torch.bfloat16)
    _ext.reset_launch_counts()
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        flash_attention_kernel(q, k, k.clone(), scale=0.125)
    assert sum(_ext.LAUNCHES.values()) == 0


def test_flash_attention_kernel_refuses_rows_off_16_bytes(dev):
    """The kernel copies rows 16 bytes at a time: a contiguous q that
    starts 4 bytes into its storage is refused, and nothing launches."""
    from repro_torch import _ext
    from repro_torch.kernels import flash_attention_kernel
    q = torch.zeros(1 + 2 * 64, device=dev)[1:].view(1, 1, 2, 64)
    k = torch.zeros((1, 1, 2, 64), device=dev)
    _ext.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_kernel(q, k, k.clone(), scale=0.125)
    assert _ext.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("b,s,w", [(4, 4000, 4096), (2, 1, 33), (3, 77, 100),
                                   (1, 4096, 31), (2, 4001, 4100),
                                   (1, 33, 4097)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_kernel_matches_plain(dev, b, s, w, with_h0):
    from repro_torch import _ext
    from repro_torch.kernels import rglru_scan, rglru_scan_plain
    g = torch.Generator(device=dev)
    g.manual_seed(b * s + w)
    a = torch.rand((b, s, w), generator=g, device=dev)
    a[torch.rand((b, s, w), generator=g, device=dev) < 0.01] = 1.0
    x = torch.randn((b, s, w), generator=g, device=dev) * 0.2
    h0 = torch.randn((b, w), generator=g, device=dev) if with_h0 else None
    _ext.reset_launch_counts()
    got = rglru_scan(a, x, h0)
    assert _ext.LAUNCHES["rglru_scan"] == 1
    assert torch.equal(got, rglru_scan_plain(a, x, h0))


def test_server_kernel_path_matches_plain_path_on_cuda(dev, tmp_path):
    """A narrow recurrentgemma (head_dim 64, which B5 takes) served on
    the card: the kernel path launches B5 and B7 once per layer of its
    kind and serves the plain path's tokens; logits within 1e-3 of the
    step's largest |logit|."""
    from repro_torch import _ext
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Server
    cfg = get_smoke_config("recurrentgemma-9b").scaled(
        dtype="float32", n_layers=7, head_dim=64, d_model=128,
        lru_width=128, local_window=16)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_real, (3, 45)).astype(np.int32)
    runs = []
    for use_kernels in (True, False):
        srv = Server(cfg, tmp_path / str(use_kernels), device=dev,
                     use_kernels=use_kernels, max_len=64)
        _ext.reset_launch_counts()
        runs.append(srv.generate(prompts, 8, keep_logits=True))
        runs[-1][1]["launches"] = dict(_ext.LAUNCHES)
        srv.close()
    (out_k, st_k), (out_p, st_p) = runs
    assert st_k["launches"]["flash_attention"] == 2
    assert st_k["launches"]["rglru_scan"] == 5
    assert st_p["launches"]["flash_attention"] == 0
    assert st_p["launches"]["rglru_scan"] == 0
    np.testing.assert_array_equal(out_k, out_p)
    for a, b in zip(st_k["logits"], st_p["logits"]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


# ---------------------------------------------------------------------------
# B6 the SSD scan: y and the final state within 1e-4 of each (batch,
# head)'s largest |value| of the plain version (64-row sub-chunks against
# the plain version's chunks: the same function, other roundings)
# ---------------------------------------------------------------------------

SSD_CASES = [(2, 1, 24, 64, 128, 1, 256, True),
             (2, 255, 8, 64, 128, 1, 256, True),
             (2, 257, 8, 64, 128, 1, 256, False),
             # the kernel's chunk is 256 rows: s = 255, 256, 257 and 513,
             # with and without a state
             (2, 255, 8, 64, 128, 1, 256, False),
             (2, 256, 8, 64, 128, 1, 256, True),
             (2, 256, 8, 64, 128, 1, 256, False),
             (2, 257, 8, 64, 128, 1, 256, True),
             (2, 513, 8, 64, 128, 1, 256, True),
             (2, 513, 8, 64, 128, 1, 256, False),
             (1, 600, 4, 40, 256, 2, 256, True),     # two p slices at n 256
             (1, 300, 2, 6, 32, 1, 64, True),        # p % 4 != 0
             (3, 100, 6, 64, 128, 1, 256, True),
             (2, 300, 4, 64, 128, 2, 256, True),
             (3, 77, 8, 16, 16, 1, 16, True),
             (1, 130, 3, 40, 32, 3, 64, True),
             (1, 70, 2, 8, 256, 1, 32, True),
             (1, 65, 2, 64, 64, 1, 64, False)]


@pytest.mark.parametrize("b,s,h,p,n,g,chunk,with_state", SSD_CASES)
def test_ssd_kernel_matches_plain(dev, b, s, h, p, n, g, chunk, with_state):
    from repro_torch import _ext
    from repro_torch.kernels import ssd_chunked, ssd_scan
    gen = torch.Generator(device=dev)
    gen.manual_seed(b * s + n)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x, dt = r(b, s, h, p), torch.nn.functional.softplus(r(b, s, h))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    B, C = r(b, s, g, n) * 0.5, r(b, s, g, n) * 0.5
    s0 = r(b, h, p, n) * 0.5 if with_state else None
    _ext.reset_launch_counts()
    got = ssd_scan(x, dt, a_log, B, C, chunk=chunk, initial_state=s0)
    assert _ext.LAUNCHES["ssd_scan"] == 1
    want = ssd_chunked(x, dt, a_log, B, C, chunk, initial_state=s0)
    for gt, w, dims in ((got[0], want[0], (1, 3)), (got[1], want[1], (2, 3))):
        assert gt.shape == w.shape and gt.dtype == torch.float32
        scale = w.abs().amax(dim=dims, keepdim=True)
        assert bool(((gt - w).abs() <= 1e-4 * scale).all())


@pytest.mark.parametrize("b,s,h,p,n,g", [(2, 300, 8, 64, 128, 1),
                                         (3, 77, 8, 16, 16, 1),
                                         (1, 130, 3, 40, 32, 3),
                                         (1, 600, 4, 40, 256, 2),
                                         (1, 300, 2, 6, 32, 1),
                                         (2, 513, 4, 64, 64, 2)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_kernel_takes_bf16(dev, with_state, b, s, h, p, n, g):
    """bf16 x, B, C and state (C18): one launch of the bf16 kernel
    (ssd_bf16.cu) and none of the f32 one, y in bf16 and the state in
    f32, as ``ssd_chunked`` gives them; y within 1e-4 of the (batch,
    head)'s max plus one bf16 rounding (2^-8 of |y|) of the plain
    version's f32 result on the same values, the state within 1e-4."""
    from repro_torch import _ext
    from repro_torch.kernels import ssd
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).bfloat16()
    x, B, C = r(b, s, h, p), r(b, s, g, n, scale=0.5), \
        r(b, s, g, n, scale=0.5)
    dt = torch.nn.functional.softplus(torch.randn(
        (b, s, h), generator=gen, device=dev))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    s0 = r(b, h, p, n, scale=0.5) if with_state else None
    _ext.reset_launch_counts()
    y, final = ssd.ssd_scan(x, dt, a_log, B, C, initial_state=s0)
    assert _ext.LAUNCHES["ssd_scan_bf16"] == 1
    assert _ext.LAUNCHES["ssd_scan"] == 0
    py, pf = ssd.ssd_chunked(x, dt, a_log, B, C, 256, s0)
    assert (y.dtype, final.dtype) == (py.dtype, pf.dtype) == (
        torch.bfloat16, torch.float32)
    wy, wf = ssd.ssd_chunked(x.float(), dt, a_log, B.float(), C.float(),
                             256, None if s0 is None else s0.float())
    scale = wy.abs().amax(dim=(1, 3), keepdim=True)
    assert bool(((y.float() - wy).abs() <= 1e-4 * scale
                 + 2.0 ** -8 * wy.abs()).all())
    fscale = wf.abs().amax(dim=(2, 3), keepdim=True)
    assert bool(((final - wf).abs() <= 1e-4 * fscale).all())


def test_ssd_kernel_refuses_a_mix_of_types(dev):
    """No caller mixes f32 and bf16 among x, B and C: a mix is refused
    before any launch, not cast."""
    from repro_torch import _ext
    from repro_torch.kernels import ssd
    x = torch.randn(1, 64, 2, 8, device=dev)
    dt = torch.rand(1, 64, 2, device=dev)
    B = torch.randn(1, 64, 1, 16, device=dev).bfloat16()
    _ext.reset_launch_counts()
    with pytest.raises(TypeError, match="x, B and C of one type"):
        ssd.ssd_scan(x, dt, torch.zeros(2, device=dev), B, B.clone())
    assert sum(_ext.LAUNCHES.values()) == 0


@pytest.mark.parametrize("const,value", [("KERNEL_CHUNK", 128),
                                         ("KERNEL_SUB", 32)])
def test_ssd_kernel_refuses_scratch_of_other_steps(dev, monkeypatch, const,
                                                   value):
    """Scratch sized by row steps other than the kernel's own is refused
    before any launch, not written past."""
    from repro_torch import _ext
    from repro_torch.kernels import ssd
    monkeypatch.setattr(ssd, const, value)
    x = torch.randn(1, 300, 2, 8, device=dev)
    dt = torch.nn.functional.softplus(torch.randn(1, 300, 2, device=dev))
    B = torch.randn(1, 300, 1, 16, device=dev)
    _ext.reset_launch_counts()
    with pytest.raises(_ext.KernelLaunchError, match="ssd_scan"):
        ssd.ssd_scan(x, dt, torch.zeros(2, device=dev), B, B.clone())
    assert _ext.LAUNCHES["ssd_scan"] == 0


def test_mamba2_server_kernel_path_matches_plain_path_on_cuda(dev, tmp_path):
    """A narrow, 3-layer mamba2 (the "scan" layout) served on the card:
    the kernel path launches B6 once per layer, and never B5 or B7, and
    serves the plain path's tokens; logits within 1e-3 of the step's
    largest |logit|.  150 prompt tokens: not a multiple of the chunk."""
    from repro_torch import _ext
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Server
    cfg = get_smoke_config("mamba2-130m").scaled(
        dtype="float32", n_layers=3, d_model=128, ssm_state=32,
        ssm_headdim=32, ssm_chunk=64)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_real, (3, 150)).astype(np.int32)
    runs = []
    for use_kernels in (True, False):
        srv = Server(cfg, tmp_path / str(use_kernels), device=dev,
                     use_kernels=use_kernels, max_len=170)
        _ext.reset_launch_counts()
        runs.append(srv.generate(prompts, 8, keep_logits=True))
        runs[-1][1]["launches"] = dict(_ext.LAUNCHES)
        srv.close()
    (out_k, st_k), (out_p, st_p) = runs
    assert st_k["launches"] == {**st_p["launches"], "ssd_scan": 3}
    assert sum(st_p["launches"].values()) == 0
    np.testing.assert_array_equal(out_k, out_p)
    for a, b in zip(st_k["logits"], st_p["logits"]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def _eager_generate(mdl, params, cfg, dev, prompts, gen, max_len):
    """The Server's call written out eagerly: prefill, then ``gen`` steps
    of ``decode_step`` and argmax -> (tokens (b, gen), logits)."""
    dtype = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    cache = mdl.init_decode_state(cfg, prompts.shape[0], max_len,
                                  dtype=dtype, device=dev)
    logits, cache = mdl.prefill(params, {"tokens": prompts}, cfg, cache)
    kept, toks = [logits], []
    for i in range(gen):
        toks.append(logits.argmax(-1)[:, None])
        logits, cache = mdl.decode_step(params, toks[-1],
                                        prompts.shape[1] + i, cfg, cache)
        kept.append(logits)
    return torch.cat(toks, 1).cpu().numpy(), kept


@pytest.mark.parametrize("size,batch", [
    ("smoke", 1), ("smoke", 2), ("smoke-bf16", 2), ("full", 1),
    ("full", 2)])
def test_mamba2_decode_graph_matches_eager_decode(dev, tmp_path, size,
                                                  batch):
    """A mamba2 Server on the card replays its decode steps from one CUDA
    graph, captured once per (batch, dtype) over three calls of other
    prompt lengths, and serves what an eager prefill + ``decode_step``
    loop serves on the same weights: equal tokens, logits within 1e-6 of
    the row's largest |logit| (the same kernels on the same shapes: equal
    bits expected), every kept logits tensor its own storage, and the
    token log equal to the returned tokens."""
    from repro_torch import trace
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.serve import Server
    from repro_torch.models import model as mdl
    if size == "full":
        cfg = get_config("mamba2-130m").scaled(dtype="float32")
    else:
        cfg = get_smoke_config("mamba2-130m").scaled(
            d_model=128, ssm_state=32, ssm_headdim=32, ssm_chunk=64,
            dtype="bfloat16" if size == "smoke-bf16" else "float32")
    gen, lens = 6, (150, 37, 300)
    srv = Server(cfg, tmp_path / "s", device=dev, max_len=max(lens) + gen)
    before = trace.counters()
    rng = np.random.default_rng(batch)
    served = []
    for n in lens:
        prompts = rng.integers(0, cfg.vocab_real, (batch, n)).astype(
            np.int32)
        out, st = srv.generate(prompts, gen, keep_logits=True)
        want_out, want = _eager_generate(mdl, srv.params, cfg, dev, prompts,
                                         gen, max(lens) + gen)
        np.testing.assert_array_equal(out, want_out)
        got = st["logits"]
        assert len(got) == gen + 1
        assert len({t.untyped_storage().data_ptr() for t in got}) == gen + 1
        for a, b in zip(got, want):
            row = b.abs().amax(-1, keepdim=True)
            assert bool(((a - b).abs() <= 1e-6 * row).all())
        served.append(out)
    srv.close()
    after = trace.counters()
    counted = {k: after.get(k, 0) - before.get(k, 0) for k in (
        "serve.decode_graph_captures", "serve.decode_graph_steps",
        "serve.decode_steps")}
    assert counted == {"serve.decode_graph_captures": 1,
                       "serve.decode_graph_steps": len(lens) * gen,
                       "serve.decode_steps": len(lens) * gen}
    log = np.frombuffer(srv.clovis.get("stream/tokens"), np.int32)
    np.testing.assert_array_equal(
        log, np.concatenate([o.T for o in served]).reshape(-1))


# ---------------------------------------------------------------------------
# gradients through the model kernels: the forward launches the kernel,
# the backward recomputes the plain version (kernels.grad); each input's
# gradient within 1e-3 of that input's largest |g| through the plain path
# ---------------------------------------------------------------------------

GRAD_RTOL = 1e-3


def _grads_match(dev, kernel_fn, plain_fn, inputs, launches_name,
                 dtype=torch.float32):
    """``dtype``: each gradient's dtype must be its input's, and both
    paths' must be ``dtype`` where it is given."""
    from repro_torch import _ext
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    kin = [t.clone().requires_grad_(True) for t in inputs]
    pin = [t.clone().requires_grad_(True) for t in inputs]
    _ext.reset_launch_counts()
    kout = kernel_fn(*kin)
    assert _ext.LAUNCHES[launches_name] == 1
    pout = plain_fn(*pin)
    kout = kout if isinstance(kout, tuple) else (kout,)
    pout = pout if isinstance(pout, tuple) else (pout,)
    assert all(o.grad_fn is not None for o in kout)
    ws = [torch.randn(o.shape, generator=gen, device=dev) for o in pout]
    kg = torch.autograd.grad(sum((o * w).sum() for o, w in zip(kout, ws)),
                             kin)
    pg = torch.autograd.grad(sum((o * w).sum() for o, w in zip(pout, ws)),
                             pin)
    assert _ext.LAUNCHES[launches_name] == 1      # the backward launches none
    for k, p, t in zip(kg, pg, inputs):
        assert k.dtype == p.dtype == t.dtype
        assert dtype is None or k.dtype == dtype
        scale = float(p.float().abs().max())
        assert float((k.float() - p.float()).abs().max()) <= GRAD_RTOL * scale


@pytest.mark.parametrize("causal,window,softcap,kv",
                         [(True, 0, 0.0, 2), (True, 48, 30.0, 1),
                          (False, 0, 0.0, 4)])
def test_flash_attention_gradient_matches_plain(dev, causal, window, softcap,
                                                kv):
    from repro_torch.kernels import attention as KA
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    b, h, s, hd = 2, 4, 130, 64
    q, k, v = (torch.randn(shape, generator=g, device=dev) for shape in
               ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap)

    def plain(q, k, v):
        return KA.flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            **kw).transpose(1, 2)
    _grads_match(dev, lambda q, k, v: KA.flash_attention(q, k, v, **kw),
                 plain, [q, k, v], "flash_attention")


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_gradient_matches_plain(dev, with_h0):
    from repro_torch.kernels import rglru as KR
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    b, s, w = 2, 50, 40
    a = torch.rand((b, s, w), generator=g, device=dev) * 0.5 + 0.45
    x = torch.randn((b, s, w), generator=g, device=dev)
    inputs = [a, x] + ([torch.randn((b, w), generator=g, device=dev)]
                       if with_h0 else [])
    _grads_match(dev, KR.rglru_scan, KR.rglru_scan_plain, inputs,
                 "rglru_scan")


@pytest.mark.parametrize("b,s,h,p,n,g,chunk,with_state",
                         [(2, 300, 4, 64, 128, 1, 256, True),
                          (1, 77, 4, 32, 16, 2, 16, False)])
def test_ssd_gradient_matches_plain(dev, b, s, h, p, n, g, chunk,
                                    with_state):
    from repro_torch.kernels import ssd as KS
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    inputs = [r(b, s, h, p), torch.rand((b, s, h), generator=gen,
                                        device=dev) * 0.1,
              r(h, scale=0.5), r(b, s, g, n, scale=0.3),
              r(b, s, g, n, scale=0.3)]
    if with_state:
        inputs.append(r(b, h, p, n, scale=0.5))
    _grads_match(
        dev, lambda *t: KS.ssd_scan(*t[:5], chunk=chunk,
                                    initial_state=t[5] if with_state
                                    else None),
        lambda *t: KS.ssd_chunked(*t[:5], chunk,
                                  t[5] if with_state else None),
        inputs, "ssd_scan")


def test_bf16_gradients_through_b5_and_b6(dev):
    """bf16 inputs that require grad: the bf16 kernels' forward, the
    plain recompute in the backward, and every gradient in bf16 (each
    input's dtype), as the plain path's."""
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import ssd as KS
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    b, h, s, hd = 2, 4, 130, 64
    q, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16()
               for shape in ((b, s, h, hd), (b, s, 2, hd), (b, s, 2, hd)))
    kw = dict(scale=hd ** -0.5, causal=True)

    def plain(q, k, v):
        return KA.flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            **kw).transpose(1, 2)
    _grads_match(dev, lambda q, k, v: KA.flash_attention(q, k, v, **kw),
                 plain, [q, k, v], "flash_attention_bf16",
                 dtype=torch.bfloat16)
    x = torch.randn((1, 77, 4, 32), generator=g, device=dev).bfloat16()
    dt = torch.rand((1, 77, 4), generator=g, device=dev) * 0.1
    a_log = torch.randn(4, generator=g, device=dev) * 0.5
    B, C = (torch.randn((1, 77, 2, 16), generator=g, device=dev
                        ).bfloat16() * 0.3 for _ in range(2))
    _grads_match(dev, lambda *t: KS.ssd_scan(*t, chunk=16),
                 lambda *t: KS.ssd_chunked(*t, 16), [x, dt, a_log, B, C],
                 "ssd_scan_bf16", dtype=None)


def test_wrappers_without_grad_keep_their_path(dev):
    """No input requires grad: the kernel's plain launch, no grad_fn."""
    from repro_torch.kernels import ssd as KS
    x = torch.randn((1, 64, 2, 32), device=dev)
    dt = torch.rand((1, 64, 2), device=dev) * 0.1
    B = torch.randn((1, 64, 1, 16), device=dev)
    y, final = KS.ssd_scan(x, dt, torch.zeros(2, device=dev), B, B.clone())
    assert y.grad_fn is None and final.grad_fn is None


def test_mamba2_train_step_on_cuda_matches_plain_path(dev, tmp_path):
    """One loss_fn gradient of a small mamba2 (state 128, head dim 64)
    through B6 against the use_kernels=False path on the same weights."""
    from repro_torch import _ext
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as mdl
    from repro_torch.tree import leaves
    cfg = get_smoke_config("mamba2-130m").scaled(
        dtype="float32", ssm_state=128, ssm_headdim=64, d_model=128,
        ssm_chunk=64)
    params = mdl.init_params(cfg, device=dev)
    batch = mdl.make_batch(0, cfg, 2, 96)
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    out = {}
    for use in (True, False):
        _ext.reset_launch_counts()
        loss, _ = mdl.loss_fn(params, batch, cfg, use_kernels=use)
        out[use] = (loss, torch.autograd.grad(loss, flat))
        assert _ext.LAUNCHES["ssd_scan"] == (cfg.n_layers if use else 0)
    (lk, gk), (lp, gp) = out[True], out[False]
    assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item())
    for k, p in zip(gk, gp):
        assert float((k - p).abs().max()) <= GRAD_RTOL * float(
            p.abs().max())


# ---------------------------------------------------------------------------
# the MoE block on the card: the same selections and outputs as its CPU
# run (activations within 1e-4), ties to the lower index, and a combine
# that gives the same bits on every run
# ---------------------------------------------------------------------------

def _moe_case(arch, **over):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    cfg = get_smoke_config(arch).scaled(dtype="float32", **over)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg,
                     device=torch.device("cpu"))
    if "router_bias" in p:
        p["router_bias"] = torch.linspace(-0.05, 0.05, cfg.n_experts)
    return cfg, p


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b"])
@pytest.mark.parametrize("b,s", [(2, 37), (4, 1)])
def test_moe_block_on_cuda_matches_cpu(dev, arch, b, s):
    from repro_torch.models import moe
    cfg, p = _moe_case(arch)
    x = torch.from_numpy(np.random.default_rng(b * s).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32))
    want, waux = moe.moe_block(p, x, cfg)
    pd = {k: v.to(dev) for k, v in p.items()}
    got, aux = moe.moe_block(pd, x.to(dev), cfg)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)
    assert abs(float(aux) - float(waux)) <= 1e-5 * abs(float(waux))
    g, gs = (b, s) if s > 1 else (1, b)
    cap = moe.capacity(cfg, gs)
    for a, c in zip(moe._route(pd, x.to(dev).reshape(g, gs, -1), cfg, cap),
                    moe._route(p, x.reshape(g, gs, -1), cfg, cap)):
        if a.dtype == torch.long:
            assert torch.equal(a.cpu(), c)


def test_moe_ties_on_cuda_go_to_the_lower_index(dev):
    """Identical token rows and two identical router columns tie exactly:
    the card keeps the lower token (and expert) index, as the CPU and
    jax.lax.top_k do."""
    from repro_torch.models import moe
    cfg, p = _moe_case("qwen2-moe-a2.7b", moe_capacity_factor=0.5)
    p["router"][:, 3] = p["router"][:, 1]
    row = torch.from_numpy(np.random.default_rng(1).standard_normal(
        cfg.d_model).astype(np.float32))
    xg = row.expand(2, 600, cfg.d_model).contiguous()
    cap = moe.capacity(cfg, 600)
    got = moe._route({k: v.to(dev) for k, v in p.items()}, xg.to(dev), cfg,
                     cap)
    want = moe._route(p, xg, cfg, cap)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(want[0], torch.arange(cap).expand_as(want[0]))
    sel = moe.router_scores(p, row[None], cfg)[1]
    assert torch.equal(moe.topk_indices(sel.to(dev), 8).cpu(),
                       moe.topk_indices(sel, 8))


def test_moe_combine_gives_the_same_bits_every_run(dev):
    from repro_torch.models import moe
    cfg, p = _moe_case("qwen2-moe-a2.7b", d_model=256, n_experts=60,
                       top_k=4, d_expert=128)
    pd = {k: v.to(dev) for k, v in p.items()}
    x = torch.randn((4, 512, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    first, _ = moe.moe_block(pd, x, cfg)
    for _ in range(5):
        again, _ = moe.moe_block(pd, x, cfg)
        assert torch.equal(again, first)


def test_moe_server_kernel_path_matches_plain_path_on_cuda(dev, tmp_path):
    """A narrow qwen2-moe (head_dim 64, which B5 takes) served on the
    card at capacity 1.25: B5 once per layer in the prefill, the plain
    path's tokens, logits within 1e-3 of the step's largest |logit|."""
    from repro_torch import _ext
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Server
    from repro_torch.models import model as mdl
    cfg = get_smoke_config("qwen2-moe-a2.7b").scaled(
        dtype="float32", n_layers=3, head_dim=64, d_model=128)
    params = mdl.init_params(cfg, device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_real, (3, 45)).astype(np.int32)
    runs = []
    for use_kernels in (True, False):
        srv = Server(cfg, tmp_path / str(use_kernels), device=dev,
                     use_kernels=use_kernels, max_len=64, params=params)
        _ext.reset_launch_counts()
        runs.append(srv.generate(prompts, 8, keep_logits=True))
        runs[-1][1]["launches"] = dict(_ext.LAUNCHES)
        srv.close()
    (out_k, st_k), (out_p, st_p) = runs
    assert st_k["launches"]["flash_attention"] == 3
    assert st_p["launches"]["flash_attention"] == 0
    np.testing.assert_array_equal(out_k, out_p)
    for a, b in zip(st_k["logits"], st_p["logits"]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


# ---------------------------------------------------------------------------
# the encoder, encoder-decoder and cross-attention families served on the
# card (head_dim 64, which B5 takes): the kernel path against the plain
# path on the same weights, logits within 1e-3 of the step's largest
# |logit| and the same greedy tokens; and C18's acceptance, a bf16 mamba2
# served through B6 against the plain path in bf16
# ---------------------------------------------------------------------------

def _serve_both(dev, tmp_path, cfg, params, prompts, extra, gen=6):
    from repro_torch import _ext
    from repro_torch.launch.serve import Server
    runs = []
    for use_kernels in (True, False):
        srv = Server(cfg, tmp_path / str(use_kernels), device=dev,
                     use_kernels=use_kernels, max_len=prompts.shape[1] + 16,
                     params=params)
        _ext.reset_launch_counts()
        out, st = srv.generate(prompts, gen, extra=extra, keep_logits=True)
        st["launches"] = dict(_ext.LAUNCHES)
        srv.close()
        runs.append((out, st))
    return runs


@pytest.mark.parametrize("pattern,launches", [(("global",), 2),
                                              (("encdec",), 2 + 2 * 2)])
def test_whisper_server_kernel_path_matches_plain_path_on_cuda(
        dev, tmp_path, pattern, launches):
    """A narrow whisper served on the card: as configured (the decoder's
    2 self-attention layers launch B5; the encoder is never read) and
    with ``encdec`` blocks (the encoder's 2 layers, then each decoder
    layer's self and cross attention)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as mdl
    cfg = get_smoke_config("whisper-large-v3").scaled(
        dtype="float32", head_dim=64, encoder_seq=150, attn_pattern=pattern)
    params = mdl.init_params(cfg, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_real, (3, 40)).astype(np.int32)
    extra = {"frames": rng.standard_normal(
        (3, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    (out_k, st_k), (out_p, st_p) = _serve_both(dev, tmp_path, cfg, params,
                                               prompts, extra)
    assert st_k["launches"]["flash_attention"] == launches
    assert sum(st_p["launches"].values()) == 0
    np.testing.assert_array_equal(out_k, out_p)
    for a, b in zip(st_k["logits"], st_p["logits"]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


def test_vision_server_kernel_path_matches_plain_path_on_cuda(dev, tmp_path):
    """A narrow llama-3.2-vision (10 layers: 8 global and 2 gated cross)
    served on the card with both gates of each cross layer at 0.5 (they
    start at 0, which makes the layer the identity): B5 once per layer
    in the prefill, the plain path's tokens and logits; other image
    embeddings move the logits."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as mdl
    cfg = get_smoke_config("llama-3.2-vision-90b").scaled(
        dtype="float32", head_dim=64, n_layers=10, n_image_tokens=101)
    params = mdl.init_params(cfg, device=dev)
    for bp in params["decoder"]["unrolled"]:
        if "mlp_gate" in bp:
            bp["mlp_gate"].fill_(0.5)
            bp["mixer"]["gate"].fill_(0.5)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_real, (3, 40)).astype(np.int32)
    embeds = [rng.standard_normal((3, cfg.n_image_tokens, cfg.d_model)
                                  ).astype(np.float32) for _ in range(2)]
    (out_k, st_k), (out_p, st_p) = _serve_both(
        dev, tmp_path, cfg, params, prompts, {"image_embeds": embeds[0]})
    assert st_k["launches"]["flash_attention"] == 10
    assert sum(st_p["launches"].values()) == 0
    np.testing.assert_array_equal(out_k, out_p)
    for a, b in zip(st_k["logits"], st_p["logits"]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    cache = mdl.init_decode_state(cfg, 3, 48, dtype=torch.float32,
                                  device=dev)
    other, _ = mdl.prefill(params, {"tokens": prompts,
                                    "image_embeds": embeds[1]}, cfg, cache)
    first = st_k["logits"][0]
    assert float((other - first).abs().max()) > 1e-2 * float(
        first.abs().max())


def test_mamba2_bf16_server_kernel_path_matches_plain_path_on_cuda(
        dev, tmp_path):
    """C18's acceptance: a narrow 3-layer mamba2 in its config's default
    bf16 served through B6's bf16 kernel (ssd_bf16.cu) against the
    plain path in bf16 on the same weights: B6 once per
    layer, logits within 3e-2 of the step's largest |logit| (both round
    their activations to bf16, 2^-8, between layers, in other places),
    and the same prefill token wherever the plain path's top two differ
    by more than that."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as mdl
    cfg = get_smoke_config("mamba2-130m").scaled(
        n_layers=3, d_model=128, ssm_state=32, ssm_headdim=32, ssm_chunk=64)
    assert cfg.dtype == "bfloat16"
    params = mdl.init_params(cfg, device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_real, (3, 150)).astype(np.int32)
    (out_k, st_k), (out_p, st_p) = _serve_both(dev, tmp_path, cfg, params,
                                               prompts, None)
    assert st_k["launches"]["ssd_scan_bf16"] == 3
    assert st_k["launches"]["ssd_scan"] == 0
    assert sum(st_p["launches"].values()) == 0
    for a, b in zip(st_k["logits"], st_p["logits"]):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 3e-2 * float(b.abs().max())
    first_k, first_p = st_k["logits"][0], st_p["logits"][0]
    top2 = first_p.topk(2, dim=-1).values
    wide = (top2[:, 0] - top2[:, 1]) > 3e-2 * float(first_p.abs().max())
    assert torch.equal(first_k.argmax(-1)[wide], first_p.argmax(-1)[wide])


def test_mesh_trainer_step_on_cuda_matches_the_plain_trainer(dev, tmp_path):
    """A narrow qwen2.5 (hd 128, GQA 4 over 2) through the Trainer on a
    world-size-1 NCCL 1 x 1 mesh against the plain Trainer from the same
    seed on the same batches: DTensor parameters, B5 two launches a
    forward, the losses within 1e-6 relative."""
    from datetime import timedelta

    import torch.distributed as dist

    from repro_torch import _ext
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.train import Trainer
    from repro_torch.models import model as mdl
    cfg = get_smoke_config("qwen2.5-32b").scaled(
        dtype="float32", head_dim=128, d_model=256)
    run = RunConfig(arch="qwen2.5-32b", remat="none", total_steps=3,
                    warmup_steps=1, checkpoint_every=1000)
    batches = [mdl.make_batch(i, cfg, 2, 128) for i in range(3)]
    losses = {}
    for mesh in (False, True):
        if mesh:
            dist.init_process_group(
                "nccl", store=dist.FileStore(str(tmp_path / "pg"), 1),
                rank=0, world_size=1, device_id=dev,
                timeout=timedelta(seconds=60))
        try:
            tr = Trainer(cfg, run, tmp_path / f"run{int(mesh)}", device=dev)
            assert (tr.mesh is not None) == mesh
            params, opt = tr.init_state(0)
            _ext.reset_launch_counts()
            losses[mesh] = [float(tr.step(params, opt, b)[2]["loss"])
                            for b in batches]
            assert _ext.LAUNCHES["flash_attention"] == 3 * cfg.n_layers
            tr.ckpt.close()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero, and no phase's failure is caught:

1. Card and build: the card's name and power limit (nvidia-smi), the
   torch and CUDA versions, and the one nvcc build of every
   ``src/repro_torch/csrc/*.cu``.
2. Each CUDA kernel against its plain PyTorch version on the card over
   edge shapes, ops, dtypes and expression specs; int results must be
   equal, f32 min/max equal, f32 sums within ``F32_SUM_RTOL`` of the
   segment's sum of |v| (atomics add in another order), the heat scan
   equal bit for bit (``[heat]``).  Each kernel is also timed at the
   shape its path gives it, beside its bound, its plain version and,
   where one exists, one PyTorch library call; one ``heat_scores`` call
   at 262,144 objects is split into its host and device parts.
3. The main path at full size: a store of 16 partitions x 4,194,304
   rows x 4 int32 columns (1 GiB, made from torch.Generator seed 0) and
   queries (a)-(d) through ``Clovis.analytics()``; each result must
   equal the ``use_kernels=False`` (numpy reference) engine's exactly,
   and every kernel must have launched.  Then ``[percip]``: query (a)
   again after ``enable_percipience()`` (equal result, heat kernel
   launched), and the percipience benchmark's traces over 1,024
   objects, predictive against reactive, with the policy's heat held
   against the numpy closed form.
4. ``[stream]``: a continuous windowed query over 16,777,216 rows
   pushed by 4 producers; every final window must equal the
   ``use_kernels=False`` batch engine over the same rows.
5. One JSON line of per-kernel numbers, then the contract's last line.

It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
F32_SUM_RTOL = 1e-4            # f32 sums vs plain, relative to sum |v|
PARTS, ROWS, KEYS, WINDOW = 16, 4_194_304, 4096, 4096
CHECK_ROWS = (1, 1023, 1025, ROWS)
CHECK_SEGS = (1, 128, 4096, 60000)   # 60000: the global-atomic path
OPS = ("sum", "count", "min", "max")
HEAT_SHAPES = ((1, 1), (24, 37), (7, 129), (64, 1000))   # (hist, nobj)
HEAT_HIST, HEAT_OBJS = 64, 262_144   # extractor hist_len x tracked objects
PERCIP_OBJS, PERCIP_BYTES, PERCIP_READS, SCAN_EVERY = 1024, 64 << 10, 2048, 16
STREAM_ELEMS, STREAM_ROWS, STREAM_PRODUCERS = 4096, 4096, 4
STREAM_WINDOW_S, STREAM_DELTA = 0.256, 262_144
ANALYTICS_CU = "src/repro_torch/csrc/analytics_kernels.cu"
KERNELS = {   # name -> (source, TPU kernel it replaces: reference file:line)
    "fused_filter_aggregate": (ANALYTICS_CU,
                               "src/repro/analytics/kernels.py:447"),
    "segment_reduce": (ANALYTICS_CU, "src/repro/analytics/kernels.py:131"),
    "window_reduce": (ANALYTICS_CU, "src/repro/analytics/kernels.py:288"),
    "heat_scan": ("src/repro_torch/csrc/percipience_kernels.cu",
                  "src/repro/percipience/heat.py:47"),
}
BATCH_KERNELS = ("fused_filter_aggregate", "segment_reduce",
                 "window_reduce")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: card and build
# ---------------------------------------------------------------------------

def phase_card_and_build(torch, ext):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    ext.library()
    log(f"[build] {time.perf_counter() - t0:.2f} s (nvcc "
        f"{ext.build_seconds:.2f} s)")
    for line in ext.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

class Checker:
    """Compares kernel with plain results and keeps the worst error."""

    def __init__(self, torch):
        self.torch = torch
        self.err = {k: 0.0 for k in KERNELS}
        self.cases = {k: 0 for k in KERNELS}

    def same(self, name, what, got, want, op, abs_sum=None):
        torch = self.torch
        self.cases[name] += 1
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} {what}: {got.dtype}{tuple(got.shape)} vs plain "
                 f"{want.dtype}{tuple(want.shape)}")
        if got.numel() == 0:
            return
        if got.dtype == torch.float32:
            both_inf = torch.isinf(got) & (got == want)
            diff = torch.where(both_inf, torch.zeros_like(got),
                               (got - want).abs())
            err = float(diff.max())
            if op == "sum":
                ok = bool((diff <= F32_SUM_RTOL * abs_sum + 1e-6).all())
            else:
                ok = err == 0.0
        else:
            err = float((got.long() - want.long()).abs().max())
            ok = err == 0.0
        self.err[name] = max(self.err[name], err)
        if not ok:
            fail(f"{name} {what}: kernel and plain differ (max abs "
                 f"error {err})")


def phase_kernels(torch, K, col, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    chk = Checker(torch)

    def data(n, n_seg):
        ids = torch.randint(0, n_seg, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        drop = torch.rand((n,), generator=gen, device=dev) < 0.05
        ids = torch.where(drop, torch.full_like(ids, -1), ids)
        cols = {
            0: ids.abs(),
            1: torch.randint(0, 100, (n,), generator=gen, device=dev,
                             dtype=torch.int32),
            2: torch.randint(-500, 500, (n,), generator=gen, device=dev,
                             dtype=torch.int32),
            3: torch.randn((n,), generator=gen, device=dev),
        }
        return ids, cols

    preds = [
        (col(1) >= 75).to_spec(),
        (((col(2) % 7) == 3) | ~(col(1) < 50)).to_spec(),   # %, ~ on bool
        ((col(2) / 3) > 10.5).to_spec(),                    # int / -> f32
        None,
        (col(1) > 1000).to_spec(),                          # rejects all
    ]
    int_values = [col(2).to_spec(), (col(2) % -7).to_spec(),
                  (~col(0)).to_spec()]                      # ~ on int
    f32_values = [(col(3) * 0.5 + col(2) / 7).to_spec(),
                  ((col(3) % 0.75) - col(1)).to_spec()]

    def program(pred, value, out_dtype):
        used = sorted(K.spec_columns(pred) | K.spec_columns(value))
        kinds = tuple((i, "F" if i == 3 else "I") for i in used)
        prog = K.compile_specs(
            json.dumps(pred, sort_keys=True) if pred else "",
            json.dumps(value, sort_keys=True) if value else "", kinds,
            out_dtype)
        return prog, used

    case = 0
    for n in CHECK_ROWS:
        for n_seg in CHECK_SEGS:
            ids, cols = data(n, n_seg)
            for op in OPS:
                for dt in (torch.int32, torch.float32):
                    case += 1
                    pred = preds[case % len(preds)]
                    vals = int_values if dt == torch.int32 else f32_values
                    value = vals[case % len(vals)]
                    prog, used = program(pred, value, str(dt).split(".")[1])
                    ts = [cols[i] for i in used]
                    what = (f"rows={n} segs={n_seg} op={op} {dt} "
                            f"pred={pred} value={value}")
                    got = K.fused_filter_aggregate_tensor(ts, prog, ids,
                                                          n_seg, op, dt)
                    want = K.fused_filter_aggregate_plain(ts, prog, ids,
                                                          n_seg, op, dt)
                    abs_sum = None
                    if op == "sum" and dt == torch.float32:
                        val = K._run_program_plain(
                            prog.code[prog.n_pred:], prog, ts).abs()
                        keep = ids >= 0
                        if prog.n_pred:
                            keep &= K._run_program_plain(
                                prog.code[:prog.n_pred], prog, ts) != 0
                        abs_sum = K.segment_reduce_plain(
                            torch.broadcast_to(val, ids.shape).contiguous(),
                            torch.where(keep, ids, -1), n_seg, "sum")
                    chk.same("fused_filter_aggregate", what + " acc",
                             got[0], want[0], op, abs_sum)
                    chk.same("fused_filter_aggregate", what + " cnt",
                             got[1], want[1], "count")

                    v = cols[2] if dt == torch.int32 else cols[3]
                    got = K.segment_reduce_tensor(v, ids, n_seg, op)
                    want = K.segment_reduce_plain(v, ids, n_seg, op)
                    abs_sum = (K.segment_reduce_plain(v.abs(), ids, n_seg,
                                                      "sum")
                               if dt == torch.float32 else None)
                    chk.same("segment_reduce", f"rows={n} segs={n_seg} "
                             f"op={op} {dt}", got, want, op, abs_sum)

    windows = [(ROWS, WINDOW, WINDOW), (ROWS, WINDOW, 1024),
               (1025, 64, 17), (4096, 4096, 4096), (1023, 8, 3)]
    for n, w, s in windows:
        _, cols = data(n, 1)
        for op in OPS:
            for v in (cols[2], cols[3]):
                got = K.window_reduce_tensor(v, w, s, op)
                want = K.window_reduce_plain(v, w, s, op)
                abs_sum = (K.window_reduce_plain(v.abs(), w, s, "sum")
                           if v.dtype == torch.float32 else None)
                chk.same("window_reduce", f"n={n} window={w} slide={s} "
                         f"op={op} {v.dtype}", got, want, op, abs_sum)
    # a sequence shorter than one window emits nothing, as in window_reduce
    short = K.window_reduce(cols[2][:100].cpu().numpy(), 128, device=dev)
    if short.shape != (0,) or short.dtype.name != "float32":
        fail(f"window_reduce on a short sequence gave {short!r}")
    torch.cuda.synchronize()
    log(f"[kernels] kernel == plain on the card: {chk.cases} cases; "
        f"max abs error {chk.err} (f32 sums within {F32_SUM_RTOL} x "
        f"sum|v|; ints and f32 min/max exact)")
    return chk


def heat_inputs(torch, gen, dev, hist, nobj, weights):
    """(hist, nobj) decay factors in [0, 1] with exact 0s and 1s, and
    weights: random with some all-zero rows, or all zero."""
    a = torch.rand((hist, nobj), generator=gen, device=dev)
    a[torch.rand((hist, nobj), generator=gen, device=dev) < 0.1] = 0.0
    a[torch.rand((hist, nobj), generator=gen, device=dev) < 0.1] = 1.0
    x = torch.rand((hist, nobj), generator=gen, device=dev) * 3
    if weights == "zero":
        x.zero_()
    else:
        x[torch.rand(hist, generator=gen, device=dev) < 0.2] = 0.0
    return a, x


def histories(torch, gen, dev, n, hist, now):
    """Right-aligned access histories as FeatureExtractor.history_tensors
    makes them (f64 epoch seconds, mask 1 on the newest k steps, k
    uniform in [0, hist]), built on the card and copied to the host."""
    k = torch.randint(0, hist + 1, (n, 1), generator=gen, device=dev)
    mask = (torch.arange(hist, device=dev) >= hist - k).double()
    gaps = torch.rand((n, hist), generator=gen, device=dev,
                      dtype=torch.float64) * 30.0
    age = gaps.flip(1).cumsum(1).flip(1)        # newest access is youngest
    ts = (now - age) * mask
    return ts.cpu().numpy(), mask.cpu().numpy()


def phase_heat(torch, H, chk, dev):
    """[heat] B4 against its plain version (bit for bit: both round the
    multiply and the add separately), and heat_scores on the card
    against the CPU and the numpy closed form."""
    import numpy as np
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    for hist, nobj in HEAT_SHAPES + ((HEAT_HIST, HEAT_OBJS),):
        for weights in ("random", "zero"):
            a, x = heat_inputs(torch, gen, dev, hist, nobj, weights)
            got = H.heat_scan(a, x, device=dev)
            want = H.heat_scan_plain(a, x)
            chk.cases["heat_scan"] += 1
            err = float((got - want).abs().max())
            chk.err["heat_scan"] = max(chk.err["heat_scan"], err)
            if not torch.allclose(got, want, rtol=1e-6, atol=0.0):
                fail(f"heat_scan hist={hist} nobj={nobj} {weights}: kernel "
                     f"and plain differ (max abs error {err})")
    now = 1.7e9
    ts, mask = histories(torch, gen, dev, 5000, HEAT_HIST, now)
    mask[:100] = 0.0                             # empty histories
    ts[:100] = 0.0
    w = np.random.default_rng(0).uniform(0.5, 4.0, ts.shape)
    for weights in (None, w):
        got = H.heat_scores(ts, mask, now, 60.0, weights=weights, device=dev)
        cpu = H.heat_scores(ts, mask, now, 60.0, weights=weights,
                            device="cpu")
        ref = H.heat_scores_ref(ts, mask, now, 60.0, weights=weights)
        if not (np.allclose(got, cpu, rtol=1e-6, atol=0.0)
                and np.allclose(got, ref, rtol=1e-5, atol=1e-12)
                and (got[:100] == 0.0).all()):
            fail("heat_scores on the card disagrees with the CPU or the "
                 "numpy closed form")
    if H.heat_scores(ts[:0], mask[:0], now, device=dev).shape != (0,):
        fail("heat_scores with no objects must return shape (0,)")
    torch.cuda.synchronize()
    log(f"[heat] kernel == plain on the card: {chk.cases['heat_scan']} "
        f"cases over (hist, nobj) {list(HEAT_SHAPES)} and "
        f"({HEAT_HIST}, {HEAT_OBJS}); max abs error "
        f"{chk.err['heat_scan']}; heat_scores cuda == cpu == closed form "
        f"(rtol 1e-5) on 5000 objects with 100 empty histories, weighted "
        f"and not, and on 0 objects")


# ---------------------------------------------------------------------------
# timing at the main path's shapes
# ---------------------------------------------------------------------------

def device_ms(torch, fn, reps=10):
    """Mean device time of ``fn`` with the 50 MB L2 flushed before each
    run (the main path's inputs arrive fresh from the host)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def phase_timing(torch, K, H, col, dev):
    """Each kernel at the shape its path gives it: B1 as query (a)'s
    fused pass, B2 as query (c)'s histogram count, B3 as query (d)'s
    window max (one partition each), B4 as one heat refresh of 262,144
    tracked objects."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def ri(lo, hi):
        return torch.randint(lo, hi, (ROWS,), generator=gen, device=dev,
                             dtype=torch.int32)

    key, quality, reading = ri(0, KEYS), ri(0, 100), ri(-500, 500)
    out = {}

    # B1: filter col(1) >= 75, key col(0), f32 sum of col(2) (query a)
    prog = K.compile_specs(json.dumps((col(1) >= 75).to_spec()),
                           json.dumps(col(2).to_spec()),
                           ((1, "I"), (2, "I")), "float32")
    ts = [quality, reading]
    survivors = int((quality >= 75).sum())
    out["fused_filter_aggregate"] = dict(
        ms=device_ms(torch, lambda: K.fused_filter_aggregate_tensor(
            ts, prog, key, KEYS, "sum", torch.float32)),
        plain_ms=device_ms(torch, lambda: K.fused_filter_aggregate_plain(
            ts, prog, key, KEYS, "sum", torch.float32)),
        # ids + the predicate column for every row, the value column for
        # the survivors, acc + cnt out
        bound_bytes=4 * ROWS * 2 + 4 * survivors + 8 * KEYS,
        library_ms=None, shape=f"rows={ROWS} segs={KEYS} sum f32")

    # B2: histogram count of 32 bins over col(2) (query c)
    bins = ((reading.double() + 500) / (1000 / 32)).floor().clamp_(max=31)
    ids = bins.to(torch.int32)
    ones = torch.ones_like(ids)
    dump = torch.where(ids >= 0, ids, 32).long()
    lib_out = torch.zeros(33, dtype=torch.int32, device=dev)
    out["segment_reduce"] = dict(
        ms=device_ms(torch, lambda: K.segment_reduce_tensor(
            ones, ids, 32, "count")),
        plain_ms=device_ms(torch, lambda: K.segment_reduce_plain(
            ones, ids, 32, "count")),
        # count reads only the ids (the values are never loaded)
        bound_bytes=4 * ROWS + 4 * 32,
        library_ms=device_ms(torch, lambda: lib_out.scatter_reduce_(
            0, dump, ones, reduce="sum")),
        shape=f"rows={ROWS} segs=32 count int32")

    # B3: tumbling window max over col(2) (query d)
    nw = ROWS // WINDOW
    out["window_reduce"] = dict(
        ms=device_ms(torch, lambda: K.window_reduce_tensor(
            reading, WINDOW, WINDOW, "max")),
        plain_ms=device_ms(torch, lambda: K.window_reduce_plain(
            reading, WINDOW, WINDOW, "max")),
        bound_bytes=4 * ROWS + 4 * nw,
        library_ms=device_ms(torch, lambda: reading.unfold(
            0, WINDOW, WINDOW).amax(1)),
        shape=f"n={ROWS} window={WINDOW} max int32")

    # B4: the heat scan over the extractor's hist_len x 262,144 objects;
    # no one PyTorch call computes a first-order linear recurrence
    a, x = heat_inputs(torch, gen, dev, HEAT_HIST, HEAT_OBJS, "random")
    out["heat_scan"] = dict(
        ms=device_ms(torch, lambda: H.heat_scan(a, x, device=dev)),
        plain_ms=device_ms(torch, lambda: H.heat_scan_plain(a, x)),
        bound_bytes=2 * 4 * HEAT_HIST * HEAT_OBJS + 4 * HEAT_OBJS,
        library_ms=None, shape=f"hist={HEAT_HIST} nobj={HEAT_OBJS} f32")
    for name, r in out.items():
        r["bound_ms"] = r["bound_bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"[timing] {name} ({r['shape']}): {r['ms']:.4f} ms/launch, "
            f"plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_bytes']} B at "
            f"{HBM_BYTES_PER_S:.3g} B/s)")
    return out


def phase_heat_split(torch, H, dev):
    """One heat_scores call at 262,144 objects x hist 64, then its steps
    one by one on the host clock (synchronised): what the card waits
    on."""
    import numpy as np
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    now = 1.7e9
    ts, mask = histories(torch, gen, dev, HEAT_OBJS, HEAT_HIST, now)
    H.heat_scores(ts[:8], mask[:8], now, device=dev)        # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole = H.heat_scores(ts, mask, now, 120.0, device=dev)
    t1 = time.perf_counter()
    lam = H.LN2 / 120.0
    s0 = time.perf_counter()
    at, xt = H._scan_inputs(ts, mask, lam, None)
    s1 = time.perf_counter()
    a_d = torch.from_numpy(at).to(dev)
    x_d = torch.from_numpy(xt).to(dev)
    torch.cuda.synchronize()
    s2 = time.perf_counter()
    h = H.heat_scan(a_d, x_d, device=dev)
    torch.cuda.synchronize()
    s3 = time.perf_counter()
    split = h.cpu().numpy().astype(np.float64) * H._tail(ts, mask, now, lam)
    s4 = time.perf_counter()
    if not np.array_equal(split, whole):
        fail("heat_scores split into its steps differs from one call")
    if not np.allclose(whole, H.heat_scores_ref(ts, mask, now, 120.0),
                       rtol=1e-5, atol=1e-12):
        fail("heat_scores at full size disagrees with the closed form")
    parts = {"f64_precompute_ms": (s1 - s0) * 1e3,
             "host_to_device_ms": (s2 - s1) * 1e3,
             "kernel_ms": (s3 - s2) * 1e3, "tail_ms": (s4 - s3) * 1e3}
    log(f"[heat] heat_scores({HEAT_OBJS} objects x {HEAT_HIST}): one call "
        f"{(t1 - t0) * 1e3:.3f} ms on the host clock; split "
        f"{json.dumps({k: round(v, 3) for k, v in parts.items()})} "
        f"(tail: device->host copy and the f64 decay to now); equal to "
        f"the closed form (rtol 1e-5)")


# ---------------------------------------------------------------------------
# phase 3: the main path at full size
# ---------------------------------------------------------------------------

def build_store(torch, Clovis, root, dev):
    cl = Clovis(root, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    for i in range(PARTS):
        tbl = torch.empty((ROWS, 4), dtype=torch.int32, device=dev)
        for c, (lo, hi) in enumerate(((0, KEYS), (0, 100), (-500, 500))):
            tbl[:, c] = torch.randint(lo, hi, (ROWS,), generator=gen,
                                      device=dev, dtype=torch.int32)
        tbl[:, 3] = i
        cl.put_array(f"capture/{i:02d}", tbl.cpu().numpy(),
                     container="capture")
    nbytes = sum(cl.store.read_size(o) for o in cl.container("capture"))
    log(f"[store] {PARTS} partitions x {ROWS} rows x 4 int32 = "
        f"{nbytes} B written in {time.perf_counter() - t0:.2f} s")
    if nbytes != PARTS * ROWS * 16:
        fail(f"store holds {nbytes} B, expected {PARTS * ROWS * 16}")
    return cl


QUERIES = ("a_mean", "b_count", "b_min", "b_max", "c_histogram",
           "d_window_max")


def queries(eng, col):
    def grouped():
        return eng.scan("capture").filter(col(1) >= 75).key_by(col(0))
    return {
        "a_mean": grouped().aggregate("mean", value=col(2)),
        "b_count": grouped().aggregate("count"),
        "b_min": grouped().aggregate("min", value=col(2)),
        "b_max": grouped().aggregate("max", value=col(2)),
        "c_histogram": eng.scan("capture").aggregate(
            "histogram", value=col(2), bins=32, vrange=(-500, 500)),
        "d_window_max": eng.scan("capture").window(WINDOW).aggregate(
            "max", value=col(2)),
    }


def equal(a, b) -> bool:
    import numpy as np
    if isinstance(a, tuple):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def check_shape(name, value):
    import numpy as np
    if name.startswith(("a_", "b_")):
        keys, vals = value
        if not (np.array_equal(keys, np.arange(KEYS)) and len(vals) == KEYS
                and np.isfinite(vals).all()):
            fail(f"{name}: expected {KEYS} finite groups")
    elif name.startswith("c_"):
        if value.shape != (32,) or int(value.sum()) != PARTS * ROWS:
            fail(f"{name}: histogram does not count every row")
    elif value.shape != (PARTS * (ROWS // WINDOW),) \
            or not (np.abs(value) < 500).all():
        fail(f"{name}: wrong window count or values")


def event_times(torch, K, run):
    """Device ms summed per kernel wrapper (and per host->device copy)
    over ``run()``, timed with CUDA events around each call."""
    names = ("fused_filter_aggregate_tensor", "segment_reduce_tensor",
             "window_reduce_tensor", "_to_device")
    saved = {n: getattr(K, n) for n in names}
    pairs = {n: [] for n in names}

    def timed(name, fn):
        def call(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **kw)
            e.record()
            pairs[name].append((s, e))
            return out
        return call
    try:
        for n in names:
            setattr(K, n, timed(n, saved[n]))
        run()
    finally:
        for n in names:
            setattr(K, n, saved[n])
    torch.cuda.synchronize()
    return {n.strip("_").replace("_tensor", ""):
            sum(s.elapsed_time(e) for s, e in ps) for n, ps in pairs.items()}


def percip_query(torch, K, col, cl, engine, want):
    """[percip] query (a) on the 1 GiB store after enable_percipience():
    the first run's reads feed the extractor, the second's scheduling
    and cost model score heat through B4.  Both must equal the result
    without percipience exactly."""
    K.reset_launch_counts()                     # [percip] starts here
    _, prefetcher, policy = cl.enable_percipience()
    refresh_ms = []
    refresh = policy.refresh

    def timed_refresh(now=None):
        t0 = time.perf_counter()
        out = refresh(now)
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    policy.refresh = timed_refresh
    for run in (1, 2):
        if run == 2:     # let the policy's heat cache (refresh_s) expire
            time.sleep(max(0.0, policy.refresh_s - (time.time()
                                                    - policy._heat_ts)))
        before, n_refresh = K.LAUNCHES["heat_scan"], len(refresh_ms)
        eng = engine()
        t0 = time.perf_counter()
        res = eng.run(queries(eng, col)["a_mean"])
        wall = time.perf_counter() - t0
        if not equal(res.value, want):
            fail(f"query a_mean with percipience (run {run}) differs from "
                 f"the result without it")
        log(f"[percip] query a_mean run {run} after enable_percipience(): "
            f"wall {wall:.3f} s, heat refresh "
            f"{sum(refresh_ms[n_refresh:]):.3f} ms in "
            f"{len(refresh_ms) - n_refresh} call(s), heat_scan launches "
            f"{K.LAUNCHES['heat_scan'] - before}, tracked objects "
            f"{len(policy._heat)}, placement "
            f"{sorted(set(res.stats.decisions.values()))}; equal to the "
            f"result without percipience")
    prefetcher.drain()
    prefetcher.shutdown()
    log(f"[percip] prefetcher on the query path: "
        f"{json.dumps(prefetcher.stats())}")
    if K.LAUNCHES["heat_scan"] <= 0:
        fail("heat_scan was not launched on the percipient query path")


def phase_main_path(torch, K, col, Clovis, dev):
    root = ROOT / ".chip_smoke"
    shutil.rmtree(root, ignore_errors=True)
    try:
        cl = build_store(torch, Clovis, root, dev)
        engines = []

        def engine(**kw):
            eng = cl.analytics(partial_cache_size=0, **kw)
            engines.append(eng)
            return eng

        results, per_query = {}, {}
        K.reset_launch_counts()                 # main path starts here
        for name in QUERIES:
            before = dict(K.LAUNCHES)
            eng = engine()
            t0 = time.perf_counter()
            res = eng.run(queries(eng, col)[name])
            wall = time.perf_counter() - t0
            results[name] = res
            per_query[name] = {k: K.LAUNCHES[k] - before[k]
                               for k in BATCH_KERNELS}
            log(f"[main] {name}: wall {wall:.3f} s (plan "
                f"{res.stats.plan_s:.3f} exec {res.stats.exec_s:.3f} "
                f"merge {res.stats.merge_s:.3f}) launches "
                f"{per_query[name]} placement {sorted(set(res.stats.decisions.values()))}")
        launches = dict(K.LAUNCHES)             # ...and ends here
        log(f"[main] launches over queries (a)-(d): {launches}")
        for k in BATCH_KERNELS:
            if launches[k] <= 0:
                fail(f"kernel {k} was not launched on the main path")

        for name in results:
            ref_eng = engine(use_kernels=False)
            t0 = time.perf_counter()
            ref = ref_eng.run(queries(ref_eng, col)[name])
            log(f"[ref] {name}: numpy reference wall "
                f"{time.perf_counter() - t0:.3f} s")
            if not equal(results[name].value, ref.value):
                fail(f"{name}: kernel path differs from the reference")
            check_shape(name, results[name].value)
        log("[main] queries (a)-(d) equal the use_kernels=False reference")

        # kernel-only and host->device time of query (a), from CUDA
        # events around each wrapper call and copy; one worker, so no
        # other thread's work lands between a pair of events
        one = engine(max_workers=1)
        t0 = time.perf_counter()
        ms = event_times(torch, K,
                         lambda: one.run(queries(one, col)["a_mean"]))
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(ms.values())
        log(f"[events] query a_mean, 1 worker: wall {wall_ms:.3f} ms; "
            f"kernels {json.dumps({k: round(v, 4) for k, v in ms.items()})}"
            f" ms in total; host->device {ms['to_device'] / PARTS:.4f} ms "
            f"per partition; device busy {busy / wall_ms:.4f} of the wall "
            f"time (kernels {(busy - ms['to_device']) / wall_ms:.6f})")
        # host time of one partition's layers (query a's fragment)
        from repro_torch.analytics.plan import apply_ops
        t0 = time.perf_counter()
        arr = cl.materialize("capture/00")
        t1 = time.perf_counter()
        apply_ops(queries(one, col)["a_mean"].ops, arr, one.kcfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log(f"[layers] one partition, host clock: store read "
            f"(materialize {arr.nbytes} B) {(t1 - t0) * 1e3:.2f} ms; "
            f"query a fragment (numpy prep + copies + kernel) "
            f"{(t2 - t1) * 1e3:.2f} ms")
        percip_query(torch, K, col, cl, engine, results["a_mean"].value)
        for eng in engines:
            eng.close()
        return launches, per_query
    finally:
        remove_store(root)


def remove_store(root: Path):
    """Remove a store root and its T1 dirs, named as core/tiers.py names
    them (Clovis keeps its tiers under root / "tiers"); no one else's."""
    tiers = str((root / "tiers").resolve())
    shutil.rmtree(root, ignore_errors=True)
    tag = hashlib.sha1(tiers.encode()).hexdigest()[:12]
    for p in Path("/dev/shm").glob(f"sage_{tag}_*"):
        shutil.rmtree(p, ignore_errors=True)


def percip_traces():
    """benchmarks/bench_percipience.py's traces over PERCIP_OBJS objects:
    sequential, strided (x7) and zipfian (p ~ 1/k^1.2, numpy seed 0)."""
    import numpy as np
    rng = np.random.default_rng(0)
    p = 1.0 / np.arange(1, PERCIP_OBJS + 1, dtype=np.float64) ** 1.2
    p /= p.sum()
    n = PERCIP_READS
    return {"sequential": [i % PERCIP_OBJS for i in range(n)],
            "strided": [(i * 7) % PERCIP_OBJS for i in range(n)],
            "zipfian": [int(v) for v in rng.choice(PERCIP_OBJS, size=n,
                                                   p=p)]}


def phase_percip_store(torch, H, K, dev):
    """[percip] the store path: each trace replayed on a fresh store of
    1,024 objects of 64 KiB on T3, predictive (percipience, its policy
    scoring an HsmDaemon scan every 16 reads) and reactive (the default
    CountingScorer).  After each predictive replay the policy's heat at
    a fixed ``now`` must equal the numpy closed form, and the kernel
    route the plain route."""
    import numpy as np
    from repro_torch.core import Addb, Clovis, HsmDaemon, Layout
    from repro_torch.core import layouts as lay
    from repro_torch.core.tiers import T1_NVRAM, T2_FLASH, T3_DISK
    base = ROOT / ".chip_smoke" / "percip"
    out = {}
    for trace_name, trace in percip_traces().items():
        out[trace_name] = {}
        for mode in ("reactive", "predictive"):
            root = base / f"{trace_name}_{mode}"
            remove_store(root)
            try:
                cl = Clovis(root, addb=Addb(), device=dev)
                payload = bytes(PERCIP_BYTES)
                for i in range(PERCIP_OBJS):
                    cl.create(f"bench/{i}", block_size=4096,
                              layout=Layout(lay.STRIPED, T3_DISK, 2))
                    cl.put(f"bench/{i}", payload)
                prefetcher = policy = None
                if mode == "predictive":
                    ex, prefetcher, policy = cl.enable_percipience(
                        sync=True, half_life_s=60.0, byte_budget=16 << 20,
                        top_k=3, min_confidence=0.05)
                    daemon = HsmDaemon(cl.store, scorer=policy)
                else:
                    daemon = HsmDaemon(cl.store)
                before = K.LAUNCHES["heat_scan"]
                hits = 0
                t0 = time.perf_counter()
                for step, obj in enumerate(trace):
                    oid = f"bench/{obj}"
                    if cl.store.meta(oid).layout.tier in (T1_NVRAM,
                                                          T2_FLASH):
                        hits += 1
                    cl.get(oid)
                    if (step + 1) % SCAN_EVERY == 0:
                        daemon.scan_once()
                wall = time.perf_counter() - t0
                r = {"hit_rate": hits / len(trace), "replay_s": wall,
                     "heat_scan_launches":
                         K.LAUNCHES["heat_scan"] - before}
                if policy is not None:
                    now = time.time()
                    oids, ts, _, mask = ex.history_tensors()
                    heat = policy.refresh(now)
                    got = np.array([heat[o] for o in oids])
                    ref = H.heat_scores_ref(ts, mask, now, 60.0)
                    plain = H.heat_scores(ts, mask, now, 60.0, device="cpu")
                    if not np.allclose(got, ref, rtol=1e-5, atol=1e-12):
                        fail(f"[percip] {trace_name}: policy heat differs "
                             f"from the closed form")
                    if not np.allclose(got, plain, rtol=1e-6, atol=0.0):
                        fail(f"[percip] {trace_name}: kernel route differs "
                             f"from the plain route")
                    r.update(tracked=len(oids), heat_max_rel_err=float(
                        np.max(np.abs(got - ref) / np.maximum(ref, 1e-300))),
                        kernel_vs_plain_max_abs=float(
                            np.max(np.abs(got - plain))),
                        prefetch=prefetcher.stats())
                    prefetcher.shutdown()
                out[trace_name][mode] = r
                log(f"[percip] {trace_name} {mode}: {json.dumps(r)}")
            finally:
                remove_store(root)
    log(f"[percip] fast-tier hit rate predictive vs reactive: " + ", ".join(
        f"{t} {v['predictive']['hit_rate']:.4f} vs "
        f"{v['reactive']['hit_rate']:.4f}" for t, v in out.items()))
    return out


class WindowRows:
    """A drained-tap stand-in holding one window's rows: the batch
    engine's ``from_stream`` reads ``partitions()``."""

    def __init__(self, rows):
        self.rows = rows

    def partitions(self):
        return {"instrument": self.rows}


def phase_stream(torch, K, col, dev):
    """[stream] a continuous query over 16,777,216 rows (4 int32 columns,
    the analytics-tour table) pushed as 4,096 elements of 4,096 rows by
    4 producers, element i at event time i ms, 0.256 s tumbling windows.
    Every final window must equal the use_kernels=False batch engine
    over the same rows; nothing may arrive late."""
    import threading

    import numpy as np
    from repro_torch.analytics import EventWindow
    from repro_torch.core import Addb, Clovis, StreamContext
    n = STREAM_ELEMS * STREAM_ROWS
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tbl = torch.empty((n, 4), dtype=torch.int32, device=dev)
    for c, (lo, hi) in enumerate(((0, KEYS), (0, 100), (-500, 500))):
        tbl[:, c] = torch.randint(lo, hi, (n,), generator=gen, device=dev,
                                  dtype=torch.int32)
    tbl[:, 3] = torch.arange(n, device=dev, dtype=torch.int32) // (
        n // STREAM_PRODUCERS)
    rows = tbl.cpu().numpy()
    del tbl
    window = EventWindow(size_s=STREAM_WINDOW_S)
    root = ROOT / ".chip_smoke" / "stream"
    remove_store(root)
    try:
        cl = Clovis(root, addb=Addb(), device=dev)
        eng = cl.analytics()
        ref_eng = cl.analytics(use_kernels=False)
        ctx = StreamContext(n_producers=STREAM_PRODUCERS)

        def chain(e, src):
            return e.from_stream(src).filter(col(1) >= 75).key_by(
                col(0)).aggregate("sum", value=col(2))

        def produce(p):
            for i in range(p, STREAM_ELEMS, STREAM_PRODUCERS):
                ctx.push(p, "instrument",
                         rows[i * STREAM_ROWS:(i + 1) * STREAM_ROWS],
                         event_ts=i * 1e-3)
        K.reset_launch_counts()                 # [stream] starts here
        t0 = time.perf_counter()
        cq = eng.run_continuous(chain(eng, ctx), window,
                                delta_rows=STREAM_DELTA)
        threads = [threading.Thread(target=produce, args=(p,))
                   for p in range(STREAM_PRODUCERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = cq.close(drain_deadline_s=600.0)
        wall = time.perf_counter() - t0
        launches = {k: K.LAUNCHES[k] for k in BATCH_KERNELS}  # ends here
        ctx.close()
        stats = cq.stats
        final = [r for r in results if r.final]
        if stats["elements"] != STREAM_ELEMS or cq.late_count:
            fail(f"[stream] {stats['elements']} elements consumed, "
                 f"{cq.late_count} late")
        if launches["segment_reduce"] <= 0:
            fail("[stream] segment_reduce was not launched")
        # the same rows, window by window, through the batch engine
        members = {}
        for i in range(STREAM_ELEMS):
            for k in window.keys_for(i * 1e-3):
                members.setdefault(k, []).append(i)
        if len(final) != len(members) or len(results) != len(members):
            fail(f"[stream] {len(final)} final windows of {len(results)}, "
                 f"expected {len(members)}")
        for r in final:
            k = round(r.start / window.stride)
            idx = members[k]
            wrows = np.concatenate([rows[i * STREAM_ROWS:
                                         (i + 1) * STREAM_ROWS]
                                    for i in idx])
            ref = ref_eng.run(chain(ref_eng, WindowRows(wrows))).value
            if not equal(r.value, ref):
                fail(f"[stream] window [{r.start}, {r.end}) differs from "
                     f"the use_kernels=False batch engine")
            if r.rows != int((wrows[:, 1] >= 75).sum()):
                fail(f"[stream] window [{r.start}, {r.end}) counted "
                     f"{r.rows} rows")
        lat = sorted(r.emit_latency_s for r in final)
        log(f"[stream] {n} rows ({rows.nbytes} B) in {STREAM_ELEMS} "
            f"elements from {STREAM_PRODUCERS} producers: {len(final)} "
            f"final windows in {wall:.3f} s = {n / wall:.1f} rows/s; "
            f"emit latency median {lat[len(lat) // 2]:.6f} s, largest "
            f"{lat[-1]:.6f} s; launches {json.dumps(launches)}; late 0; "
            f"peak buffered rows {stats['peak_buffered_rows']}; every "
            f"window equals the use_kernels=False batch engine (int32)")
        eng.close()
        ref_eng.close()
        return launches
    finally:
        remove_store(root)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _ext
    from repro_torch.analytics import kernels as K
    from repro_torch.analytics.exprs import col
    from repro_torch.core import Clovis
    from repro_torch.percipience import heat as H
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    smi = phase_card_and_build(torch, _ext)
    chk = phase_kernels(torch, K, col, dev)
    phase_heat(torch, H, chk, dev)
    timing = phase_timing(torch, K, H, col, dev)
    phase_heat_split(torch, H, dev)
    launches, per_query = phase_main_path(torch, K, col, Clovis, dev)
    phase_percip_store(torch, H, K, dev)
    # [percip] ends here: heat_scan launches of both percipience phases
    launches["heat_scan"] = K.LAUNCHES["heat_scan"]
    log(f"[percip] heat_scan launches over the [percip] phases: "
        f"{launches['heat_scan']}")
    if launches["heat_scan"] <= 0:
        fail("heat_scan was not launched on the percipience path")
    stream = phase_stream(torch, K, col, dev)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": chk.err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
        })
    log(f"[main] launches per query: {json.dumps(per_query)}")
    log(f"[stream] launches: {json.dumps(stream)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)                          # nvidia-smi's "name, power.limit"
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

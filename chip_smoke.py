#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero, and no phase's failure is caught:

1. Card and build: the card's name and power limit (nvidia-smi), the
   torch and CUDA versions, and the nvcc build of ``csrc/analytics_kernels.cu``.
2. Each CUDA kernel against its plain PyTorch version on the card over
   edge shapes, ops, dtypes and expression specs; int results must be
   equal, f32 min/max equal, f32 sums within ``F32_SUM_RTOL`` of the
   segment's sum of |v| (atomics add in another order).  Each kernel is
   also timed at the shape the main path gives it, beside its bound,
   its plain version and, where one exists, one PyTorch library call.
3. The main path at full size: a store of 16 partitions x 4,194,304
   rows x 4 int32 columns (1 GiB, made from torch.Generator seed 0) and
   queries (a)-(d) through ``Clovis.analytics()``; each result must
   equal the ``use_kernels=False`` (numpy reference) engine's exactly,
   and every kernel must have launched.
4. One JSON line of per-kernel numbers, then the contract's last line.

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
SOURCE = "src/repro_torch/csrc/analytics_kernels.cu"
KERNELS = {   # name -> TPU kernel it replaces (reference file:line)
    "fused_filter_aggregate": "src/repro/analytics/kernels.py:447",
    "segment_reduce": "src/repro/analytics/kernels.py:131",
    "window_reduce": "src/repro/analytics/kernels.py:288",
}


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


def phase_timing(torch, K, col, dev):
    """Each kernel at the shape the main path gives it (one partition):
    B1 as query (a)'s fused pass, B2 as query (c)'s histogram count, B3
    as query (d)'s window max."""
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
    for name, r in out.items():
        r["bound_ms"] = r["bound_bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"[timing] {name} ({r['shape']}): {r['ms']:.4f} ms/launch, "
            f"plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_bytes']} B at "
            f"{HBM_BYTES_PER_S:.3g} B/s)")
    return out


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
                               for k in KERNELS}
            log(f"[main] {name}: wall {wall:.3f} s (plan "
                f"{res.stats.plan_s:.3f} exec {res.stats.exec_s:.3f} "
                f"merge {res.stats.merge_s:.3f}) launches "
                f"{per_query[name]} placement {sorted(set(res.stats.decisions.values()))}")
        launches = dict(K.LAUNCHES)             # ...and ends here
        log(f"[main] launches over queries (a)-(d): {launches}")
        for k, n in launches.items():
            if n <= 0:
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
        for eng in engines:
            eng.close()
        return launches, per_query
    finally:
        shutil.rmtree(root, ignore_errors=True)
        # this store's T1 dirs only, named as core/tiers.py names them
        # (Clovis keeps its tiers under root / "tiers")
        tiers = str((root / "tiers").resolve())
        tag = hashlib.sha1(tiers.encode()).hexdigest()[:12]
        for p in Path("/dev/shm").glob(f"sage_{tag}_*"):
            shutil.rmtree(p, ignore_errors=True)


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
    dev = torch.device("cuda", 0)

    smi = phase_card_and_build(torch, _ext)
    chk = phase_kernels(torch, K, col, dev)
    timing = phase_timing(torch, K, col, dev)
    launches, per_query = phase_main_path(torch, K, col, Clovis, dev)

    rows = []
    for name, replaces in KERNELS.items():
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": chk.err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
        })
    log(f"[main] launches per query: {json.dumps(per_query)}")
    log(smi)                          # nvidia-smi's "name, power.limit"
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

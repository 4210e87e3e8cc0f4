"""B1 and B2's order of work on the card, emulated on the CPU and held
against the reference.

``csrc/analytics_kernels.cu`` cuts the rows into one contiguous run a
block, walks each run in tiles of ``kRows`` rows a thread (a thread's rows
in groups of 4), folds each row into a table in shared memory (for an f32
sum up to ``kLaneSegments`` segments a table a thread; else, with
atomics, a table a warp up to ``kLaneSegments`` and one for the block up
to ``kSmemSegments``), flushes each block's tables into a partial (a
thread table's entries in a fixed order), and folds the blocks' partials
in block order in a second launch.  This file does the same, step by
step, with the kernel's constants read from the source, in float32 /
wrapping int32 arithmetic (an atomic table's rows fold in
tile order here; on the card in the order its warps arrive), and holds the
result against ``repro.analytics.kernels`` (the Pallas kernel with
``interpret=True``) and the numpy ``*_ref`` oracles: integer results and
f32 min/max equal (NaN where the reference has NaN), f32 sums within
``1e-5`` of the segment's sum of |v| (another order of the same sum; the
card's tests allow 1e-4 of it).  B1's values come from float arithmetic
that the oracles take in float64 and XLA may contract, so there its f32
min/max are held within ``rtol=1e-5`` of the oracles, as in
``test_torch_kernels.py``, and equal to the port's plain version, whose
arithmetic is the kernel's.  The grid and block sizes are shrunk (they
are parameters of the same plan) so that small inputs cross every block,
tile and table boundary.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analytics import kernels as JK
from repro.analytics.exprs import col as jcol
from repro_torch.analytics import kernels as K

CU = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
      / "analytics_kernels.cu").read_text()
SUM_RTOL = 1e-5      # f32 sums, of the segment's sum of |v|


def _const(name):
    m = re.search(rf"constexpr \w+ {name} = ([^;]+);", CU)
    return int(eval(m.group(1), {}))


ROWS = _const("kRows")
LANE_SEGMENTS = _const("kLaneSegments")
SMEM_SEGMENTS = _const("kSmemSegments")
SMEM_BUDGET = _const("kSmemBudget")
COMBINE_PARTS = _const("kCombineParts")
MAX_WARPS = _const("kMaxWarps")
MIN_BLOCK_ROWS = _const("kMinBlockRows")


def _identity(op, dt):
    """The kernel's start(): the reference's identities (int32 max
    starts from -INT32_MAX)."""
    if op in ("sum", "count"):
        return dt.type(0)
    if dt == np.int32:
        return np.int32(2**31 - 1 if op == "min" else -(2**31 - 1))
    return np.float32(np.inf if op == "min" else -np.inf)


def _combine(op, dt, a, b):
    if op in ("sum", "count"):
        if dt == np.int32:
            return np.int32((int(a) + int(b) + 2**31) % 2**32 - 2**31)
        return np.float32(np.float32(a) + np.float32(b))
    if dt == np.float32 and (np.isnan(a) or np.isnan(b)):
        return np.float32(np.nan)
    return min(a, b) if op == "min" else max(a, b)


def plan(n, n_seg, cnt, levels, *, f32_sum=True, sms,
         max_warps=MAX_WARPS, min_block_rows=MIN_BLOCK_ROWS,
         smem_segments=SMEM_SEGMENTS):
    """The kernel's plan_for: (mode, threads, blocks, chunk); a block
    table on the small path is one table a warp."""
    stack = levels * ROWS * 32 * 4
    words = 2 if cnt else 1
    fixed = 0
    if n_seg <= LANE_SEGMENTS and f32_sum:
        mode, per_warp = "lane", 32 * n_seg * 4 * words + stack
    elif n_seg <= LANE_SEGMENTS:
        mode, per_warp = "block", n_seg * 4 * words + stack
    elif n_seg <= smem_segments:
        mode, per_warp = "block", stack
        fixed = n_seg * 4 * words
    else:
        mode, per_warp = "global", stack
    warps = max_warps
    if per_warp:
        warps = min(warps, (SMEM_BUDGET - fixed) // per_warp)
    want = max(1, -(-n // min_block_rows))
    blocks = min(want, 4 * sms if mode == "global" else sms)
    per = -(-n // blocks)                  # rows a block, rounded up
    chunk = max(4, -(-per // 4) * 4)       # to whole 16-byte groups
    return mode, 32 * warps, blocks, chunk


def _xor_tree(op, dt, xs):
    """warp_fold over 32 lanes: lane l folds lane l ^ o, o = 16 .. 1."""
    for o in (16, 8, 4, 2, 1):
        xs = [_combine(op, dt, xs[l], xs[l ^ o]) for l in range(32)]
    return xs[0]


def emulate(v, keep, ids, n_seg, op, dt, *, levels=0, **grid):
    """Run the kernel's order of work: v (n,) values, keep (n,) bool
    (the predicate; ids outside [0, n_seg) are dropped here as there).
    Returns (acc, cnt, mode)."""
    n = len(ids)
    f32_sum = op == "sum" and dt == np.float32
    mode, nt, G, chunk = plan(n, n_seg, True, levels, f32_sum=f32_sum,
                              **grid)
    ident = _identity(op, dt)
    keep = keep & (ids >= 0) & (ids < n_seg)
    if op == "count":                    # the kernel folds ones
        v = np.ones(n, dt)
    if mode == "global":                 # atomics: no order to emulate
        acc = np.full(n_seg, ident, dt)
        cnt = np.zeros(n_seg, np.int32)
        for row in np.flatnonzero(keep):
            acc[ids[row]] = _combine(op, dt, acc[ids[row]], v[row])
            cnt[ids[row]] += 1
        return acc, cnt, mode
    parts = []
    for b in range(G):
        r0, r1 = b * chunk, min(n, (b + 1) * chunk)
        # a table a thread, or one (the block's, or a warp's: the order of
        # an atomic fold does not change ints, keys or counts)
        width = nt if mode == "lane" else 1
        tab = [[ident] * width for _ in range(n_seg)]
        ctab = [[0] * width for _ in range(n_seg)]
        for t0 in range(r0, r1, ROWS * nt):
            for r in range(ROWS):           # a thread's rows, in order
                k, j = divmod(r, 4)
                for tid in range(nt):
                    row = t0 + 4 * (tid + k * nt) + j
                    if row < r1 and keep[row]:
                        s, t = ids[row], tid % width
                        tab[s][t] = _combine(op, dt, tab[s][t], v[row])
                        ctab[s][t] += 1
        acc = np.empty(n_seg, dt)
        cnt = np.zeros(n_seg, np.int32)
        for s in range(n_seg):
            if mode == "block":
                acc[s], cnt[s] = tab[s][0], ctab[s][0]
                continue
            # a warp a segment: lane l folds threads l, l + 32, ... in
            # order, then the xor tree across the lanes
            xs, cs = [], []
            for lane in range(32):
                x, c = tab[s][lane], ctab[s][lane]
                for i in range(lane + 32, nt, 32):
                    x = _combine(op, dt, x, tab[s][i])
                    c += ctab[s][i]
                xs.append(x)
                cs.append(c)
            acc[s], cnt[s] = _xor_tree(op, dt, xs), sum(cs)
        parts.append((acc, cnt))
    # second launch: runs of ceil(G / parts) blocks, then the runs, in order
    per = -(-G // COMBINE_PARTS)
    acc = np.empty(n_seg, dt)
    cnt = np.zeros(n_seg, np.int32)
    for s in range(n_seg):
        runs = []
        for q in range(COMBINE_PARTS):
            x, c = ident, 0
            for g in range(q * per, min(G, (q + 1) * per)):
                x = _combine(op, dt, x, parts[g][0][s])
                c += parts[g][1][s]
            runs.append((x, c))
        x, c = runs[0]
        for xq, cq in runs[1:]:
            x, c = _combine(op, dt, x, xq), c + cq
        acc[s], cnt[s] = x, c
    return acc, cnt, mode


def _abs_sum(v, keep, ids, n_seg):
    """Each segment's sum of |v| over the rows it keeps (NaN as 0)."""
    out = np.zeros(n_seg, np.float64)
    k = keep & (ids >= 0) & (ids < n_seg)
    np.add.at(out, ids[k], np.nan_to_num(np.abs(v[k].astype(np.float64))))
    return out


def _same(got, want, what, abs_sum=None, rtol=0.0):
    """Equal (f32 within ``rtol``, NaN where ``want`` has NaN), or for f32
    sums (abs_sum given) within SUM_RTOL of the segment's sum of |v|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    if abs_sum is None:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   equal_nan=True, err_msg=what)
        return
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want), err_msg=what)
    err = np.abs(got[~nan] - want[~nan])
    assert (err <= SUM_RTOL * abs_sum[~nan] + 1e-6).all(), (what, err.max())


def _values(rng, n, dt, nan=False):
    if dt == np.int32:
        return rng.integers(-500, 500, n).astype(np.int32)
    v = rng.standard_normal(n).astype(np.float32)
    if nan:
        v[rng.random(n) < 0.01] = np.nan
    return v


# (n, n_seg, grid): every mode, several blocks and tiles a block, empty
# blocks (n = 10 over 8 blocks of 4 rows), a block run that is not a
# multiple of a tile, and the global-atomic path at a lowered threshold
GRIDS = {
    "small-1": (1023, 1, dict(sms=5, max_warps=2, min_block_rows=64)),
    "small-32": (2051, LANE_SEGMENTS, dict(sms=7, max_warps=1,
                                          min_block_rows=100)),
    "block-33": (2051, LANE_SEGMENTS + 1, dict(sms=3, max_warps=2,
                                               min_block_rows=300)),
    "block-130": (4001, 130, dict(sms=9, max_warps=3, min_block_rows=64)),
    "empty-blocks": (10, 3, dict(sms=8, max_warps=1, min_block_rows=1)),
    "one-block": (700, 40, dict(sms=132)),
    "global": (1500, 70, dict(sms=4, max_warps=1, min_block_rows=256,
                              smem_segments=64)),
}


@pytest.mark.parametrize("case", list(GRIDS))
@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("dt", [np.int32, np.float32])
def test_segment_blocks_match_reference(case, op, dt):
    """B2: ids in [-1, n_seg + 3) (below 0 and at or past n_seg dropped),
    f32 values with NaNs."""
    n, n_seg, grid = GRIDS[case]
    rng = np.random.default_rng(n + n_seg)
    v = _values(rng, n, np.dtype(dt), nan=True)
    ids = rng.integers(-1, n_seg + 3, n).astype(np.int32)
    acc, _, mode = emulate(v, np.ones(n, bool), ids, n_seg, op,
                           np.dtype(dt), **grid)
    want_mode = {"small": "lane" if op == "sum" and dt == np.float32
                  else "block", "block": "block", "global": "global"}
    assert case in ("empty-blocks", "one-block") or \
        mode == want_mode[case.split("-")[0]]
    tol = _abs_sum(v, np.ones(n, bool), ids, n_seg) if op == "sum" else None
    _same(acc, JK.segment_reduce(v, ids, n_seg, op=op, interpret=True),
          "pallas", tol)
    inside = np.where(ids < n_seg, ids, -1)
    _same(acc, K.segment_reduce_ref(v, inside, n_seg, op=op), "ref", tol)


def test_segment_blocks_int32_sum_wraps():
    n = 3000
    v = np.full(n, 2**30 + 7, np.int32)
    ids = (np.arange(n) % 3).astype(np.int32)
    for case in ("small-32", "block-33"):
        acc, _, _ = emulate(v, np.ones(n, bool), ids, 3 if case == "small-32"
                            else 40, "sum", np.dtype(np.int32),
                            **GRIDS[case][2])
        want = JK.segment_reduce(v, ids, 3, op="sum", interpret=True)
        np.testing.assert_array_equal(acc[:3], want)


def test_segment_blocks_every_row_in_one_segment():
    """Worst contention: every lane of every warp folds into segment 0."""
    n = 2500
    v = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    ids = np.zeros(n, np.int32)
    for n_seg, grid in ((1, GRIDS["small-1"][2]), (50, GRIDS["block-130"][2])):
        for op in ("sum", "max"):
            acc, cnt, _ = emulate(v, np.ones(n, bool), ids, n_seg, op,
                                  np.dtype(np.float32), **grid)
            tol = _abs_sum(v, np.ones(n, bool), ids, n_seg) \
                if op == "sum" else None
            _same(acc, JK.segment_reduce(v, ids, n_seg, op=op,
                                         interpret=True), f"{n_seg} {op}",
                  tol)
            assert int(cnt[0]) == n and not cnt[1:].any()


def _fused_inputs(rng, n):
    return {0: rng.integers(0, 5, n).astype(np.int32),
            1: rng.integers(0, 100, n).astype(np.int32),
            2: rng.integers(-500, 500, n).astype(np.int32),
            3: (rng.standard_normal(n) * 2).astype(np.float32)}


SPECS = [("ge-int", jcol(1) >= 75, jcol(2)),
         ("or-spill", ((jcol(2) % 7) == 3) | ~(jcol(1) < 50),
          jcol(3) * 0.5 + jcol(2) / 7),                  # a spilled level
         ("none", None, jcol(3) % -1.5)]


@pytest.mark.parametrize("case", ["small-32", "block-130", "empty-blocks",
                                  "global"])
@pytest.mark.parametrize("spec", range(len(SPECS)))
@pytest.mark.parametrize("op", ["sum", "count", "min", "max"])
def test_fused_blocks_match_reference(case, spec, op):
    """B1: the program runs as the plain interpreter runs it (same
    encoding), the survivors fold in the kernel's order."""
    n, n_seg, grid = GRIDS[case]
    rng = np.random.default_rng(7 * n + spec)
    name, pred, value = SPECS[spec]
    cols = _fused_inputs(rng, n)
    ids = rng.integers(-1, n_seg, n).astype(np.int32)
    ps = None if pred is None else pred.to_spec()
    vs = None if op == "count" else value.to_spec()
    used = sorted(K.spec_columns(ps) | K.spec_columns(vs) | {1})
    cols = {i: cols[i] for i in used}
    coldt = {i: c.dtype for i, c in cols.items()}
    dt = K.fused_out_dtype(vs, coldt)
    prog = K.fused_program(cols, ps, vs, dt)
    levels = 1 + max([a for c, a in prog.code
                      if c & 0xff == K._OPCODES["push"]], default=-1)
    ts = [torch.from_numpy(K._kernel_column(cols[i])) for i in used]
    keep = np.ones(n, bool)
    if prog.n_pred:
        keep = K._run_program_plain(prog.code[:prog.n_pred], prog,
                                    ts).numpy() != 0
    if op != "count" and len(prog.code) > prog.n_pred:
        v = np.broadcast_to(K._run_program_plain(
            prog.code[prog.n_pred:], prog, ts).numpy(), (n,)).astype(dt)
    else:
        v = np.ones(n, dt)
    acc, cnt, _ = emulate(v, keep, ids, n_seg, op, np.dtype(dt),
                          levels=levels, **grid)
    want = JK.fused_filter_aggregate(cols, ps, vs, ids, n_seg, op=op,
                                     interpret=True)
    tol = _abs_sum(v, keep, ids, n_seg) if op == "sum" else None
    _same(acc, want[0], f"{name} pallas acc", tol, rtol=1e-5)
    _same(cnt, want[1], f"{name} pallas cnt")
    ra, rc = K.fused_filter_aggregate_ref(cols, ps, vs, ids, n_seg, op=op)
    _same(acc, ra, f"{name} ref acc", tol, rtol=1e-5)
    pa, pc = K.fused_filter_aggregate(cols, ps, vs, ids, n_seg, op=op,
                                      device="cpu")
    _same(acc, pa, f"{name} plain acc", tol)
    _same(cnt, pc, f"{name} plain cnt")
    _same(cnt, rc, f"{name} ref cnt")


def test_plan_fits_shared_memory_at_every_table_size():
    """Every plan on the shared-memory paths fits kSmemBudget with at
    least one warp, at each table size and stack depth the compiler
    allows; query (a) (B1, 4,096 segments) runs 32 warps on one block a
    multiprocessor, query (c) (B2's 32-bin count) 32 warps with a table
    each, an f32 sum over 32 segments (B1) 28 warps of thread tables."""
    for n_seg in (1, LANE_SEGMENTS, LANE_SEGMENTS + 1, 4096, SMEM_SEGMENTS):
        for levels in (0, K.MAX_STACK - 1):
            for cnt in (False, True):
                for f32_sum in (False, True):
                    mode, nt, _, _ = plan(1 << 22, n_seg, cnt, levels,
                                          f32_sum=f32_sum, sms=132)
                    assert nt >= 32 and mode != "global"
    assert plan(1 << 22, 4096, True, 0, sms=132) == ("block", 1024, 132,
                                                     31776)
    assert plan(1 << 22, 32, False, 0, f32_sum=False,
                sms=132)[:3] == ("block", 1024, 132)
    assert plan(1 << 22, 32, True, 0, sms=132)[:2] == ("lane", 896)
    assert plan(100, 4096, True, 0, sms=132)[2] == 1

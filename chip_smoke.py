#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero, and no phase's failure is caught:

1. Card and build: the card's name and power limit (nvidia-smi), the
   torch and CUDA versions, the one nvcc build of every
   ``src/repro_torch/csrc/*.cu`` with its ptxas lines (B5 and B7 must
   not spill; B1 and B2 must keep no stack frame), and the count of
   tensor-core instructions in the SASS of the flash-attention and SSD
   kernels (cuobjdump).
2. Each CUDA kernel against its plain PyTorch version on the card over
   edge shapes, ops, dtypes and expression specs; int results must be
   equal, f32 min/max equal (NaN where plain has NaN), f32 sums within
   ``F32_SUM_RTOL`` of the segment's sum of |v| (they add in another
   order), the heat scan equal bit for bit (``[heat]``); B1 and B2 also
   at their design's thresholds (``AGG_CASES``), and their f32 sums must
   repeat bit for bit at 1 and 32 segments (a table a thread).  Each kernel is also timed on the
   device (CUDA events, the card kept busy while the host enqueues) at
   the shape its path gives it, beside its bound, its plain version and,
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
5. ``[cluster]``: a ``repro_torch.cluster.ClusterClovis`` of 4 nodes and
   2 replicas holding the same 1 GiB table; queries (a)-(d) through
   ``analytics()`` must be byte-identical to [main]'s, and stay so when
   the node that is primary for the most partitions is killed after
   the second shipped fragment of (a) (a reroute in the ADDB route
   trace, the node evicted, every partition on 2 live nodes).
   ``[serving]``: a fresh such cluster behind ``serving()``; tenants ops
   and science (priority 2) submit (a), (b) count and (c) at once, each
   twice; every response equal to [main]'s, dedup + cache hits above 0,
   each request's ADDB serving trace complete.  ``[compaction]``: 256
   deltas of 4,096 rows (64 KiB) appended through ``compaction()`` with
   the default policy, query (a) through the front door before and
   after ``compact()``, both equal to numpy over the rows.  B1, B2 and
   B3 must launch in these phases.
6. ``[model-kernels]`` (before the timing): B5 flash attention and B7
   the RG-LRU scan against their plain versions at the serving shapes
   and at edge shapes; B7 bit for bit, B5 within ``ATTN_RTOL`` of each
   query row's largest |o|.  ``[serve]``: recurrentgemma-9b at
   full width (9,627,414,528 f32 parameters drawn on the card from
   seed 0) serves 4 prompts of 4,000 tokens (numpy seed 0) and 32
   greedy tokens through ``repro_torch.launch.serve.Server``; its
   prefill must launch B5 12 and B7 26 times, its logits must agree
   with the ``use_kernels=False`` path on the same weights at prefill
   and at every decode step (within ``SERVE_LOGIT_RTOL`` of the step's
   largest |logit|), and the token log must read back from Clovis; two
   more decode steps run under torch.profiler (device busy share).
   ``[model-kernels]`` also holds B6, the Mamba2 SSD scan, against its
   plain version at the serving shape and at edge shapes (y and the
   final state within ``SSD_RTOL`` of each (batch, head)'s largest
   |value|) and, at one small shape, against the sequential oracle
   ``ssd_reference`` (within ``SSD_SEQ_RTOL``).  ``[serve-ssm]`` (after
   ``[serve]`` has freed its weights): mamba2-130m at full width
   (128,983,488 f32 parameters from seed 0) serves 4 prompts of 16,000
   tokens and 32 greedy tokens the same way; its prefill must launch B6
   24 times and B5/B7 never.
7. One JSON line of per-kernel numbers, then the contract's last line.

It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import hashlib
import json
import re
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
BINS = 32                      # query (c)'s histogram
# (rows, segs, every row in one segment): B1 and B2 keep a table a thread
# up to 32 segments, one a block up to 8,192, atomics above; their grid
# is a block per 16,384 rows up to one a multiprocessor (132 blocks from
# 2,146,305 rows); query (c)'s shape; all rows in one segment
AGG_CASES = ((70_000, 32, False), (70_000, 33, False),
             (100_003, 8192, False), (100_003, 8193, False),
             (16_384, 4096, False), (16_385, 4096, False),
             (2_162_689, 4096, False), (ROWS, BINS, False),
             (1 << 20, 1, True), (1 << 20, 4096, True))
OPS = ("sum", "count", "min", "max")
HEAT_SHAPES = ((1, 1), (24, 37), (7, 129), (64, 1000))   # (hist, nobj)
HEAT_HIST, HEAT_OBJS = 64, 262_144   # extractor hist_len x tracked objects
PERCIP_OBJS, PERCIP_BYTES, PERCIP_READS, SCAN_EVERY = 1024, 64 << 10, 2048, 16
STREAM_ELEMS, STREAM_ROWS, STREAM_PRODUCERS = 4096, 4096, 4
STREAM_WINDOW_S, STREAM_DELTA = 0.256, 262_144
CLUSTER_NODES, CLUSTER_REPLICAS = 4, 2
TENANTS, SERVED = ("ops", "science"), ("a_mean", "b_count", "c_histogram")
DELTAS, DELTA_ROWS = 256, 4096  # [compaction]: 64 KiB deltas, 16 MiB
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM dense TF32 tensor cores
TF32X3_FLOPS = TF32_FLOPS / 3  # B6 split-TF32 products; a reference only
ATTN_RTOL = 1e-4               # B5 vs plain, relative to the row's max |o|
SERVE_LOGIT_RTOL = 1e-3        # kernel vs plain path, of the step's max |logit|
SERVE_ARCH, SERVE_PARAMS = "recurrentgemma-9b", 9_627_414_528
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4000, 32
SSM_ARCH, SSM_PARAMS = "mamba2-130m", 128_983_488
SSM_BATCH, SSM_PROMPT, SSM_GEN = 4, 16000, 32   # 16,000 = 62.5 chunks
SSD_RTOL = 1e-4                # B6 vs plain, of the (batch, head)'s max |value|
SSD_SEQ_RTOL = 1e-3            # B6 vs the sequential oracle (step-by-step
                               # decays against exponentiated cumsums)
PROFILE_STEPS = 2              # decode steps traced after the comparison
HOST_COVER_CYCLES = 2_000_000  # ~1 ms of card spin ahead of each timed call
# (b, h, kv, sq, sk, hd, causal, window, softcap); the first is the
# serving shape of recurrentgemma-9b's local-attention layers
ATTN_CASES = ((4, 16, 1, 4000, 4000, 256, True, 2048, 0.0),
              (1, 4, 4, 333, 333, 64, True, 0, 0.0),        # MHA
              (2, 8, 2, 517, 517, 128, True, 100, 30.0),    # GQA
              (1, 8, 1, 129, 129, 256, False, 0, 0.0),      # MQA
              (2, 4, 2, 200, 200, 128, False, 50, 30.0),
              (1, 4, 1, 45, 300, 64, False, 0, 0.0),        # sq < sk
              (3, 6, 3, 1000, 1000, 64, True, 256, 30.0),
              (1, 1, 1, 1, 1, 64, True, 0, 0.0),
              # hd 256 with sq/sk not multiples of the 16-key tile or the
              # 128-row query tile, the window's edge inside a tile
              (1, 16, 1, 1000, 1000, 256, True, 333, 30.0),
              (2, 4, 2, 77, 1001, 256, False, 0, 30.0),   # sq < sk
              (1, 8, 2, 250, 250, 256, True, 17, 0.0))    # GQA, window < tile
# (b, s, w, h0); the first two are the serving shape of the RG-LRU layers
# s not a multiple of the 32-step stage, w not a multiple of the 32-channel
# block (16-byte copies at w % 4 == 0, 4-byte ones otherwise)
SCAN_CASES = ((4, 4000, 4096, True), (4, 4000, 4096, False),
              (2, 1, 33, True), (3, 77, 100, False), (1, 4096, 31, True),
              (2, 4001, 4100, True), (1, 33, 4097, False))
# (b, s, h, p, n, g, chunk, initial state); the first two are the serving
# shape of mamba2-130m's SSD layers, the others edge cases: s = 1, s
# around the kernel's 256-row chunk (255, 256, 257, 513) with and without
# a state, s < chunk, g = 2 and g = h, p not a multiple of 16 or of 4,
# two p slices, and every state size the kernel takes
SSD_CASES = ((4, 16000, 24, 64, 128, 1, 256, True),
             (4, 16000, 24, 64, 128, 1, 256, False),
             (2, 1, 24, 64, 128, 1, 256, True),
             (2, 255, 8, 64, 128, 1, 256, True),
             (2, 257, 8, 64, 128, 1, 256, False),
             (3, 100, 6, 64, 128, 1, 256, True),
             (2, 300, 4, 64, 128, 2, 256, True),
             (3, 77, 8, 16, 16, 1, 16, True),
             (1, 130, 3, 40, 32, 3, 64, True),
             (1, 70, 2, 8, 256, 1, 32, True),
             (1, 65, 2, 64, 64, 1, 64, False),
             (2, 255, 8, 64, 128, 1, 256, False),
             (2, 256, 8, 64, 128, 1, 256, True),
             (2, 256, 8, 64, 128, 1, 256, False),
             (2, 257, 8, 64, 128, 1, 256, True),
             (2, 513, 8, 64, 128, 1, 256, True),
             (2, 513, 8, 64, 128, 1, 256, False),
             (1, 600, 4, 40, 256, 2, 256, True),
             (1, 300, 2, 6, 32, 1, 64, True))
SSD_SEQ_CASE = 6               # the SSD_CASES entry also held against the oracle
ANALYTICS_CU = "src/repro_torch/csrc/analytics_kernels.cu"
MODEL_CU = "src/repro_torch/csrc/model_kernels.cu"
SSM_CU = "src/repro_torch/csrc/ssm_kernels.cu"
KERNELS = {   # name -> (source, TPU kernel it replaces: reference file:line)
    "fused_filter_aggregate": (ANALYTICS_CU,
                               "src/repro/analytics/kernels.py:447"),
    "segment_reduce": (ANALYTICS_CU, "src/repro/analytics/kernels.py:131"),
    "window_reduce": (ANALYTICS_CU, "src/repro/analytics/kernels.py:288"),
    "heat_scan": ("src/repro_torch/csrc/percipience_kernels.cu",
                  "src/repro/percipience/heat.py:47"),
    "flash_attention": (MODEL_CU, "src/repro/kernels/flash_attention.py:36"),
    "rglru_scan": (MODEL_CU, "src/repro/kernels/rglru_scan.py:29"),
    "ssd_scan": (SSM_CU, "src/repro/kernels/ssd_scan.py:32"),
}
MODEL_KERNELS = ("flash_attention", "rglru_scan", "ssd_scan")
AGG_PTXAS = ("fused_kernel", "segment_kernel", "combine_kernel")  # B1, B2
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
    entry, spills, frames = None, [], []
    agg = {k: {"instantiations": 0, "registers": set(), "stack_frame": 0,
               "spill_bytes": 0} for k in AGG_PTXAS}
    for line in ext.build_log.splitlines():
        if any(w in line for w in ("registers", "Compiling entry", "spill")):
            log(f"[build] {line.strip()}")
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
            for k in AGG_PTXAS:
                agg[k]["instantiations"] += k in entry
            continue
        if not entry:
            continue
        name = next((k for k in AGG_PTXAS if k in entry), None)
        if "spill" in line:
            nums = [int(n) for n in re.findall(r"(\d+) bytes", line)]
            if any(k in entry for k in ("flash_attention_kernel",
                                        "rglru_scan_kernel")) \
                    and any(nums[1:]):
                spills.append(entry)
            if name:                   # "F bytes stack frame, S stores, L loads"
                agg[name]["stack_frame"] = max(agg[name]["stack_frame"],
                                               nums[0])
                agg[name]["spill_bytes"] += sum(nums[1:])
                if any(nums):
                    frames.append(entry)
        elif name and "registers" in line:
            agg[name]["registers"].update(
                int(n) for n in re.findall(r"Used (\d+) registers", line))
    if spills:
        fail(f"B5/B7 kernels spill registers: {spills}")
    for k, v in agg.items():
        v["registers"] = [min(v["registers"], default=0),
                          max(v["registers"], default=0)]
    log(f"[build] B1/B2 ptxas (min/max registers over the instantiations): "
        f"{json.dumps(agg)}")
    if frames:
        fail(f"B1/B2 kernels keep a stack frame or spill: {frames}")
    log_tensor_core_sass(ext)
    return smi


def log_tensor_core_sass(ext):
    """Count the tensor-core instructions (HMMA/HGMMA) in the SASS of the
    flash-attention (B5) and SSD (B6) kernels, where the toolkit has
    cuobjdump; every one of their kernels that multiplies must have
    some."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = shutil.which("cuobjdump") or (
        str(Path(CUDA_HOME) / "bin" / "cuobjdump") if CUDA_HOME else None)
    if tool is None or not Path(tool).is_file():
        log("[build] cuobjdump not found: SASS not counted (see the ptxas "
            "lines and csrc/ssm_kernels.cu)")
        return
    sass = subprocess.run([tool, "-sass", ext.library()._name],
                          capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            if "ssd" in fn or "flash_attention" in fn:
                counts[fn] = 0
        elif fn in counts and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    log(f"[build] tensor-core instructions (HMMA/HGMMA) in the SASS of "
        f"the flash-attention and SSD kernels: {json.dumps(counts)}")
    for mma in ("flash_attention_kernel", "ssd_state_kernel",
                "ssd_out_kernel"):
        if not any(v > 0 for k, v in counts.items() if mma in k):
            fail(f"{mma} has no tensor-core instruction in its SASS")


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

    agg_edges(torch, K, chk, gen, dev, data, program, preds, int_values,
              f32_values)

    # B3 takes a block per window of 1,024 elements or more, a warp
    # below: both sides of that threshold, windows and slides that are not
    # multiples of 4, and more than 65,535 windows
    windows = [(ROWS, WINDOW, WINDOW), (ROWS, WINDOW, 1024),
               (1025, 64, 17), (4096, 4096, 4096), (1023, 8, 3),
               (ROWS, 1024, 1024), (ROWS, 1023, 1023), (100_003, 1031, 13),
               (ROWS, 8, 4), (300_000, 2048, 3)]
    nan_cases = 0
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
        # f32 min/max with NaNs in about one window in ten: equal to plain,
        # NaN where plain has NaN
        v = cols[3].clone()
        v[torch.rand((n,), generator=gen, device=dev) < 0.1 / w] = \
            float("nan")
        for op in ("min", "max"):
            got = K.window_reduce_tensor(v, w, s, op)
            want = K.window_reduce_plain(v, w, s, op)
            try:
                torch.testing.assert_close(got, want, rtol=0, atol=0,
                                           equal_nan=True)
            except AssertionError as e:
                fail(f"window_reduce n={n} window={w} slide={s} op={op} "
                     f"with NaNs: kernel and plain differ: {e}")
            nan_cases += 1
            chk.cases["window_reduce"] += 1
    # a sequence shorter than one window emits nothing, as in window_reduce
    short = K.window_reduce(cols[2][:100].cpu().numpy(), 128, device=dev)
    if short.shape != (0,) or short.dtype.name != "float32":
        fail(f"window_reduce on a short sequence gave {short!r}")
    torch.cuda.synchronize()
    log(f"[kernels] kernel == plain on the card: {chk.cases} cases; "
        f"max abs error {chk.err} (f32 sums within {F32_SUM_RTOL} x "
        f"sum|v|; ints and f32 min/max exact; window_reduce windows "
        f"{windows} (n, window, slide), {nan_cases} of its cases f32 "
        f"min/max over values with NaNs, equal with equal_nan)")
    return chk


def agg_edges(torch, K, chk, gen, dev, data, program, preds, int_values,
              f32_values):
    """B1 and B2 at their design's thresholds (AGG_CASES), with every row
    in one segment, f32 min/max over NaNs, and f32 sums run three times
    at 1 and 32 segments (a table a thread): the same bits (ROADMAP
    C4)."""
    def both(ids, cols, n_seg, what, ops=OPS, dts=(torch.int32,
                                                   torch.float32)):
        for op in ops:
            for dt in dts:
                pred = preds[0] if dt == torch.int32 else preds[1]
                value = (int_values[0] if dt == torch.int32
                         else f32_values[0])
                prog, used = program(pred, value, str(dt).split(".")[1])
                ts = [cols[i] for i in used]
                got = K.fused_filter_aggregate_tensor(ts, prog, ids, n_seg,
                                                      op, dt)
                want = K.fused_filter_aggregate_plain(ts, prog, ids, n_seg,
                                                      op, dt)
                abs_sum = None
                if op == "sum" and dt == torch.float32:
                    val = K._run_program_plain(prog.code[prog.n_pred:],
                                               prog, ts).abs()
                    keep = K._run_program_plain(prog.code[:prog.n_pred],
                                                prog, ts) != 0
                    abs_sum = K.segment_reduce_plain(
                        val.contiguous(), torch.where(keep, ids, -1), n_seg,
                        "sum")
                same_nan(chk, "fused_filter_aggregate", f"{what} op={op} "
                         f"{dt} acc", got[0], want[0], op, abs_sum)
                chk.same("fused_filter_aggregate", f"{what} op={op} {dt} "
                         f"cnt", got[1], want[1], "count")
                v = cols[2] if dt == torch.int32 else cols[3]
                got = K.segment_reduce_tensor(v, ids, n_seg, op)
                want = K.segment_reduce_plain(v, ids, n_seg, op)
                abs_sum = (K.segment_reduce_plain(v.abs().nan_to_num(0.0),
                                                  ids, n_seg, "sum")
                           if dt == torch.float32 else None)
                same_nan(chk, "segment_reduce", f"{what} op={op} {dt}", got,
                         want, op, abs_sum)

    for n, n_seg, one in AGG_CASES:
        ids, cols = data(n, n_seg)
        if one:                        # every row in one segment
            ids = torch.full_like(ids, 7 % n_seg)
        both(ids, cols, n_seg, f"rows={n} segs={n_seg}"
             + (" one segment" if one else ""))
    for n_seg in (32, 33, KEYS, 8193):
        ids, cols = data(70_000, n_seg)
        cols[3][torch.rand((70_000,), generator=gen, device=dev)
                < 2.0 / n_seg] = float("nan")
        both(ids, cols, n_seg, f"rows=70000 segs={n_seg} with NaNs",
             ops=("min", "max"), dts=(torch.float32,))
    for n_seg in (1, BINS):            # f32 sums in thread tables
        ids, cols = data(ROWS, n_seg)
        prog, used = program(preds[1], f32_values[0], "float32")
        ts = [cols[i] for i in used]
        b1 = [K.fused_filter_aggregate_tensor(ts, prog, ids, n_seg, "sum",
                                              torch.float32)[0]
              for _ in range(3)]
        b2 = [K.segment_reduce_tensor(cols[3], ids, n_seg, "sum")
              for _ in range(3)]
        for name, runs in (("fused_filter_aggregate", b1),
                           ("segment_reduce", b2)):
            if not all(torch.equal(runs[0], r) for r in runs[1:]):
                fail(f"{name} f32 sum at rows={ROWS} segs={n_seg} changed "
                     f"its bits between runs")
    log(f"[kernels] B1/B2 at their thresholds (rows, segs, one segment): "
        f"{AGG_CASES}; f32 min/max with NaNs equal with equal_nan at segs "
        f"32, 33, {KEYS}, 8193; f32 sums the same bits over 3 runs at "
        f"rows={ROWS} segs 1 and {BINS}")


def same_nan(chk, name, what, got, want, op, abs_sum):
    """chk.same, with NaN where plain has NaN (f32 min/max, and f32 sums
    of a segment holding a NaN)."""
    torch = chk.torch
    nan = torch.isnan(want) if want.dtype == torch.float32 else None
    if nan is None or not bool(nan.any()):
        chk.same(name, what, got, want, op, abs_sum)
        return
    if not torch.equal(torch.isnan(got), nan):
        fail(f"{name} {what}: NaN where plain has none, or none where it "
             f"has NaN")
    keep = ~nan
    chk.same(name, what, got[keep], want[keep], op,
             None if abs_sum is None else abs_sum[keep])


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


def attn_inputs(torch, gen, dev, b, h, kv, sq, sk, hd):
    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return r(b, h, sq, hd), r(b, kv, sk, hd), r(b, kv, sk, hd)


def scan_inputs(torch, gen, dev, b, s, w, with_h0):
    """RG-LRU coefficients: a in [0, 1) with some exact 0s and 1s, x and
    h0 normal."""
    a = torch.rand((b, s, w), generator=gen, device=dev)
    a[torch.rand((b, s, w), generator=gen, device=dev) < 0.01] = 0.0
    a[torch.rand((b, s, w), generator=gen, device=dev) < 0.01] = 1.0
    x = torch.randn((b, s, w), generator=gen, device=dev) * 0.2
    h0 = (torch.randn((b, w), generator=gen, device=dev) if with_h0
          else None)
    return a, x, h0


def ssd_inputs(torch, gen, dev, b, s, h, p, n, g, with_state):
    """The SSD layer's inputs as the mamba2 block makes them: dt the
    softplus of a normal (dt_bias 0), a_log = log(linspace(1, 16, h)) as
    ``init_ssm`` sets it, x, B, C and the state normal."""
    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    dt = torch.nn.functional.softplus(r(b, s, h))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    s0 = r(b, h, p, n, scale=0.5) if with_state else None
    return (r(b, s, h, p), dt, a_log, r(b, s, g, n, scale=0.5),
            r(b, s, g, n, scale=0.5), s0)


def ssd_error(got, want, dims):
    """(max |got - want|, the largest |got - want| / the (batch, head)'s
    max |want|); ``dims`` are the axes reduced per (batch, head)."""
    diff = (got - want).abs()
    scale = want.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    return float(diff.max()), float((diff / scale).amax())


def phase_model_kernels(torch, KA, KR, KS, chk, dev):
    """[model-kernels] B5, B6 and B7 against their plain versions on the
    card: B7 bit for bit (both round the multiply and the add
    separately), B5 within ATTN_RTOL of each query row's largest |o|
    (f32 products summed in another order than the plain matmuls), B6's
    y and final state within SSD_RTOL of each (batch, head)'s largest
    |value| (split-TF32 products and f64 cumsums against the plain
    version's f32 matmuls and cumsums: the same function, other
    roundings), and at one small shape within SSD_SEQ_RTOL of the
    sequential oracle."""
    from repro_torch.models.ssm import ssd_reference
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    worst_rel = 0.0
    for b, h, kv, sq, sk, hd, causal, window, cap in ATTN_CASES:
        q, k, v = attn_inputs(torch, gen, dev, b, h, kv, sq, sk, hd)
        kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                  softcap=cap)
        got = KA.flash_attention_kernel(q, k, v, **kw)
        want = KA.flash_attention_plain(q, k, v, **kw)
        chk.cases["flash_attention"] += 1
        what = (f"flash_attention b={b} h={h} kv={kv} sq={sq} sk={sk} "
                f"hd={hd} causal={causal} window={window} softcap={cap}")
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"{what}: shape {tuple(got.shape)} or non-finite output")
        diff = (got - want).abs()
        row = want.abs().amax(-1, keepdim=True)
        chk.err["flash_attention"] = max(chk.err["flash_attention"],
                                         float(diff.max()))
        worst_rel = max(worst_rel, float((diff / row.clamp_min(
            1e-30)).max()))
        if not bool((diff <= ATTN_RTOL * row).all()):
            fail(f"{what}: kernel and plain differ (max abs error "
                 f"{float(diff.max())})")
        del q, k, v, got, want, diff
    for b, s_, w, with_h0 in SCAN_CASES:
        a, x, h0 = scan_inputs(torch, gen, dev, b, s_, w, with_h0)
        got = KR.rglru_scan(a, x, h0)
        want = KR.rglru_scan_plain(a, x, h0)
        chk.cases["rglru_scan"] += 1
        err = float((got - want).abs().max())
        chk.err["rglru_scan"] = max(chk.err["rglru_scan"], err)
        if not torch.equal(got, want):
            fail(f"rglru_scan b={b} s={s_} w={w} h0={with_h0}: kernel and "
                 f"plain differ (max abs error {err})")
    ssd_rel, ssd_worst, seq_rel = 0.0, "", 0.0
    for i, (b, s_, h, p, n, g, chunk, with_s0) in enumerate(SSD_CASES):
        args = ssd_inputs(torch, gen, dev, b, s_, h, p, n, g, with_s0)
        got = KS.ssd_scan(*args[:5], chunk=chunk, initial_state=args[5])
        wants = [("plain", KS.ssd_chunked(*args[:5], chunk,
                                          initial_state=args[5]),
                  SSD_RTOL)]
        if i == SSD_SEQ_CASE:
            wants.append(("ssd_reference", ssd_reference(*args), SSD_SEQ_RTOL))
        chk.cases["ssd_scan"] += 1
        what = (f"ssd_scan b={b} s={s_} h={h} p={p} n={n} g={g} "
                f"chunk={chunk} initial_state={with_s0}")
        for name, want, rtol in wants:
            for part, dims, x, w in (("y", (1, 3), got[0], want[0]),
                                     ("final state", (2, 3), got[1],
                                      want[1])):
                if x.shape != w.shape or not bool(torch.isfinite(x).all()):
                    fail(f"{what}: {part} of shape {tuple(x.shape)} or "
                         f"non-finite")
                err, rel = ssd_error(x, w, dims)
                if name == "plain":
                    chk.err["ssd_scan"] = max(chk.err["ssd_scan"], err)
                    if rel > ssd_rel:
                        ssd_rel, ssd_worst = rel, f"{part} at {what}"
                else:
                    seq_rel = max(seq_rel, rel)
                if not rel <= rtol:
                    fail(f"{what}: kernel and {name} {part} differ by "
                         f"{rel:.3e} of the (batch, head)'s max (limit "
                         f"{rtol}; max abs error {err})")
        del args, got, wants
    torch.cuda.synchronize()
    log(f"[model-kernels] kernel == plain on the card: flash_attention "
        f"{chk.cases['flash_attention']} cases (MHA/GQA/MQA, window 0 and "
        f">0, softcap 0 and 30, causal and not, unaligned sq/sk, hd "
        f"64/128/256, window edges inside a key tile), max abs error "
        f"{chk.err['flash_attention']}, max error / row max |o| "
        f"{worst_rel:.3e} (limit {ATTN_RTOL}); "
        f"rglru_scan {chk.cases['rglru_scan']} cases bit for bit (with and "
        f"without h0, s=1, s and w not multiples of 32, w of 4); ssd_scan "
        f"{chk.cases['ssd_scan']} cases (serving shape with and without a "
        f"state, s=1, s 255/256/257/513 with and without a state, g=2 "
        f"and g=h, p 6/8/16/40/64, n 16-256), max abs "
        f"error {chk.err['ssd_scan']}, max error / (batch, head) max "
        f"{ssd_rel:.3e} (limit {SSD_RTOL}; {ssd_worst}), against "
        f"ssd_reference at "
        f"SSD_CASES[{SSD_SEQ_CASE}] {seq_rel:.3e} (limit {SSD_SEQ_RTOL})")


# ---------------------------------------------------------------------------
# timing at the main path's shapes
# ---------------------------------------------------------------------------

def device_ms(torch, fn, reps=10, host=False):
    """Mean device time of ``fn`` with the 50 MB L2 flushed before each
    run (the main path's inputs arrive fresh from the host).  The card
    spins for ``HOST_COVER_CYCLES`` before the start event, so the host
    has enqueued ``fn``'s launches by the time it starts: the events time
    the device, not the Python and ctypes work of the call (which, for a
    kernel shorter than that work, they would otherwise time).  With
    ``host`` the card does not spin and the events take in that work too:
    the time a call costs a path whose card waits on its host."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        if not host:
            torch.cuda._sleep(HOST_COVER_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def attn_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask leaves visible, positions = indices."""
    n = 0
    for i in range(sq):
        hi = min(sk, i + 1) if causal else sk
        lo = max(0, i - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def ssd_flops(b, s, h, p, n, chunk):
    """Operations of the chunked SSD scan at ``chunk``, causal pairs only
    (as B5's visible pairs): per chunk of L rows, L(L+1)/2 pairs x (2n
    for C.B and 2p for the gated product with x), plus 2 x 2 L n p for
    y_off and the state update.  The form is exact at any chunk length
    and its work a row, (L+1)/2 (2n + 2p) + 4np, grows with L, so the
    least work of the function is at chunk 1, the step-by-step
    recurrence; B6's bound is counted there."""
    total = 0
    for c0 in range(0, s, chunk):
        L = min(chunk, s - c0)
        total += L * (L + 1) // 2 * (2 * n + 2 * p) + 4 * L * n * p
    return b * h * total


def phase_timing(torch, K, H, KA, KR, KS, col, dev):
    """Each kernel at the shape its path gives it: B1 as query (a)'s
    fused pass, B2 as query (c)'s histogram count, B3 as query (d)'s
    window max (one partition each), B4 as one heat refresh of 262,144
    tracked objects, B5 and B7 as one local-attention and one RG-LRU
    layer of the [serve] prefill, B6 as one SSD layer of the
    [serve-ssm] prefill."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def ri(lo, hi):
        return torch.randint(lo, hi, (ROWS,), generator=gen, device=dev,
                             dtype=torch.int32)

    key, quality, reading = ri(0, KEYS), ri(0, 100), ri(-500, 500)
    out = {}

    # B1 at each of its main-path shapes (the queries' fused passes):
    # filter col(1) >= 75, key col(0); (a) f32 sum of col(2) for the mean
    # (the kernels line's row), (b) count, int32 min and max of col(2)
    pred = json.dumps((col(1) >= 75).to_spec())
    value = json.dumps(col(2).to_spec())
    kinds = ((1, "I"), (2, "I"))
    keep = quality >= 75
    survivors = int(keep.sum())
    # 32-byte sectors of the value column holding a survivor: what a
    # read of the survivors' values moves at the least
    sectors = int(keep.view(-1, 8).any(dim=1).sum())
    b1_shapes = {}
    for q, (spec, op, dt, ts) in {
            "a_mean": (value, "sum", torch.float32, [quality, reading]),
            "b_count": ("", "sum", torch.int32, [quality]),
            "b_min": (value, "min", torch.int32, [quality, reading]),
            "b_max": (value, "max", torch.int32, [quality, reading])}.items():
        prog = K.compile_specs(pred, spec, kinds[:len(ts)],
                               str(dt).split(".")[1])
        b1 = (lambda prog=prog, ts=ts, op=op, dt=dt:
              K.fused_filter_aggregate_tensor(ts, prog, key, KEYS, op, dt))
        # ids and the predicate column for every row, the value column for
        # the survivors (by rows, or by the 32-byte sectors that hold one),
        # acc + cnt out
        rows_bytes = 4 * ROWS * 2 + 8 * KEYS
        b1_shapes[q] = dict(
            ms=device_ms(torch, b1), host_ms=device_ms(torch, b1, host=True),
            bound_bytes=rows_bytes + (4 * survivors if spec else 0),
            sector_bytes=rows_bytes + (32 * sectors if spec else 0),
            plain_ms=device_ms(torch, lambda prog=prog, ts=ts, op=op, dt=dt:
                               K.fused_filter_aggregate_plain(
                                   ts, prog, key, KEYS, op, dt)))
    a = b1_shapes["a_mean"]
    out["fused_filter_aggregate"] = dict(
        ms=a["ms"], plain_ms=a["plain_ms"], bound_bytes=a["bound_bytes"],
        host_ms=a["host_ms"], library_ms=None, library_host_ms=None,
        shapes=b1_shapes, shape=f"rows={ROWS} segs={KEYS} sum f32 "
        f"(query a)")
    for q, r in b1_shapes.items():
        log(f"[timing] fused_filter_aggregate {q}: {r['ms']:.4f} ms/launch "
            f"(device), {r['host_ms']:.4f} ms per call with the host's work, "
            f"plain {r['plain_ms']:.4f} ms; bound {r['bound_bytes']} B = "
            f"{r['bound_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms, by 32-byte "
            f"sectors {r['sector_bytes']} B = "
            f"{r['sector_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms "
            f"({sectors} of {ROWS // 8} value sectors hold one of "
            f"{survivors} survivors)")

    # B2: histogram count of 32 bins over col(2) (query c)
    bins = ((reading.double() + 500) / (1000 / BINS)).floor().clamp_(
        max=BINS - 1)
    ids = bins.to(torch.int32)
    ones = torch.ones_like(ids)
    dump = torch.where(ids >= 0, ids, BINS).long()
    lib_out = torch.zeros(BINS + 1, dtype=torch.int32, device=dev)
    b2 = lambda: K.segment_reduce_tensor(ones, ids, BINS, "count")  # noqa: E731
    b2_lib = lambda: lib_out.scatter_reduce_(  # noqa: E731
        0, dump, ones, reduce="sum")
    out["segment_reduce"] = dict(
        ms=device_ms(torch, b2),
        plain_ms=device_ms(torch, lambda: K.segment_reduce_plain(
            ones, ids, BINS, "count")),
        # count reads only the ids (the values are never loaded)
        bound_bytes=4 * ROWS + 4 * BINS,
        library_ms=device_ms(torch, b2_lib),
        host_ms=device_ms(torch, b2, host=True),
        library_host_ms=device_ms(torch, b2_lib, host=True),
        shape=f"rows={ROWS} segs={BINS} count int32")

    # B3: tumbling window max over col(2) (query d)
    nw = ROWS // WINDOW
    b3 = lambda: K.window_reduce_tensor(reading, WINDOW, WINDOW, "max")
    b3_lib = lambda: reading.unfold(0, WINDOW, WINDOW).amax(1)
    out["window_reduce"] = dict(
        ms=device_ms(torch, b3),
        plain_ms=device_ms(torch, lambda: K.window_reduce_plain(
            reading, WINDOW, WINDOW, "max")),
        bound_bytes=4 * ROWS + 4 * nw,
        library_ms=device_ms(torch, b3_lib),
        # per call with the host's work in it, as query (d) pays it
        host_ms=device_ms(torch, b3, host=True),
        library_host_ms=device_ms(torch, b3_lib, host=True),
        shape=f"n={ROWS} window={WINDOW} max int32")

    # B4: the heat scan over the extractor's hist_len x 262,144 objects;
    # no one PyTorch call computes a first-order linear recurrence
    a, x = heat_inputs(torch, gen, dev, HEAT_HIST, HEAT_OBJS, "random")
    out["heat_scan"] = dict(
        ms=device_ms(torch, lambda: H.heat_scan(a, x, device=dev)),
        plain_ms=device_ms(torch, lambda: H.heat_scan_plain(a, x)),
        bound_bytes=2 * 4 * HEAT_HIST * HEAT_OBJS + 4 * HEAT_OBJS,
        library_ms=None, shape=f"hist={HEAT_HIST} nobj={HEAT_OBJS} f32")

    # B5: one local-attention layer of the [serve] prefill; the yardstick
    # is SDPA with the same boolean window-causal mask over K/V expanded
    # to every head (the port never calls it)
    import torch.nn.functional as F
    b, h, kv, sq, sk, hd, causal, window, cap = ATTN_CASES[0]
    q, k, v = attn_inputs(torch, gen, dev, b, h, kv, sq, sk, hd)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=cap)
    qi = torch.arange(sq, device=dev)[:, None]
    ki = torch.arange(sk, device=dev)[None, :]
    mask = (ki <= qi) & (ki > qi - window)
    k16, v16 = (t.expand(b, h, sk, hd).contiguous() for t in (k, v))
    pairs = attn_pairs(sq, sk, causal, window)
    flops = 4 * hd * pairs * b * h            # q.k and p.v, 2 each
    out["flash_attention"] = dict(
        ms=device_ms(torch, lambda: KA.flash_attention_kernel(q, k, v, **kw)),
        plain_ms=device_ms(torch, lambda: KA.flash_attention_plain(
            q, k, v, **kw)),
        library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k16, v16, attn_mask=mask, scale=kw["scale"])),
        bound_bytes=4 * (2 * q.numel() + k.numel() + v.numel()),
        # f32 operands take the tensor cores' TF32 rate; the kernel's
        # three products each (3xTF32) are its own cost, as B6's
        bound_flops=flops, flops_rate=TF32_FLOPS,
        shape=f"b={b} h={h} kv={kv} s={sq} hd={hd} "
        f"window={window} f32 ({pairs} visible pairs per head)")
    del q, k, v, k16, v16, mask

    # B7: one RG-LRU layer of the [serve] prefill (h0 from the cache); no
    # one PyTorch call computes a linear recurrence
    b, s_, w, with_h0 = SCAN_CASES[0]
    a, x, h0 = scan_inputs(torch, gen, dev, b, s_, w, with_h0)
    out["rglru_scan"] = dict(
        ms=device_ms(torch, lambda: KR.rglru_scan(a, x, h0)),
        plain_ms=device_ms(torch, lambda: KR.rglru_scan_plain(a, x, h0)),
        library_ms=None, bound_bytes=4 * (3 * a.numel() + h0.numel()),
        shape=f"b={b} s={s_} w={w} f32")
    del a, x, h0

    # B6: one SSD layer of the [serve-ssm] prefill (initial state from the
    # cache); no one PyTorch call computes the SSD scan
    b, s_, h, p, n, g, chunk, with_s0 = SSD_CASES[0]
    args = ssd_inputs(torch, gen, dev, b, s_, h, p, n, g, with_s0)
    io = sum(t.numel() for t in args if t is not None) \
        + b * s_ * h * p + b * h * p * n          # + y and the final state
    out["ssd_scan"] = dict(
        ms=device_ms(torch, lambda: KS.ssd_scan(
            *args[:5], chunk=chunk, initial_state=args[5])),
        plain_ms=device_ms(torch, lambda: KS.ssd_chunked(
            *args[:5], chunk, initial_state=args[5])),
        library_ms=None, bound_bytes=4 * io,
        # f32 operands take the tensor cores' TF32 rate; the kernel's
        # three products each (3xTF32) are its own cost, not the function's
        bound_flops=ssd_flops(b, s_, h, p, n, 1), flops_rate=TF32_FLOPS,
        shape=f"b={b} s={s_} h={h} p={p} n={n} g={g} f32, counted at "
        f"chunk 1; in 64-row chunks the form does "
        f"{ssd_flops(b, s_, h, p, n, 64)} FLOP, the reference's chunk "
        f"{chunk} {ssd_flops(b, s_, h, p, n, chunk)}")
    log_ssd_launches(torch, lambda: KS.ssd_scan(
        *args[:5], chunk=chunk, initial_state=args[5]))
    del args

    for name, r in out.items():
        bytes_ms = r["bound_bytes"] / HBM_BYTES_PER_S * 1e3
        rate = r.get("flops_rate", F32_FLOPS)
        ops_ms = r.get("bound_flops", 0) / rate * 1e3
        r["bound_ms"] = max(bytes_ms, ops_ms)
        r["bound_by"] = "operations" if ops_ms > bytes_ms else "bytes"
        extra = ""
        if "bound_flops" in r:
            extra = (f"; {r['bound_flops']} FLOP at {rate:.4g}/s = "
                     f"{ops_ms:.4f} ms; at the f32 rate {F32_FLOPS:.3g}/s "
                     f"{r['bound_flops'] / F32_FLOPS * 1e3:.4f} ms, at the "
                     f"TF32 tensor-core rate "
                     f"{r['bound_flops'] / TF32_FLOPS * 1e3:.4f} ms, at "
                     f"3xTF32 {r['bound_flops'] / TF32X3_FLOPS * 1e3:.4f} "
                     f"ms; achieved {r['bound_flops'] / r['ms'] / 1e9:.2f} "
                     f"TFLOP/s")
        else:
            extra = (f"; achieved {r['bound_bytes'] / r['ms'] / 1e6:.1f} "
                     f"GB/s")
        if "host_ms" in r:
            lib = r["library_host_ms"]
            extra += (f"; per call with the host's work: {r['host_ms']:.4f} "
                      f"ms, library "
                      f"{'none' if lib is None else f'{lib:.4f} ms'}")
        log(f"[timing] {name} ({r['shape']}): {r['ms']:.4f} ms/launch, "
            f"plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['bound_bytes']} B at {HBM_BYTES_PER_S:.3g} B/s = "
            f"{bytes_ms:.4f} ms{extra})")
    return out


def log_ssd_launches(torch, call):
    """Device ms of each of B6's launches in one ``call`` (torch.profiler,
    self device time by kernel name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        m = re.search(r"ssd_\w+_kernel", e.key)
        if m and e.device_type == DeviceType.CUDA:
            parts[m.group(0)] = e.self_device_time_total / e.count / 1e3
    if not any(parts.values()):
        log("[timing] ssd_scan launches: the profiler saw no device time "
            "(not measured)")
        return
    log(f"[timing] ssd_scan launches in one call (torch.profiler, device "
        f"ms): {json.dumps(parts)}")


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

def table_rows(torch, gen, dev, n, shard):
    """``n`` rows of the analytics-tour table (key, quality, reading,
    shard; int32), drawn on the card from ``gen``."""
    tbl = torch.empty((n, 4), dtype=torch.int32, device=dev)
    for c, (lo, hi) in enumerate(((0, KEYS), (0, 100), (-500, 500))):
        tbl[:, c] = torch.randint(lo, hi, (n,), generator=gen, device=dev,
                                  dtype=torch.int32)
    tbl[:, 3] = shard
    return tbl.cpu().numpy()


def fill_store(torch, cl, dev, tag="[store]"):
    """Write the 1 GiB table into ``cl`` (a Clovis or a ClusterClovis):
    PARTS partitions of ROWS rows from torch.Generator seed 0."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    for i in range(PARTS):
        cl.put_array(f"capture/{i:02d}", table_rows(torch, gen, dev, ROWS, i),
                     container="capture")
    wall = time.perf_counter() - t0
    nbytes = sum(cl.store.read_size(o) for o in cl.container("capture"))
    log(f"{tag} {PARTS} partitions x {ROWS} rows x 4 int32 = "
        f"{nbytes} B written in {wall:.2f} s")
    if nbytes != PARTS * ROWS * 16:
        fail(f"{tag} store holds {nbytes} B, expected {PARTS * ROWS * 16}")
    return cl


def build_store(torch, Clovis, root, dev):
    return fill_store(torch, Clovis(root, device=dev), dev)


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
        return launches, per_query, {n: r.value for n, r in results.items()}
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


# ---------------------------------------------------------------------------
# phase 4b: the storage cluster, the serving front door and compaction
# ---------------------------------------------------------------------------

def remove_cluster(root: Path):
    """Remove a ClusterClovis root: each node keeps a Clovis stack (and
    its T1 dirs) under root / node_id."""
    if root.is_dir():
        for node_root in root.iterdir():
            remove_store(node_root)
    remove_store(root)


def build_cluster(torch, root, dev, tag):
    from repro_torch.cluster import ClusterClovis
    remove_cluster(root)
    cl = ClusterClovis(root, nodes=CLUSTER_NODES, replicas=CLUSTER_REPLICAS,
                       device=dev)
    fill_store(torch, cl, dev, tag)
    held = sum(n.store.read_size(o) for n in cl.alive_nodes()
               for o in cl.container("capture") if n.store.exists(o))
    log(f"{tag} {CLUSTER_NODES} nodes, {CLUSTER_REPLICAS} replicas: "
        f"{held} B held on the nodes")
    if held != CLUSTER_REPLICAS * PARTS * ROWS * 16:
        fail(f"{tag} nodes hold {held} B, expected "
             f"{CLUSTER_REPLICAS * PARTS * ROWS * 16}")
    return cl


def phase_cluster(torch, K, col, dev, main_values):
    """[cluster] queries (a)-(d) through ``ClusterClovis.analytics()``
    over a 4-node, 2-replica cluster holding the [main] table; each
    result must be byte-identical to [main]'s.  Then the node that is
    primary for the most partitions is killed after the second shipped
    fragment of query (a) (two workers, as the reference's failover
    test): the result must stay byte-identical, the route trace show a
    reroute, the node leave the ring and every partition keep 2 live
    holders."""
    root = ROOT / ".chip_smoke" / "cluster"
    try:
        cl = build_cluster(torch, root, dev, "[cluster]")
        K.reset_launch_counts()                 # [cluster] starts here
        for name in QUERIES:
            eng = cl.analytics(partial_cache_size=0)
            t0 = time.perf_counter()
            res = eng.run(queries(eng, col)[name])
            wall = time.perf_counter() - t0
            eng.close()
            if not equal(res.value, main_values[name]):
                fail(f"[cluster] {name} differs from [main]'s result")
            log(f"[cluster] {name}: wall {wall:.3f} s (plan "
                f"{res.stats.plan_s:.3f} exec {res.stats.exec_s:.3f} "
                f"merge {res.stats.merge_s:.3f}); byte-identical to [main]")
        log(f"[cluster] fragment time by node over (a)-(d) (ADDB route "
            f"trace, host clock): {json.dumps(node_fragment_ms(cl))}")

        primaries = {}
        for oid in cl.container("capture"):
            p = cl.primary_of(oid)
            primaries[p] = primaries.get(p, 0) + 1
        victim = max(sorted(primaries), key=primaries.get)
        evictions = []
        evict = cl.evict_node

        def timed_evict(node_id):
            t0 = time.perf_counter()
            out = evict(node_id)
            evictions.append((time.perf_counter() - t0, out))
            return out
        cl.evict_node = timed_evict              # the HA handler calls it
        ships = [0]

        def killer(_res):
            ships[0] += 1
            if ships[0] == 2:
                cl.kill_node(victim)
        n_routes = len(cl.addb.route_trace())
        cl.shipper.add_observer(killer)
        eng = cl.analytics(partial_cache_size=0, max_workers=2)
        t0 = time.perf_counter()
        res = eng.run(queries(eng, col)["a_mean"])
        wall = time.perf_counter() - t0
        cl.shipper.remove_observer(killer)
        eng.close()
        launches = {k: K.LAUNCHES[k] for k in BATCH_KERNELS}  # ends here
        routes = cl.addb.route_trace()[n_routes:]
        reroutes = sum(1 for t in routes if t["rerouted"])
        if not equal(res.value, main_values["a_mean"]):
            fail("[cluster] a_mean with a node killed mid-scan differs from "
                 "the healthy result")
        if not reroutes:
            fail("[cluster] no fragment was rerouted after the kill")
        if victim in cl.ring or not evictions:
            fail(f"[cluster] {victim} was not evicted from the ring")
        holders = {o: len(cl.live_holders(o)) for o in cl.container("capture")}
        if set(holders.values()) != {CLUSTER_REPLICAS}:
            fail(f"[cluster] live holders after the eviction: {holders}")
        evict_s, summary = evictions[0]
        log(f"[cluster] failover: {victim} (primary of "
            f"{primaries[victim]} of {PARTS} partitions) killed after the "
            f"2nd shipped fragment of a_mean; wall {wall:.3f} s, "
            f"{reroutes} of {len(routes)} routes rerouted; eviction and "
            f"re-replication {evict_s:.3f} s ({summary['partitions']} "
            f"partitions, {summary['bytes']} B); byte-identical to the "
            f"healthy run, every partition on {CLUSTER_REPLICAS} live nodes")
        for k in BATCH_KERNELS:
            if launches[k] <= 0:
                fail(f"[cluster] kernel {k} was not launched")
        cl.close()
        return launches
    finally:
        remove_cluster(root)


def node_fragment_ms(cl):
    """Per node: fragments served and their mean and largest wall ms, from
    the cluster's ADDB route trace."""
    by_node = {}
    for t in cl.addb.route_trace():
        if t["ok"]:
            by_node.setdefault(t["node"], []).append(t["latency_s"] * 1e3)
    return {n: [len(v), round(sum(v) / len(v), 3), round(max(v), 3)]
            for n, v in sorted(by_node.items())}


def query_a_numpy(rows):
    """Query (a) over ``rows`` in numpy: filter quality >= 75, group by
    key, mean reading (exact sums: every partial is an integer < 2**24)."""
    import numpy as np
    keep = rows[:, 1] >= 75
    keys = rows[keep, 0].astype(np.int64)
    counts = np.bincount(keys, minlength=KEYS)
    sums = np.bincount(keys, weights=rows[keep, 2].astype(np.float64),
                       minlength=KEYS)
    live = np.flatnonzero(counts)
    return live.astype(np.int64), sums[live] / counts[live]


def phase_serving(torch, K, col, dev, main_values):
    """[serving] ``ClusterClovis.serving()`` over a fresh 4-node cluster
    holding the [main] table: tenants ops and science (priority 2)
    submit queries (a), (b) count and (c) at once, each twice; every
    response must be ok and equal [main]'s, single-flight or the
    partial cache must have shared work, and the ADDB serving trace hold
    each request's stages.  Then [compaction] on the same cluster."""
    from repro_torch.serving import QueryRequest, TenantConfig
    root = ROOT / ".chip_smoke" / "serving"
    try:
        cl = build_cluster(torch, root, dev, "[serving]")
        svc = cl.serving([TenantConfig("ops"),
                          TenantConfig("science", priority=2.0)], workers=4)
        specs = {n: QueryRequest.from_dataset(
                     "ops", queries(svc.engine, col)[n]).ops
                 for n in SERVED}
        K.reset_launch_counts()                 # [serving] starts here
        t0 = time.perf_counter()
        subs = [(t, n, svc.submit(QueryRequest(t, "capture", specs[n],
                                               tag=f"{t}/{n}/{rep}")))
                for rep in range(2) for t in TENANTS for n in SERVED]
        resps = [(t, n, sub.tag, sub.result(timeout=1200))
                 for t, n, sub in subs]
        wall = time.perf_counter() - t0
        launches = {k: K.LAUNCHES[k] for k in BATCH_KERNELS}  # ends here
        shared = 0
        for t, n, tag, r in resps:
            if not r.ok:
                fail(f"[serving] {tag} failed: {r.error}")
            if not equal(r.value, main_values[n]):
                fail(f"[serving] {tag} differs from [main]'s result")
            shared += r.stats.dedup_hits + r.stats.cache_hits
            stages = {s["stage"] for s in svc.addb.serving_trace(tag)}
            if not {"admit", "queue", "plan", "execute"} <= stages:
                fail(f"[serving] {tag}: serving trace holds {sorted(stages)}")
        if shared <= 0:
            fail("[serving] no fragment was shared (dedup + cache hits 0)")
        for k in ("fused_filter_aggregate", "segment_reduce"):
            if launches[k] <= 0:
                fail(f"[serving] kernel {k} was not launched")
        for t in TENANTS:
            mine = [r.trace for tt, _, _, r in resps if tt == t]
            p50 = {k: sorted(tr[k] for tr in mine)[len(mine) // 2]
                   for k in ("total_s", "queue_s", "plan_s", "execute_s",
                             "merge_s")}
            log(f"[serving] tenant {t}: {len(mine)} requests, latency p50 "
                f"{p50['total_s']:.3f} s, max "
                f"{max(tr['total_s'] for tr in mine):.3f} s; p50 by stage "
                f"(s): queue {p50['queue_s']:.3f}, plan {p50['plan_s']:.3f}, "
                f"execute {p50['execute_s']:.3f}, merge {p50['merge_s']:.3f}")
        log(f"[serving] {len(resps)} requests in {wall:.3f} s, every one "
            f"equal to [main]'s; dedup + cache hits {shared}; "
            f"{json.dumps(svc.stats()['flights'])}")
        comp = phase_compaction(torch, K, cl, svc, dev, specs["a_mean"])
        svc.close()
        cl.close()
        return {"serving": launches, "compaction": comp}
    finally:
        remove_cluster(root)


def phase_compaction(torch, K, cl, svc, dev, spec_a):
    """[compaction] ``cluster.compaction()`` with the default policy:
    DELTAS deltas of DELTA_ROWS rows (64 KiB each) appended to container
    cevents, query (a) through the serving engine before and after
    ``compact()``; both must equal numpy over the appended rows, the
    pinned snapshot version must advance, and the deltas must merge into
    blocks of at most the policy's group size."""
    import numpy as np
    from repro_torch.serving import QueryRequest
    comp = cl.compaction()
    pol = comp.compactor.policy
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = table_rows(torch, gen, dev, DELTAS * DELTA_ROWS, 0)
    rows[:, 3] = np.arange(len(rows)) // DELTA_ROWS
    want = query_a_numpy(rows)
    K.reset_launch_counts()                     # [compaction] starts here
    t0 = time.perf_counter()
    for i in range(DELTAS):
        comp.append_rows("cevents", rows[i * DELTA_ROWS:(i + 1) * DELTA_ROWS])
    append_s = time.perf_counter() - t0
    req = QueryRequest("ops", "cevents", spec_a, tag="cevents/before")
    before = svc.query(req, timeout=1200)
    t0 = time.perf_counter()
    report = comp.compact("cevents")["cevents"]
    compact_s = time.perf_counter() - t0
    after = svc.query(QueryRequest("ops", "cevents", spec_a,
                                   tag="cevents/after"), timeout=1200)
    launches = {k: K.LAUNCHES[k] for k in BATCH_KERNELS}   # ends here
    for r in (before, after):
        if not r.ok or not equal(r.value, want):
            fail(f"[compaction] query a on cevents ({r.tag}) differs from "
                 f"numpy over the appended rows: {r.error}")
    v0, v1 = before.stats.snapshot_version, after.stats.snapshot_version
    if not v1 > v0 >= DELTAS:
        fail(f"[compaction] snapshot version {v0} -> {v1}")
    # groups of up to min(max_group, target / delta) deltas; a last run
    # shorter than min_group stays as it is
    per_group = min(pol.max_group, pol.target_bytes // (DELTA_ROWS * 16))
    full, rest = divmod(DELTAS, per_group)
    merged = full + (rest >= pol.min_group)
    left = 0 if rest >= pol.min_group else rest
    blocks = comp.manifest("cevents").snapshot().entries
    if (report.blocks_in != DELTAS - left or report.blocks_out != merged
            or len(blocks) != merged + left
            or sum(e.rows for e in blocks) != len(rows)):
        fail(f"[compaction] {report.blocks_in} deltas into "
             f"{report.blocks_out} blocks, manifest {len(blocks)}; "
             f"expected {DELTAS - left} into {merged}, {left} left")
    if launches["fused_filter_aggregate"] <= 0:
        fail("[compaction] fused_filter_aggregate was not launched")
    log(f"[compaction] {DELTAS} deltas x {DELTA_ROWS} rows x 4 int32 "
        f"({rows.nbytes} B) appended in {append_s:.3f} s = "
        f"{DELTAS / append_s:.1f} appends/s, {rows.nbytes / append_s:.1f} "
        f"B/s; compact {compact_s:.3f} s into {report.blocks_out} blocks of "
        f"{sorted({e.nbytes for e in blocks})} B (policy: max_group "
        f"{pol.max_group}, target {pol.target_bytes} B); query a before "
        f"{before.trace['total_s']:.3f} s ({before.stats.partitions} "
        f"partitions, snapshot {v0}), after {after.trace['total_s']:.3f} s "
        f"({after.stats.partitions}, snapshot {v1}); both equal numpy")
    comp.close()
    return launches


def kernel_event_times(torch, run):
    """Run ``run()`` with CUDA events around every B5, B6 and B7 wrapper
    call the model layers make; returns (run's value, ms summed per
    kernel)."""
    from repro_torch.models import attention as MA
    from repro_torch.models import rglru as MR
    from repro_torch.models import ssm as MS
    targets = ((MA, "flash_attention"), (MR, "rglru_scan"),
               (MS, "ssd_scan"))
    saved = [getattr(mod, name) for mod, name in targets]
    pairs = {name: [] for _, name in targets}

    def timed(name, fn):
        def call(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            val = fn(*a, **kw)
            e.record()
            pairs[name].append((s, e))
            return val
        return call
    try:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, timed(name, fn))
        value = run()
    finally:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    return value, {n: sum(s.elapsed_time(e) for s, e in ps)
                   for n, ps in pairs.items()}


def profile_decode(torch, step, n, tag="serve"):
    """[serve] ``n`` decode steps under torch.profiler: wall ms per step
    (host clock, synchronised), device ms per step (CUDA kernel self
    time), kernels per step and the three costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3 / n
    if dev_ms <= 0:
        log(f"[{tag}] decode profile: the profiler saw no device time "
            "(not measured)")
        return
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:3]
    log(f"[{tag}] decode profile ({n} steps, torch.profiler): wall "
        f"{wall_ms:.3f} ms/step, device busy {dev_ms:.3f} ms/step = "
        f"{dev_ms / wall_ms:.4f} of the wall, "
        f"{sum(e.count for e in kern) / n:.0f} kernels/step; costliest: " +
        "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.3f} "
                  f"ms/step x{e.count // n}" for e in top))


KERNEL_TAGS = {"flash_attention": "B5", "ssd_scan": "B6", "rglru_scan": "B7"}


def phase_serve(torch, ext, cfg, dev, *, tag="serve",
                expect_params=SERVE_PARAMS, batch=SERVE_BATCH,
                prompt=SERVE_PROMPT, gen=SERVE_GEN):
    """[serve] recurrentgemma-9b (or, as [serve-ssm], mamba2-130m) at
    full width through the port's Server: weights drawn on the card from
    torch.Generator seed 0, ``batch`` prompts of ``prompt`` tokens (numpy
    seed 0), ``gen`` greedy tokens.  The prefill must launch B5 once per
    attention layer, B7 once per RG-LRU layer and B6 once per SSD layer,
    and no other; the kernel path's logits must agree with the plain
    path's on the same weights (one copy on the card) at prefill and at
    every decode step fed the served tokens; the token log must read
    back.  Returns the launches of the kernels the model runs."""
    import numpy as np
    from repro_torch.core import FunctionShipper
    from repro_torch.launch.serve import Server
    from repro_torch.models import model as mdl
    from repro_torch.models.transformer import stack_kinds
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    if tf32[0]:
        fail(f"[{tag}] TF32 matmuls are on; the kernel and plain paths "
             "would differ for a reason that is neither")
    kinds = [k for ks in stack_kinds(cfg).values() for k in ks]
    want_launches = {
        "flash_attention": kinds.count("local") + kinds.count("global"),
        "rglru_scan": kinds.count("rglru"), "ssd_scan": kinds.count("ssd")}
    used = [k for k in MODEL_KERNELS if want_launches[k]]
    n_params = mdl.count_params_analytic(cfg)
    if n_params != expect_params:
        fail(f"[{tag}] {cfg.name} counts {n_params} parameters, expected "
             f"{expect_params}")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_real, (batch, prompt)).astype(np.int32)
    max_len = prompt + gen + 8
    root = ROOT / ".chip_smoke" / tag
    remove_store(root)
    try:
        torch.cuda.synchronize(dev)             # the device's context is up
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        srv = Server(cfg, root, device=dev, max_len=max_len)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        held = sum(t.numel() for t in mdl.leaves(srv.params))
        if held != n_params:
            fail(f"[{tag}] the server holds {held} parameters, not "
                 f"{n_params}")
        log(f"[{tag}] {cfg.name}: {held} f32 parameters "
            f"({torch.cuda.memory_allocated(dev)} B on the card) drawn in "
            f"{init_s:.3f} s; TF32 allow matmul {tf32[0]} cudnn {tf32[1]} "
            f"float32 matmul precision {tf32[2]!r}; batch {batch} x "
            f"{prompt} prompt tokens, {gen} generated")
        ext.reset_launch_counts()               # the served path starts here
        (out, stats), kms = kernel_event_times(torch, lambda: srv.generate(
            prompts, gen, keep_logits=True))
        launches = {k: ext.LAUNCHES[k] for k in MODEL_KERNELS}  # ends here
        peak = torch.cuda.max_memory_allocated(dev)
        srv.close()
        if launches != want_launches:
            fail(f"[{tag}] one prefill launched {launches}, expected "
                 f"{want_launches}")
        logits = stats.pop("logits")
        if out.shape != (batch, gen) or not all(
                bool(torch.isfinite(x).all()) and x.shape == (
                    batch, cfg.vocab_size) for x in logits):
            fail(f"[{tag}] tokens or logits of the wrong shape, or "
                 "non-finite logits")
        prefill_ms = stats["prefill_s"] * 1e3
        log(f"[{tag}] kernel path: prefill {stats['prefill_s']:.3f} s "
            f"({batch * prompt / stats['prefill_s']:.1f} "
            f"prompt tok/s), decode {stats['decode_s']:.3f} s = "
            f"{stats['tok_per_s']:.2f} tok/s ({batch} x {gen}); "
            f"launches in the prefill {json.dumps(launches)}; device ms "
            + ", ".join(f"in {KERNEL_TAGS[k]} {kms[k]:.3f} = "
                        f"{kms[k] / prefill_ms:.4f}" for k in used)
            + f" of the prefill; peak card memory {peak} B")

        # the token log, streamed into Clovis during decode
        cl = srv.clovis
        toks = np.frombuffer(cl.get("stream/tokens"), np.int32)
        if not np.array_equal(toks.reshape(gen, batch), out.T):
            fail(f"[{tag}] the token log in Clovis differs from the "
                 "generated tokens")
        sh = FunctionShipper(cl)
        try:
            hist = sh.ship("histogram", "stream/tokens")
        finally:
            sh.shutdown()
        if not hist.ok or int(np.asarray(hist.value).sum()) != toks.nbytes:
            fail(f"[{tag}] histogram over the token log failed: {hist}")
        log(f"[{tag}] token log stream/tokens in container servelog: "
            f"{toks.nbytes} B equal to the generated tokens; in-storage "
            f"histogram (FunctionShipper) {np.asarray(hist.value)[:8]}...")

        # the plain path on the same weights: prefill, then decode fed
        # the kernel path's tokens
        torch.cuda.reset_peak_memory_stats(dev)
        cache = mdl.init_decode_state(cfg, batch, max_len,
                                      dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        plain, cache = mdl.prefill(srv.params, {"tokens": prompts}, cfg,
                                   cache, use_kernels=False)
        torch.cuda.synchronize(dev)
        plain_s = time.perf_counter() - t0
        rel, agree = [], 0
        for i in range(gen + 1):
            if i:
                plain, cache = mdl.decode_step(
                    srv.params, torch.from_numpy(out[:, i - 1:i]),
                    prompt + i - 1, cfg, cache)
            scale = float(plain.abs().max())
            r = float((logits[i] - plain).abs().max()) / scale
            rel.append(r)
            agree += int((logits[i].argmax(-1) == plain.argmax(-1)).sum())
            if not r <= SERVE_LOGIT_RTOL:
                fail(f"[{tag}] step {i}: kernel and plain logits differ by "
                     f"{r:.3e} of the largest |logit| (limit "
                     f"{SERVE_LOGIT_RTOL})")
        profile_decode(torch, lambda i: mdl.decode_step(
            srv.params, plain.argmax(-1)[:, None], prompt + gen + i, cfg,
            cache), PROFILE_STEPS, tag)
        log(f"[{tag}] plain path (use_kernels=False: the reference's dense "
            f"attention, log-depth scan and chunked SSD) on the same "
            f"weights: prefill {plain_s:.3f} s, peak card memory "
            f"{torch.cuda.max_memory_allocated(dev)} B; max |kernel - "
            f"plain| / max |logit| at prefill {rel[0]:.3e}, over the {gen} "
            f"decode steps {max(rel[1:]):.3e} (limit {SERVE_LOGIT_RTOL}); "
            f"greedy choices agree {agree}/{batch * (gen + 1)}")
        del srv, cache, plain, logits
        torch.cuda.empty_cache()
        return {k: launches[k] for k in used}
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
    from repro_torch.configs import get_config
    from repro_torch.core import Clovis
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import rglru as KR
    from repro_torch.kernels import ssd as KS
    from repro_torch.percipience import heat as H
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    smi = phase_card_and_build(torch, _ext)
    chk = phase_kernels(torch, K, col, dev)
    phase_heat(torch, H, chk, dev)
    phase_model_kernels(torch, KA, KR, KS, chk, dev)
    timing = phase_timing(torch, K, H, KA, KR, KS, col, dev)
    phase_heat_split(torch, H, dev)
    launches, per_query, main_values = phase_main_path(torch, K, col,
                                                       Clovis, dev)
    phase_percip_store(torch, H, K, dev)
    # [percip] ends here: heat_scan launches of both percipience phases
    launches["heat_scan"] = K.LAUNCHES["heat_scan"]
    log(f"[percip] heat_scan launches over the [percip] phases: "
        f"{launches['heat_scan']}")
    if launches["heat_scan"] <= 0:
        fail("heat_scan was not launched on the percipience path")
    stream = phase_stream(torch, K, col, dev)
    cluster = phase_cluster(torch, K, col, dev, main_values)
    served = phase_serving(torch, K, col, dev, main_values)
    launches.update(phase_serve(
        torch, _ext, get_config(SERVE_ARCH).scaled(dtype="float32"), dev))
    launches.update(phase_serve(
        torch, _ext, get_config(SSM_ARCH).scaled(dtype="float32"), dev,
        tag="serve-ssm", expect_params=SSM_PARAMS, batch=SSM_BATCH,
        prompt=SSM_PROMPT, gen=SSM_GEN))

    rows = []
    for name, (source, replaces) in KERNELS.items():
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": chk.err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    log(f"[main] launches per query: {json.dumps(per_query)}")
    b1 = timing["fused_filter_aggregate"]["shapes"]
    log("[timing] fused_filter_aggregate by main-path shape (device ms a "
        "launch, ms a call with the host's work, launches on the main "
        "path): " + json.dumps({q: [round(r["ms"], 4), round(r["host_ms"], 4),
                                    per_query[q]["fused_filter_aggregate"]]
                                for q, r in b1.items()}))
    log(f"[stream] launches: {json.dumps(stream)}")
    log(f"[cluster] launches: {json.dumps(cluster)}")
    log(f"[serving] launches: {json.dumps(served['serving'])}; "
        f"[compaction] launches: {json.dumps(served['compaction'])}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)                          # nvidia-smi's "name, power.limit"
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

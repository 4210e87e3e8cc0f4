#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

It holds what neither of the two other on-card suites checks.  Each
kernel against its plain version, at edge shapes and at the shapes the
served and trained paths give it, is ``tests/test_torch_cuda.py``
(``pytest -m cuda``), which also lists those served shapes; the
full-width numbers and checks of the benchmark's cells (mamba2-130m
trained on 8 x 2,048 tokens and serving long prompts, qwen2-moe-a2.7b
serving code, each at batch 1) are ``sagebench/``'s.

Phases, in the order they run; any failure exits non-zero, and no
phase's failure is caught:

1. Card and build: the card's name and power limit (nvidia-smi), the
   torch and CUDA versions, the one nvcc build of every
   ``src/repro_torch/csrc/*.cu`` with its ptxas lines (B5, its bf16
   kernel and B7 must not spill; B1 and B2 must keep no stack frame),
   and the count of tensor-core instructions (HMMA, HGMMA) and TMA loads
   (UTMALDG) in the SASS of the flash-attention and SSD kernels
   (cuobjdump): the bf16 kernels of B5 and B6 must hold HGMMA.
2. ``[timing]``: each kernel timed on the device (CUDA events, the card
   kept busy while the host enqueues) at the shape its path gives it,
   beside its bound, its plain version and, where one exists, one
   PyTorch library call (B5 also at every served shape, in f32 and on
   bf16 inputs through its bf16 kernel, and at MLA's prefill shape
   through ``mla.attend_kernel``'s zero padding, held to
   ``mla._attend_plain`` and bounded at the model's widths; B6 on bf16
   inputs too, each B6
   call split into its launches; the slot-skipping MoE expert kernel at
   qwen2-moe's decode shape and the sweep behind
   ``moe.DECODE_MAX_SLOTS``; B6's backward kernel at ``[train]``'s
   shape beside the plain recompute it replaced).  Each timed kernel's
   output is held once
   to its plain version's on the same inputs, at the card tests'
   limits (``held``).  Bounds take bytes at the HBM rate and
   B5's and B6's operations at the tensor cores' peaks, B6's counted
   step by step, as ``sagebench/counts.py`` counts them; the others'
   operations at f32's 67 TFLOP/s.  One ``heat_scores`` call at 262,144
   objects is split into its host and device parts.
3. The main path at full size: a store of 16 partitions x 4,194,304
   rows x 4 int32 columns (1 GiB, made from torch.Generator seed 0) and
   queries (a)-(d) through ``Clovis.analytics()``; each result must
   equal the ``use_kernels=False`` (numpy reference) engine's exactly,
   and every kernel must have launched.  Then ``[percip]``: query (a)
   again after ``enable_percipience()`` (equal result, heat kernel
   launched), and the percipience benchmark's traces cut to 512
   objects and 1,024 reads, predictive against reactive, with the
   policy's heat held against the numpy closed form.
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
6. ``[edge]``: ``benchmarks/bench_edge.py``'s hostile schedule (seed
   2026, 4 producers, 1,200 events, 3 crashes: duplicates, reordering,
   poison, a torn tail) through the port's ``EdgeIngestor`` into a
   continuous ``EventWindow`` sum on the card, with ``tests/chaos.py``'s
   harness loaded over ``repro_torch.edge``; streaming windows plus late
   adjustments must equal the batch query and the schedule's sums, the
   dead letters the poison injected; B2 must launch.
7. The full-width models that no benchmark cell serves (and the cells'
   two at batch 4), each through
   ``repro_torch.launch.serve.Server`` with weights drawn on the card
   from seed 0 and prompts from numpy seed 0.  ``[serve]``:
   recurrentgemma-9b (9,627,414,528 f32 parameters) serves 4 prompts of
   4,000 tokens and 32 greedy tokens; its prefill must launch B5 12 and
   B7 26 times, its logits must agree with the ``use_kernels=False``
   path on the same weights at prefill and at every decode step (within
   ``SERVE_LOGIT_RTOL`` of the step's largest |logit|) with equal greedy
   tokens, and the token log must read back from Clovis.
   ``[serve-mla]``: deepseek-v3-671b, its depth cut to its 3 dense
   layers and 1 MoE layer (256 experts, top 8 within 4 of 8 groups,
   sigmoid router with its bias, gates x 2.5; YaRN) and no MTP
   (15,111,101,696 f32 parameters), serves 2 prompts of 1,024 tokens and
   16 greedy tokens; its prefill launches B5 once a layer (MLA's q/k and
   v heads zero-padded to head dim 256), and its eager decode must
   launch the MoE expert kernel; instead of a plain path it is held to the
   reference's own invariant: on the same weights at capacity E/k
   (lossless), 1 prompt of 256 tokens, prefill plus 8 absorbed decode
   steps give the expanded form's full-forward logits over the prompt
   and the fed tokens (within ``SERVE_LOGIT_RTOL``).
   ``[serve-whisper]``: whisper-large-v3 uncut (1,392,056,320 f32
   parameters) serves 4 prompts of 384 tokens and 32 greedy tokens with
   4 x 1,500 frames drawn after the prompts (the reference's stub
   frontend); its decoder is 32 ``global`` blocks that never read the
   encoder (as in the reference), so its prefill launches B5 32 times,
   and the encoder is driven on its own over the frames (32 non-causal
   B5 launches) against its plain path.  ``[serve-vision]``:
   llama-3.2-vision cut to 10 layers (8 global, 2 gated cross;
   10,657,899,012 f32 parameters), both gates of each cross layer set
   to 0.5 after the seeded init (at 0 a cross layer is the identity),
   4 x 1,601 image embeddings, 4 prompts of 1,024 tokens and 32 greedy
   tokens: B5 10 times a prefill, the same checks, and other image
   embeddings must move the prefill logits by more than
   ``MEMORY_MOVE_RTOL``.  ``[serve-bf16]``: mamba2-130m (B6; 4 prompts
   of 16,000 tokens, decode replayed from a CUDA graph) and
   whisper-large-v3 (B5) in their configs' default bf16, through the
   bf16 kernels (``attention_bf16.cu``, ``ssd_bf16.cu``; the f32 ones
   never launch): every block (and whisper's encoder blocks) run through
   the kernels and through the plain path on the same bf16 input,
   within ``BF16_LAYER_RTOL`` of the block's largest |value|; and the
   kernel path's logits (and encoder output) no farther from the plain
   f32 path on the same weights than the plain bf16 path's, by more
   than ``BF16_F32_MARGIN`` of that distance (|a - b| / |b|, averaged
   over the steps).  ``[serve-ssm]`` and ``[serve-moe]``: the cells'
   models at batch 4, where their cells serve batch 1, the same checks
   in f32: mamba2-130m (128,983,488 parameters) on 4 prompts of 16,000
   tokens, B6 24 times a prefill; qwen2-moe-a2.7b at full width and
   depth (14,315,784,192 parameters; 24 MoE layers of 60 routed
   experts, top 4, and 4 shared) on 4 prompts of 4,000 tokens, B5 24
   times a prefill and the MoE expert kernel in its decode, whose
   greedy tokens may differ from the plain path's at a routing near-tie
   (C19).  Each decodes from a CUDA graph, so each decode step's logits
   are the graph's, held to the plain path's eager steps.
8. ``[train]``: mamba2-130m at full width and depth in f32 (seed 0)
   trained through ``repro_torch.launch.train.Trainer`` on 8 x 2,048
   tokens a step from a corpus in Clovis, B6 in every forward pass and
   its backward kernel in every backward pass (24 launches a step each):
   steps 1-20 with stream checkpoints; a T1 device
   killed and repaired by HA; a new Trainer restores step 20 bit for
   bit against a host snapshot and trains steps 21-40; the loss must
   fall.  Then one checkpoint of the whole state (params, m, v) with
   each of the collective, window and stream strategies, each restored
   bit for bit.
9. ``[dist]``: qwen2.5-32b at full width (d_model 5,120, 40 heads over
   8 KV heads, hd 128, d_ff 27,648, vocab 152,064) cut to 2 of its 64
   layers (2,532,350,976 f32 parameters), 2 x 2,048 tokens a step from
   a Clovis corpus, 3 steps through the plain ``Trainer`` and then,
   from the same seed on the same batches, through the ``Trainer`` on a
   world-size-1 NCCL process group's 1 x 1 ``("data", "model")`` mesh
   (``DTensor`` parameters and AdamW state): the losses within
   ``DIST_LOSS_RTOL`` relative, B5 two launches a forward.  The dry run
   of the same cell on a fake 1 x 1 group (``repro_torch.launch.dryrun``)
   must hold the state the mesh Trainer holds on the card, byte for
   byte.
10. One JSON line of per-kernel numbers, then the contract's last line.

It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import datetime
import gc
import hashlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PARTS, ROWS, KEYS, WINDOW = 16, 4_194_304, 4096, 4096
BINS = 32                      # query (c)'s histogram
HEAT_HIST, HEAT_OBJS = 64, 262_144   # extractor hist_len x tracked objects
# [percip]: bench_percipience.py's traces cut from its 1,024 objects and
# 2,048 reads to 512 and 1,024 (still two passes of the sequential and
# strided traces), for the run's time limit
PERCIP_OBJS, PERCIP_BYTES, PERCIP_READS, SCAN_EVERY = 512, 64 << 10, 1024, 16
STREAM_ELEMS, STREAM_ROWS, STREAM_PRODUCERS = 4096, 4096, 4
STREAM_WINDOW_S, STREAM_DELTA = 0.256, 262_144
CLUSTER_NODES, CLUSTER_REPLICAS = 4, 2
TENANTS, SERVED = ("ops", "science"), ("a_mean", "b_count", "c_histogram")
DELTAS, DELTA_ROWS = 256, 4096  # [compaction]: 64 KiB deltas, 16 MiB
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
SERVE_LOGIT_RTOL = 1e-3        # kernel vs plain path, of the step's max |logit|
SERVE_ARCH, SERVE_PARAMS = "recurrentgemma-9b", 9_627_414_528
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4000, 32
SSM_ARCH, SSM_PARAMS = "mamba2-130m", 128_983_488
SSM_BATCH, SSM_PROMPT, SSM_GEN = 4, 16000, 32   # 16,000 = 62.5 chunks
MOE_ARCH, MOE_PARAMS = "qwen2-moe-a2.7b", 14_315_784_192
MOE_BATCH, MOE_PROMPT, MOE_GEN = 4, 4000, 32
# the slot-skipping expert kernel at qwen2-moe's decode shape, swept
# against the batched products over every expert
MOE_DECODE_SWEEP = (1, 2, 4, 8, 16, 32, 64)
MLA_ARCH, MLA_PARAMS = "deepseek-v3-671b", 15_111_101_696
MLA_CUT = dict(n_layers=4, mtp_depth=0)   # 3 dense + 1 MoE layer, no MTP
MLA_BATCH, MLA_PROMPT, MLA_GEN = 2, 1024, 16
MLA_CHECK_PROMPT, MLA_CHECK_STEPS = 256, 8   # the lossless invariant's run
WHISPER_ARCH, WHISPER_PARAMS = "whisper-large-v3", 1_392_056_320
# 384 + 32 = 416 of whisper's 448 decoder positions
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN = 4, 384, 32
VISION_ARCH, VISION_PARAMS = "llama-3.2-vision-90b", 10_657_899_012
VISION_CUT = dict(n_layers=10)  # 2 periods of 4 global + 1 cross layer
VISION_BATCH, VISION_PROMPT, VISION_GEN = 4, 1024, 32
VISION_GATE = 0.5              # both tanh gates of a cross layer (0 at init)
MEMORY_MOVE_RTOL = 1e-2        # other image embeddings must move the prefill
                               # logits by more, of the largest |logit|
BF16_LAYER_RTOL = 3e-2         # bf16: one block through the kernels vs
                               # plain on the same input, of its max |value|
BF16_F32_MARGIN = 0.1          # bf16: the kernel path's mean distance from
                               # the f32 path may exceed the plain bf16
                               # path's by this share of it
# [edge]: benchmarks/bench_edge.py's schedule and windows
EDGE_SEED, EDGE_PRODUCERS, EDGE_EVENTS, EDGE_CRASHES = 2026, 4, 1200, 3
EDGE_WINDOW_S, EDGE_REORDER_S, EDGE_LATENESS_S = 1.0, 0.4, 0.5
# [train]: mamba2-130m, 8 x 2,048 tokens a step, 20 steps, a restart, 20
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = SSM_ARCH, 8, 2048
TRAIN_STEPS, TRAIN_RESTART = 40, 20
HOST_COVER_CYCLES = 2_000_000  # ~1 ms of card spin ahead of each timed call
# [dist]: qwen2.5-32b at full width cut to 2 of its 64 layers, 2 x 2,048
# tokens a step, 3 steps: the plain Trainer, then the mesh Trainer on a
# world-size-1 NCCL 1 x 1 mesh from the same seed on the same batches
DIST_ARCH, DIST_CUT, DIST_PARAMS = "qwen2.5-32b", dict(n_layers=2), \
    2_532_350_976
DIST_BATCH, DIST_SEQ, DIST_STEPS = 2, 2048, 3
DIST_LOSS_RTOL = 1e-6          # mesh vs plain Trainer loss, relative
ANALYTICS_CU = "src/repro_torch/csrc/analytics_kernels.cu"
MODEL_CU = "src/repro_torch/csrc/model_kernels.cu"
SSM_CU = "src/repro_torch/csrc/ssm_kernels.cu"
ATTN_BF16_CU = "src/repro_torch/csrc/attention_bf16.cu"
SSD_BF16_CU = "src/repro_torch/csrc/ssd_bf16.cu"
SSD_BWD_CU = "src/repro_torch/csrc/ssd_bwd.cu"
MOE_CU = "src/repro_torch/csrc/moe_decode.cu"
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
    "flash_attention_bf16": (ATTN_BF16_CU,
                             "src/repro/kernels/flash_attention.py:36"),
    "ssd_scan_bf16": (SSD_BF16_CU, "src/repro/kernels/ssd_scan.py:32"),
    "moe_experts_decode": (MOE_CU, "none: the reference's MoE runs through "
                           "jnp (src/repro/models/moe.py)"),
    "ssd_scan_bwd": (SSD_BWD_CU, "none: the reference takes jax.grad of "
                     "ssd_chunked (src/repro/models/ssm.py:93)"),
}
MODEL_KERNELS = ("flash_attention", "rglru_scan", "ssd_scan",
                 "flash_attention_bf16", "ssd_scan_bf16")
# the served run whose launches a model kernel's row of the kernels line
# reads: the one at the shape [timing] times it at
LAUNCHED_IN = {"flash_attention": "serve", "rglru_scan": "serve",
               "ssd_scan": "serve-ssm", "moe_experts_decode": "serve-moe",
               "flash_attention_bf16": "serve-bf16",
               "ssd_scan_bf16": "serve-bf16"}
# the kernel a wrapper launches on bf16 inputs, by its f32 kernel's name
BF16_KERNELS = {"flash_attention": "flash_attention_bf16",
                "ssd_scan": "ssd_scan_bf16"}
# kernels whose SASS must hold tensor-core instructions: the f32 ones
# HMMA (mma.sync), the bf16 ones HGMMA (wgmma)
HMMA_KERNELS = ("flash_attention_kernel", "ssd_state_kernel",
                "ssd_out_kernel", "ssd_bwd_dstate_kernel",
                "ssd_bwd_chunk_kernel")
HGMMA_KERNELS = ("flash_attention_bf16_kernel", "ssd_state_bf16_kernel",
                 "ssd_out_bf16_kernel")
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
                                        "flash_attention_bf16_kernel",
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
    """Count the tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma)
    and TMA loads (UTMALDG) in the SASS of the flash-attention (B5) and
    SSD (B6) kernels, where the toolkit has cuobjdump; every one of their
    kernels that multiplies must have some, the bf16 ones HGMMA."""
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
                counts[fn] = {"HMMA": 0, "HGMMA": 0, "UTMALDG": 0}
        elif fn in counts:
            for op in ("HGMMA", "HMMA", "UTMALDG"):
                if f"{op}." in line:
                    counts[fn][op] += 1
    log(f"[build] tensor-core instructions (HMMA/HGMMA) and TMA loads "
        f"(UTMALDG) in the SASS of the flash-attention and SSD kernels: "
        f"{json.dumps(counts)}")
    for op, names in (("HMMA", HMMA_KERNELS), ("HGMMA", HGMMA_KERNELS)):
        for mma in names:
            if not any(v[op] > 0 for k, v in counts.items() if mma in k):
                fail(f"{mma} has no {op} instruction in its SASS")


# ---------------------------------------------------------------------------
# phase 2: timing at the main path's shapes
# ---------------------------------------------------------------------------

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


def held(name, got, want, limit=0.0):
    """The largest |got - want| of a kernel's output against its plain
    version's on the same inputs; fail() where it passes ``limit`` (a
    number or a tensor that broadcasts; 0 is bit for bit)."""
    err = (got.double() - want.double()).abs()
    if got.shape != want.shape or not bool((err <= limit).all()):
        fail(f"[timing] {name}: the kernel departs from its plain version "
             f"by up to {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def attn_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask leaves visible, positions = indices."""
    n = 0
    for i in range(sq):
        hi = min(sk, i + 1) if causal else sk
        lo = max(0, i - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def moe_decode_params(torch, dev):
    """qwen2-moe-a2.7b's routed experts of one layer at full width in f32
    (E 60, d 2,048, f 1,408: 2.08 GB), drawn on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(MOE_ARCH).scaled(dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(7)
    return cfg, moe.init_moe(gen, cfg, device=dev)


def moe_decode_case(torch, dev, cfg, params, b, dtype="float32"):
    """A single-token group of b tokens routed and dispatched as
    ``moe_block`` does (x drawn from numpy seed b), the experts in
    ``dtype`` -> (p, xd (E, C, d), valid (E, C))."""
    import numpy as np
    from repro_torch.models import moe
    dt = getattr(torch, dtype)
    p = {k: v.to(dt) if k.startswith("w_") else v for k, v in params.items()}
    x = torch.from_numpy(np.random.default_rng(b).standard_normal(
        (1, b, cfg.d_model)).astype(np.float32)).to(dev)
    tok_idx, weight, _, _, _ = moe._route(p, x, cfg, moe.capacity(cfg, b))
    return p, moe._dispatch(x.to(dt), tok_idx), weight[0] != 0


def moe_decode_timing(torch, dev):
    """[timing] the slot-skipping expert kernel at qwen2-moe's decode shape
    (batch 1, the kernels line's row, and 4; f32 and, at batch 1, bf16)
    beside its plain version and, as the library, the batched products
    over all 60 experts that it replaces (``moe._expert_ffn``); then the
    sweep over ``MOE_DECODE_SWEEP`` that set ``moe.DECODE_MAX_SLOTS``.
    Bound: the kept experts' weights, their slots' x and the whole y, at
    3.35 TB/s."""
    from repro_torch.models import moe
    cfg, params = moe_decode_params(torch, dev)
    out, sweep = {}, []
    for b, dtype, name in ((1, "float32", "moe_experts_decode"),
                           (4, "float32", "moe_experts_decode@b4"),
                           (1, "bfloat16", "moe_experts_decode@b1-bf16")):
        p, xd, valid = moe_decode_case(torch, dev, cfg, params, b, dtype)
        ws = [p[k] for k in ("w_gate", "w_up", "w_down")]
        e, c, d = xd.shape
        kept, width = int(valid.any(-1).sum()), xd.element_size()
        got = moe.expert_ffn_decode(xd, *ws, valid, cfg.act,
                                    max_kept=b * cfg.top_k)[0]
        want = moe.expert_ffn_decode_plain(xd, *ws, valid, cfg.act)[0]
        rtol = 1e-5 if dtype == "float32" else 2e-2    # of the largest |y|
        out[name] = dict(
            max_abs_err=held(name, got, want,
                             rtol * float(want.float().abs().max())),
            ms=device_ms(torch, lambda: moe.expert_ffn_decode(
                xd, *ws, valid, cfg.act, max_kept=b * cfg.top_k)),
            plain_ms=device_ms(torch, lambda: moe.expert_ffn_decode_plain(
                xd, *ws, valid, cfg.act)),
            library_ms=device_ms(torch, lambda: moe._expert_ffn(p, xd, cfg)),
            bound_bytes=width * (kept * 3 * d * cfg.d_expert + kept * c * d
                                 + e * c * d),
            shape=f"E={e} C={c} d={d} f={cfg.d_expert} batch {b}, {kept} "
            f"experts kept, {dtype}; library = bmm over all {e} experts")
        del p, xd, valid, ws, got, want
    for b in MOE_DECODE_SWEEP:
        p, xd, valid = moe_decode_case(torch, dev, cfg, params, b)
        ws = [p[k] for k in ("w_gate", "w_up", "w_down")]
        k_ms = device_ms(torch, lambda: moe.expert_ffn_decode(
            xd, *ws, valid, cfg.act, max_kept=b * cfg.top_k))
        lib_ms = device_ms(torch, lambda: moe._expert_ffn(p, xd, cfg))
        sweep.append((b, xd.shape[1], int(valid.any(-1).sum()), k_ms, lib_ms))
        del p, xd, valid, ws
    log("[timing] moe decode sweep (qwen2-moe-a2.7b, f32, device ms; "
        "DECODE_MAX_SLOTS " + str(moe.DECODE_MAX_SLOTS) + "): " + "; ".join(
            f"batch {b} C {c} read {k} of {cfg.n_experts}: kernel "
            f"{km:.4f}, bmm {lm:.4f} ({lm / km:.2f}x)"
            for b, c, k, km, lm in sweep))
    return out


def phase_timing(torch, K, H, KA, KR, KS, col, dev):
    """Each kernel at the shape its path gives it: B1 as query (a)'s
    fused pass, B2 as query (c)'s histogram count, B3 as query (d)'s
    window max (one partition each), B4 as one heat refresh of 262,144
    tracked objects, B5 and B7 as one local-attention and one RG-LRU
    layer of the [serve] prefill (B5 also at every other served shape,
    MLA's through ``mla.attend_kernel``), B6 as one SSD layer of
    mamba2-130m serving 16,000 prompt tokens.  Bytes and peaks, and B6's
    operations,
    are counted as the benchmark counts them (``sagebench/counts.py``).
    Each kernel's output is held once to its plain version's (``held``)
    at the limits of ``tests/test_torch_cuda.py``, which lists the
    served shapes."""
    from sagebench.counts import HBM_BYTES_PER_S, PEAK_FLOPS, ssd_flops
    sys.path.append(str(ROOT / "tests"))
    from test_torch_cuda import ATTN_SERVED, SCAN_SERVED, SSD_SERVED
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
    # f32 sums within 1e-4 of the kept rows' sum of |v|, the rest equal
    abs_sum = K.segment_reduce_plain(reading.abs().float(),
                                     torch.where(keep, key, -1), KEYS, "sum")
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
        plain = (lambda prog=prog, ts=ts, op=op, dt=dt:
                 K.fused_filter_aggregate_plain(ts, prog, key, KEYS, op, dt))
        (acc, cnt), (pacc, pcnt) = b1(), plain()
        name = f"fused_filter_aggregate {q}"
        err = max(held(name, cnt, pcnt), held(
            name, acc, pacc,
            1e-4 * abs_sum + 1e-6 if dt == torch.float32 else 0.0))
        # ids and the predicate column for every row, the value column for
        # the survivors (by rows, or by the 32-byte sectors that hold one),
        # acc + cnt out
        rows_bytes = 4 * ROWS * 2 + 8 * KEYS
        b1_shapes[q] = dict(
            ms=device_ms(torch, b1), host_ms=device_ms(torch, b1, host=True),
            bound_bytes=rows_bytes + (4 * survivors if spec else 0),
            sector_bytes=rows_bytes + (32 * sectors if spec else 0),
            plain_ms=device_ms(torch, plain), max_abs_err=err)
    a = b1_shapes["a_mean"]
    out["fused_filter_aggregate"] = dict(
        ms=a["ms"], plain_ms=a["plain_ms"], bound_bytes=a["bound_bytes"],
        max_abs_err=a["max_abs_err"],
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
    b2_plain = lambda: K.segment_reduce_plain(  # noqa: E731
        ones, ids, BINS, "count")
    out["segment_reduce"] = dict(
        max_abs_err=held("segment_reduce", b2(), b2_plain()),
        ms=device_ms(torch, b2), plain_ms=device_ms(torch, b2_plain),
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
    b3_plain = lambda: K.window_reduce_plain(  # noqa: E731
        reading, WINDOW, WINDOW, "max")
    out["window_reduce"] = dict(
        max_abs_err=held("window_reduce", b3(), b3_plain()),
        ms=device_ms(torch, b3), plain_ms=device_ms(torch, b3_plain),
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
        max_abs_err=held("heat_scan", H.heat_scan(a, x, device=dev),
                         H.heat_scan_plain(a, x)),
        ms=device_ms(torch, lambda: H.heat_scan(a, x, device=dev)),
        plain_ms=device_ms(torch, lambda: H.heat_scan_plain(a, x)),
        bound_bytes=2 * 4 * HEAT_HIST * HEAT_OBJS + 4 * HEAT_OBJS,
        library_ms=None, shape=f"hist={HEAT_HIST} nobj={HEAT_OBJS} f32")

    # B5: one local-attention layer of the [serve] prefill; the yardstick
    # is SDPA with the same boolean window-causal mask over K/V expanded
    # to every head (the port never calls it)
    import torch.nn.functional as F
    b, h, kv, sq, sk, hd, causal, window, cap = ATTN_SERVED["serve"]
    q, k, v = attn_inputs(torch, gen, dev, b, h, kv, sq, sk, hd)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=cap)
    qi = torch.arange(sq, device=dev)[:, None]
    ki = torch.arange(sk, device=dev)[None, :]
    mask = (ki <= qi) & (ki > qi - window)
    k16, v16 = (t.expand(b, h, sk, hd).contiguous() for t in (k, v))
    pairs = attn_pairs(sq, sk, causal, window)
    flops = 4 * hd * pairs * b * h            # q.k and p.v, 2 each
    want = KA.flash_attention_plain(q, k, v, **kw)
    out["flash_attention"] = dict(
        max_abs_err=held("flash_attention", KA.flash_attention_kernel(
            q, k, v, **kw), want, 1e-4 * want.abs().amax(-1, keepdim=True)),
        ms=device_ms(torch, lambda: KA.flash_attention_kernel(q, k, v, **kw)),
        plain_ms=device_ms(torch, lambda: KA.flash_attention_plain(
            q, k, v, **kw)),
        library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k16, v16, attn_mask=mask, scale=kw["scale"])),
        bound_bytes=4 * (2 * q.numel() + k.numel() + v.numel()),
        # f32 operands take the tensor cores' TF32 rate; the kernel's
        # three products each (3xTF32) are its own cost, as B6's
        bound_flops=flops, flops_rate=PEAK_FLOPS["float32"],
        shape=f"b={b} h={h} kv={kv} s={sq} hd={hd} "
        f"window={window} f32 ({pairs} visible pairs per head)")
    del q, k, v, k16, v16, mask, want

    # B5 at the other served shapes (ATTN_SERVED) in f32, then at every
    # one on bf16 inputs (the configs' default dtype, through
    # attention_bf16.cu, held to the plain version's f32 result on the
    # same values plus one bf16 rounding of |o|; the bound reads and writes 2-byte elements at the
    # bf16 tensor-core rate); the yardstick is SDPA's causal or unmasked
    # form over K/V expanded to every head, or at [serve]'s shape its
    # window-causal boolean mask; MLA's shape is timed on its own route
    # below
    others = [name for name in ATTN_SERVED if name != "mla"]
    served = [(name, False) for name in others if name != "serve"]
    for name, bf16 in served + [(name, True) for name in others]:
        b, h, kv, sq, sk, hd, causal, window, cap = ATTN_SERVED[name]
        q, k, v = attn_inputs(torch, gen, dev, b, h, kv, sq, sk, hd)
        if bf16:
            q, k, v = (t.bfloat16() for t in (q, k, v))
        kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                  softcap=cap)
        kx, vx = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
        if window:
            mask = (ki <= qi) & (ki > qi - window)
            sdpa = dict(attn_mask=mask)
        else:
            sdpa = dict(is_causal=causal)
        pairs = attn_pairs(sq, sk, causal, window)
        size = 2 if bf16 else 4
        want = KA.flash_attention_plain(q.float(), k.float(), v.float(),
                                        **kw)
        limit = 1e-4 * want.abs().amax(-1, keepdim=True)
        if bf16:        # and one bf16 rounding of the output
            limit = limit + 2.0 ** -8 * want.abs()
        row = f"flash_attention@{name}" + ("@bf16" if bf16 else "")
        out[row] = dict(
            max_abs_err=held(row, KA.flash_attention_kernel(q, k, v, **kw),
                             want, limit),
            ms=device_ms(torch, lambda: KA.flash_attention_kernel(
                q, k, v, **kw)),
            plain_ms=device_ms(torch, lambda: KA.flash_attention_plain(
                q, k, v, **kw)),
            library_ms=device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, kx, vx, scale=kw["scale"], **sdpa)),
            bound_bytes=size * (2 * q.numel() + k.numel() + v.numel()),
            bound_flops=4 * hd * pairs * b * h,
            flops_rate=PEAK_FLOPS["bfloat16" if bf16 else "float32"],
            shape=f"b={b} h={h} kv={kv} sq={sq} sk={sk} hd={hd} "
            f"{'causal' if causal else 'non-causal'}"
            f"{f' window={window}' if window else ''}, "
            f"{'bf16' if bf16 else 'f32'} ({pairs} visible pairs per head)")
        del q, k, v, kx, vx, sdpa, want, limit
    del qi, ki
    # the bf16 kernel's row of the kernels line: whisper's encoder, where
    # [serve-bf16] spends most of its B5 time
    out["flash_attention_bf16"] = out["flash_attention@whisper-encoder@bf16"]
    out["flash_attention@mla"] = mla_attention_timing(torch, gen, dev,
                                                      ATTN_SERVED["mla"])

    b, s_, h, p, n, g, chunk, with_s0 = SSD_SERVED
    args = list(ssd_inputs(torch, gen, dev, b, s_, h, p, n, g, with_s0))
    for j in (0, 3, 4):             # x, B, C; dt, a_log and the state f32
        args[j] = args[j].bfloat16()
    io = sum(t.numel() * t.element_size() for t in args if t is not None) \
        + 2 * b * s_ * h * p + 4 * b * h * p * n   # + y (bf16), the state
    # y within 1e-4 of the (batch, head)'s max plus one bf16 rounding of
    # the plain version's f32 result on the same values, the state 1e-4
    y, final = KS.ssd_scan(*args[:5], chunk=chunk, initial_state=args[5])
    wy, wf = KS.ssd_chunked(*(t.float() for t in args[:5]), chunk,
                            initial_state=args[5])
    out["ssd_scan@bf16"] = dict(
        max_abs_err=max(
            held("ssd_scan@bf16 y", y, wy, 1e-4 * wy.abs().amax(
                dim=(1, 3), keepdim=True) + 2.0 ** -8 * wy.abs()),
            held("ssd_scan@bf16 state", final, wf,
                 1e-4 * wf.abs().amax(dim=(2, 3), keepdim=True))),
        ms=device_ms(torch, lambda: KS.ssd_scan(
            *args[:5], chunk=chunk, initial_state=args[5])),
        plain_ms=device_ms(torch, lambda: KS.ssd_chunked(
            *args[:5], chunk, initial_state=args[5])),
        library_ms=None, bound_bytes=io,
        bound_flops=ssd_flops(b, s_, h, p, n),
        flops_rate=PEAK_FLOPS["bfloat16"],
        shape=f"b={b} s={s_} h={h} p={p} n={n} g={g} x, B, C bf16, "
        f"state f32, counted step by step")
    out["ssd_scan_bf16"] = out["ssd_scan@bf16"]
    log_ssd_launches(torch, lambda: KS.ssd_scan(
        *args[:5], chunk=chunk, initial_state=args[5]), "ssd_scan@bf16")
    del args, y, final, wy, wf

    # B7: one RG-LRU layer of the [serve] prefill (h0 from the cache); no
    # one PyTorch call computes a linear recurrence
    b, s_, w, with_h0 = SCAN_SERVED
    a, x, h0 = scan_inputs(torch, gen, dev, b, s_, w, with_h0)
    out["rglru_scan"] = dict(
        max_abs_err=held("rglru_scan", KR.rglru_scan(a, x, h0),
                         KR.rglru_scan_plain(a, x, h0)),
        ms=device_ms(torch, lambda: KR.rglru_scan(a, x, h0)),
        plain_ms=device_ms(torch, lambda: KR.rglru_scan_plain(a, x, h0)),
        library_ms=None, bound_bytes=4 * (3 * a.numel() + h0.numel()),
        shape=f"b={b} s={s_} w={w} f32")
    del a, x, h0

    # B6: one SSD layer of mamba2-130m's prefill (initial state from the
    # cache); no one PyTorch call computes the SSD scan
    b, s_, h, p, n, g, chunk, with_s0 = SSD_SERVED
    args = ssd_inputs(torch, gen, dev, b, s_, h, p, n, g, with_s0)
    io = sum(t.numel() for t in args if t is not None) \
        + b * s_ * h * p + b * h * p * n          # + y and the final state
    # y and the state within 1e-4 of each (batch, head)'s largest |value|
    got = KS.ssd_scan(*args[:5], chunk=chunk, initial_state=args[5])
    want = KS.ssd_chunked(*args[:5], chunk, initial_state=args[5])
    out["ssd_scan"] = dict(
        max_abs_err=max(held(f"ssd_scan {part}", gt, w, 1e-4 * w.abs().amax(
            dim=dims, keepdim=True)) for part, gt, w, dims in (
                ("y", got[0], want[0], (1, 3)),
                ("state", got[1], want[1], (2, 3)))),
        ms=device_ms(torch, lambda: KS.ssd_scan(
            *args[:5], chunk=chunk, initial_state=args[5])),
        plain_ms=device_ms(torch, lambda: KS.ssd_chunked(
            *args[:5], chunk, initial_state=args[5])),
        library_ms=None, bound_bytes=4 * io,
        # f32 operands take the tensor cores' TF32 rate; the kernel's
        # three products each (3xTF32) are its own cost, not the function's
        bound_flops=ssd_flops(b, s_, h, p, n),
        flops_rate=PEAK_FLOPS["float32"],
        shape=f"b={b} s={s_} h={h} p={p} n={n} g={g} f32, counted step "
        f"by step")
    log_ssd_launches(torch, lambda: KS.ssd_scan(
        *args[:5], chunk=chunk, initial_state=args[5]), "ssd_scan")
    del args, got, want
    out["ssd_scan_bwd"] = ssd_bwd_timing(torch, KS, gen, dev)
    out.update(moe_decode_timing(torch, dev))

    for name, r in out.items():
        if name in BF16_KERNELS.values():
            continue                    # logged under its shape's name
        bytes_ms = r["bound_bytes"] / HBM_BYTES_PER_S * 1e3
        rate = r.get("flops_rate", F32_FLOPS)
        ops_ms = r.get("bound_flops", 0) / rate * 1e3
        r["bound_ms"] = max(bytes_ms, ops_ms)
        r["bound_by"] = "operations" if ops_ms > bytes_ms else "bytes"
        extra = ""
        if "bound_flops" in r:
            tf32_ms = r["bound_flops"] / PEAK_FLOPS["float32"] * 1e3
            extra = (f"; {r['bound_flops']} FLOP at {rate:.4g}/s = "
                     f"{ops_ms:.4f} ms; at the f32 rate {F32_FLOPS:.3g}/s "
                     f"{r['bound_flops'] / F32_FLOPS * 1e3:.4f} ms, at the "
                     f"TF32 tensor-core rate {tf32_ms:.4f} ms, at 3xTF32 "
                     f"{3 * tf32_ms:.4f} ms; achieved "
                     f"{r['bound_flops'] / r['ms'] / 1e9:.2f} TFLOP/s")
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


def mla_attention_timing(torch, gen, dev, shape):
    """[timing] B5 as MLA's prefill takes it (``ATTN_SERVED["mla"]``):
    deepseek-v3's q/k heads (nope 128 + rope 64) and v heads (128)
    zero-padded to head dim 256 by ``mla.attend_kernel``, the padding's
    copies in its time as on the main path, held to ``mla._attend_plain``
    on the same inputs within 1e-4 of each row's max |o| (B5's limit).
    The bound counts the model's widths (``sagebench/metrics/
    mla_counts.py``, the yardstick of ``mla_attn_roofline.serve``), never
    the padded ones."""
    from repro_torch.configs import get_config
    from repro_torch.models import mla
    from sagebench.counts import PEAK_FLOPS
    from sagebench.metrics.mla_counts import attention_bytes, attention_flops
    b, h, _, s, _, hd, _, _, _ = shape
    cfg = get_config(MLA_ARCH).scaled(dtype="float32")
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    widths = dict(n_heads=h, qk_nope_head_dim=dn, qk_rope_head_dim=dr,
                  v_head_dim=dv, dtype="float32")

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    args = (r(b, s, h, dn), r(b, s, h, dr), r(b, s, h, dn), r(b, s, dr),
            r(b, s, h, dv))
    scale, pos = mla._scale(cfg), torch.arange(s, device=dev)
    want = mla._attend_plain(*args, pos, cfg)
    row = dict(
        max_abs_err=held("flash_attention@mla", mla.attend_kernel(
            *args, scale), want, 1e-4 * want.abs().amax(-1, keepdim=True)),
        ms=device_ms(torch, lambda: mla.attend_kernel(*args, scale)),
        plain_ms=device_ms(torch, lambda: mla._attend_plain(*args, pos,
                                                             cfg)),
        library_ms=None, bound_bytes=attention_bytes(widths, b, s),
        bound_flops=attention_flops(widths, b, s),
        flops_rate=PEAK_FLOPS["float32"],
        shape=f"b={b} h={h} s={s} q/k {dn}+{dr} v {dv} padded to hd={hd}, "
        f"causal, f32, YaRN scale {scale:.6g}; bound at the model's widths")
    del args, want
    return row


def ssd_bwd_timing(torch, KS, gen, dev):
    """[timing] B6's backward kernel at [train]'s shape (one SSD layer of
    mamba2-130m on 8 x 2,048 tokens, no state): one ``sage_ssd_scan_bwd``
    launch from what the forward kept, beside the plain recompute it
    replaced (``ssd_chunked`` at chunk 256 and ``torch.autograd.grad`` of
    it), each gradient held to ``ssd_chunked_bwd`` within 1e-4 of its
    largest |value| over the (batch, head) or (batch, group), d a_log's
    over the heads (the card tests' limit).  Its bound is bytes: each
    input it reads and each gradient it writes, once."""
    b, s_, h, p, n, g = TRAIN_BATCH, TRAIN_SEQ, 24, 64, 128, 1
    args = ssd_inputs(torch, gen, dev, b, s_, h, p, n, g, False)[:5]
    dy = torch.randn((b, s_, h, p), generator=gen, device=dev)
    _, _, kept = KS._launch(*args, None, keep=True)
    got = KS._launch_bwd(*kept, dy, None, False)
    want = KS.ssd_chunked_bwd(*args, dy, 256)
    err = max(held(f"ssd_scan_bwd {name}", gt, w, 1e-4 * (
        w.abs().amax() if dims is None else w.abs().amax(dim=dims,
                                                          keepdim=True)))
        for name, gt, w, dims in zip(
            ("dx", "ddt", "da_log", "dB", "dC"), got, want,
            ((1, 3), (1,), None, (1, 3), (1, 3))))
    del got, want
    ins = [t.clone().requires_grad_(True) for t in args]

    def plain():
        with torch.enable_grad():
            y, _ = KS.ssd_chunked(*ins, 256)
            torch.autograd.grad(y, ins, dy)
    # read: x, dy, dt, a_log, B, C and the forward's states, decays and
    # C B^T tiles; written: dx, ddt, d a_log, dB, dC
    io = (2 * (2 * b * s_ * h * p + b * s_ * h + 2 * b * s_ * g * n + h)
          - b * s_ * h * p + sum(t.numel() for t in kept[5:]))
    r = dict(max_abs_err=err,
             ms=device_ms(torch, lambda: KS._launch_bwd(*kept, dy, None,
                                                        False)),
             plain_ms=device_ms(torch, plain, reps=3), library_ms=None,
             bound_bytes=4 * io,
             shape=f"b={b} s={s_} h={h} p={p} n={n} g={g} f32, gradients "
             f"of every input")
    log_ssd_launches(torch, lambda: KS._launch_bwd(*kept, dy, None, False),
                     "ssd_scan_bwd")
    return r


def log_ssd_launches(torch, call, label):
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
        log(f"[timing] {label} launches: the profiler saw no device time "
            f"(not measured)")
        return
    log(f"[timing] {label} launches in one call (torch.profiler, device "
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
    ``PERCIP_OBJS`` objects of 64 KiB on T3, predictive (percipience, its
    policy scoring an HsmDaemon scan every 16 reads) and reactive (the default
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


def phase_serve(torch, ext, cfg, dev, *, tag="serve",
                expect_params=SERVE_PARAMS, batch=SERVE_BATCH,
                prompt=SERVE_PROMPT, gen=SERVE_GEN):
    """[serve] recurrentgemma-9b (or, as [serve-ssm], mamba2-130m; as
    [serve-moe], qwen2-moe-a2.7b; as [serve-mla], deepseek-v3 cut to 4
    layers; as [serve-whisper], whisper-large-v3; as [serve-vision],
    llama-3.2-vision cut to 10 layers; as [serve-bf16], mamba2-130m and
    whisper-large-v3 in bf16) at full width through the port's Server:
    weights drawn on the card from torch.Generator seed 0, ``batch``
    prompts of ``prompt`` tokens (numpy seed 0; then, from the same
    generator, whisper's frames or vision's image embeddings, as the
    reference's ``serve.main`` draws them), ``gen`` greedy tokens.
    A model with cross layers gets both their gates set to
    ``VISION_GATE`` first (``set_cross_gates``).  The prefill must
    launch B5 once per attention or MLA layer (twice per ``encdec``
    layer, once per encoder layer where the stack reads the encoder),
    B7 once per RG-LRU layer and B6 once per SSD layer, and no other;
    the token log must read back.  Whisper's encoder is then driven on
    its own (``encoder_check``).  Then the kernel path's logits must
    agree with the plain path's on the same weights (one copy on the
    card) at prefill and at every decode step fed the served tokens
    (``plain_path``); a bf16 model's blocks are also held one by one
    (``layer_check``); an MLA model is held to ``mla_lossless_check``
    instead.  Returns the launches of the kernels
    the model runs."""
    import numpy as np
    from repro_torch.core import FunctionShipper
    from repro_torch.launch.serve import Server
    from repro_torch.models import model as mdl
    from repro_torch.models.transformer import reads_memory, stack_kinds
    from repro_torch.tree import leaves
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    if tf32[0]:
        fail(f"[{tag}] TF32 matmuls are on; the kernel and plain paths "
             "would differ for a reason that is neither")
    kinds = [k for ks in stack_kinds(cfg).values() for k in ks]
    encoder = cfg.n_encoder_layers if (cfg.is_encoder_decoder
                                       and reads_memory(cfg)) else 0
    want_launches = {
        "flash_attention": (
            kinds.count("local") + kinds.count("global")
            + kinds.count("cross") + 2 * kinds.count("encdec") + encoder),
        "rglru_scan": kinds.count("rglru"), "ssd_scan": kinds.count("ssd")}
    if cfg.dtype == "bfloat16":         # B5 and B6 launch their bf16 kernels
        want_launches = {BF16_KERNELS.get(k, k): n
                         for k, n in want_launches.items()}
    want_launches = {k: want_launches.get(k, 0) for k in MODEL_KERNELS}
    used = [k for k in MODEL_KERNELS if want_launches[k]]
    n_params = mdl.count_params_analytic(cfg)
    if n_params != expect_params:
        fail(f"[{tag}] {cfg.name} counts {n_params} parameters, expected "
             f"{expect_params}")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_real, (batch, prompt)).astype(
        np.int32)
    extra = memory_inputs(cfg, rng, batch)
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
        held = sum(t.numel() for t in leaves(srv.params))
        if held != n_params:
            fail(f"[{tag}] the server holds {held} parameters, not "
                 f"{n_params}")
        log(f"[{tag}] {cfg.name}: {held} f32 parameters "
            f"({torch.cuda.memory_allocated(dev)} B on the card) drawn in "
            f"{init_s:.3f} s, computing in {cfg.dtype}; TF32 allow matmul "
            f"{tf32[0]} cudnn {tf32[1]} float32 matmul precision "
            f"{tf32[2]!r}; batch {batch} x {prompt} prompt tokens, {gen} "
            f"generated" + "".join(f"; {k} {tuple(v.shape)} (numpy seed 0, "
                                   f"after the prompts)"
                                   for k, v in extra.items()))
        if cfg.cross_attn_period:
            log(f"[{tag}] both tanh gates of "
                f"{set_cross_gates(torch, srv.params)} cross layers set to "
                f"{VISION_GATE} after the seeded init (they start at 0, "
                f"where a cross layer is the identity)")
        ext.reset_launch_counts()               # the served path starts here
        out, stats = srv.generate(prompts, gen, extra=extra, keep_logits=True)
        launches = {k: ext.LAUNCHES[k] for k in MODEL_KERNELS}  # ends here
        # a graph's warm-up and capture launch the MoE's single-token
        # kernel; its replays do not count
        moe_decode = ext.LAUNCHES["moe_experts_decode"]
        peak = torch.cuda.max_memory_allocated(dev)
        srv.close()
        if launches != want_launches:
            fail(f"[{tag}] one prefill launched {launches}, expected "
                 f"{want_launches}")
        if cfg.is_moe:
            if not moe_decode:
                fail(f"[{tag}] decode never launched moe_experts_decode")
            log(f"[{tag}] moe_experts_decode launched {moe_decode} times "
                f"outside replays (a graph's warm-up and capture, or every "
                f"eager step's MoE layers)")
        logits = stats.pop("logits")
        if out.shape != (batch, gen) or not all(
                bool(torch.isfinite(x).all()) and x.shape == (
                    batch, cfg.vocab_size) for x in logits):
            fail(f"[{tag}] tokens or logits of the wrong shape, or "
                 "non-finite logits")
        log(f"[{tag}] kernel path: prefill {stats['prefill_s']:.3f} s "
            f"({batch * prompt / stats['prefill_s']:.1f} "
            f"prompt tok/s), decode {stats['decode_s']:.3f} s = "
            f"{stats['tok_per_s']:.2f} tok/s ({batch} x {gen}); "
            f"launches in the prefill {json.dumps(launches)}; peak card "
            f"memory {peak} B of "
            f"{torch.cuda.get_device_properties(dev).total_memory} B")

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
        if cfg.use_mla:
            del logits
            mla_lossless_check(torch, srv.params, cfg, dev, tag)
        else:
            if cfg.is_encoder_decoder:
                encoder_check(torch, ext, srv.params, cfg, dev, tag,
                              extra["frames"])
            plain_path(torch, srv.params, cfg, dev, tag, prompts, out,
                       logits, extra)
            if cfg.dtype == "bfloat16":
                layer_check(torch, srv.params, cfg, dev, tag, prompts,
                            extra)
            if cfg.cross_attn_period:
                memory_moves(torch, srv.params, cfg, dev, tag, prompts,
                             logits[0], memory_inputs(cfg, rng, batch))
            del logits
        # the Server (its weights, caches and decode graphs) may sit in a
        # reference cycle: collect it before the next phase draws its own
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        served = {k: launches[k] for k in used}
        if cfg.is_moe:
            served["moe_experts_decode"] = moe_decode
        return served
    finally:
        remove_store(root)


def rms_rel(a, b) -> float:
    """|a - b| / |b| over all elements (the RMS of the difference over
    the RMS of ``b``)."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def plain_path(torch, params, cfg, dev, tag, prompts, out, logits, extra):
    """The plain path (``use_kernels=False``) on the same weights:
    prefill, then decode fed the kernel path's tokens.  In f32 each
    step's logits must be within ``SERVE_LOGIT_RTOL`` of its largest
    |logit| and every greedy choice must agree (except a MoE model's,
    whose routing can flip at a near-tie: C19).

    In bf16 the two paths round to bf16 after every op, and a rounding
    flipped by another f32 sum in B5 or B6 grows through the layers and
    along the sequence into noise of bf16's own size, so their logits
    are not held to each other (``layer_check`` holds each block).  The
    plain path runs again in f32 on the same weights and fed tokens, and
    the kernel path's distance from it (|a - b| / |b| over a step's
    logits, averaged over the prefill and decode steps) must not exceed
    the plain bf16 path's by more than ``BF16_F32_MARGIN`` of it."""
    from repro_torch.models import model as mdl
    batch, prompt = prompts.shape
    gen = out.shape[1]
    bf16 = cfg.dtype == "bfloat16"
    torch.cuda.reset_peak_memory_stats(dev)

    def run(cfg):
        """-> (per-step logits, prefill s) of the plain path"""
        cache = mdl.init_decode_state(
            cfg, batch, prompt + gen + 8, device=dev,
            dtype=torch.bfloat16 if cfg.dtype == "bfloat16"
            else torch.float32)
        t0 = time.perf_counter()
        lg, cache = mdl.prefill(params, {"tokens": prompts, **extra}, cfg,
                                cache, use_kernels=False)
        torch.cuda.synchronize(dev)
        prefill_s = time.perf_counter() - t0
        steps = [lg[..., :cfg.vocab_real]]
        for i in range(1, gen + 1):
            lg, cache = mdl.decode_step(
                params, torch.from_numpy(out[:, i - 1:i]), prompt + i - 1,
                cfg, cache)
            steps.append(lg[..., :cfg.vocab_real])
        return steps, prefill_s

    logits = [lg[..., :cfg.vocab_real] for lg in logits]
    plain, plain_s = run(cfg)
    rel = [float((logits[i] - plain[i]).abs().max())
           / float(plain[i].abs().max()) for i in range(gen + 1)]
    n_agree = sum(int((logits[i].argmax(-1) == plain[i].argmax(-1)).sum())
                  for i in range(gen + 1))
    if bf16:
        f32 = run(cfg.scaled(dtype="float32"))[0]
        dist = {name: [rms_rel(a[i], b[i]) for i in range(gen + 1)]
                for name, a, b in (("kernel - plain bf16", logits, plain),
                                   ("plain bf16 - f32", plain, f32),
                                   ("kernel bf16 - f32", logits, f32))}
        dmax = [float((plain[i] - f32[i]).abs().max())
                / float(f32[i].abs().max()) for i in range(gen + 1)]
        del f32
        mean = {name: sum(d) / len(d) for name, d in dist.items()}
        log(f"[{tag}] bf16, |a - b| / |b| over each step's logits "
            f"(prefill, then the {gen} decode steps): " + "; ".join(
                f"{name} {['%.3e' % r for r in d]}"
                for name, d in dist.items())
            + f"; max |a - b| / max |b|: kernel - plain bf16 "
            f"{['%.3e' % r for r in rel]}, plain bf16 - f32 "
            f"{['%.3e' % r for r in dmax]}")
        bound = (1 + BF16_F32_MARGIN) * mean["plain bf16 - f32"]
        if not mean["kernel bf16 - f32"] <= bound:
            fail(f"[{tag}] the bf16 kernel path is {mean['kernel bf16 - f32']:.4e} "
                 f"from the f32 path on average, farther than the plain "
                 f"bf16 path's {mean['plain bf16 - f32']:.4e} by more than "
                 f"{BF16_F32_MARGIN} of it")
        verdict = (f"mean |a - b| / |b| from the f32 path: kernel bf16 "
                   f"{mean['kernel bf16 - f32']:.4e}, plain bf16 "
                   f"{mean['plain bf16 - f32']:.4e} (the kernel's may "
                   f"exceed it by {BF16_F32_MARGIN} of it: {bound:.4e}); "
                   f"kernel - plain bf16 {mean['kernel - plain bf16']:.4e}; "
                   f"max |kernel - plain| / max |logit| at prefill "
                   f"{rel[0]:.3e}, over the decode steps {max(rel[1:]):.3e}")
    else:
        worst = max(range(gen + 1), key=lambda i: rel[i])
        if not rel[worst] <= SERVE_LOGIT_RTOL:
            fail(f"[{tag}] step {worst}: kernel and plain logits differ by "
                 f"{rel[worst]:.3e} of the largest |logit| (limit "
                 f"{SERVE_LOGIT_RTOL})")
        if not cfg.is_moe and n_agree != batch * (gen + 1):
            fail(f"[{tag}] the kernel and plain paths chose other greedy "
                 f"tokens: {n_agree} of {batch * (gen + 1)} agree")
        verdict = (f"max |kernel - plain| / max |logit| at prefill "
                   f"{rel[0]:.3e}, over the {gen} decode steps "
                   f"{max(rel[1:]):.3e} (limit {SERVE_LOGIT_RTOL})")
    log(f"[{tag}] plain path (use_kernels=False: the reference's dense "
        f"attention, log-depth scan and chunked SSD) on the same "
        f"weights: prefill {plain_s:.3f} s, peak card memory "
        f"{torch.cuda.max_memory_allocated(dev)} B; {verdict}; greedy "
        f"choices agree {n_agree}/{batch * (gen + 1)}"
        + ("" if bf16 else " (all must)"))


def layer_check(torch, params, cfg, dev, tag, prompts, extra):
    """bf16: every block of the served stack, and of whisper's encoder
    over the served frames, run through the kernels and through the
    plain path on the same bf16 input (the kernel path's, block by
    block, over the whole prompts as in training): the outputs within
    ``BF16_LAYER_RTOL`` of the block output's largest |value|.  One
    block's two outputs part only where a bf16 rounding of B5's or B6's
    output flips (2^-8 of a value), so no noise carried from earlier
    layers widens the limit."""
    from repro_torch.models import model as mdl
    from repro_torch.models import transformer as tfm
    block_forward = tfm.block_forward
    worst, part = {}, ["decoder"]

    def both(bp, x, cfg_, kind, **kw):
        kw.pop("use_kernels")
        got = block_forward(bp, x, cfg_, kind, use_kernels=True, **kw)
        want = block_forward(bp, x, cfg_, kind, use_kernels=False, **kw)
        r = float((got[0].float() - want[0].float()).abs().max()) / float(
            want[0].float().abs().max())
        n, w = worst.get((part[0], kind), (0, 0.0))
        worst[part[0], kind] = (n + 1, max(w, r))
        if not r <= BF16_LAYER_RTOL:
            fail(f"[{tag}] a {part[0]} {kind} block's kernel and plain outputs on the "
                 f"same bf16 input differ by {r:.3e} of its largest |value| "
                 f"(limit {BF16_LAYER_RTOL})")
        return got

    tfm.block_forward = both
    try:
        with torch.no_grad():
            memory = None
            if cfg.is_encoder_decoder:      # driven even where unread
                part[0] = "encoder"
                memory = mdl._encode(params, extra["frames"], cfg,
                                     use_kernels=True)
                part[0] = "decoder"
            elif tfm.reads_memory(cfg):
                memory = mdl._memory(params, extra, cfg, True)
            if not tfm.reads_memory(cfg):
                memory = None
            tokens = torch.from_numpy(prompts).to(dev)
            x = mdl._embed(params, tokens, cfg, mdl.compute_dtype(cfg))
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=dev)[None].expand_as(tokens)
            tfm.stack_forward_train(params["decoder"], x, cfg,
                                    positions=positions, memory=memory,
                                    use_kernels=True)
    finally:
        tfm.block_forward = block_forward
    torch.cuda.synchronize(dev)
    log(f"[{tag}] bf16 blocks one by one, kernel against plain on the same "
        f"input, max |a - b| / max |b| (limit {BF16_LAYER_RTOL}): " + ", ".join(
            f"{n} {kind} blocks of the {where} up to {w:.3e}"
            for (where, kind), (n, w) in worst.items()))


def memory_inputs(cfg, rng, batch):
    """The stub frontends' input, as the reference's ``serve.main``
    draws it from its generator after the prompts: whisper's frames
    (batch, 1,500, d), vision's image embeddings (batch, 1,601, d),
    standard normal in f32; {} for the other models."""
    import numpy as np
    if cfg.is_encoder_decoder:
        shape, key = (batch, cfg.encoder_seq, cfg.d_model), "frames"
    elif cfg.cross_attn_period:
        shape, key = (batch, cfg.n_image_tokens, cfg.d_model), "image_embeds"
    else:
        return {}
    return {key: rng.standard_normal(shape).astype(np.float32)}


def encoder_check(torch, ext, params, cfg, dev, tag, frames):
    """Whisper's encoder (``_encode``) over the served frames through B5
    (non-causal, one launch a layer, counted from 0 just before and read
    just after) and through the plain path: in f32 the outputs within
    ``SERVE_LOGIT_RTOL`` of the largest |value|; in bf16 (where
    ``layer_check`` holds each block) the kernel encoder's |a - b| / |b|
    from the plain f32 encoder within ``1 + BF16_F32_MARGIN`` times the
    plain bf16 encoder's, as ``plain_path``'s logits."""
    from repro_torch.models import model as mdl
    bf16 = cfg.dtype == "bfloat16"
    name = "flash_attention_bf16" if bf16 else "flash_attention"
    ext.reset_launch_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got = mdl._encode(params, frames, cfg, use_kernels=True)
    torch.cuda.synchronize(dev)
    kernel_s = time.perf_counter() - t0
    launches = ext.LAUNCHES[name]
    if launches != cfg.n_encoder_layers or sum(ext.LAUNCHES.values()) != \
            launches:
        fail(f"[{tag}] the encoder launched {dict(ext.LAUNCHES)}, expected "
             f"{name} {cfg.n_encoder_layers} times")
    t0 = time.perf_counter()
    want = mdl._encode(params, frames, cfg, use_kernels=False)
    torch.cuda.synchronize(dev)
    plain_s = time.perf_counter() - t0
    rel = float((got.float() - want.float()).abs().max()) / float(
        want.float().abs().max())
    if got.shape != (frames.shape[0], cfg.encoder_seq, cfg.d_model) or \
            not bool(torch.isfinite(got).all()):
        fail(f"[{tag}] the encoder's output {tuple(got.shape)} is not of "
             f"the expected shape, or not finite")
    if bf16:
        f32 = mdl._encode(params, frames, cfg.scaled(dtype="float32"),
                          use_kernels=False)
        own, kern = rms_rel(want, f32), rms_rel(got, f32)
        del f32
        verdict = (f"|a - b| / |b| from the plain f32 encoder: kernel bf16 "
                   f"{kern:.4e}, plain bf16 {own:.4e} (the kernel's within "
                   f"{1 + BF16_F32_MARGIN} times it); kernel - plain bf16 "
                   f"{rms_rel(got, want):.4e}, max |kernel - plain| / max "
                   f"|value| {rel:.3e}")
        if not kern <= (1 + BF16_F32_MARGIN) * own:
            fail(f"[{tag}] the bf16 encoder through B5: {verdict}")
    else:
        verdict = (f"max |kernel - plain| / max |value| {rel:.3e} (limit "
                   f"{SERVE_LOGIT_RTOL})")
        if not rel <= SERVE_LOGIT_RTOL:
            fail(f"[{tag}] the encoder's kernel and plain outputs: "
                 f"{verdict}")
    log(f"[{tag}] encoder ({cfg.n_encoder_layers} layers over "
        f"{tuple(frames.shape)} frames): {launches} B5 launches, "
        f"{kernel_s:.3f} s through B5, {plain_s:.3f} s plain; {verdict}")


def set_cross_gates(torch, params, value=VISION_GATE):
    """Both tanh gates (attention's ``gate`` and the MLP's ``mlp_gate``)
    of every cross layer to ``value``: they start at 0, where a cross
    layer is the identity.  Returns how many layers were set."""
    n = 0
    for blocks in params["decoder"].values():
        for bp in blocks:
            if "mlp_gate" in bp:
                bp["mlp_gate"].fill_(value)
                bp["mixer"]["gate"].fill_(value)
                n += 1
    return n


def memory_moves(torch, params, cfg, dev, tag, prompts, first, other):
    """A second kernel-path prefill on other image embeddings (``other``,
    the generator's next draw) must move the logits by more than
    ``MEMORY_MOVE_RTOL`` of the largest |logit|: the cross layers read
    the memory."""
    from repro_torch.models import model as mdl
    cache = mdl.init_decode_state(cfg, prompts.shape[0], prompts.shape[1],
                                  dtype=torch.float32, device=dev)
    again, cache = mdl.prefill(params, {"tokens": prompts, **other}, cfg,
                               cache)
    del cache
    moved = float((again - first).abs().max()) / float(first.abs().max())
    if not moved > MEMORY_MOVE_RTOL:
        fail(f"[{tag}] other image embeddings moved the prefill logits by "
             f"{moved:.3e} of the largest |logit| (must exceed "
             f"{MEMORY_MOVE_RTOL})")
    log(f"[{tag}] other image embeddings move the prefill logits by "
        f"{moved:.3e} of the largest |logit| (must exceed "
        f"{MEMORY_MOVE_RTOL})")


def mla_lossless_check(torch, params, cfg, dev, tag):
    """[serve-mla] the reference's own invariant (its
    ``tests/test_models.py``) on the served weights: at capacity E/k no
    token is dropped, and prefill plus absorbed-decode logits equal the
    expanded form's full forward over the prompt and the fed tokens
    (within ``SERVE_LOGIT_RTOL`` of the step's largest |logit|).  One
    prompt of ``MLA_CHECK_PROMPT`` tokens and ``MLA_CHECK_STEPS`` greedy
    steps: at E/k every expert's capacity is the whole group, so the
    gathered (E, C, d) tensor grows with the tokens."""
    import numpy as np
    from repro_torch.models import model as mdl
    lcfg = cfg.scaled(moe_capacity_factor=cfg.n_experts / cfg.top_k)
    n, steps = MLA_CHECK_PROMPT, MLA_CHECK_STEPS
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_real, (1, n)).astype(np.int64)).to(dev)
    with torch.no_grad():
        cache = mdl.init_decode_state(lcfg, 1, n + steps,
                                      dtype=torch.float32, device=dev)
        lg, cache = mdl.prefill(params, {"tokens": prompt}, lcfg, cache)
        served, fed = [lg], []
        for i in range(steps):
            fed.append(served[-1].argmax(-1)[:, None])
            lg, cache = mdl.decode_step(params, fed[-1], n + i, lcfg, cache)
            served.append(lg)
        del cache
        full = mdl.forward_train(params, {"tokens": torch.cat(
            [prompt] + fed, dim=1)}, lcfg)[0][0, n - 1:]
    rel = [float((a[0] - full[i]).abs().max()) / float(full[i].abs().max())
           for i, a in enumerate(served)]
    if not all(bool(torch.isfinite(a).all()) for a in served) or \
            not max(rel) <= SERVE_LOGIT_RTOL:
        fail(f"[{tag}] absorbed decode against the expanded form at "
             f"capacity E/k: {['%.3e' % r for r in rel]} of the largest "
             f"|logit| (limit {SERVE_LOGIT_RTOL})")
    log(f"[{tag}] lossless invariant (capacity E/k = "
        f"{lcfg.moe_capacity_factor:g}, 1 x {n} prompt tokens, {steps} "
        f"decode steps): max |served - full forward| / max |logit| at "
        f"prefill {rel[0]:.3e}, over the decode steps {max(rel[1:]):.3e} "
        f"(limit {SERVE_LOGIT_RTOL})")


# ---------------------------------------------------------------------------
# phase 7: edge ingest under chaos into a continuous query on the card
# ---------------------------------------------------------------------------

def load_chaos():
    """``tests/chaos.py``'s harness as a private module over the port's
    edge package (its ``repro.edge`` imports rewritten in memory)."""
    path = ROOT / "tests" / "chaos.py"
    src = path.read_text().replace("from repro.edge", "from repro_torch.edge")
    spec = importlib.util.spec_from_file_location("chip_smoke_chaos", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod          # dataclasses look their module up
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def phase_edge(torch, K, col, dev, smi):
    """[edge] the hostile schedule of benchmarks/bench_edge.py through
    EdgeBuffer -> EdgeIngestor -> StreamContext -> a continuous
    EventWindow sum keyed by (producer, window) on the card.  Returns the
    batch kernels' launches while the schedule ran."""
    from repro_torch.analytics import EventWindow
    from repro_torch.core import Addb, Clovis, StreamContext, StreamTap
    chaos = load_chaos()
    root = ROOT / ".chip_smoke" / "edge"
    remove_store(root)
    try:
        cl = Clovis(root, addb=Addb(), device=dev)
        eng = cl.analytics()
        tap = StreamTap()
        ctx = StreamContext(n_producers=EDGE_PRODUCERS, attach=tap)
        ds = eng.from_stream(ctx).key_by(col(0)).aggregate("sum",
                                                           value=col(1))
        harness = chaos.ChaosHarness(ctx, root / "buffers", EDGE_PRODUCERS,
                                     window_s=EDGE_WINDOW_S,
                                     segment_bytes=4096, addb=cl.addb)
        actions = chaos.make_schedule(
            EDGE_SEED, producers=EDGE_PRODUCERS, n_events=EDGE_EVENTS,
            window_s=EDGE_WINDOW_S, reorder_s=EDGE_REORDER_S,
            n_crashes=EDGE_CRASHES)
        K.reset_launch_counts()                 # [edge] starts here
        t0 = time.perf_counter()
        cq = eng.run_continuous(
            ds, EventWindow(EDGE_WINDOW_S, allowed_lateness_s=EDGE_LATENESS_S),
            delta_rows=64)
        harness.run(actions)
        recovery = harness.final_recovery()
        closed = ctx.close()
        results = cq.close()
        wall = time.perf_counter() - t0
        launches = {k: K.LAUNCHES[k] for k in BATCH_KERNELS}  # ends here
        st = harness.stats
        if not closed:
            fail("[edge] the stream did not drain")
        if st["crashes"] < 1 or st["torn_crashes"] < 1 or \
                st["duplicates_injected"] < 1 or st["poison_injected"] < 1:
            fail(f"[edge] the schedule was too tame: {st}")
        if launches["segment_reduce"] <= 0:
            fail("[edge] segment_reduce was not launched")
        streaming = {}
        for r in results:
            if r.value is not None:
                for k, v in zip(*r.value):
                    streaming[int(k)] = streaming.get(int(k), 0) + int(v)
        late = {}
        for le in cq.late:
            if not le.assigned:
                k, v = int(le.payload[0]), int(le.payload[1])
                late[k] = late.get(k, 0) + v
        keys, vals = (eng.from_stream(tap).key_by(col(0))
                      .aggregate("sum", value=col(1)).collect())
        batch = {int(k): int(v) for k, v in zip(keys, vals)}
        combined = dict(streaming)
        for k, v in late.items():
            combined[k] = combined.get(k, 0) + v
        if combined != batch:
            bad = [k for k in set(combined) | set(batch)
                   if combined.get(k) != batch.get(k)]
            fail(f"[edge] streaming windows + late adjustments differ from "
                 f"the batch query at {len(bad)} keys")
        if batch != harness.expected:
            fail("[edge] the batch query lost or doubled events against "
                 "the schedule's sums")
        if chaos.TORN_SENTINEL in set(batch.values()):
            fail("[edge] a torn record reached the aggregates")
        if harness.dlq.published != st["poison_injected"]:
            fail(f"[edge] {harness.dlq.published} dead letters for "
                 f"{st['poison_injected']} poison events")
        if st["buf_torn_tail_recovered"] < 1:
            fail("[edge] no torn tail was recovered")
        cst = cq.stats
        if cst["open_windows"] or cst["buffered_rows"]:
            fail(f"[edge] the operator did not drain: {cst}")
        replays = st["replays"] + EDGE_PRODUCERS
        log(f"[edge] {st['emitted']} events ({len(actions)} actions) from "
            f"{EDGE_PRODUCERS} producers in {wall:.3f} s = "
            f"{st['emitted'] / wall:.1f} events/s; {st['crashes']} crashes "
            f"({st['torn_crashes']} torn, {st['buf_torn_tail_recovered']} "
            f"torn tails recovered), {replays} replays (applied "
            f"{recovery['applied'] + st['replay_applied']} lost events), "
            f"{st['duplicates_injected']} duplicates injected and "
            f"{st['ingest_duplicates']} absorbed, {st['poison_injected']} "
            f"poison = {harness.dlq.published} dead letters; "
            f"{len(batch)} window keys, streaming + {len(late)} late "
            f"adjustments == batch == the schedule's sums (int64); "
            f"launches {json.dumps(launches)}; {smi}")
        eng.close()
        return launches
    finally:
        remove_store(root)


# ---------------------------------------------------------------------------
# phase 8: training with checkpoint/restart through Clovis
# ---------------------------------------------------------------------------

def host_snapshot(torch, state):
    """{leaf name: a host copy} of a training state."""
    from repro_torch.tree import flatten_with_names
    return {n: t.detach().to("cpu", copy=True)
            for n, t in flatten_with_names(state)}


def same_bits(torch, tag, got, want):
    """Fail unless every leaf of ``got`` has the dtype, shape and bytes of
    ``want``'s leaf of the same name (a ``host_snapshot``)."""
    from repro_torch.tree import flatten_with_names

    def raw(t):
        return t.detach().cpu().reshape(-1).view(torch.uint8)
    flat = flatten_with_names(got)
    if sorted(n for n, _ in flat) != sorted(want):
        fail(f"[train] {tag}: leaf names differ")
    for n, t in flat:
        w = want[n]
        if t.dtype != w.dtype or t.shape != w.shape or not torch.equal(
                raw(t), raw(w)):
            fail(f"[train] {tag}: leaf {n} differs")


def phase_train(torch, ext, dev):
    """[train] mamba2-130m at full width trained through the port's
    Trainer with checkpoint/restart through Clovis (see the module's
    docstring).  Returns B6's launches over the training steps."""
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data.pipeline import TokenLoader, build_synthetic_corpus
    from repro_torch.launch.train import Trainer
    from repro_torch.tree import leaves
    cfg = get_config(TRAIN_ARCH).scaled(dtype="float32")
    run = RunConfig(arch=TRAIN_ARCH, remat="none", total_steps=TRAIN_STEPS,
                    warmup_steps=4, checkpoint_every=10,
                    checkpoint_strategy="stream")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    n_layers = cfg.n_layers
    root = ROOT / ".chip_smoke" / "train"
    remove_store(root)
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        tr = Trainer(cfg, run, root, device=dev)
        t0 = time.perf_counter()
        n_tok = build_synthetic_corpus(tr.clovis, vocab=cfg.vocab_real,
                                       n_shards=4,
                                       tokens_per_shard=b * (s + 1) * 8)
        corpus_s = time.perf_counter() - t0
        params, opt = tr.init_state(run.seed)
        n_params = sum(t.numel() for t in leaves(params))
        state_bytes = sum(t.numel() * t.element_size()
                          for t in leaves((params, opt)))
        if n_params != SSM_PARAMS:
            fail(f"[train] {n_params} parameters, expected {SSM_PARAMS}")
        log(f"[train] {cfg.name}: {n_params} f32 parameters, state "
            f"(params, m, v, step) {state_bytes} B; corpus {n_tok} tokens "
            f"in 4 shards written to Clovis in {corpus_s:.3f} s; batch "
            f"{b} x {s} tokens a step")

        # 1. steps 1-20, stream checkpoints at 10 and 20
        loader = TokenLoader(tr.clovis, batch=b, seq=s)
        torch.cuda.reset_peak_memory_stats(dev)
        ext.reset_launch_counts()               # the train path starts here
        params, opt, hist = tr.train(TRAIN_RESTART, loader, params=params,
                                     opt_state=opt, log_every=1)
        launches = ext.LAUNCHES["ssd_scan"]     # ends here
        bwd = ext.LAUNCHES["ssd_scan_bwd"]
        loader.close()
        tr.ckpt.close()
        if not launches == bwd == n_layers * TRAIN_RESTART:
            fail(f"[train] steps 1-{TRAIN_RESTART} launched B6 {launches} "
                 f"and its backward {bwd} times, expected {n_layers} a "
                 f"step each")
        saved = host_snapshot(torch, {"params": params, "opt": opt})
        ckpt1 = [(i.step, i.strategy, round(i.seconds, 3))
                 for i in tr.ckpt.history]

        # 2. a T1 device dies; HA repairs what it held
        dev0 = tr.clovis.pools["t1_nvram"].devices[0]
        affected = len(tr.clovis.store.objects_on_device(dev0.name))
        t0 = time.perf_counter()
        repaired = tr.ha.engage_repair(dev0.name)
        ha_s = time.perf_counter() - t0
        if not repaired:
            fail(f"[train] HA repaired nothing on {dev0.name}")
        log(f"[train] HA: {dev0.name} killed; {affected} objects of its "
            f"tier checked, {len(repaired)} re-silvered (a block with no "
            f"healthy copy left), in {ha_s:.3f} s")
        del params, opt
        torch.cuda.empty_cache()

        # 3. restart: a new Trainer on the same root
        tr2 = Trainer(cfg, run, root, device=dev)
        t0 = time.perf_counter()
        got = tr2.try_restore()
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        if got is None or got[0] != TRAIN_RESTART:
            fail(f"[train] restart found step "
                 f"{None if got is None else got[0]}, not {TRAIN_RESTART}")
        step, params, opt = got
        same_bits(torch, f"restore of step {step}",
                  {"params": params, "opt": opt}, saved)
        log(f"[train] restart: a new Trainer restored step {step} in "
            f"{restore_s:.3f} s, equal bit for bit to the host snapshot "
            f"of step {TRAIN_RESTART} ({len(saved)} leaves)")
        del saved

        # 4. steps 21-40
        loader = TokenLoader(tr2.clovis, batch=b, seq=s, start_step=step)
        ext.reset_launch_counts()               # the train path starts here
        params, opt, hist2 = tr2.train(TRAIN_STEPS, loader, start_step=step,
                                       params=params, opt_state=opt,
                                       log_every=1)
        launches2 = ext.LAUNCHES["ssd_scan"]    # ends here
        bwd2 = ext.LAUNCHES["ssd_scan_bwd"]
        loader.close()
        if not launches2 == bwd2 == n_layers * (TRAIN_STEPS - step):
            fail(f"[train] steps {step + 1}-{TRAIN_STEPS} launched B6 "
                 f"{launches2} and its backward {bwd2} times, expected "
                 f"{n_layers} a step each")
        peak = torch.cuda.max_memory_allocated(dev)

        # 5. the losses
        losses = [l for _, l in hist + hist2]
        if [st for st, _ in hist + hist2] != list(range(1, TRAIN_STEPS + 1)):
            fail("[train] the loss history skips steps")
        if not all(np.isfinite(losses)):
            fail(f"[train] non-finite losses: {losses}")
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        if not last < first:
            fail(f"[train] the loss did not fall: mean of steps 1-5 "
                 f"{first:.4f}, of steps {TRAIN_STEPS - 4}-{TRAIN_STEPS} "
                 f"{last:.4f}")
        log(f"[train] losses {json.dumps([round(l, 4) for l in losses])}; "
            f"mean of steps 1-5 {first:.4f}, of steps {TRAIN_STEPS - 4}-"
            f"{TRAIN_STEPS} {last:.4f}; B6 launches {launches} + "
            f"{launches2} ({n_layers} a step); peak card memory {peak} B; "
            f"checkpoints {ckpt1} + "
            f"{[(i.step, i.strategy, round(i.seconds, 3)) for i in tr2.ckpt.history]}")
        tr2.ckpt.close()

        # 6. one checkpoint of the whole state with each strategy
        state = {"params": params, "opt": opt}
        want = host_snapshot(torch, state)
        for i, strategy in enumerate(("collective", "window", "stream")):
            cm = CheckpointManager(tr2.clovis, strategy=strategy)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            info = cm.save(1000 + i, state)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = cm.restore(1000 + i, like=state, device=dev)
            torch.cuda.synchronize(dev)
            load_s = time.perf_counter() - t0
            cm.close()
            same_bits(torch, f"{strategy} restore", out, want)
            del out
            log(f"[train] {strategy}: {info.n_leaves} leaves, {info.bytes} "
                f"B saved in {save_s:.3f} s = {info.bytes / save_s / 1e9:.3f} "
                f"GB/s, restored to the card in {load_s:.3f} s = "
                f"{info.bytes / load_s / 1e9:.3f} GB/s, equal bit for bit")
        del want
        return {"ssd_scan": launches + launches2,
                "ssd_scan_bwd": bwd + bwd2}
    finally:
        remove_store(root)


def phase_dist(torch, ext, dev):
    """[dist] qwen2.5-32b at full width, cut to 2 layers, through the
    plain Trainer and then the mesh Trainer on a world-size-1 NCCL 1 x 1
    mesh from the same seed on the same batches (equal losses, B5 two
    launches a forward); the dry run of this cell against the state the
    card holds."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.data.pipeline import TokenLoader, build_synthetic_corpus
    from repro_torch.launch import analysis as AN
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.train import Trainer
    from repro_torch.tree import leaves
    cfg = get_config(DIST_ARCH).scaled(dtype="float32", **DIST_CUT)
    run = RunConfig(arch=DIST_ARCH, remat="none", total_steps=DIST_STEPS,
                    warmup_steps=1, checkpoint_every=1000)
    b, s, n_layers = DIST_BATCH, DIST_SEQ, cfg.n_layers
    roots = [ROOT / ".chip_smoke" / n for n in ("dist", "dist_mesh")]
    for r in roots:
        remove_store(r)
    try:
        # the dry run of this cell, before the real process group exists
        with dryrun.fake_world(MeshShape((1, 1), ("data", "model"))) as fm:
            rep = dryrun.count_cell(
                DIST_ARCH, ShapeConfig("dist", s, b, "train"), mesh=fm,
                mesh_name="1x1", cfg=get_config(DIST_ARCH).scaled(
                    dtype="float32", **DIST_CUT),
                param_dtype=torch.float32, remat="none")
            _, (dparams, dopt, dbatch), _, _, _ = dryrun.build_cell(
                DIST_ARCH, ShapeConfig("dist", s, b, "train"), mesh=fm,
                cfg=cfg, param_dtype=torch.float32, remat="none")
            dry_state = AN.local_bytes((dparams, dopt))
            dry_batch = AN.local_bytes(dbatch)
        if rep.argument_bytes != dry_state + dry_batch:
            fail(f"[dist] the dry run's argument bytes "
                 f"{rep.argument_bytes} are not its state's {dry_state} "
                 f"+ batch's {dry_batch}")

        # 1. the plain Trainer
        tr = Trainer(cfg, run, roots[0], device=dev)
        build_synthetic_corpus(tr.clovis, vocab=cfg.vocab_real, n_shards=2,
                               tokens_per_shard=b * (s + 1) * DIST_STEPS)
        loader = TokenLoader(tr.clovis, batch=b, seq=s)
        batches = [next(loader) for _ in range(DIST_STEPS)]
        loader.close()
        tr.ckpt.close()
        runs = {}
        for mesh in (False, True):
            if mesh:
                dist.init_process_group(
                    "nccl", store=dist.FileStore(
                        str(ROOT / ".chip_smoke" / "dist_pg"), 1),
                    rank=0, world_size=1, device_id=dev,
                    timeout=datetime.timedelta(seconds=120))
                tr = Trainer(cfg, run, roots[1], data_mesh=1, model_mesh=1,
                             device=dev)
                if tr.mesh is None or tr.mesh.device_type != dev.type:
                    fail("[dist] the Trainer in a process group built no "
                         "CUDA mesh")
            torch.cuda.reset_peak_memory_stats(dev)
            params, opt = tr.init_state(run.seed)
            n_params = sum(t.numel() for t in leaves(params))
            if n_params != DIST_PARAMS:
                fail(f"[dist] {n_params} parameters, expected "
                     f"{DIST_PARAMS}")
            state = AN.local_bytes((params, opt))
            ext.reset_launch_counts()           # the path starts here
            losses, ms = [], []
            for batch in batches:
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                params, opt, m = tr.step(params, opt, batch)
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
            launches = ext.LAUNCHES["flash_attention"]   # ends here
            if launches != n_layers * DIST_STEPS:
                fail(f"[dist] mesh={mesh}: B5 launched {launches} times in "
                     f"{DIST_STEPS} steps, expected {n_layers} a forward")
            placed = {str(getattr(t, "placements", None))
                      for t in leaves(params)}
            runs[mesh] = dict(losses=losses, ms=ms, state=state,
                              launches=launches, placed=placed,
                              peak=torch.cuda.max_memory_allocated(dev))
            if mesh:
                tr.ckpt.close()
            del params, opt, tr
            torch.cuda.empty_cache()
        plain, meshed = runs[False], runs[True]
        rel = max(abs(a - p) / abs(p) for a, p in
                  zip(meshed["losses"], plain["losses"]))
        if not all(np.isfinite(plain["losses"] + meshed["losses"])):
            fail(f"[dist] non-finite losses {runs}")
        if not rel <= DIST_LOSS_RTOL:
            fail(f"[dist] mesh losses {meshed['losses']} vs plain "
                 f"{plain['losses']}: {rel:.3e} apart (limit "
                 f"{DIST_LOSS_RTOL})")
        if meshed["placed"] != {"(Replicate(), Replicate())"}:
            fail(f"[dist] the mesh Trainer's parameters are placed "
                 f"{meshed['placed']}")
        if not meshed["state"] == plain["state"] == dry_state:
            fail(f"[dist] state bytes: dry run {dry_state}, mesh Trainer "
                 f"{meshed['state']}, plain {plain['state']}")
        log(f"[dist] {cfg.name} at full width cut to {cfg.n_layers} of 64 "
            f"layers: {DIST_PARAMS} f32 parameters; {b} x {s} tokens a "
            f"step, {DIST_STEPS} steps; plain Trainer losses "
            f"{plain['losses']} ({[round(x, 3) for x in plain['ms']]} ms), "
            f"mesh Trainer on a world-size-1 NCCL 1 x 1 mesh "
            f"{meshed['losses']} ({[round(x, 3) for x in meshed['ms']]} "
            f"ms): {rel:.3e} apart (limit {DIST_LOSS_RTOL}), "
            f"{'bit for bit' if meshed['losses'] == plain['losses'] else 'not bit for bit'}; "
            f"B5 {meshed['launches']} launches ({n_layers} a forward, GQA "
            f"40 over 8 heads, hd 128); parameters placed "
            f"{sorted(meshed['placed'])}")
        log(f"[dist] dry run of this cell (1 x 1 fake group, f32, "
            f"remat none): argument bytes {rep.argument_bytes} = state "
            f"{dry_state} + batch {dry_batch}; the mesh Trainer holds "
            f"{meshed['state']} B of parameters and AdamW state on the "
            f"card (equal byte for byte); torch.cuda.max_memory_allocated "
            f"{meshed['peak']} B over its {DIST_STEPS} steps (plain "
            f"Trainer {plain['peak']} B)")
        return {"flash_attention": meshed["launches"]}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for r in roots:
            remove_store(r)
        shutil.rmtree(ROOT / ".chip_smoke" / "dist_pg", ignore_errors=True)


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
    t_last = [t_start]

    def lap(phases):
        """Log the wall the phases since the last lap took."""
        now = time.perf_counter()
        log(f"[time] {phases}: {now - t_last[0]:.1f} s")
        t_last[0] = now

    smi = phase_card_and_build(torch, _ext)
    lap("build")
    timing = phase_timing(torch, K, H, KA, KR, KS, col, dev)
    lap("timing")
    phase_heat_split(torch, H, dev)
    lap("heat split")
    launches, per_query, main_values = phase_main_path(torch, K, col,
                                                       Clovis, dev)
    phase_percip_store(torch, H, K, dev)
    # [percip] ends here: heat_scan launches of both percipience phases
    launches["heat_scan"] = K.LAUNCHES["heat_scan"]
    log(f"[percip] heat_scan launches over the [percip] phases: "
        f"{launches['heat_scan']}")
    if launches["heat_scan"] <= 0:
        fail("heat_scan was not launched on the percipience path")
    lap("main, percip")
    stream = phase_stream(torch, K, col, dev)
    lap("stream")
    cluster = phase_cluster(torch, K, col, dev, main_values)
    lap("cluster")
    served = phase_serving(torch, K, col, dev, main_values)
    lap("serving, compaction")
    edge = phase_edge(torch, K, col, dev, smi)
    lap("edge")
    runs = {}                           # a served run's launches, by tag

    def serve(cfg, tag="serve", **kw):
        runs.setdefault(tag, {}).update(
            phase_serve(torch, _ext, cfg, dev, tag=tag, **kw))
        lap(tag)

    serve(get_config(SERVE_ARCH).scaled(dtype="float32"))
    serve(get_config(SSM_ARCH).scaled(dtype="float32"), "serve-ssm",
          expect_params=SSM_PARAMS, batch=SSM_BATCH, prompt=SSM_PROMPT,
          gen=SSM_GEN)
    serve(get_config(MOE_ARCH).scaled(dtype="float32"), "serve-moe",
          expect_params=MOE_PARAMS, batch=MOE_BATCH, prompt=MOE_PROMPT,
          gen=MOE_GEN)
    serve(get_config(MLA_ARCH).scaled(dtype="float32", **MLA_CUT),
          "serve-mla", expect_params=MLA_PARAMS, batch=MLA_BATCH,
          prompt=MLA_PROMPT, gen=MLA_GEN)
    serve(get_config(WHISPER_ARCH).scaled(dtype="float32"), "serve-whisper",
          expect_params=WHISPER_PARAMS, batch=WHISPER_BATCH,
          prompt=WHISPER_PROMPT, gen=WHISPER_GEN)
    serve(get_config(VISION_ARCH).scaled(dtype="float32", **VISION_CUT),
          "serve-vision", expect_params=VISION_PARAMS, batch=VISION_BATCH,
          prompt=VISION_PROMPT, gen=VISION_GEN)
    # the configs' own default dtype, bf16 (C18)
    serve(get_config(SSM_ARCH), "serve-bf16", expect_params=SSM_PARAMS,
          batch=SSM_BATCH, prompt=SSM_PROMPT, gen=SSM_GEN)
    serve(get_config(WHISPER_ARCH), "serve-bf16",
          expect_params=WHISPER_PARAMS, batch=WHISPER_BATCH,
          prompt=WHISPER_PROMPT, gen=WHISPER_GEN)
    launches.update({k: runs[tag][k] for k, tag in LAUNCHED_IN.items()})
    trained = phase_train(torch, _ext, dev)
    launches["ssd_scan_bwd"] = trained["ssd_scan_bwd"]
    lap("train")
    distributed = phase_dist(torch, _ext, dev)
    lap("dist")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
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
    log(f"[edge] launches: {json.dumps(edge)}; [train] launches over "
        f"{TRAIN_STEPS} steps: {json.dumps(trained)}; [dist] launches "
        f"over {DIST_STEPS} steps: {json.dumps(distributed)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)                          # nvidia-smi's "name, power.limit"
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

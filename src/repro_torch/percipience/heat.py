"""Batched heat scoring + Markov next-access prediction — the
*prediction* stage of SAGE's percipience loop (the paper's title claim:
storage that anticipates access instead of only reacting to it).

The heat of an object is an exponentially-decayed access count,

    heat(now) = sum_i w_i * exp(-lambda * (now - t_i)),   lambda = ln2 / T½

over its access timestamps t_i.  Evaluated as a linear recurrence over
the (time-ordered) access history,

    h_i = exp(-lambda * (t_i - t_{i-1})) * h_{i-1} + w_i,

one kernel launch scores every tracked object: ``heat_scan`` runs the
hand-written CUDA kernel ``sage_heat_scan`` (``csrc/percipience_kernels.cu``,
one thread per object, h in a register) on a CUDA tensor, and its plain
PyTorch version ``heat_scan_plain`` on a CPU tensor.

Gap/decay precomputation happens in float64 numpy — epoch-second
timestamps do not survive float32 — only the decay factors (all in
[0, 1]) and weights are handed to the f32 kernel.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch._ext import count_launch
from repro_torch.device import DeviceLike, resolve_device

LN2 = math.log(2.0)


# ---------------------------------------------------------------------------
# heat scan  (replaces repro/percipience/heat.py _heat_kernel)
# ---------------------------------------------------------------------------

def heat_scan_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: the same sequential f32 recurrence as the kernel,
    ``h = a[t] * h + x[t]`` from the oldest step, a multiply and an add
    each rounded to f32."""
    h = torch.zeros(a.shape[1], dtype=torch.float32, device=a.device)
    for t in range(a.shape[0]):
        h = a[t] * h + x[t]
    return h


def heat_scan(a, x, *, device: DeviceLike = None) -> torch.Tensor:
    """a, x: (hist, nobj) f32 decay factors / weights, oldest step first
    (arrays or tensors; any shape, padded or not).  Returns (nobj,) f32
    heat at each object's last access, on ``device`` (default ``cuda``).
    A CUDA tensor launches ``sage_heat_scan``; a CPU tensor runs
    ``heat_scan_plain``."""
    dev = resolve_device(device)
    a = torch.as_tensor(a, dtype=torch.float32).to(dev).contiguous()
    x = torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()
    if a.dim() != 2 or a.shape != x.shape:
        raise ValueError(f"heat_scan takes two (hist, nobj) arrays, got "
                         f"{tuple(a.shape)} and {tuple(x.shape)}")
    if not a.is_cuda:
        return heat_scan_plain(a, x)
    hist, nobj = a.shape
    out = torch.empty(nobj, dtype=torch.float32, device=dev)
    if nobj == 0:
        return out
    from repro_torch import _ext
    lib = _ext.library()
    with torch.cuda.device(dev):
        err = lib.sage_heat_scan(a.data_ptr(), x.data_ptr(), hist, nobj,
                                 out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    _ext.check(lib, err, "heat_scan")
    count_launch("heat_scan")
    return out


def _scan_inputs(ts: np.ndarray, m: np.ndarray, lam: float,
                 weights: Optional[np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The f64 precompute: (hist, nobj) f32 decay factors and weights."""
    n = ts.shape[0]
    w = m if weights is None else np.asarray(weights, np.float64) * m

    # decay factor per step: exp(-lam * gap to previous access); padded /
    # leading steps get a=1, x=0 (identity, the rglru padding trick)
    prev = np.concatenate([ts[:, :1], ts[:, :-1]], axis=1)
    gaps = np.clip(ts - prev, 0.0, None)
    a = np.where(m > 0, np.exp(-lam * gaps), 1.0)
    # first valid access decays h=0, so its factor is irrelevant; clamp it
    # to 1 to avoid exp underflow noise on huge epoch-vs-0 gaps
    first = np.argmax(m, axis=1)
    has = m.any(axis=1)
    a[np.arange(n), first] = np.where(has, 1.0, a[np.arange(n), first])
    return (np.ascontiguousarray(a.T, np.float32),
            np.ascontiguousarray(w.T, np.float32))


def _tail(ts: np.ndarray, m: np.ndarray, now: float,
          lam: float) -> np.ndarray:
    """Decay from each object's last access to ``now`` (f64)."""
    t_last = (ts * m).max(axis=1)
    return np.where(m.any(axis=1),
                    np.exp(-lam * np.clip(now - t_last, 0.0, None)), 0.0)


def heat_scores(timestamps: np.ndarray, mask: np.ndarray, now: float,
                half_life_s: float = 120.0,
                weights: Optional[np.ndarray] = None,
                device: DeviceLike = None) -> np.ndarray:
    """Heat for every object from its access-timestamp history.

    timestamps/mask (and optional per-access weights): (nobj, hist),
    right-aligned as produced by FeatureExtractor.history_tensors (each
    step decays by the gap to the previous *column*, so masks with holes
    are outside the contract, as in the reference).  Returns (nobj,) f64
    heat as of ``now``; the scan runs on ``device`` (default ``cuda``).
    """
    ts = np.asarray(timestamps, np.float64)
    m = np.asarray(mask, np.float64)
    if ts.shape[0] == 0:
        return np.zeros((0,), np.float64)
    lam = LN2 / half_life_s
    at, xt = _scan_inputs(ts, m, lam, weights)
    h_last = heat_scan(at, xt, device=device).cpu().numpy().astype(
        np.float64)
    return h_last * _tail(ts, m, now, lam)


def heat_scores_ref(timestamps: np.ndarray, mask: np.ndarray, now: float,
                    half_life_s: float = 120.0,
                    weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Pure-numpy closed form: sum_i w_i * 2^-((now - t_i)/T½)."""
    ts = np.asarray(timestamps, np.float64)
    m = np.asarray(mask, np.float64)
    lam = LN2 / half_life_s
    w = m if weights is None else np.asarray(weights, np.float64) * m
    return (w * np.exp(-lam * np.clip(now - ts, 0.0, None)) * (m > 0)
            ).sum(axis=1)


# ---------------------------------------------------------------------------
# Markov next-access prediction
# ---------------------------------------------------------------------------

def markov_topk(probs: torch.Tensor, current: torch.Tensor, k: int = 3
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched top-k next-bucket prediction.

    probs: (B, B) row-normalised transition matrix; current: (m,) int
    bucket indices.  Returns (values, indices), each (m, k), on the
    tensors' device."""
    return torch.topk(probs[current], k, dim=1)


def markov_predict(probs: np.ndarray, current: int, k: int = 3,
                   min_p: float = 0.0,
                   device: DeviceLike = None) -> List[Tuple[int, float]]:
    """Top-k (bucket, probability) successors of ``current``, filtered to
    probability > min_p.  Thin convenience over markov_topk, on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    vals, idxs = markov_topk(
        torch.as_tensor(np.asarray(probs), dtype=torch.float32).to(dev),
        torch.tensor([current], device=dev), k=k)
    out = []
    for p, b in zip(vals[0].cpu().numpy(), idxs[0].cpu().numpy()):
        if p > min_p:
            out.append((int(b), float(p)))
    return out

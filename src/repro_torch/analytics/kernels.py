"""Aggregation hot-path kernels: segmented group-by reduce, windowed
reductions, histogram and the fused filter -> aggregate pass — SAGE's
in-storage compute primitives (paper §4.1), as hand-written CUDA
kernels for Hopper (``csrc/analytics_kernels.cu``).

Three layers per kernel:

* the **host API** (``segment_reduce``, ``window_reduce``,
  ``histogram``, ``fused_filter_aggregate``): numpy in, numpy out, with
  the names, padding, dtype, identity and empty-input rules of
  ``repro.analytics.kernels``.  It moves the inputs to ``device`` and
  calls the wrapper;
* the **wrapper** (``*_tensor``): on a CUDA tensor it launches the
  kernel (and counts the launch in ``LAUNCHES``) or raises; on a CPU
  tensor it runs the plain version.  There is no other fallback;
* the **plain PyTorch version** (``*_plain``): masks,
  ``scatter_reduce`` and ``unfold`` — the CPU path and, on the card,
  the yardstick ``chip_smoke.py`` holds each kernel against.

Integer inputs reduce in int32 (exact, wrapping like ``np.add.at``);
everything else in float32.  The fused pass compiles its predicate and
value specs on the host into a typed postfix program (``compile_specs``)
that the one CUDA build interprets per row; the plain version runs the
same program with torch ops, so typing is shared and the arithmetic is
written twice.  The numpy ``*_ref`` oracles are copies of the
reference package's.
"""
from __future__ import annotations

import ctypes
import functools
import json
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# launch counts live in _ext, shared by every kernel of the library
from repro_torch._ext import (LAUNCHES, count_launch,  # noqa: F401
                              reset_launch_counts)
from repro_torch.analytics.exprs import _BINOPS
from repro_torch.device import DeviceLike, resolve_device

OPS = ("sum", "count", "min", "max")
_LANES = 128
_SUBLANES = 8
_TILE = _LANES * _SUBLANES
_OP_CODE = {"sum": 0, "count": 1, "min": 2, "max": 3}
_DT_CODE = {torch.int32: 0, torch.float32: 1}

def kernel_mode(device: DeviceLike = None) -> str:
    """How a kernel call on ``device`` executes: ``cuda`` (the
    hand-written kernels) or ``torch-cpu`` (their plain PyTorch
    versions).  Benchmarks label every number with this."""
    return "cuda" if resolve_device(device).type == "cuda" else "torch-cpu"


def _identity(op: str, dtype) -> float:
    if op in ("sum", "count"):
        return 0
    big = np.iinfo(dtype).max if np.issubdtype(dtype, np.integer) \
        else np.inf
    return big if op == "min" else -big


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _lib():
    from repro_torch import _ext
    return _ext, _ext.library()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, *ts: torch.Tensor):
    for t in ts:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous on "
                             f"the same CUDA device as the first")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{ts[0].device}")


# ---------------------------------------------------------------------------
# expression-spec evaluation (numpy reference + planning helpers)
# ---------------------------------------------------------------------------

def eval_spec(spec: Dict, getcol):
    """Evaluate a serialised expression spec (exprs.to_spec) against
    ``getcol(i) -> array`` with numpy semantics (the unfused path and
    the reference oracles)."""
    t = spec["t"]
    if t == "col":
        return getcol(spec["i"])
    if t == "lit":
        return spec["v"]
    if t == "bin":
        return _BINOPS[spec["op"]](eval_spec(spec["l"], getcol),
                                   eval_spec(spec["r"], getcol))
    if t == "not":
        return ~eval_spec(spec["e"], getcol)
    raise ValueError(f"bad expr spec {spec!r}")


def spec_columns(spec: Optional[Dict]) -> set:
    """Column indices a spec reads (pruned-scan planning)."""
    if spec is None:
        return set()
    t = spec["t"]
    if t == "col":
        return {spec["i"]}
    if t == "bin":
        return spec_columns(spec["l"]) | spec_columns(spec["r"])
    if t == "not":
        return spec_columns(spec["e"])
    return set()


_CMP_OPS = (">", ">=", "<", "<=", "==", "!=")


def _spec_dtype(spec: Dict, coldt: Dict[int, np.dtype]) -> np.dtype:
    """Result dtype of a spec under numpy promotion — how the unfused
    path's ``expr(rows)`` would come out, so the fused kernel picks the
    identical int32/float32 accumulator."""
    t = spec["t"]
    if t == "col":
        return np.dtype(coldt[spec["i"]])
    if t == "lit":
        return np.asarray(spec["v"]).dtype
    if t == "not":
        return np.dtype(bool)
    if spec["op"] in _CMP_OPS:
        return np.dtype(bool)
    l = _spec_dtype(spec["l"], coldt)
    r = _spec_dtype(spec["r"], coldt)
    if spec["op"] == "/":
        return np.result_type(l, r, np.float32)
    return np.result_type(l, r)


def fused_out_dtype(value_spec: Optional[Dict],
                    coldt: Dict[int, np.dtype]) -> np.dtype:
    """int32/float32 accumulator choice, identical to what the unfused
    path gets from evaluating the value expr on numpy rows."""
    if value_spec is None:
        return np.dtype(np.int32)            # count's ones
    dt = _spec_dtype(value_spec, coldt)
    return np.dtype(np.int32) if np.issubdtype(dt, np.integer) \
        else np.dtype(np.float32)


# ---------------------------------------------------------------------------
# typed postfix programs for the fused kernel
# ---------------------------------------------------------------------------
#
# Every node is typed int32 (I), float32 (F) or bool (B, held as int32
# 0/1), the 32-bit types the reference's JAX kernel computes in: ints
# and bools promote to F next to a float, `/` is true division in F, a
# comparison yields B, `~` is logical on B and bitwise on I.  The opcode
# numbers match enum Code in csrc/analytics_kernels.cu.

_I, _F, _B = "I", "F", "B"
_OPCODES = {
    "col": 0, "lit": 1, "i2f": 2, "f2i": 3, "f2b": 4,
    "+I": 10, "-I": 11, "*I": 12, "%I": 13, "&": 14, "|": 15,
    "~I": 16, "~B": 17,
    "+F": 20, "-F": 21, "*F": 22, "/F": 23, "%F": 24,
    ">I": 30, ">=I": 31, "<I": 32, "<=I": 33, "==I": 34, "!=I": 35,
    ">F": 40, ">=F": 41, "<F": 42, "<=F": 43, "==F": 44, "!=F": 45,
}
MAX_COLS, MAX_CODE, MAX_LITS, MAX_STACK = 16, 128, 64, 16


def _col_kind(dtype: np.dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return _B
    if np.issubdtype(dtype, np.integer):
        return _I
    if np.issubdtype(dtype, np.floating):
        return _F
    raise TypeError(f"fused kernel cannot read a {dtype} column")


def _kernel_column(c: np.ndarray) -> np.ndarray:
    """A column as the kernel reads it: int32 for ints and bools,
    float32 for floats (the JAX kernel's 32-bit arrays)."""
    return c.astype(np.float32 if _col_kind(c.dtype) == _F else np.int32,
                    copy=False)


class Program(NamedTuple):
    """A compiled fused-kernel program: ``code`` is a tuple of (opcode,
    arg) instructions, the first ``n_pred`` of them the predicate
    (leaving an I/B value, nonzero keeps the row) and the rest the value
    (leaving the accumulator dtype); ``lits`` holds each literal's int32
    or float32 bit pattern and ``lit_f`` which of them are floats."""
    code: Tuple[Tuple[int, int], ...]
    n_pred: int
    lits: Tuple[int, ...]
    lit_f: Tuple[bool, ...]


def _lit(v) -> Tuple[int, str]:
    """(int32 bit pattern, kind) of a literal (JAX's 32-bit view)."""
    if isinstance(v, (bool, np.bool_)):
        return int(bool(v)), _B
    if isinstance(v, (int, np.integer)):
        if not -2**31 <= int(v) < 2**31:
            raise OverflowError(f"literal {v} does not fit in int32")
        return int(v), _I
    if isinstance(v, (float, np.floating)):
        return int(np.float32(v).view(np.int32)), _F
    raise TypeError(f"unsupported literal {v!r}")


def _kind(spec: Dict, kinds: Dict[int, str]) -> str:
    """I/F/B type of a spec node, as the JAX kernel computes it."""
    t = spec["t"]
    if t == "col":
        return kinds[spec["i"]]
    if t == "lit":
        return _lit(spec["v"])[1]
    if t == "not":
        kind = _kind(spec["e"], kinds)
        if kind == _F:
            raise TypeError("~ is not defined on a float expression")
        return kind
    if t != "bin":
        raise ValueError(f"bad expr spec {spec!r}")
    op = spec["op"]
    lk, rk = _kind(spec["l"], kinds), _kind(spec["r"], kinds)
    floaty = _F in (lk, rk) or op == "/"
    if op in ("&", "|"):
        if floaty:
            raise TypeError(f"{op} is not defined on floats")
        return _B if lk == rk == _B else _I
    if op in ("+", "-", "*") and lk == rk == _B:
        raise TypeError(f"{op} on two booleans is not supported")
    if op in _CMP_OPS:
        return _B
    return _F if floaty else _I


@functools.lru_cache(maxsize=512)
def compile_specs(pred_json: str, value_json: str,
                  coltypes: Tuple[Tuple[int, str], ...], out_dtype: str
                  ) -> Program:
    """Compile a predicate and a value spec (JSON, "" for none) into one
    postfix program.  ``coltypes`` pairs each column index with its kind
    (I/F/B), in slot order; ``out_dtype`` is the accumulator's numpy
    dtype name."""
    slot = {i: j for j, (i, _) in enumerate(coltypes)}
    kinds = dict(coltypes)
    code: List[Tuple[int, int]] = []
    lits: List[int] = []
    lit_f: List[bool] = []
    depth = [0, 0]                         # current, max

    def push(op, arg=0):
        code.append((_OPCODES[op], arg))
        if op in ("col", "lit"):
            depth[0] += 1
        elif op not in ("i2f", "f2i", "f2b", "~I", "~B"):
            depth[0] -= 1
        depth[1] = max(depth)

    def emit(spec):
        t = spec["t"]
        if t == "col":
            push("col", slot[spec["i"]])
        elif t == "lit":
            bits, kind = _lit(spec["v"])
            lits.append(bits)
            lit_f.append(kind == _F)
            push("lit", len(lits) - 1)
        elif t == "not":
            emit(spec["e"])
            push("~B" if _kind(spec, kinds) == _B else "~I")
        else:
            op = spec["op"]
            lk, rk = _kind(spec["l"], kinds), _kind(spec["r"], kinds)
            floaty = (_F in (lk, rk) or op == "/") and op not in ("&", "|")
            emit(spec["l"])
            if floaty and lk != _F:
                push("i2f")
            emit(spec["r"])
            if floaty and rk != _F:
                push("i2f")
            push(op if op in ("&", "|") else op + (_F if floaty else _I))

    n_pred = 0
    if pred_json:
        pred = json.loads(pred_json)
        emit(pred)
        if _kind(pred, kinds) == _F:
            push("f2b")
        n_pred = len(code)
    if value_json:
        value = json.loads(value_json)
        depth[0] = 0
        emit(value)
        kind = _kind(value, kinds)
        if out_dtype == "float32" and kind != _F:
            push("i2f")
        elif out_dtype == "int32" and kind == _F:
            push("f2i")
    if len(code) > MAX_CODE or len(lits) > MAX_LITS \
            or depth[1] > MAX_STACK:
        raise ValueError(f"expression too large for the fused kernel "
                         f"({len(code)} instructions, {len(lits)} "
                         f"literals, stack {depth[1]})")
    return Program(tuple(code), n_pred, tuple(lits), tuple(lit_f))


_OPNAMES = {v: k for k, v in _OPCODES.items()}


def _run_program_plain(code, prog: Program,
                       cols: List[torch.Tensor]) -> torch.Tensor:
    """The plain PyTorch version of the kernel's program interpreter:
    I/B values are int32 tensors, F values float32 tensors."""
    dev = cols[0].device if cols else torch.device("cpu")
    st: List[torch.Tensor] = []
    for opc, arg in code:
        op = _OPNAMES[opc]
        if op == "col":
            st.append(cols[arg])
        elif op == "lit":
            t = torch.tensor(prog.lits[arg], dtype=torch.int32, device=dev)
            st.append(t.view(torch.float32) if prog.lit_f[arg] else t)
        elif op in ("i2f", "f2i", "f2b", "~I", "~B"):
            x = st.pop()
            if op == "i2f":
                x = x.to(torch.float32)
            elif op == "f2i":
                x = x.to(torch.int32)
            elif op == "f2b":
                x = (x != 0).to(torch.int32)
            elif op == "~I":
                x = torch.bitwise_not(x)
            else:
                x = 1 - x
            st.append(x)
        else:
            b, a = st.pop(), st.pop()
            st.append(_binop_plain(op, a, b))
    return st[0]


def _binop_plain(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if op in ("&", "|"):
        return (torch.bitwise_and if op == "&" else torch.bitwise_or)(a, b)
    base, kind = op[:-1], op[-1]
    if base == "%":
        if kind == _I:
            bad = (b == 0) | (b == -1)        # x % 0 == 0 (numpy, JAX)
            r = torch.remainder(a, torch.where(bad, torch.ones_like(b), b))
            return torch.where(bad, torch.zeros_like(r), r)
        r = torch.fmod(a, b)
        fix = (r != 0) & ((r < 0) != (b < 0))
        return torch.where(fix, r + b, r)
    if base in _CMP_OPS:
        return {">": torch.gt, ">=": torch.ge, "<": torch.lt, "<=": torch.le,
                "==": torch.eq, "!=": torch.ne}[base](a, b).to(torch.int32)
    fn = {"+": torch.add, "-": torch.sub, "*": torch.mul,
          "/": torch.div}[base]
    return fn(a, b)


# ---------------------------------------------------------------------------
# segmented group-by reduce  (replaces repro/analytics/kernels.py
# _segment_kernel)
# ---------------------------------------------------------------------------

def segment_reduce_plain(values: torch.Tensor, ids: torch.Tensor,
                         n_segments: int, op: str) -> torch.Tensor:
    """Plain PyTorch: drop negative ids, ``scatter_reduce`` the rest into
    an identity-filled output."""
    out = torch.full((n_segments,), _identity(op, _np_dtype(values.dtype)),
                     dtype=values.dtype, device=values.device)
    keep = (ids >= 0) & (ids < n_segments)
    idx = ids[keep].long()
    v = values[keep]
    if op == "count":
        v = torch.ones_like(v)
    red = {"sum": "sum", "count": "sum", "min": "amin", "max": "amax"}[op]
    return out.scatter_reduce_(0, idx, v, reduce=red, include_self=True)


def segment_reduce_tensor(values: torch.Tensor, ids: torch.Tensor,
                          n_segments: int, op: str) -> torch.Tensor:
    """values int32/float32 (n,), ids int32 (n,), negative = dropped.
    CUDA tensors launch ``sage_segment_reduce``; CPU tensors run the
    plain version."""
    if not values.is_cuda:
        return segment_reduce_plain(values, ids, n_segments, op)
    _check_cuda("segment_reduce", values, ids)
    if values.dtype not in _DT_CODE or ids.dtype != torch.int32 \
            or values.shape != ids.shape or values.dim() != 1:
        raise ValueError("segment_reduce takes (n,) int32/float32 values "
                         "and (n,) int32 ids")
    out = torch.full((n_segments,), _identity(op, _np_dtype(values.dtype)),
                     dtype=values.dtype, device=values.device)
    ext, lib = _lib()
    with torch.cuda.device(values.device):
        err = lib.sage_segment_reduce(
            values.data_ptr(), ids.data_ptr(), values.numel(),
            out.data_ptr(), n_segments, _DT_CODE[values.dtype],
            _OP_CODE[op], _stream(values))
    ext.check(lib, err, "segment_reduce")
    count_launch("segment_reduce")
    return out


def segment_reduce(values: np.ndarray, seg_ids: np.ndarray, n_segments: int,
                   *, op: str = "sum",
                   device: DeviceLike = None) -> np.ndarray:
    """Reduce ``values`` by integer segment id in [0, n_segments).

    Negative ids are dropped.  Integer inputs reduce in int32 (exact);
    everything else in float32.  Returns (n_segments,) with the op
    identity for empty segments.  Runs the CUDA kernel on a ``cuda``
    device (the default) and the plain version on ``cpu``.
    """
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}")
    v = np.asarray(values).reshape(-1)
    ids = np.asarray(seg_ids, np.int32).reshape(-1)
    if v.shape != ids.shape:
        raise ValueError("values and seg_ids must align")
    dtype = np.int32 if np.issubdtype(v.dtype, np.integer) else np.float32
    if n_segments <= 0 or v.size == 0:
        return np.full((max(n_segments, 0),),
                       _identity(op, np.dtype(dtype)), dtype)
    dev = resolve_device(device)
    v = v.astype(dtype, copy=False)
    ident = _identity(op, np.dtype(dtype))

    n = v.size
    pad = (-n) % _TILE
    if pad:
        v = np.pad(v, (0, pad), constant_values=dtype(0) if op in
                   ("sum", "count") else ident)
        ids = np.pad(ids, (0, pad), constant_values=-1)
    out = segment_reduce_tensor(_to_device(v, dev), _to_device(ids, dev),
                                n_segments, op)
    return out.cpu().numpy()


def segment_reduce_ref(values: np.ndarray, seg_ids: np.ndarray,
                       n_segments: int, *, op: str = "sum") -> np.ndarray:
    """Pure-numpy reference (np.ufunc.at scatter)."""
    v = np.asarray(values).reshape(-1)
    ids = np.asarray(seg_ids, np.int64).reshape(-1)
    dtype = np.int32 if np.issubdtype(v.dtype, np.integer) else np.float32
    v = v.astype(dtype)
    keep = ids >= 0
    v, ids = v[keep], ids[keep]
    out = np.full((n_segments,), _identity(op, np.dtype(dtype)), dtype)
    if op == "sum":
        np.add.at(out, ids, v)
    elif op == "count":
        np.add.at(out, ids, np.ones_like(v, dtype))
    elif op == "min":
        np.minimum.at(out, ids, v)
    else:
        np.maximum.at(out, ids, v)
    return out


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return np.dtype(np.int32) if dt == torch.int32 else np.dtype(np.float32)


# ---------------------------------------------------------------------------
# windowed reductions  (replaces _window_kernel)
# ---------------------------------------------------------------------------

def window_reduce_plain(values: torch.Tensor, window: int, slide: int,
                        op: str) -> torch.Tensor:
    """Plain PyTorch: ``unfold`` the complete windows, reduce each."""
    mat = values.unfold(0, window, slide)          # (n_windows, window)
    if op == "count":
        return torch.full((mat.shape[0],), window, dtype=values.dtype,
                          device=values.device)
    if op == "sum":
        return mat.sum(dim=1, dtype=values.dtype)
    return mat.amin(dim=1) if op == "min" else mat.amax(dim=1)


def window_reduce_tensor(values: torch.Tensor, window: int, slide: int,
                         op: str) -> torch.Tensor:
    """values int32/float32 (n,) with n >= window.  CUDA tensors launch
    ``sage_window_reduce`` (a block per window of 1,024 elements or more,
    else a warp, folding coalesced 16-byte loads straight from the
    sequence); CPU tensors run the plain version."""
    if not values.is_cuda:
        return window_reduce_plain(values, window, slide, op)
    _check_cuda("window_reduce", values)
    if values.dtype not in _DT_CODE or values.dim() != 1 \
            or values.numel() < window:
        raise ValueError("window_reduce takes (n,) int32/float32 values "
                         "with n >= window")
    n_windows = (values.numel() - window) // slide + 1
    out = torch.empty((n_windows,), dtype=values.dtype, device=values.device)
    ext, lib = _lib()
    with torch.cuda.device(values.device):
        err = lib.sage_window_reduce(
            values.data_ptr(), window, slide, n_windows, out.data_ptr(),
            _DT_CODE[values.dtype], _OP_CODE[op], _stream(values))
    ext.check(lib, err, "window_reduce")
    count_launch("window_reduce")
    return out


def window_reduce(values: np.ndarray, window: int, *, op: str = "sum",
                  slide: Optional[int] = None,
                  device: DeviceLike = None) -> np.ndarray:
    """Tumbling (or, with ``slide``, sliding) window reduction over a 1-D
    value sequence; only complete windows emit.  ``mean`` callers divide
    the ``sum`` result by ``window``."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}")
    slide = window if slide is None else slide
    if window <= 0 or slide <= 0:
        raise ValueError("window size and slide must be positive")
    v = np.asarray(values).reshape(-1)
    if v.size < window:
        return np.zeros((0,), np.float32)
    dev = resolve_device(device)
    dtype = np.int32 if np.issubdtype(v.dtype, np.integer) else np.float32
    out = window_reduce_tensor(_to_device(v.astype(dtype, copy=False), dev),
                               window, slide, op)
    return out.cpu().numpy()


def _window_matrix(values: np.ndarray, window: int, slide: int
                   ) -> np.ndarray:
    """(n_windows, window) matrix of full windows (tail dropped)."""
    if window <= 0 or slide <= 0:
        raise ValueError("window size and slide must be positive")
    v = np.asarray(values).reshape(-1)
    if v.size < window:
        return v[:0].reshape(0, window)
    n_windows = (v.size - window) // slide + 1
    idx = (np.arange(n_windows)[:, None] * slide +
           np.arange(window)[None, :])
    return v[idx]


def window_reduce_ref(values: np.ndarray, window: int, *, op: str = "sum",
                      slide: Optional[int] = None) -> np.ndarray:
    slide = window if slide is None else slide
    mat = _window_matrix(values, window, slide)
    dtype = np.int32 if np.issubdtype(mat.dtype, np.integer) else np.float32
    mat = mat.astype(dtype)
    if mat.shape[0] == 0:
        return np.zeros((0,), np.float32)
    fn = {"sum": np.sum, "count": np.sum, "min": np.min, "max": np.max}[op]
    if op == "count":
        mat = np.ones_like(mat)
    return fn(mat, axis=1)


# ---------------------------------------------------------------------------
# histogram (fixed uniform bins -> segmented count)
# ---------------------------------------------------------------------------

def histogram_bin_ids(values: np.ndarray, bins: int,
                      vrange: Tuple[float, float]) -> np.ndarray:
    """Uniform-bin ids with np.histogram edge semantics: values in
    [lo, hi], hi landing in the last bin; out-of-range -> -1 (dropped)."""
    lo, hi = float(vrange[0]), float(vrange[1])
    if not (bins > 0 and lo < hi):
        raise ValueError("histogram needs bins > 0 and vrange lo < hi")
    v = np.asarray(values, np.float64).reshape(-1)
    width = (hi - lo) / bins
    ids = np.floor((v - lo) / width).astype(np.int64)
    ids = np.minimum(ids, bins - 1)           # v == hi -> last bin
    ids[(v < lo) | (v > hi)] = -1
    return ids


def histogram(values: np.ndarray, bins: int, vrange: Tuple[float, float],
              *, device: DeviceLike = None) -> np.ndarray:
    """np.histogram-compatible uniform-bin counts via the segmented
    count kernel."""
    ids = histogram_bin_ids(values, bins, vrange)
    ones = np.ones(ids.shape, np.int32)
    return segment_reduce(ones, ids, bins, op="count", device=device)


def histogram_ref(values: np.ndarray, bins: int,
                  vrange: Tuple[float, float]) -> np.ndarray:
    return np.histogram(np.asarray(values).reshape(-1), bins=bins,
                        range=vrange)[0].astype(np.int32)


# ---------------------------------------------------------------------------
# fused filter -> segmented reduce  (replaces _fused_kernel)
# ---------------------------------------------------------------------------
#
# The pushdown hot path: evaluate the shipped predicate AND fold the
# survivors into segment accumulators in one pass — no materialized
# boolean mask, no compacted intermediate rows.  Inputs arrive as
# individual columns (the colblock pruned-read shape), a predicate/value
# spec each, and host-computed segment ids for the *unfiltered* rows;
# rejected rows never reach an accumulator.  Each call also returns
# per-segment survivor counts so the caller can drop empty groups and
# derive means.

def fused_filter_aggregate_plain(cols: List[torch.Tensor], program: Program,
                                 ids: torch.Tensor, n_segments: int,
                                 op: str, out_dtype: torch.dtype
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: run the program as whole-column torch ops, mask,
    then ``scatter_reduce`` survivors and their count."""
    code, n_pred = program.code, program.n_pred
    keep = (ids >= 0) & (ids < n_segments)
    if n_pred:
        keep &= _run_program_plain(code[:n_pred], program, cols) != 0
    if op != "count" and len(code) > n_pred:
        val = _run_program_plain(code[n_pred:], program, cols)
        val = torch.broadcast_to(val, ids.shape)
    else:
        val = torch.ones(ids.shape, dtype=out_dtype, device=ids.device)
    idx = torch.where(keep, ids, torch.full_like(ids, -1))
    acc = segment_reduce_plain(val.contiguous(), idx, n_segments, op)
    cnt = segment_reduce_plain(torch.ones_like(ids), idx, n_segments, "sum")
    return acc, cnt


def fused_filter_aggregate_tensor(cols: List[torch.Tensor], program: Program,
                                  ids: torch.Tensor, n_segments: int,
                                  op: str, out_dtype: torch.dtype
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cols: int32/float32 (n,) tensors in program slot order; ids int32
    (n,).  CUDA tensors launch ``sage_fused_aggregate``; CPU tensors run
    the plain version."""
    if not ids.is_cuda:
        return fused_filter_aggregate_plain(cols, program, ids, n_segments,
                                            op, out_dtype)
    _check_cuda("fused_filter_aggregate", ids, *cols)
    code, n_pred, lits = program.code, program.n_pred, program.lits
    if ids.dtype != torch.int32 or ids.dim() != 1 or any(
            c.shape != ids.shape or c.dtype not in _DT_CODE for c in cols):
        raise ValueError("fused_filter_aggregate takes (n,) int32 ids and "
                         "(n,) int32/float32 columns")
    if len(cols) > MAX_COLS:
        raise ValueError(f"more than {MAX_COLS} columns")
    acc = torch.full((n_segments,), _identity(op, _np_dtype(out_dtype)),
                     dtype=out_dtype, device=ids.device)
    cnt = torch.zeros((n_segments,), dtype=torch.int32, device=ids.device)
    ptrs = (ctypes.c_void_p * max(len(cols), 1))(
        *[c.data_ptr() for c in cols])
    ops = (ctypes.c_int * max(len(code), 1))(*[c for c, _ in code])
    args = (ctypes.c_int * max(len(code), 1))(*[a for _, a in code])
    litv = (ctypes.c_int32 * max(len(lits), 1))(*lits)
    ext, lib = _lib()
    with torch.cuda.device(ids.device):
        err = lib.sage_fused_aggregate(
            ptrs, len(cols), ops, args, n_pred, len(code) - n_pred, litv,
            len(lits), ids.data_ptr(), ids.numel(), acc.data_ptr(),
            cnt.data_ptr(), n_segments, _DT_CODE[out_dtype], _OP_CODE[op],
            _stream(ids))
    ext.check(lib, err, "fused_filter_aggregate")
    count_launch("fused_filter_aggregate")
    return acc, cnt


def fused_program(cols: Dict[int, np.ndarray], pred_spec: Optional[Dict],
                  value_spec: Optional[Dict], out_dtype) -> Program:
    """The compiled program for these specs at these column dtypes."""
    order = tuple(sorted(cols))
    coltypes = tuple((i, _col_kind(np.asarray(cols[i]).dtype))
                     for i in order)
    pred_json = json.dumps(pred_spec, sort_keys=True) if pred_spec else ""
    value_json = json.dumps(value_spec, sort_keys=True) if value_spec \
        else ""
    return compile_specs(pred_json, value_json, coltypes,
                         np.dtype(out_dtype).name)


def fused_filter_aggregate(cols: Dict[int, np.ndarray],
                           pred_spec: Optional[Dict],
                           value_spec: Optional[Dict],
                           seg_ids: np.ndarray, n_segments: int, *,
                           op: str, device: DeviceLike = None,
                           out_dtype=None
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """One-pass filter -> segmented reduce over column arrays.

    ``cols`` maps original column index -> (rows,) array (a pruned
    colblock read or sliced row-major block); ``seg_ids`` are
    host-computed int32 ids in [0, n_segments) over the *unfiltered*
    rows (-1 drops a row unconditionally).  Returns
    ``(agg, counts)`` of shape (n_segments,): the op-reduced survivor
    values (op identity where no survivors) and survivor counts.
    Integer aggregates are exact int32.  ``out_dtype`` overrides the
    inferred int32/float32 accumulator (grouped means reduce integer
    values in float32, matching the unfused cast-then-reduce).
    """
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}")
    ids = np.asarray(seg_ids, np.int32).reshape(-1)
    n = ids.size
    order = tuple(sorted(cols))
    coldt = {i: np.asarray(cols[i]).dtype for i in order}
    dtype = np.dtype(out_dtype) if out_dtype is not None \
        else fused_out_dtype(value_spec, coldt)
    ident = _identity(op, dtype)
    if n_segments <= 0 or n == 0:
        return (np.full((max(n_segments, 0),), ident, dtype),
                np.zeros((max(n_segments, 0),), np.int32))
    dev = resolve_device(device)
    program = fused_program(cols, pred_spec, value_spec, dtype)

    pad = (-n) % _TILE
    ids_p = np.pad(ids, (0, pad), constant_values=-1) if pad else ids
    col_t = []
    for i in order:
        c = _kernel_column(np.asarray(cols[i]).reshape(-1))
        if c.size != n:
            raise ValueError(f"column {i} has {c.size} rows, ids {n}")
        # pad value 1 keeps pad-row predicate math away from div-by-zero
        col_t.append(_to_device(
            np.pad(c, (0, pad), constant_values=c.dtype.type(1))
            if pad else c, dev))
    tdt = torch.int32 if dtype == np.int32 else torch.float32
    acc, cnt = fused_filter_aggregate_tensor(
        col_t, program, _to_device(ids_p, dev), n_segments, op, tdt)
    return acc.cpu().numpy(), cnt.cpu().numpy()


def fused_filter_aggregate_ref(cols: Dict[int, np.ndarray],
                               pred_spec: Optional[Dict],
                               value_spec: Optional[Dict],
                               seg_ids: np.ndarray, n_segments: int, *,
                               op: str) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy reference: materialize the mask, compact, reduce —
    exactly the unfused path the fused kernel must match."""
    ids = np.asarray(seg_ids, np.int64).reshape(-1)
    order = tuple(sorted(cols))
    coldt = {i: np.asarray(cols[i]).dtype for i in order}
    dtype = fused_out_dtype(value_spec, coldt)
    getcol = lambda i: np.asarray(cols[i]).reshape(-1)   # noqa: E731
    if pred_spec is None:
        keep = ids >= 0
    else:
        keep = np.broadcast_to(
            np.asarray(eval_spec(pred_spec, getcol), bool),
            ids.shape) & (ids >= 0)
    if value_spec is None:
        val = np.ones(ids.shape, dtype)
    else:
        val = np.broadcast_to(
            np.asarray(eval_spec(value_spec, getcol)).astype(dtype),
            ids.shape)
    ids_k, val_k = ids[keep], val[keep]
    acc = segment_reduce_ref(val_k.astype(dtype), ids_k, n_segments, op=op)
    cnt = segment_reduce_ref(np.ones(ids_k.shape, np.int32), ids_k,
                             n_segments, op="count")
    return acc.astype(dtype), cnt


# ---------------------------------------------------------------------------
# program-cache introspection
# ---------------------------------------------------------------------------

def kernel_cache_info() -> Dict[str, int]:
    """Hit/miss/entry counts of the cached spec compiler — a miss is
    one host-side compile of a (spec, column types) pair; the CUDA
    build itself is shared by every query."""
    ci = compile_specs.cache_info()
    return {"hits": ci.hits, "misses": ci.misses, "entries": ci.currsize}


def kernel_cache_clear():
    compile_specs.cache_clear()

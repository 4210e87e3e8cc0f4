"""Build and load the port's CUDA kernels on first use.

``csrc/analytics_kernels.cu`` compiles with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, and ``ninja`` is not needed), loaded with ``ctypes``, which
releases the interpreter lock during each launch call.  The library
lands in ``_build/`` beside this file, named by a hash of the source and
flags, so an edited source never loads a stale build; a build goes to a
temporary name and is renamed into place, so a concurrent process never
loads half a file.

There is no fallback: a missing ``nvcc``, a failed build or a failed
load raises.  Loading is serialised by a lock, because the analytics
executor launches kernels from thread pools.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "analytics_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC") + ARCH_FLAGS

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the build (0 if cached)
build_log: str = ""                     # nvcc/ptxas output of that build

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C signatures of the launchers in SOURCE
_SIGNATURES = {
    "sage_fused_aggregate": (_P, _I, _P, _P, _I, _I, _P, _I, _P, _I64,
                             _P, _P, _I, _I, _I, _P),
    "sage_segment_reduce": (_P, _P, _I64, _P, _I, _I, _I, _P),
    "sage_window_reduce": (_P, _I64, _I64, _I64, _P, _I, _I, _P),
    "sage_error_string": (_I,),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or the CUDA source did not compile or load."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    for c in cands:
        if c.is_file():
            return str(c)
    raise KernelBuildError("nvcc not found (CUDA_HOME unset and no nvcc on "
                           "PATH); the CUDA kernels cannot be built")


def _build() -> ctypes.CDLL:
    """Compile SOURCE unless its library exists, then load it."""
    global build_seconds, build_log
    h = hashlib.sha1(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{SOURCE.stem}-{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(f"nvcc failed for {SOURCE.name} (exit "
                                   f"{proc.returncode}):\n{build_log}")
        os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = (ctypes.c_char_p if name.endswith("_string")
                      else ctypes.c_int)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call of the
    process)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise when a launcher of ``lib`` returned a CUDA error code."""
    if err != 0:
        msg = lib.sage_error_string(err).decode()
        raise KernelLaunchError(f"{what}: CUDA error {err} ({msg})")

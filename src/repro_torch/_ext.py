"""Build and load the port's CUDA kernels on first use.

Every ``csrc/*.cu`` source compiles in its own ``nvcc`` process, all
started together, and one more ``nvcc`` call links the objects into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds, and ``ninja`` is not needed), loaded with ``ctypes``,
which releases the interpreter lock during each launch call.  The library
lands in ``_build/`` beside this file, named by a hash of the flags and
of every source and header (``csrc/*.cu``, ``csrc/*.cuh``), so an edited
source or header never loads a stale build; a build goes to a temporary
name and is renamed into place, so a concurrent process never loads half
a file.

There is no fallback: a missing ``nvcc``, a failed build or a failed
load raises.  Loading is serialised by a lock, because the analytics
executor launches kernels from thread pools.

``LAUNCHES`` counts the launches of each kernel in this process (plain
versions are not counted); each wrapper adds one where it launches.
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
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
              "-Xcompiler", "-fPIC") + ARCH_FLAGS

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the build (0 if cached)
build_log: str = ""                     # nvcc/ptxas output of that build

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_float)
# C signatures of the launchers in SOURCES
_SIGNATURES = {
    "sage_fused_aggregate": (_P, _I, _P, _P, _I, _I, _P, _I, _P, _I64,
                             _P, _P, _I, _I, _I, _P),
    "sage_segment_reduce": (_P, _P, _I64, _P, _I, _I, _I, _P),
    "sage_window_reduce": (_P, _I64, _I64, _I64, _P, _I, _I, _P),
    "sage_heat_scan": (_P, _P, _I64, _I64, _P, _P),
    "sage_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                             _I, _F, _P),
    "sage_rglru_scan": (_P, _P, _P, _I64, _I64, _I64, _P, _P),
    "sage_ssd_scan": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P, _I, _I, _P),
    "sage_error_string": (_I,),
}

LAUNCHES: Dict[str, int] = {"fused_filter_aggregate": 0,
                            "segment_reduce": 0, "window_reduce": 0,
                            "heat_scan": 0, "flash_attention": 0,
                            "rglru_scan": 0, "ssd_scan": 0}
_launch_lock = threading.Lock()


def reset_launch_counts():
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str):
    with _launch_lock:
        LAUNCHES[name] += 1


class KernelBuildError(RuntimeError):
    """nvcc is missing or the CUDA sources did not compile or load."""


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


def library_path(csrc: Path = CSRC) -> Path:
    """Where the library built from ``csrc`` lands: named by a hash of
    NVCC_FLAGS and of the name and bytes of every ``*.cu`` source and
    every ``*.cuh`` header they include."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"sage_kernels-{h.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    """Compile SOURCES unless their library exists, then load it."""
    global build_seconds, build_log
    out = library_path()
    t0 = time.perf_counter()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in SOURCES]
        nvcc = _nvcc()
        try:
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o",
                                       str(obj), str(src)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for src, obj in zip(SOURCES, objs)]
            logs = [p.communicate()[0] for p in procs]
            build_log = "".join(logs)
            bad = [s.name for s, p in zip(SOURCES, procs) if p.returncode]
            if not bad:
                link = subprocess.run([nvcc, "-shared", *ARCH_FLAGS, "-o",
                                       str(tmp), *map(str, objs)],
                                      capture_output=True, text=True)
                build_log += link.stdout + link.stderr
                if link.returncode:
                    bad = ["the link"]
            if bad:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(f"nvcc failed for {', '.join(bad)}:"
                                       f"\n{build_log}")
            os.replace(tmp, out)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
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

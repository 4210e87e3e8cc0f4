"""The PyTorch port stands alone: it imports neither ``jax`` nor the
reference package ``repro``, and its entry points run on the card by
default, raising (never quietly running on the CPU) where there is
none."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Import every port module with ``jax`` made unimportable; no
    ``repro`` module may load on the way."""
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("repro", "jaxlib")
                or (m.startswith("jax") and sys.modules[m] is not None))
assert not leaked, leaked
print(" ".join(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={**os.environ,
                              "PYTHONPATH": str(REPO / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 50                      # every module imported
    assert names >= {"repro_torch.configs", "repro_torch.configs.base",
                     "repro_torch.configs.registry",
                     "repro_torch.configs.recurrentgemma_9b",
                     "repro_torch.kernels", "repro_torch.kernels.attention",
                     "repro_torch.kernels.rglru", "repro_torch.models",
                     "repro_torch.models.common",
                     "repro_torch.models.attention",
                     "repro_torch.models.rglru",
                     "repro_torch.models.transformer",
                     "repro_torch.models.model",
                     "repro_torch.models.convert", "repro_torch.launch",
                     "repro_torch.launch.serve",
                     "repro_torch.percipience", "repro_torch.percipience.heat",
                     "repro_torch.percipience.advisor",
                     "repro_torch.percipience.prefetcher",
                     "repro_torch.percipience.telemetry",
                     "repro_torch.core.streams",
                     "repro_torch.core.storage_window",
                     "repro_torch.analytics.streaming"}


@pytest.fixture()
def no_cuda(monkeypatch):
    """This host as one without a usable card, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_cuda, tmp_path):
    from repro_torch import NoCudaDeviceError, resolve_device
    from repro_torch.analytics import kernels as K
    from repro_torch.core import Clovis
    with pytest.raises(NoCudaDeviceError):
        resolve_device()
    with pytest.raises(NoCudaDeviceError):
        Clovis(tmp_path / "s")
    with pytest.raises(NoCudaDeviceError):
        K.kernel_mode()
    with pytest.raises(NoCudaDeviceError):
        K.segment_reduce(np.arange(4), np.zeros(4, np.int32), 1)


def test_cpu_engine_inherits_device_and_runs_plain_versions(no_cuda,
                                                            tmp_path):
    from repro_torch.analytics import col
    from repro_torch.analytics import kernels as K
    from repro_torch.core import Clovis
    cl = Clovis(tmp_path / "s", device="cpu")
    eng = cl.analytics()
    try:
        assert eng.device == torch.device("cpu")
        assert eng.shipper.device == torch.device("cpu")
        assert K.kernel_mode(eng.device) == "torch-cpu"
        cl.put_array("t/0", np.arange(12, dtype=np.int32).reshape(6, 2),
                     container="t")
        K.reset_launch_counts()
        assert eng.scan("t").filter(col(0) > 4).count() == 3
        assert sum(K.LAUNCHES.values()) == 0      # no CUDA kernel on CPU
    finally:
        eng.close()


def test_cuda_wrapper_never_falls_back(monkeypatch):
    """A CUDA tensor goes to the kernel or raises: with the build made to
    fail, each wrapper raises instead of running its plain version."""
    from repro_torch import _ext
    from repro_torch.analytics import kernels as K

    def broken():
        raise _ext.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_ext, "library", broken)
    monkeypatch.setattr(K, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    v = torch.zeros(4, dtype=torch.int32)
    prog = K.compile_specs("", "", (), "int32")
    K.reset_launch_counts()
    with pytest.raises(_ext.KernelBuildError):
        K.segment_reduce_tensor(v, v, 2, "sum")
    with pytest.raises(_ext.KernelBuildError):
        K.window_reduce_tensor(v, 2, 2, "sum")
    with pytest.raises(_ext.KernelBuildError):
        K.fused_filter_aggregate_tensor([], prog, v, 2, "count",
                                        torch.int32)
    assert sum(K.LAUNCHES.values()) == 0

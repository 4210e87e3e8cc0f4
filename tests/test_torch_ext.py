"""The kernel library's name follows every byte it is built from, headers
included, so an edited ``csrc/*.cuh`` never loads a stale build.  No
``nvcc`` is needed: only the name is computed."""
import shutil

import pytest

from repro_torch import _ext


@pytest.fixture()
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_ext.CSRC, dst)
    return dst


def test_the_sources_include_a_header():
    assert any(_ext.CSRC.glob("*.cuh"))
    assert all(p.suffix == ".cu" for p in _ext.SOURCES)


def test_library_name_is_stable_and_in_the_build_dir(csrc):
    path = _ext.library_path(csrc)
    assert path == _ext.library_path(csrc) == _ext.library_path()
    assert path.parent == _ext.BUILD_DIR
    assert path.name.startswith("sage_kernels-") and path.suffix == ".so"


@pytest.mark.parametrize("pattern", ["*.cuh", "*.cu"])
def test_library_name_changes_with_a_file_it_is_built_from(csrc, pattern):
    before = _ext.library_path(csrc)
    src = sorted(csrc.glob(pattern))[0]
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert _ext.library_path(csrc) != before


def test_library_name_changes_with_a_new_header(csrc):
    before = _ext.library_path(csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _ext.library_path(csrc) != before


def _launchers():
    """name -> parameter kinds of every ``extern "C"`` function in
    csrc/*.cu, read from the source: a pointer (any ``*``) is "P", an
    ``int64_t`` "I64", an ``int`` "I", a ``float`` "F"."""
    import re
    kinds = {}
    for src in _ext.SOURCES:
        text = src.read_text()
        block = text[text.index('extern "C" {'):]
        for m in re.finditer(r"^(?:int|const char\*) (sage_\w+)\(([^)]*)\)",
                             block, re.M):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            kinds[m.group(1)] = [
                "P" if "*" in p else "I64" if p.startswith("int64_t")
                else "F" if p.startswith("float") else "I" for p in params]
    return kinds


def test_argtypes_match_every_launcher_in_the_sources():
    """A launcher whose C signature and ``_SIGNATURES`` entry disagree in
    count or kind would only fail (or pass a cut pointer) on the card."""
    names = {_ext._P: "P", _ext._I: "I", _ext._I64: "I64", _ext._F: "F"}
    found = _launchers()
    assert set(found) == set(_ext._SIGNATURES)
    for name, params in found.items():
        assert [names[t] for t in _ext._SIGNATURES[name]] == params, name


def test_every_cu_under_csrc_is_built():
    """Each ``.cu`` compiles in its own nvcc process, so a source that
    ``SOURCES`` missed would leave its launchers out of the library; the
    bf16 kernels of B5 and B6 are sources of their own."""
    assert set(_ext.SOURCES) == set(_ext.CSRC.glob("*.cu"))
    names = {p.name for p in _ext.SOURCES}
    assert {"attention_bf16.cu", "ssd_bf16.cu"} <= names


def test_bf16_launchers_are_bound_and_counted():
    """B5 and B6 on bf16 inputs have launchers of their own, bound beside
    the f32 ones with the same argument kinds as theirs (B6's without the
    scores scratch), and launch counts of their own."""
    sig = _ext._SIGNATURES
    assert sig["sage_flash_attention_bf16"] == sig["sage_flash_attention"]
    f32 = list(sig["sage_ssd_scan"])
    del f32[16]                          # the scores scratch
    assert list(sig["sage_ssd_scan_bf16"]) == f32
    for name in ("flash_attention", "ssd_scan"):
        assert _ext.LAUNCHES[name] == _ext.LAUNCHES[f"{name}_bf16"] == 0


def test_the_kernel_modules_import_without_nvcc_or_triton(tmp_path):
    """Nothing is built or imported from the toolchain when the modules
    are imported: here there is no nvcc, no CUDA_HOME and no triton."""
    import os
    import subprocess
    import sys
    code = ("import sys; from repro_torch import _ext; "
            "from repro_torch.kernels import attention, ssd, rglru; "
            "assert _ext._lib is None; "
            "assert 'triton' not in sys.modules; print('ok')")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = str(tmp_path)
    env["PYTHONPATH"] = str(_ext.CSRC.parents[1])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

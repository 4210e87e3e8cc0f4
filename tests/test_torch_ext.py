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

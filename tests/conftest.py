import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def sage(tmp_path):
    """Fresh Clovis stack per test (own ADDB, no throttling)."""
    from repro.core.addb import Addb
    from repro.core.clovis import Clovis

    return Clovis(tmp_path / "sage", addb=Addb(), devices_per_tier=3)


def make_events(sage, n_objects=4, rows=256, seed=0, container="events",
                key_range=(0, 7)):
    """Container of (key, filter, value, part) int32 row tables.

    Shared store factory for the analytics/serving/compaction suites
    (previously copy-pasted per file).  ``key_range`` is the half-open
    range of column-0 group keys: the analytics suite wants a small
    keyspace for group-by fan-in, the serving suite a wide signed one.
    """
    rng = np.random.default_rng(seed)
    lo, hi = key_range
    arrs = []
    for i in range(n_objects):
        a = np.empty((rows, 4), np.int32)
        a[:, 0] = rng.integers(lo, hi, rows)
        a[:, 1] = rng.integers(0, 100, rows)
        a[:, 2] = rng.integers(-40, 40, rows)
        a[:, 3] = i
        sage.put_array(f"{container}/{i:02d}", a, container=container)
        arrs.append(a)
    return np.vstack(arrs)


@pytest.fixture()
def edge_buffer_factory(tmp_path):
    """Factory for durable EdgeBuffers under this test's tmp dir; every
    buffer it makes is closed at teardown."""
    from repro.edge.buffer import EdgeBuffer

    made = []

    def make(name="p0", **kw):
        kw.setdefault("segment_bytes", 256)
        buf = EdgeBuffer(tmp_path / "edge" / name, **kw)
        made.append(buf)
        return buf

    yield make
    for buf in made:
        buf.close()


@pytest.fixture()
def dht_factory(sage):
    """Factory for WindowDHTs backed by this test's Clovis stack."""
    from benchmarks.bench_dht import WindowDHT
    from repro.core.storage_window import WindowAllocator

    wa = WindowAllocator(sage)

    def make(name="t", n_buckets=64, heap=8, tier=None):
        return WindowDHT(wa, name, n_buckets, heap, tier)

    return make

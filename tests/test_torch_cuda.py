"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips on a host without a
usable GPU; run them on one with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Integer results must be equal, f32 min/max equal and f32 sums within
``1e-4`` of the segment's sum of |v| (atomics add in another order).
``chip_smoke.py`` covers the same ground at the main path's sizes.
"""
import numpy as np
import pytest
import torch

from repro_torch.analytics import col
from repro_torch.analytics import kernels as K

pytestmark = pytest.mark.cuda
OPS = ("sum", "count", "min", "max")


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _close(got, want, op, abs_sum=None):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32 and op == "sum":
        assert bool(((got - want).abs() <= 1e-4 * abs_sum + 1e-6).all())
    else:
        assert torch.equal(got, want)


def _data(dev, n, n_seg, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ids = torch.randint(-1, n_seg, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    ints = torch.randint(-500, 500, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    floats = torch.randn((n,), generator=g, device=dev)
    return ids, ints, floats


@pytest.mark.parametrize("n,n_seg", [(1, 1), (1025, 128), (70000, 4096),
                                     (70000, 60000)])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt", ["int32", "float32"])
def test_segment_kernel_matches_plain(dev, n, n_seg, op, dt):
    ids, ints, floats = _data(dev, n, n_seg, n + n_seg)
    v = ints if dt == "int32" else floats
    K.reset_launch_counts()
    got = K.segment_reduce_tensor(v, ids, n_seg, op)
    assert K.LAUNCHES["segment_reduce"] == 1
    want = K.segment_reduce_plain(v, ids, n_seg, op)
    _close(got, want, op, K.segment_reduce_plain(v.abs(), ids, n_seg, "sum"))


@pytest.mark.parametrize("n,window,slide", [(1025, 64, 17), (70000, 4096,
                                                             4096),
                                            (4096, 4096, 1)])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dt", ["int32", "float32"])
def test_window_kernel_matches_plain(dev, n, window, slide, op, dt):
    _, ints, floats = _data(dev, n, 1, window)
    v = ints if dt == "int32" else floats
    got = K.window_reduce_tensor(v, window, slide, op)
    want = K.window_reduce_plain(v, window, slide, op)
    _close(got, want, op, K.window_reduce_plain(v.abs(), window, slide,
                                                "sum"))


SPECS = [((col(1) % 7) == 3) | ~(col(0) < 0), (col(0) / 3) > 10.5, None]


@pytest.mark.parametrize("n,n_seg", [(1, 1), (1025, 128), (70000, 60000)])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_fused_kernel_matches_plain(dev, n, n_seg, op, spec):
    ids, ints, floats = _data(dev, n, n_seg, 7 * n + spec)
    pred = SPECS[spec]
    cols = {0: ints.cpu().numpy(), 1: (ints % 97).cpu().numpy(),
            2: floats.cpu().numpy()}
    for value, dt in ((col(1) % -7, np.int32), (col(2) * 0.5 + col(0) / 7,
                                                 np.float32)):
        prog = K.fused_program(cols, None if pred is None else
                               pred.to_spec(), value.to_spec(), dt)
        ts = [torch.from_numpy(cols[i]).to(dev) for i in sorted(cols)]
        tdt = torch.int32 if dt == np.int32 else torch.float32
        got = K.fused_filter_aggregate_tensor(ts, prog, ids, n_seg, op, tdt)
        want = K.fused_filter_aggregate_plain(ts, prog, ids, n_seg, op, tdt)
        val = K._run_program_plain(prog.code[prog.n_pred:], prog, ts)
        abs_sum = K.segment_reduce_plain(val.abs().float(), ids, n_seg,
                                         "sum")
        _close(got[0], want[0], op, abs_sum)
        _close(got[1], want[1], "count")


def test_host_api_on_cuda_matches_cpu(dev):
    rng = np.random.default_rng(0)
    v = rng.integers(-500, 500, 5000).astype(np.int32)
    ids = rng.integers(-1, 50, 5000).astype(np.int32)
    for op in OPS:
        np.testing.assert_array_equal(
            K.segment_reduce(v, ids, 50, op=op, device=dev),
            K.segment_reduce(v, ids, 50, op=op, device="cpu"))
        np.testing.assert_array_equal(
            K.window_reduce(v, 64, op=op, slide=5, device=dev),
            K.window_reduce(v, 64, op=op, slide=5, device="cpu"))
    np.testing.assert_array_equal(
        K.histogram(v, 32, (-500, 500), device=dev),
        K.histogram_ref(v, 32, (-500, 500)))

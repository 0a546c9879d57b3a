"""``core.device_simulate._trace_lanes``: the trace's 64-bit keys copied to
the run's device once and split there into their (lo, hi) int32 lanes, bit
for bit ``keys_to_lanes`` for every dtype and layout a caller passes.

A C-contiguous uint64 or int64 array is taken as it is; anything else is
converted on the host first and counted as ``keys_converted``.  The lanes
are contiguous, own their memory (never the caller's array, also on the
CPU, where the copy to the device is none), and ``bytes_in`` is 8 bytes a
key.  The ``gpu`` case runs the same equalities on the card and checks
that the device copy of the keys is released:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_trace_lanes.py``.
"""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import program_trace
from repro_torch.core.device_simulate import _trace_lanes
from repro_torch.kernels.sketch_common import keys_to_lanes

DTYPES = ("uint64", "int64", "int32", "list")
SHAPES = ("1d", "2d", "strided")
CASES = [(d, s) for d in DTYPES for s in SHAPES]


def _keys(dtype: str, shape: str, cols: int = 40):
    """A trace of ``dtype`` (uint64 with high bits set, int64 and int32
    with negatives, a Python list of int64 values) laid out as ``shape``:
    a (cols,) row, an (8, cols) array, or a (4, cols) strided slice."""
    rng = np.random.default_rng(7)
    if dtype == "int32":
        k = rng.integers(-2**31, 2**31, size=(4, 2 * cols), dtype=np.int32)
    else:
        k = rng.integers(0, 2**64, size=(4, 2 * cols), dtype=np.uint64)
        assert (k >= np.uint64(2**63)).any()
        if dtype != "uint64":
            k = k.view(np.int64)
    if dtype != "uint64":
        assert (k < 0).any()
    k = {"1d": k[0, :cols], "2d": k.reshape(8, cols),
         "strided": k[:, ::2]}[shape]
    assert k.flags.c_contiguous == (shape != "strided")
    return k.tolist() if dtype == "list" else k


def _converted(dtype: str, shape: str) -> bool:
    return dtype not in ("uint64", "int64") or shape == "strided"


def _assert_lanes_equal(trace, lo, hi):
    want_lo, want_hi = keys_to_lanes(trace)
    for got, want in ((lo, want_lo), (hi, want_hi)):
        assert got.dtype == torch.int32 and got.is_contiguous()
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def _profiled_lanes(trace):
    """(lo, hi), and the ``engine.lanes`` and ``engine.copy_in`` spans of
    one ``_trace_lanes`` call on the CPU."""
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        lo, hi = _trace_lanes(trace, "cpu")
        spans = program_trace.spans_between(t0, time.time_ns())
    assert [s.name for s in spans] == ["engine.lanes", "engine.copy_in"]
    return (lo, hi), spans


@pytest.mark.parametrize("dtype,shape", CASES)
def test_trace_lanes_equal_keys_to_lanes(dtype, shape):
    trace = _keys(dtype, shape)
    _assert_lanes_equal(trace, *_trace_lanes(trace, "cpu"))


@pytest.mark.parametrize("trace", [
    np.array(2**64 - 5, dtype=np.uint64), np.array([-7], dtype=np.int64),
    np.zeros(0, dtype=np.uint64), np.zeros((3, 0), dtype=np.int64),
    np.arange(-6, 6, dtype=np.int64).reshape(3, 4).T],
    ids=["scalar", "one-key", "empty", "empty-lanes", "transposed"])
def test_trace_lanes_edge_shapes(trace):
    _assert_lanes_equal(trace, *_trace_lanes(trace, "cpu"))


@pytest.mark.parametrize("dtype,shape", CASES)
def test_lanes_are_contiguous_int32_and_never_alias_the_trace(dtype, shape):
    trace = _keys(dtype, shape)
    before = np.array(trace, copy=True)
    lo, hi = _trace_lanes(trace, "cpu")
    assert lo.dtype == hi.dtype == torch.int32
    assert lo.is_contiguous() and hi.is_contiguous()
    assert lo.untyped_storage().data_ptr() != hi.untyped_storage().data_ptr()
    lo.add_(1)
    hi.bitwise_not_()
    np.testing.assert_array_equal(np.asarray(trace), before)


@pytest.mark.parametrize("dtype,shape", CASES)
def test_bytes_in_is_8_a_key_and_only_conversions_are_counted(dtype, shape):
    trace = _keys(dtype, shape)
    n = np.asarray(trace).size
    (lo, hi), (lanes, copy_in) = _profiled_lanes(trace)
    want = {"keys_converted": n} if _converted(dtype, shape) else {}
    assert lanes.counters == want
    assert copy_in.counters == {"bytes_in": 8 * n}
    assert lo.nbytes + hi.nbytes == 8 * n
    _assert_lanes_equal(trace, lo, hi)


def test_a_read_only_trace_is_converted_and_left_as_it_is():
    trace = _keys("uint64", "2d")
    trace.flags.writeable = False
    (lo, hi), (lanes, copy_in) = _profiled_lanes(trace)
    assert lanes.counters == {"keys_converted": trace.size}
    assert copy_in.counters == {"bytes_in": 8 * trace.size}
    _assert_lanes_equal(trace, lo, hi)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", CASES)
def test_trace_lanes_on_card_equal_keys_to_lanes_and_free_the_keys(dtype,
                                                                   shape):
    """On the card: the same equalities, and the device memory held after
    the call is exactly lo plus hi (the int64 keys were released); sizes
    are whole 512-byte blocks of the allocator."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    trace = _keys(dtype, shape, cols=4096)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    lo, hi = _trace_lanes(trace, "cuda")
    grown = torch.cuda.memory_allocated() - before
    assert lo.is_cuda and hi.is_cuda
    assert grown == lo.nbytes + hi.nbytes == 8 * np.asarray(trace).size
    _assert_lanes_equal(trace, lo, hi)

"""The benchmark's copy of the trace generators is frozen: a digest of a
small trace from each, pinned, and the port's generators still agreeing
with it today (a later change to the program's generators fails only the
second test, never the benchmark's inputs)."""
import hashlib

import numpy as np
import pytest

from tinylfu_bench import gen
from tinylfu_bench.gen import synthetic

CALLS = {
    "zipf_trace": dict(length=5000, n_items=3000, alpha=0.9, seed=7),
    "tenant_lanes_trace": dict(streams=4, length=2000, n_items=3000,
                               drift_every=500, seed=7),
    "youtube_dynamic_trace": dict(length=4200, weeks=3, items_per_week=500,
                                  seed=7),
    "wiki_drift_trace": dict(length=5000, n_items=4000, drift_every=1000,
                             seed=7),
    "spc1_like_trace": dict(length=5000, n_random=2000, seed=7),
    "oltp_like_trace": dict(length=5000, n_pages=2000, seed=7),
    "scan_then_hotspot_trace": dict(),
    "fickle_churn_trace": dict(length=5000, seed=7),
    "phase_shift_trace": dict(length=5000, seed=7),
    "glimpse_trace": dict(length=5000, seed=7),
    "multi_tenant_prompt_trace": dict(n_requests=200, n_tenants=20, seed=7),
}
PINS = {
    "zipf_trace": "a4792db2fef2236b",
    "tenant_lanes_trace": "3afcf87ad66e63b7",
    "youtube_dynamic_trace": "8db792b3250781e4",
    "wiki_drift_trace": "f48b8e549ff812b0",
    "spc1_like_trace": "09030886a7f87745",
    "oltp_like_trace": "2701341a3dc35158",
    "scan_then_hotspot_trace": "d1e27782ae49c5f4",
    "fickle_churn_trace": "331c88bc81c081bf",
    "phase_shift_trace": "e838dd69ce83a231",
    "glimpse_trace": "46fe80182c669ded",
    "multi_tenant_prompt_trace": "3aa46bc9227dab7b",
}


def sha(a) -> str:
    a = np.ascontiguousarray(a, dtype="<i8")
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_copied_generator_is_frozen(name):
    assert sha(getattr(synthetic, name)(**CALLS[name])) == PINS[name]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_port_generator_agrees_with_the_copy(name):
    from repro_torch.traces import synthetic as port
    assert sha(getattr(port, name)(**CALLS[name])) == PINS[name]


def test_make_takes_the_seed_and_gives_uint64():
    t = {"generator": "zipf_trace", "args": {"length": 100, "n_items": 50}}
    a, b = gen.make(t, 2**31 + 5), gen.make(t, 2**31 + 5)
    c = gen.make(t, 2**31 + 6)
    assert a.dtype == np.uint64 and np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert np.array_equal(gen.make(t, 2**40), gen.make(t, 2**40))


def test_make_refuses_what_is_not_a_generator():
    for name in ("zipf_probs", "_cdf"):
        with pytest.raises(ValueError):
            gen.make({"generator": name, "args": {}}, 1)

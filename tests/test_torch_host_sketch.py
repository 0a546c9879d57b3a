"""The port's host sketch (repro_torch.core.sketch) against the reference's
(repro.core.sketch), and the caches built on it by default.

``FrequencySketch`` is fed the same keys with the same seeds and
configurations in both packages (CM and CBF layouts, with and without the
doorkeeper, conservative and plain updates, through resets): every estimate
and every counter, doorkeeper bit and register must be equal.  A
default-constructed port ``PrefixCache`` (the host sketch, nothing swapped)
must replay run P1's stream stat for stat like the default JAX one, and the
driver's default ``serve()`` must report what the reference's reports.

Run as a script, it prints the default JAX caches' stats over P1's grid,
pinned as ``check_runs.P1_HOST_PINS`` (``chip_smoke.py`` holds the port to
them): ``PYTHONPATH=src python tests/test_torch_host_sketch.py``, ~10 s.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import sketch as jsk
from repro.serve import driver as jdriver
from repro.serve import prefix_cache as jpc
from repro.traces import synthetic as jsyn
from repro_torch.check_runs import P1_CAPS, P1_HOST_PINS, P1_TRACE, replay
from repro_torch.core import sketch as psk
from repro_torch.serve import driver as pdriver
from repro_torch.serve import prefix_cache as ppc
from repro_torch.traces import synthetic as psyn

# SketchConfig kwargs: CM and CBF layouts, doorkeeper on and off, plain
# updates, small caps and a sample size that resets several times
SKETCH_CFGS = [
    dict(sample_size=1 << 20, counters=4096, rows=4, cap=1 << 30),
    dict(sample_size=500, counters=1024, rows=4, cap=7,
         doorkeeper_bits=4096, seed=3),
    dict(sample_size=300, counters=256, rows=4, cap=15, conservative=False,
         seed=1),
    dict(sample_size=400, counters=2048, rows=1, probes_per_row=4, cap=15,
         doorkeeper_bits=1024, doorkeeper_probes=2),
    dict(sample_size=64, counters=64, rows=2, cap=3, doorkeeper_bits=256,
         seed=7),
]


def keys_for(seed: int, n: int = 3000) -> list[int]:
    """Repeats from 150 keys, one-hit keys and full 64-bit keys."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 150, n)
    big = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    pick = rng.random(n)
    return [int(s) if p < 0.6 else int(b) if p < 0.8 else 10_000 + i
            for i, (s, b, p) in enumerate(zip(small, big, pick))]


def test_splitmix_matches():
    for x in (0, 1, 2**63, 2**64 - 1, 0x9E3779B97F4A7C15, 123_456_789):
        assert psk._splitmix64_py(x) == jsk._splitmix64_py(x)


@pytest.mark.parametrize("case", range(len(SKETCH_CFGS)))
def test_frequency_sketch_matches_reference(case):
    kw = SKETCH_CFGS[case]
    port = psk.FrequencySketch(psk.SketchConfig(**kw))
    ref = jsk.FrequencySketch(jsk.SketchConfig(**kw))
    assert port.cfg.width == ref.cfg.width
    assert port.cfg.meta_bits() == ref.cfg.meta_bits()
    keys = keys_for(case)
    for i, k in enumerate(keys):
        port.add(k)
        ref.add(k)
        if i % 97 == 0:
            assert port.estimate(k) == ref.estimate(k)
    assert (port.size, port.resets) == (ref.size, ref.resets)
    if kw["sample_size"] < len(keys):
        assert port.resets > 0
    for k in set(keys) | set(range(200)):
        assert port.estimate(k) == ref.estimate(k), k
    np.testing.assert_array_equal(port.table_array(), ref.table_array())
    assert port.dk == ref.dk
    port.reset()
    ref.reset()
    assert port.table == ref.table and port.size == ref.size


@pytest.mark.parametrize("cache_size", [1, 64, 200, 1000, 65_536])
@pytest.mark.parametrize("kw", [dict(), dict(sample_factor=3, rows=2),
                                dict(doorkeeper=False, counters_per_item=1.0),
                                dict(seed=5, dk_bits_per_item=2.0)])
def test_default_sketch_sizing_matches(cache_size, kw):
    port = psk.default_sketch(cache_size, **kw)
    ref = jsk.default_sketch(cache_size, **kw)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    assert port._probe_seeds == ref._probe_seeds
    assert port._dk_seeds == ref._dk_seeds


def test_default_sketch_refusals():
    with pytest.raises(NotImplementedError, match="item 10"):
        psk.default_sketch(100, shards=4)
    with pytest.raises(ValueError) as pe:
        psk.default_sketch(100, stale_estimates=True)
    with pytest.raises(ValueError) as je:
        jsk.default_sketch(100, stale_estimates=True)
    assert str(pe.value) == str(je.value)


def test_host_admission_matches_reference():
    port = ppc.HostAdmission(300, seed=2)
    ref = jpc.HostAdmission(300, seed=2)
    keys = keys_for(9, 2000)
    for s in range(0, len(keys), 32):
        port.record_batch(keys[s:s + 32])
        ref.record_batch(keys[s:s + 32])
    for c, v in zip(keys[:400], keys[400:800]):
        assert port.admit(c, v) == ref.admit(c, v)
        assert port.admit(-c - 1, v) == ref.admit(-c - 1, v)


@pytest.mark.parametrize("policy,cap", sorted(P1_HOST_PINS))
def test_default_prefix_cache_runs_p1_host(policy, cap):
    """Run P1-host on the CPU: a default-constructed port PrefixCache over
    P1's full stream gives the pinned stats of the default JAX cache."""
    stream = psyn.multi_tenant_prompt_trace(**P1_TRACE)
    got = replay(ppc.PrefixCache(cap, policy=policy), stream)
    assert dataclasses.astuple(got) == P1_HOST_PINS[(policy, cap)]


def test_default_prefix_cache_matches_jax_default():
    """PrefixCache(C) of either package, defaults only, over a shortened
    P1 stream: every stat equal."""
    stream = psyn.multi_tenant_prompt_trace(300, n_tenants=40,
                                            tenant_alpha=1.0, seed=81)
    got = replay(ppc.PrefixCache(200), stream)
    want = replay(jpc.PrefixCache(200), stream)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.admitted > 0 and got.rejected > 0


def test_default_serve_matches_jax_default():
    """The drivers' default serve() (smoke config, host sketch, different
    random weights): the engine stats depend only on the prompts, the
    schedule and the cache, so they must be equal."""
    got = pdriver.serve("qwen3-4b", n_requests=12, device="cpu")
    want = jdriver.serve("qwen3-4b", n_requests=12)
    del got["wall_s"]
    assert got == want
    assert got["completed"] == 12 and got["block_hits"] > 0


if __name__ == "__main__":
    stream = jsyn.multi_tenant_prompt_trace(**P1_TRACE)
    for policy in ("tinylfu", "wtinylfu"):
        for cap in P1_CAPS:
            s = replay(jpc.PrefixCache(cap, policy=policy), stream)
            print(f"    ({policy!r}, {cap}): {dataclasses.astuple(s)},",
                  flush=True)

"""The port's serving-admission path (repro_torch.serve.prefix_cache) against
the JAX package's: block hashes, the payload pool, the multi-tenant prompt
trace, and a shortened replay of benchmarks/bench_serving.py whose
``PrefixCacheStats`` must equal the JAX ``PrefixCache`` stat for stat.

With the device sketch (``device_sketch=True``) the JAX cache runs its
``DeviceAdmission`` with the jnp oracles (``use_pallas=False``, held
bit-equal to the Pallas kernels by tests/test_kernels.py) and the port its
plain versions on the CPU.  Default-constructed caches (the host sketch) are
compared with nothing swapped.

Run as a script, it prints the JAX package's exact stats for runs P1 and P2
(``repro_torch.check_runs``, run on the card by ``chip_smoke.py``):
``PYTHONPATH=src python tests/test_torch_prefix_cache.py``, several minutes
on a CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import prefix_cache as jpc
from repro.traces import synthetic as jsyn
from repro_torch.check_runs import P1_CAPS, P1_TRACE, P2_CAP, P2_TRACE, replay
from repro_torch.serve import prefix_cache as ppc
from repro_torch.traces import synthetic as psyn

torch.set_num_threads(1)


def jax_cache(capacity, policy):
    """The JAX PrefixCache with its admission on the jnp oracles."""
    pc = jpc.PrefixCache(capacity, policy=policy, sample_factor=8)
    if pc.admission is not None:
        pc.admission = jpc.DeviceAdmission(capacity, 8, use_pallas=False)
    return pc


def test_block_hashes_match():
    rng = np.random.default_rng(0)
    for n, bs in ((8, 4), (10, 4), (33, 8), (200, 16)):
        toks = list(rng.integers(0, 50_000, n))
        assert ppc.block_hashes(toks, bs) == jpc.block_hashes(toks, bs)
    a = ppc.block_hashes([1, 2, 3, 4, 5, 6, 7, 8], 4)
    b = ppc.block_hashes([1, 2, 3, 4, 9, 9, 9, 9], 4)
    assert a[0] == b[0] and a[1] != b[1]


def test_payload_pool_store_load_free():
    tpl = {"a": torch.zeros(2, 3), "n": {"b": torch.zeros(4, dtype=torch.int32)}}
    pool = ppc.PayloadPool(tpl, 4, device="cpu")
    s1 = pool.store({"a": torch.ones(2, 3),
                     "n": {"b": torch.arange(4, dtype=torch.int32)}})
    got = pool.load(s1)
    assert float(got["a"].sum()) == 6.0
    assert got["n"]["b"].tolist() == [0, 1, 2, 3]
    assert pool.used == 1
    s2 = pool.store({"a": torch.full((2, 3), 2.0),
                     "n": {"b": torch.ones(4, dtype=torch.int32)}})
    many = pool.load_many([s2, s1])
    assert many["a"].shape == (2, 2, 3) and float(many["a"][0, 0, 0]) == 2.0
    pool.free(s1)
    assert pool.used == 1
    assert float(got["a"].sum()) == 6.0          # a load is a copy
    with pytest.raises(TypeError):
        ppc.PayloadPool({"a": np.zeros(2)}, 2, device="cpu")


def test_payload_pool_exhaustion():
    pool = ppc.PayloadPool({"a": torch.zeros(2)}, 2, device="cpu")
    assert pool.store({"a": torch.ones(2)}) is not None
    assert pool.store({"a": torch.ones(2)}) is not None
    assert pool.store({"a": torch.ones(2)}) is None


def test_multi_tenant_prompt_trace_matches():
    for args in ((300, 40, 1.0, 5), (6000, 400, 1.0, 81)):
        n, t, a, s = args
        np.testing.assert_array_equal(
            psyn.multi_tenant_prompt_trace(n, n_tenants=t, tenant_alpha=a,
                                           seed=s),
            jsyn.multi_tenant_prompt_trace(n, n_tenants=t, tenant_alpha=a,
                                           seed=s))
    assert len(psyn.multi_tenant_prompt_trace(**P1_TRACE)) == 216_903


@pytest.mark.parametrize("policy", ["lru", "tinylfu", "wtinylfu"])
def test_shortened_replay_matches_jax(policy):
    """A few hundred requests at capacity 200: every stat equal."""
    stream = psyn.multi_tenant_prompt_trace(300, n_tenants=40,
                                            tenant_alpha=1.0, seed=81)
    port = replay(ppc.PrefixCache(200, policy=policy, device_sketch=True,
                                  device="cpu"), stream)
    ref = replay(jax_cache(200, policy), stream)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if policy != "lru":
        assert port.admitted > 0 and port.rejected > 0


@pytest.mark.parametrize("policy", ["lru", "tinylfu", "wtinylfu"])
def test_shortened_replay_default_matches_jax_default(policy):
    """The same replay through default-constructed caches of both packages
    (the host sketch; nothing swapped): every stat equal.  At C=200 the
    host sketch decides differently from the device sketch."""
    stream = psyn.multi_tenant_prompt_trace(300, n_tenants=40,
                                            tenant_alpha=1.0, seed=81)
    port = ppc.PrefixCache(200, policy=policy)
    assert policy == "lru" or isinstance(port.admission, ppc.HostAdmission)
    got = replay(port, stream)
    ref = replay(jpc.PrefixCache(200, policy=policy), stream)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    if policy == "wtinylfu":
        dev = replay(ppc.PrefixCache(200, device_sketch=True, device="cpu"),
                     stream)
        assert (got.block_hits, got.admitted) == (2044, 595)
        assert (dev.block_hits, dev.admitted) == (2052, 577)


def test_cache_semantics_match_reference_tests():
    """tests/test_serving.py's policy contracts, on the port."""
    pc = ppc.PrefixCache(8, policy="tinylfu", device_sketch=True,
                         device="cpu")
    hot = list(range(8))
    for _ in range(20):
        pc.lookup(hot)
    for i in range(8):
        pc.insert(i, i)
    for k in range(1000, 1032):
        pc.insert(k, k)
    assert sum(1 for k in hot if k in pc) == 8
    assert pc.stats.rejected >= 30
    w = ppc.PrefixCache(100, policy="wtinylfu", window_frac=0.1,
                        device_sketch=True, device="cpu")
    for i in range(5):
        w.insert(5000 + i, i)
    assert not w.insert(77, 9) and 77 in w
    lru = ppc.PrefixCache(4, policy="lru", device="cpu")
    freed = [f for i in range(8) for f in lru.insert(i, i)]
    assert len(lru) == 4 and sorted(freed) == [0, 1, 2, 3]


def test_lookup_snapshots_matches_jax():
    rng = np.random.default_rng(4)
    port = ppc.PrefixCache(16, policy="wtinylfu", device_sketch=True,
                           device="cpu")
    ref = jax_cache(16, "wtinylfu")
    for _ in range(60):
        hashes = [int(x) for x in rng.integers(0, 40, 12)]
        assert port.lookup_snapshots(hashes, 3)[0] == \
            ref.lookup_snapshots(hashes, 3)[0]
        for h in hashes[:4]:
            if h not in port:
                port.insert(h, h)
                ref.insert(h, h)
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)


def test_host_sketch_is_not_ported():
    """The host sketch is ported, sharded twin included:
    default_sketch(shards=2) gives the ShardedFrequencySketch with the
    reference's configuration; the cache refuses a policy the reference
    does not have."""
    from repro.core.sketch import default_sketch as jax_default_sketch
    from repro_torch.core.sketch import ShardedFrequencySketch, default_sketch
    port, ref = default_sketch(64, shards=2), jax_default_sketch(64, shards=2)
    assert isinstance(port, ShardedFrequencySketch)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    assert port.shards == ref.shards == 2
    with pytest.raises(ValueError, match="policy"):
        ppc.PrefixCache(64, policy="arc", device="cpu")


def test_cache_defaults_to_the_card():
    """The device sketch and the pool default to the card; the default
    cache (the host sketch) touches no device, so it builds anywhere."""
    for policy in ("lru", "tinylfu", "wtinylfu"):
        assert ppc.PrefixCache(64, policy=policy).stats.lookups == 0
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    for make in (lambda: ppc.PrefixCache(64, device_sketch=True),
                 lambda: ppc.PayloadPool({"a": torch.zeros(1)}, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


if __name__ == "__main__":
    stream = jsyn.multi_tenant_prompt_trace(**P1_TRACE)
    for policy in ("lru", "tinylfu", "wtinylfu"):
        for cap in P1_CAPS:
            s = replay(jax_cache(cap, policy), stream)
            print("P1", policy, cap, dataclasses.astuple(s), flush=True)
    s = replay(jax_cache(P2_CAP, "wtinylfu"),
               jsyn.multi_tenant_prompt_trace(**P2_TRACE))
    print("P2 wtinylfu", P2_CAP, dataclasses.astuple(s), flush=True)

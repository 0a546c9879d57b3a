"""The port's serving engine (repro_torch.serve.engine) against the JAX
package's, on the CPU: the same prompts (``make_workload``) and the same
weights (``check_runs.numpy_params``) through both ``ServeEngine``s on the
qwen3 smoke config.  Every ``stats`` field must be equal (they depend only
on the prompts, the schedule and the cache), and with fp32 compute the
generated tokens too.  With the device sketch the JAX engine's admission
runs on the jnp oracles (``DeviceAdmission(use_pallas=False)``, held
bit-equal to its Pallas kernels by tests/test_kernels.py) and the port's
(``device_sketch=True``) on its plain versions; default-constructed engines
(the host sketch) are compared with nothing swapped.  Also
tests/test_serving.py's reuse determinism and tests/test_system.py's
pool-pressure accounting, on the port.

Run as a script, it prints the JAX engine's stats for run L of
``repro_torch.check_runs`` (held on the card by ``chip_smoke.py``):
``PYTHONPATH=src python tests/test_torch_serving.py``, a few minutes on a
CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxEngine
from repro.serve import driver as jdriver
from repro.serve import prefix_cache as jpc
from repro_torch.check_runs import numpy_params
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeEngine
from repro_torch.serve import driver as pdriver

torch.set_num_threads(1)


def engines(engine_kw, *, fp32=False, vocab=None, seed=0, device_sketch=True):
    """(JAX engine, port engine) over the same weights; both on the device
    sketch (the JAX one on its jnp oracles) or both on their defaults."""
    jcfg = jax_get_config("qwen3-4b", smoke=True)
    cfg = get_config("qwen3-4b", smoke=True)
    if fp32:
        jcfg = jcfg.replace(compute_dtype=jnp.float32)
        cfg = cfg.replace(compute_dtype=torch.float32)
    if vocab:
        jcfg, cfg = jcfg.replace(vocab_size=vocab), cfg.replace(
            vocab_size=vocab)
    tree = numpy_params(cfg, seed)
    jeng = JaxEngine(jax_build_model(jcfg),
                     jax.tree_util.tree_map(jnp.asarray, tree), **engine_kw)
    if device_sketch and jeng.prefix_cache.admission is not None:
        jeng.prefix_cache.admission = jpc.DeviceAdmission(
            jeng.prefix_cache.capacity, 8, use_pallas=False)
    peng = ServeEngine(Model(cfg, device="cpu"),
                       params_from_numpy(cfg, tree, device="cpu"),
                       **engine_kw, **({"device_sketch": True}
                                       if device_sketch else {}))
    return jeng, peng


def replay(eng, prompts, new_tokens):
    for p in prompts:
        eng.submit(p, new_tokens)
    return eng.run()


def test_make_workload_matches():
    cfg = get_config("qwen3-4b", smoke=True)
    for kw in (dict(), dict(n_tenants=6, prefix_len=40, suffix_len=7,
                            seed=3)):
        got = pdriver.make_workload(cfg, 30, **kw)
        want = jdriver.make_workload(jax_get_config("qwen3-4b", smoke=True),
                                     30, **kw)
        assert [list(map(int, p)) for p in got] == \
            [list(map(int, p)) for p in want]


@pytest.mark.parametrize("fp32", [True, False])
def test_engine_matches_jax(fp32):
    """The driver's smoke setup (max_batch 4, block 8, 48 pool slots; 16
    prompts of 24 shared and 9 own tokens, 3 new tokens each)."""
    kw = dict(max_batch=4, max_len=128, block_size=8, pool_slots=48)
    jeng, peng = engines(kw, fp32=fp32)
    cfg = peng.cfg
    prompts = pdriver.make_workload(cfg, 16, seed=1)
    want = replay(jeng, prompts, 3)
    got = replay(peng, prompts, 3)
    assert peng.stats == jeng.stats
    assert peng.stats["block_hits"] > 0
    assert sorted(got) == sorted(want)
    assert all(len(v) == 3 for v in got.values())
    if fp32:
        assert got == {r: [int(t) for t in v] for r, v in want.items()}


def test_engine_default_matches_jax_default():
    """The driver's smoke setup through default-constructed engines of both
    packages (the host sketch; nothing swapped): every stat and, in fp32,
    every token equal.  Every lookup records into the host sketch; the pool
    has as many slots as the cache, so no candidate reaches admission (the
    reference's caveat)."""
    kw = dict(max_batch=4, max_len=128, block_size=8, pool_slots=48)
    jeng, peng = engines(kw, fp32=True, device_sketch=False)
    from repro_torch.serve import HostAdmission
    assert isinstance(peng.prefix_cache.admission, HostAdmission)
    prompts = pdriver.make_workload(peng.cfg, 16, seed=1)
    want = replay(jeng, prompts, 3)
    got = replay(peng, prompts, 3)
    assert peng.stats == jeng.stats and peng.stats["block_hits"] > 0
    assert got == {r: [int(t) for t in v] for r, v in want.items()}


def test_snapshot_every_is_taken_and_inert_on_dense():
    """ServeEngine takes the reference's snapshot_every; on the dense model
    it changes nothing: snapshot_every=2 (in both packages) and the port's
    default give the JAX engine's stats and fp32 tokens.  The SSM families,
    where it sets the snapshot period: tests/test_torch_family_serving.py."""
    kw = dict(max_batch=4, max_len=128, block_size=8, pool_slots=48)
    jeng, peng = engines({**kw, "snapshot_every": 2}, fp32=True,
                         device_sketch=False)
    _, pdef = engines(kw, fp32=True, device_sketch=False)
    assert peng.snapshot_every == 2 and pdef.snapshot_every == 2
    prompts = pdriver.make_workload(peng.cfg, 16, seed=1)
    want = replay(jeng, prompts, 3)
    got = replay(peng, prompts, 3)
    assert replay(pdef, prompts, 3) == got
    assert peng.stats == pdef.stats == jeng.stats
    assert peng.stats["block_hits"] > 0
    assert got == {r: [int(t) for t in v] for r, v in want.items()}


def test_full_pool_admits_nothing_like_jax():
    """The pool has as many slots as the cache; once it is full no payload
    is stored and no candidate reaches admission: run L's caveat, small."""
    kw = dict(max_batch=2, max_len=96, block_size=8, pool_slots=6)
    jeng, peng = engines(kw, vocab=151936)
    prompts = pdriver.make_workload(peng.cfg, 10, n_tenants=3,
                                    prefix_len=40, suffix_len=16, seed=2)
    replay(jeng, prompts, 2)
    replay(peng, prompts, 2)
    s = peng.stats
    assert s == jeng.stats
    assert s["pool_used"] == 6 and s["admitted"] == s["rejected"] == 0
    assert s["block_hits"] > 0


def test_run_l_stats_at_smoke_width():
    """Run L's schedule on the port at smoke width (the published
    vocabulary): every stat equals the JAX pin that chip_smoke.py holds the
    full-width run to."""
    from repro_torch.check_runs import (L_ENGINE, L_NEW_TOKENS, L_PINS,
                                        L_WORKLOAD)
    cfg = get_config("qwen3-4b", smoke=True).replace(vocab_size=151936)
    m = Model(cfg, device="cpu")
    eng = ServeEngine(m, m.init(torch.Generator().manual_seed(0)),
                      **L_ENGINE, device_sketch=True)
    wl = dict(L_WORKLOAD)
    out = replay(eng, pdriver.make_workload(cfg, wl.pop("n_requests"), **wl),
                 L_NEW_TOKENS)
    assert len(out) == L_WORKLOAD["n_requests"]
    assert eng.stats == L_PINS


def port_engine(**kw):
    cfg = get_config("qwen3-4b", smoke=True)
    m = Model(cfg, device="cpu")
    return ServeEngine(m, m.init(torch.Generator().manual_seed(0)), **kw)


def test_generation_deterministic_under_reuse():
    eng = port_engine(max_batch=2, max_len=128, block_size=8, pool_slots=16)
    prompt = list(np.random.default_rng(1).integers(0, eng.cfg.vocab_size,
                                                    33))
    eng.submit(prompt, 6)
    r1 = eng.run()
    eng.submit(prompt, 6)
    r2 = eng.run()                      # second pass reuses cached blocks
    assert r1[0] == r2[1]
    assert eng.stats["block_hits"] > 0


def test_engine_under_pool_pressure():
    """Pool smaller than the working set: no leaks, accounting holds."""
    eng = port_engine(max_batch=2, max_len=96, block_size=8, pool_slots=4,
                      prefix_policy="tinylfu")
    rng = np.random.default_rng(1)
    shared = list(rng.integers(0, eng.cfg.vocab_size, 16))
    for _ in range(6):
        eng.submit(shared + list(rng.integers(0, eng.cfg.vocab_size, 9)), 2)
    out = eng.run()
    assert len(out) == 6
    assert eng.pool.used <= 4
    assert eng.pool.used == len(eng.prefix_cache)


def test_engine_defaults_and_refusals():
    from repro_torch.serve import DeviceAdmission, HostAdmission
    cfg = get_config("qwen3-4b", smoke=True)
    m = Model(cfg, device="cpu")
    assert isinstance(ServeEngine(m, None).prefix_cache.admission,
                      HostAdmission)
    assert isinstance(ServeEngine(m, None, device_sketch=True)
                      .prefix_cache.admission, DeviceAdmission)
    from types import SimpleNamespace
    from repro_torch.serve.extend import extend
    with pytest.raises(ValueError, match="tpu"):
        extend(SimpleNamespace(cfg=cfg.replace(family="tpu")), None, None,
               None, 0)
    eng = port_engine(max_batch=1, max_len=16, block_size=8, pool_slots=4)
    eng.submit(list(range(20)), 1)
    with pytest.raises(ValueError, match="exceed"):
        eng.run()


def l_pins():
    """Run L's stats from the JAX engine at smoke width with the published
    vocabulary."""
    from repro_torch.check_runs import (L_ENGINE, L_NEW_TOKENS,
                                        L_WORKLOAD)
    jeng, _ = engines(dict(L_ENGINE), vocab=151936)
    wl = dict(L_WORKLOAD)
    prompts = jdriver.make_workload(jeng.cfg, wl.pop("n_requests"), **wl)
    out = replay(jeng, prompts, L_NEW_TOKENS)
    assert len(out) == len(prompts)
    return jeng.stats


if __name__ == "__main__":
    import time
    t0 = time.perf_counter()
    print("L_PINS =", l_pins())
    print(f"# {time.perf_counter() - t0:.1f} s")

"""The sharded sketch (``shards=S``) through the port's engine against the
JAX engine's sharded contracts (tests/test_device_simulate.py,
tests/test_sketch_merge.py, tests/test_streams.py), on the CPU.

Each case feeds the same keys to the port (``device="cpu"``: the plain
``step_ref`` one merge epoch at a time, ``merge_halve`` after every full
epoch) and to the JAX engine (``backend="jit"``) and requires every state
leaf (``csum`` included) and the hit flags to be equal: flat and 8 ways,
4- and 8-bit counters, doorkeeper on and off, traces that end mid-epoch,
shorter than an epoch and empty, integrity clean and with a flipped global
word, and ``sample_size=0`` against the unsharded step.  Tenant lanes,
sharded sweeps and the JAX Pallas kernel are in test_torch_sharded_lanes.py.

Run as a script, it prints the JAX pins of runs F4/F4I and the sharded G1
hits (``repro_torch.check_runs``, run on the card by ``chip_smoke.py``):
``PYTHONPATH=src python tests/test_torch_sharded.py``, ~1 min.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro.kernels import sketch_merge as jkm
from repro.kernels import sketch_step as jks
from repro_torch.core import device_simulate as pds
from repro_torch.kernels import sketch_merge as pkm
from repro_torch.kernels import sketch_step as pks
from repro_torch.kernels.sketch_common import keys_to_lanes
from repro_torch.traces import synthetic as psyn

torch.set_num_threads(1)

C, T, WARMUP = 64, 900, 200


@functools.lru_cache(maxsize=None)
def zipf(n=T, seed=7):
    return psyn.zipf_trace(n, n_items=3000, alpha=0.9, seed=seed)


def assert_state_equal(got: dict, want: dict, what: str = ""):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what} state[{k!r}]")


def both(trace, capacity=C, **kw):
    """(port result, state, hits), (JAX result, state, hits) of one run."""
    p = pds.simulate_trace(trace, capacity, device="cpu", return_state=True,
                           **kw)
    j = jds.simulate_trace(trace, capacity, return_state=True, **kw)
    return p, j


def assert_runs_equal(p, j):
    (pr, ps, ph), (jr, js, jh) = p, j
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js)
    assert (pr.hits, pr.accesses, pr.policy) == (jr.hits, jr.accesses,
                                                 jr.policy)
    assert sorted(pr.extra) == sorted(jr.extra)
    for k in ("shards", "merge_every", "integrity", "assoc", "streams"):
        assert pr.extra.get(k) == jr.extra.get(k), k


CASES = {
    "S2 flat cb4 dk": dict(shards=2),
    "S4 flat cb8 no-dk": dict(shards=4, counter_bits=8, sample_factor=20,
                              doorkeeper=False),
    "S2 ways8 cb8 dk": dict(shards=2, assoc=8, counter_bits=8),
    "S4 ways8 cb4 no-dk": dict(shards=4, assoc=8, doorkeeper=False),
    "S4 ways8 cb4 dk, W below the epoch": dict(shards=4, assoc=8,
                                               sample_factor=1,
                                               merge_every=200),
}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_jax(name):
    """A 900-access trace: merge epochs of 256 (the last one partial, not
    folded), or of 200 with W=64 so that folds owe several halvings."""
    kw = {"merge_every": 256, "warmup": WARMUP, **CASES[name]}
    p, j = both(zipf(), **kw)
    assert_runs_equal(p, j)
    assert p[0].extra["shards"] == kw["shards"]


@pytest.mark.parametrize("n", [0, 100], ids=["empty", "shorter than an epoch"])
@pytest.mark.parametrize("assoc", [None, 8], ids=["flat", "ways 8"])
def test_short_traces_equal_jax(n, assoc):
    p, j = both(zipf()[:n], shards=4, merge_every=256, assoc=assoc)
    assert_runs_equal(p, j)
    assert p[2].shape == (n,)


@pytest.mark.parametrize("assoc", [None, 8], ids=["flat", "ways 8"])
def test_integrity_equals_plain_and_jax(assoc):
    """integrity=True: every shared leaf and hit flag as without it, no
    shard quarantined, csum equal to JAX's."""
    kw = dict(shards=4, merge_every=256, assoc=assoc, warmup=WARMUP)
    p, j = both(zipf(seed=8), integrity=True, **kw)
    assert_runs_equal(p, j)
    plain = pds.simulate_trace(zipf(seed=8), C, device="cpu",
                               return_state=True, **kw)
    np.testing.assert_array_equal(p[2].numpy(), plain[2].numpy())
    assert_state_equal({k: v for k, v in p[1].items() if k != "csum"},
                       plain[1])
    assert int(p[1]["csum"][-1]) == 0 and p[0].extra["integrity"] is True


@pytest.mark.parametrize("assoc", [None, 8], ids=["flat", "ways 8"])
def test_quarantine_from_a_flipped_word_equals_reference(assoc):
    """A state with one flipped global counter word goes through the port's
    sharded runner and the reference's _run_sharded: leaf for leaf the
    quarantine matches (shard 1 zeroed, csum[S] counts it)."""
    cfg = pds.DeviceWTinyLFU(C, shards=4, integrity=True, assoc=assoc,
                             merge_every=256)
    spec = cfg.spec()
    jspec = jds.DeviceWTinyLFU(C, shards=4, integrity=True, assoc=assoc,
                               merge_every=256).spec()
    tr = zipf(seed=9)
    _, st, _ = pds.simulate_trace(tr[:512], C, device="cpu", shards=4,
                                  integrity=True, assoc=assoc,
                                  merge_every=256, return_state=True)
    start = {k: v.numpy().copy() for k, v in st.items()}
    start["counters"].view(np.uint32)[spec.wps_shard + 2] ^= np.uint32(1 << 5)
    rest = tr[512:T]
    lo, hi = keys_to_lanes(np.asarray(rest, np.uint64))
    pst = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    pst, ph = pds.run_chunks(spec, cfg.params(device="cpu"), pst,
                             torch.from_numpy(lo), torch.from_numpy(hi), 256,
                             fold=pkm.merge_halve)
    jst, jh = jds._run_sharded(
        jspec, jks.make_step_params(cfg.window_cap, cfg.main_cap,
                                    cfg.prot_cap, cfg.sample_size, cfg.cap),
        {k: jnp.asarray(v) for k, v in start.items()}, jnp.asarray(lo),
        jnp.asarray(hi), 256, "jit", False)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert_state_equal({k: v.numpy() for k, v in pst.items()}, jst)
    assert int(pst["csum"][-1]) == 1


@pytest.mark.parametrize("assoc", [None, 8], ids=["flat", "ways 8"])
def test_no_aging_equals_unsharded_bitwise(assoc):
    """sample_size=0 and collision-free widths: the sharded step with folds
    between epochs gives the unsharded step's hit flags bit for bit
    (reference tests/test_sketch_merge.py:239)."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 300, size=900, dtype=np.uint64)
    lo, hi = (torch.from_numpy(x) for x in keys_to_lanes(keys))
    kw = dict(width=1 << 16, rows=4, dk_bits=1 << 14)
    kw.update(dict(window_slots=2, main_slots=40) if assoc is None
              else dict(window_slots=8, main_slots=64, assoc=8))
    params = pks.make_step_params(2, 40, 32, 0, 7, 0, device="cpu")
    u, s = pks.StepSpec(**kw), pks.StepSpec(**kw, shards=4)
    _, hu = pds.run_chunks(u, params, pks.init_step_state(u, 2, 40,
                                                          device="cpu"),
                           lo, hi, 900)
    _, hs = pds.run_chunks(s, params, pks.init_step_state(s, 2, 40,
                                                          device="cpu"),
                           lo, hi, 300, fold=pkm.merge_halve)
    np.testing.assert_array_equal(hu.numpy(), hs.numpy())
    assert int(hu.sum()) > 100


if __name__ == "__main__":
    from repro.traces.synthetic import zipf_trace
    from repro_torch.check_runs import digest

    def leaves(s):
        return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
                s.items()}

    f = zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9, seed=11)
    for integrity in (False, True):
        r, s, _ = jds.simulate_trace(f, 65_536, warmup=480_000, assoc=8,
                                     shards=4, integrity=integrity,
                                     return_state=True)
        print(f"F4 integrity={integrity}: hits {r.hits} regs "
              f"{np.asarray(s['regs']).tolist()} digest {digest(leaves(s))}"
              f" merge_every {r.extra['merge_every']}")
    g = zipf_trace(60_000, n_items=50_000, alpha=0.9, seed=7)
    for S in (2, 4):
        r = jds.simulate_trace(g, 200, warmup=10_000, shards=S)
        print(f"G1 shards={S}: hits {r.hits}")

"""The port's batched sketch ops (repro_torch.kernels.ops and the four
kernel modules under it) against the JAX package's, bitwise.

Both sides get the same keys (numpy, from a seed); JAX runs on the CPU with
its jnp oracles (``use_pallas=False``, held bit-equal to the Pallas kernels
by tests/test_kernels.py), and a few cases run the Pallas kernels in
interpret mode.  The port runs its plain versions on CPU tensors.  Covers
the tests/test_kernels.py configurations and batches, the automatic reset at
the sample boundary, cap saturation, order dependence, the standalone reset,
the count-min lower bound, the ``DeviceTinyLFU`` facade and JAX-built state
carried into the port.

Run as a script, it prints the JAX package's exact results for run S
(``repro_torch.check_runs``, run on the card by ``chip_smoke.py``):
``PYTHONPATH=src python tests/test_torch_sketch_ops.py``.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sketch_common as jsc
from repro.traces import synthetic as jsyn
from repro_torch.kernels import ops as pops
from repro_torch.kernels import sketch_common as psc
from repro_torch.kernels import sketch_estimate, sketch_update, sketch_reset
from repro_torch.kernels import admission
from repro_torch.check_runs import (S_BATCH, S_BLOCKS, S_DECISIONS,
                                    SKETCH_CFGS as CFGS, digest, mixed_keys)


# the plain add issues a few dozen tiny ops per key: intra-op threads only
# spin, and under parallel test workers they contend for every core
torch.set_num_threads(1)

def cfgs(kw):
    return jsc.DeviceSketchConfig(**kw), psc.DeviceSketchConfig(**kw)


def jlanes(keys):
    return jsc.keys_to_lanes(np.asarray(keys, np.uint64))


def plines(keys):
    lo, hi = psc.keys_to_lanes(np.asarray(keys, np.uint64))
    return torch.from_numpy(lo.copy()), torch.from_numpy(hi.copy())


def assert_state_equal(pstate, jstate):
    for k in ("counters", "doorkeeper", "size"):
        np.testing.assert_array_equal(pstate[k].numpy(), np.asarray(jstate[k]),
                                      err_msg=f"state[{k!r}]")


@pytest.mark.parametrize("ci", range(len(CFGS)))
@pytest.mark.parametrize("batch", [1, 7, 128, 300])
def test_ops_match_jax(ci, batch):
    """add, estimate, admit and reset: state and outputs bit-equal."""
    jcfg, pcfg = cfgs(CFGS[ci])
    keys = mixed_keys(ci * 1000 + batch, batch)
    js = jops.add(jcfg, jsc.init_state(jcfg), *jlanes(keys), False)
    ps = pops.add(pcfg, psc.init_state(pcfg, device="cpu"), *plines(keys))
    assert_state_equal(ps, js)
    q = np.concatenate([keys[:32], mixed_keys(batch, 32)])
    v = np.roll(q, 1)
    np.testing.assert_array_equal(
        pops.estimate(pcfg, ps, *plines(q)).numpy(),
        np.asarray(jops.estimate(jcfg, js, *jlanes(q), False)))
    np.testing.assert_array_equal(
        pops.admit(pcfg, ps, *plines(q), *plines(v)).numpy(),
        np.asarray(jops.admit(jcfg, js, *jlanes(q), *jlanes(v), False)))
    assert_state_equal(pops.reset(pcfg, ps), jref.reset_ref(jcfg, js))


@pytest.mark.parametrize("ci,batch", [(0, 7), (1, 128), (3, 128)])
def test_ops_match_pallas_interpret(ci, batch):
    """The Pallas kernels themselves (interpret mode) at batch <= 128."""
    jcfg, pcfg = cfgs(CFGS[ci])
    keys = mixed_keys(7 + batch, batch)
    js = jops.add(jcfg, jsc.init_state(jcfg), *jlanes(keys), True)
    ps = pops.add(pcfg, psc.init_state(pcfg, device="cpu"), *plines(keys))
    assert_state_equal(ps, js)
    q = keys[:64]
    v = np.roll(q, 3)
    np.testing.assert_array_equal(
        pops.estimate(pcfg, ps, *plines(q)).numpy(),
        np.asarray(jops.estimate(jcfg, js, *jlanes(q), True)))
    np.testing.assert_array_equal(
        pops.admit(pcfg, ps, *plines(q), *plines(v)).numpy(),
        np.asarray(jops.admit(jcfg, js, *jlanes(q), *jlanes(v), True)))


def test_auto_reset_on_sample_boundary():
    """size 300 -> one reset after the batch -> 150, doorkeeper cleared."""
    kw = dict(width=256, rows=4, cap=15, dk_bits=1024, sample_size=256)
    jcfg, pcfg = cfgs(kw)
    keys = np.tile(np.arange(100), 3).astype(np.uint64)
    ps = pops.add(pcfg, psc.init_state(pcfg, device="cpu"), *plines(keys))
    assert int(ps["size"]) == 150
    assert int(ps["doorkeeper"].sum()) == 0
    assert int(ps["counters"].abs().sum()) > 0
    assert_state_equal(ps, jops.add(jcfg, jsc.init_state(jcfg),
                                    *jlanes(keys), False))


def test_cap_saturation():
    jcfg, pcfg = cfgs(dict(width=256, rows=4, cap=7, dk_bits=0))
    keys = np.full(50, 123456, np.uint64)
    ps = pops.add(pcfg, psc.init_state(pcfg, device="cpu"), *plines(keys))
    js = jops.add(jcfg, jsc.init_state(jcfg), *jlanes(keys), False)
    assert_state_equal(ps, js)
    assert int(pops.estimate(pcfg, ps, *plines(keys[:1]))[0]) == 7


def test_cap_plus_doorkeeper_reaches_cap_plus_one():
    jcfg, pcfg = cfgs(dict(width=256, rows=4, cap=7, dk_bits=1024))
    keys = np.full(50, 99, np.uint64)
    ps = pops.add(pcfg, psc.init_state(pcfg, device="cpu"), *plines(keys))
    assert_state_equal(ps, jops.add(jcfg, jsc.init_state(jcfg),
                                    *jlanes(keys), False))
    assert int(pops.estimate(pcfg, ps, *plines(keys[:1]))[0]) == 8


def test_sequential_order_dependence():
    """One batch equals two half-batches, and both equal JAX."""
    jcfg, pcfg = cfgs(CFGS[0])
    keys = mixed_keys(2, 120)
    once = pops.add(pcfg, psc.init_state(pcfg, device="cpu"), *plines(keys))
    two = psc.init_state(pcfg, device="cpu")
    pops.add(pcfg, two, *plines(keys[:60]))
    pops.add(pcfg, two, *plines(keys[60:]))
    for k in once:
        assert torch.equal(once[k], two[k]), k
    assert_state_equal(once, jops.add(jcfg, jsc.init_state(jcfg),
                                      *jlanes(keys), False))


def test_standalone_reset_matches_pallas():
    jcfg, pcfg = cfgs(CFGS[0])
    keys = mixed_keys(1, 500)
    js = jops.add(jcfg, jsc.init_state(jcfg), *jlanes(keys), False)
    ps = psc.sketch_state_from_numpy(
        pcfg, {k: np.asarray(v) for k, v in js.items()}, device="cpu")
    before = ps["counters"].clone()
    pops.reset(pcfg, ps)
    assert_state_equal(ps, jops.reset(jcfg, js))
    for nib in range(8):
        np.testing.assert_array_equal(
            ((ps["counters"] >> (4 * nib)) & 0xF).numpy(),
            ((before >> (4 * nib)) & 0xF).numpy() // 2)
    assert int(ps["size"]) == 250


@settings(max_examples=10, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=10_000), min_size=1,
                max_size=200))
def test_property_estimate_lower_bounds_true_count(keys):
    """est >= min(true count, cap + 1): the doorkeeper absorbs a key's first
    occurrence and gives it back as +1; the table never undercounts."""
    pcfg = psc.DeviceSketchConfig(width=4096, rows=4, cap=15,
                                  dk_bits=1 << 14)
    karr = np.asarray(keys, np.uint64)
    ps = pops.add(pcfg, psc.init_state(pcfg, device="cpu"), *plines(karr))
    uniq, counts = np.unique(karr, return_counts=True)
    est = pops.estimate(pcfg, ps, *plines(uniq)).numpy()
    assert (est >= np.minimum(counts, pcfg.cap + 1)).all()


def test_facade_end_to_end_matches_jax():
    p = pops.DeviceTinyLFU(num_blocks=128, sample_factor=8, device="cpu")
    j = jops.DeviceTinyLFU(num_blocks=128, sample_factor=8, use_pallas=False)
    assert p.cfg.__dict__ == j.cfg.__dict__
    rng = np.random.default_rng(0)
    hot = rng.integers(0, 100, size=2000, dtype=np.uint64)
    for s in range(0, 2000, 250):                 # several resets (W=1024)
        p.record(hot[s:s + 250])
        j.record(hot[s:s + 250])
    assert_state_equal(p.state, j.state)
    cold = np.arange(10_000, 10_064, dtype=np.uint64)
    hot_q = np.arange(0, 64, dtype=np.uint64)
    np.testing.assert_array_equal(p.estimate(hot_q), j.estimate(hot_q))
    admits = p.admit(cold, hot_q)
    np.testing.assert_array_equal(admits, j.admit(cold, hot_q))
    assert admits.sum() <= 3
    assert p.admit(hot_q, cold).sum() >= 60
    assert p.estimate(np.zeros(0, np.uint64)).shape == (0,)
    assert p.admit(np.zeros(0, np.uint64), np.zeros(0, np.uint64)).shape == (0,)


@pytest.mark.parametrize("n", [1, 7, 64, 1000, 65536, 10**6])
def test_make_config_matches(n):
    for kw in ({}, {"counters_per_item": 1.0}, {"sample_factor": 20}):
        assert (pops.make_config(n, **kw).__dict__
                == jops.make_config(n, **kw).__dict__)


def test_state_carried_from_jax():
    """A JAX-built state loads into the port leaf for leaf and answers the
    same estimates; it round-trips back to numpy unchanged."""
    jcfg, pcfg = cfgs(CFGS[1])
    keys = mixed_keys(3, 400)
    js = jops.add(jcfg, jsc.init_state(jcfg), *jlanes(keys), False)
    arrays = {k: np.asarray(v) for k, v in js.items()}
    ps = psc.sketch_state_from_numpy(pcfg, arrays, device="cpu")
    assert ps["size"].shape == () and ps["size"].device.type == "cpu"
    for k, v in psc.sketch_state_to_numpy(ps).items():
        np.testing.assert_array_equal(v, arrays[k])
    q = keys[:100]
    np.testing.assert_array_equal(
        pops.estimate(pcfg, ps, *plines(q)).numpy(),
        np.asarray(jops.estimate(jcfg, js, *jlanes(q), False)))
    with pytest.raises(ValueError, match="shape"):
        bad = dict(arrays, counters=arrays["counters"][:, :-1])
        psc.sketch_state_from_numpy(pcfg, bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        psc.sketch_state_from_numpy(pcfg, {"counters": arrays["counters"]},
                                    device="cpu")


def test_config_and_inputs_are_checked():
    for kw in (dict(width=12), dict(width=256, cap=16),
               dict(width=256, dk_bits=48), dict(width=256, rows=9)):
        with pytest.raises(ValueError):
            psc.DeviceSketchConfig(**kw)
    pcfg = psc.DeviceSketchConfig(width=256)
    state = psc.init_state(pcfg, device="cpu")
    lo = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="lanes"):
        pops.estimate(pcfg, state, lo, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="lanes"):
        pops.add(pcfg, state, lo.long(), lo.long())


def test_entry_points_default_to_the_card():
    """Without device="cpu" the facade and the state live on the card, and
    raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        pops.DeviceTinyLFU(64)
    with pytest.raises(RuntimeError, match="CUDA"):
        psc.init_state(psc.DeviceSketchConfig(width=256))


def test_kernel_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions: no launch."""
    for fn in (sketch_update.add, sketch_estimate.estimate,
               admission.admit, sketch_reset.reset):
        fn.launches = 0
    p = pops.DeviceTinyLFU(16, device="cpu")
    p.record(np.arange(200, dtype=np.uint64))
    p.admit(np.arange(3, dtype=np.uint64), np.arange(3, dtype=np.uint64))
    assert [sketch_update.add.launches, sketch_estimate.estimate.launches,
            admission.admit.launches, sketch_reset.reset.launches] == [0] * 4


def test_s_run_matches_jax_at_small_size():
    """Run S's procedure (record in batches with resets, then estimate and
    admit a prefix against its roll) at a small capacity: the state digest,
    reset count, estimate digest and admitted count equal JAX's."""
    trace = jsyn.zipf_trace(6000, n_items=5000, alpha=0.9, seed=11)
    got = s_run(pops.DeviceTinyLFU(96, device="cpu"), trace, 512, 1000)
    want = s_run(jops.DeviceTinyLFU(96, use_pallas=False), trace, 512, 1000)
    assert got == want
    assert got[1] >= 3


def s_run(t, trace, batch, n_dec):
    """(state digest, resets, estimate digest, admitted count) of a
    ``DeviceTinyLFU`` of either package after run S's procedure."""
    resets = 0
    for s in range(0, len(trace), batch):
        keys = trace[s:s + batch].astype(np.uint64)
        before = int(t.state["size"])
        t.record(keys)
        resets += int(int(t.state["size"]) < before + len(keys))
    cands = trace[:n_dec].astype(np.uint64)
    est = t.estimate(cands)
    admitted = int(t.admit(cands, np.roll(cands, 1)).sum())
    leaves = {k: torch.from_numpy(np.asarray(v).copy())
              for k, v in t.state.items()}
    return (digest(leaves), resets,
            digest({"estimate": torch.from_numpy(np.asarray(est).copy())}),
            admitted)


if __name__ == "__main__":
    f_trace = jsyn.zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9,
                              seed=11)
    print("S pins (JAX, jnp oracles):",
          s_run(jops.DeviceTinyLFU(S_BLOCKS, use_pallas=False), f_trace,
                S_BATCH, S_DECISIONS))

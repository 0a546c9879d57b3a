"""Whole adaptive runs (``simulate_trace(..., adaptive=True)``) of the port
against the JAX engine (``backend="jit"``), on the CPU.

Each run feeds the same keys to the port (``device="cpu"``: one plain
``step_ref`` per climb epoch, then the fold when sharded, the tensor climb
and ``rebalance``) and to the JAX engine and requires the hit flags, every
state leaf, ``final_quota``, ``trajectory`` and the row's keys to be equal:
flat and 4 and 8 ways, 4- and 8-bit counters, doorkeeper on and off,
``shards=4`` (the fold rides the climb epochs), a trace that ends in a
partial epoch (it steps but never climbs), shorter than one epoch and
empty.  A phase-shift trace drives the quota across the window set count,
so both branches of the window-way rule run.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro_torch.core import device_simulate as pds
from repro_torch.traces import synthetic as psyn

torch.set_num_threads(1)


def assert_state_equal(got: dict, want: dict, what: str = ""):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what} state[{k!r}]")


@functools.lru_cache(maxsize=None)
def shift_trace(n=1500):
    return psyn.phase_shift_trace(n, n_hot=200, working_set=40, advance=0.1,
                                  seed=7)


RUNS = [
    ("flat cb4 dk", 60, dict(), 200),
    ("ways 4 cb4 dk", 64, dict(assoc=4), 200),
    ("ways 8 cb8 no-dk", 100, dict(assoc=8, counter_bits=8,
                                   doorkeeper=False), 256),
    ("ways 4 shards 4", 64, dict(assoc=4, shards=4), 200),
    ("flat shards 4 cb8", 60, dict(shards=4, counter_bits=8), 256),
]


@pytest.mark.parametrize("case", range(len(RUNS)),
                         ids=[r[0] for r in RUNS])
def test_adaptive_run_equals_jax(case):
    """simulate_trace(adaptive=True) == the JAX engine: hits, hit flags,
    every leaf, final quota, trajectory and the row's keys, over a trace
    that ends in a partial epoch."""
    _, C, kw, epoch = RUNS[case]
    tr = shift_trace()
    assert len(tr) % epoch
    args = dict(adaptive=True, warmup=100, return_state=True, **kw)
    pr, ps, ph = pds.simulate_trace(tr, C, device="cpu",
                                    climb=pds.ClimbSpec(epoch_len=epoch),
                                    **args)
    jr, js, jh = jds.simulate_trace(tr, C,
                                    climb=jds.ClimbSpec(epoch_len=epoch),
                                    **args)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js)
    pe, je = dict(pr.extra), dict(jr.extra)
    assert pe.pop("backend") == "plain" and pe.pop("device") == "cpu"
    del je["backend"], je["device"]
    assert pe == je
    assert (pr.hits, pr.policy, pr.accesses) == (jr.hits, jr.policy,
                                                 jr.accesses)
    assert pr.policy.endswith("+climb")
    assert len(pe["trajectory"]["quota"]) == len(tr) // epoch
    if kw.get("assoc"):          # both branches of window_set_ways ran
        nws = pds.DeviceWTinyLFU(C, adaptive=True, **kw).spec().window_sets
        quotas = pe["trajectory"]["quota"] + [pe["final_quota"]]
        assert min(quotas) < nws <= max(quotas)
    if kw.get("shards"):
        assert pe["merge_every"] == epoch


@pytest.mark.parametrize("n", [200, 0], ids=["shorter than an epoch",
                                             "empty"])
def test_short_adaptive_runs_equal_jax(n):
    tr = shift_trace()[:n]
    pr, ps, _ = pds.simulate_trace(tr, 64, adaptive=True, assoc=4,
                                   device="cpu", return_state=True)
    jr, js, _ = jds.simulate_trace(tr, 64, adaptive=True, assoc=4,
                                   return_state=True)
    assert "trajectory" not in pr.extra and "trajectory" not in jr.extra
    assert (pr.hits, pr.extra["final_quota"]) == (jr.hits,
                                                  jr.extra["final_quota"])
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js)


def test_run_with_checkpoint_still_raises(tmp_path):
    """(Named when checkpointing was not ported.)  An adaptive run with a
    checkpoint directory runs in segments of whole climb epochs and equals
    the plain run (hits, trajectory, final quota); a cadence off the climb
    epoch still raises, the reference's ValueError."""
    cfg = pds.DeviceWTinyLFU(64, assoc=4, adaptive=True)
    climb = pds.ClimbSpec(epoch_len=128)
    with pytest.raises(ValueError, match="checkpoint_every 100"):
        cfg.run(np.arange(10), device="cpu", climb=climb,
                checkpoint_dir=str(tmp_path / "x"), checkpoint_every=100)
    r = cfg.run(shift_trace()[:300], device="cpu", climb=climb)
    assert r.extra["adaptive"] and len(r.extra["trajectory"]["quota"]) == 2
    c = cfg.run(shift_trace()[:300], device="cpu", climb=climb,
                checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=128)
    for k in ("trajectory", "final_quota"):
        assert c.extra[k] == r.extra[k], k
    assert c.hits == r.hits


def test_adaptive_run_equals_jax_pallas_kernel():
    """A few hundred accesses against the JAX Pallas kernel (interpret
    mode: the reference's masked tail epoch that never climbs)."""
    tr = shift_trace()[:420]
    kw = dict(adaptive=True, assoc=4, return_state=True)
    pr, ps, ph = pds.simulate_trace(tr, 64, device="cpu",
                                    climb=pds.ClimbSpec(epoch_len=128), **kw)
    jr, js, jh = jds.simulate_trace(tr, 64, backend="pallas",
                                    climb=jds.ClimbSpec(epoch_len=128), **kw)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js)
    assert pr.extra["trajectory"] == jr.extra["trajectory"]
    assert pr.extra["final_quota"] == jr.extra["final_quota"]

"""Tenant lanes (``streams=B``) on the port against the JAX engine's lane
contracts (tests/test_streams.py), on the CPU.

Every case feeds the same ``(B, T)`` keys to the port (``device="cpu"``,
the plain ``step_ref`` looping over the lanes) and to the JAX engine
(``backend="jit"``, JAX on the CPU) and requires every state leaf, the
``(B, T)`` hit flags and ``lane_hits`` to be equal; each port lane must
also equal the port's solo run of its keys.  One case holds the port to the
JAX Pallas kernel (``backend="pallas"``, interpret mode) at two lanes.
"""
import functools
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro.kernels import sketch_step as jks
from repro_torch.core import device_simulate as pds
from repro_torch.kernels import sketch_step as pks
from repro_torch.traces import synthetic as psyn

torch.set_num_threads(1)

B, C, T = 3, 64, 2000


def lanes_trace(seed=0, length=T):
    return psyn.tenant_lanes_trace(B, length, n_items=5000, alpha=1.1,
                                   seed=seed)


@functools.lru_cache(maxsize=None)
def port_lanes(seed, assoc):
    return pds.simulate_trace(lanes_trace(seed), C, streams=B, assoc=assoc,
                              warmup=200, device="cpu", return_state=True)


def assert_state_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what} state[{k!r}]")


@pytest.mark.parametrize("assoc", [None, 4], ids=["flat", "ways 4"])
def test_lanes_equal_jax(assoc):
    """simulate_trace(streams=3) == the JAX engine's: every leaf, the (B, T)
    hit flags, lane_hits, the aggregate and the row's keys."""
    seed = 0 if assoc is None else 1
    pr, ps, ph = port_lanes(seed, assoc)
    jr, js, jh = jds.simulate_trace(lanes_trace(seed), C, streams=B,
                                    assoc=assoc, warmup=200,
                                    return_state=True)
    assert ph.shape == (B, T)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js, "lanes")
    assert (pr.hits, pr.accesses, pr.hit_ratio) == (jr.hits, jr.accesses,
                                                    jr.hit_ratio)
    assert pr.accesses == (T - 200) * B
    assert pr.extra["lane_hits"] == jr.extra["lane_hits"]
    assert pr.extra["streams"] == jr.extra["streams"] == B
    assert sorted(pr.extra) == sorted(jr.extra)


@pytest.mark.parametrize("assoc", [None, 4], ids=["flat", "ways 4"])
def test_every_lane_equals_its_solo_run(assoc):
    seed = 0 if assoc is None else 1
    pr, ps, ph = port_lanes(seed, assoc)
    tr = lanes_trace(seed)
    for b in range(B):
        sr, ss, sh = pds.simulate_trace(tr[b], C, assoc=assoc, warmup=200,
                                        device="cpu", return_state=True)
        np.testing.assert_array_equal(ph[b].numpy(), sh.numpy(),
                                      err_msg=f"lane {b} hit flags")
        assert_state_equal({k: v[b] for k, v in ps.items()}, ss,
                           f"lane {b}")
        assert pr.extra["lane_hits"][b] == sr.hits
    assert pr.hits == sum(pr.extra["lane_hits"])


def test_adversarial_lane_cannot_perturb_neighbours():
    """Lane 0 streams all-once churn (sketch poison, window thrash); lanes 1
    and 2 equal their solo runs, and the whole run equals JAX's."""
    n = 1200
    benign = lanes_trace(6, n)
    adversarial = psyn.fickle_churn_trace(n, n_hot=8, hot_frac=0.02, seed=9)
    tr = np.stack([adversarial, benign[1], benign[2]])
    _, ps, ph = pds.simulate_trace(tr, C, streams=B, device="cpu",
                                   return_state=True)
    _, js, jh = jds.simulate_trace(tr, C, streams=B, return_state=True)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js, "lanes")
    for b in (1, 2):
        _, ss, sh = pds.simulate_trace(tr[b], C, device="cpu",
                                       return_state=True)
        np.testing.assert_array_equal(ph[b].numpy(), sh.numpy(),
                                      err_msg=f"lane {b} perturbed by "
                                      "adversarial lane 0")
        assert_state_equal({k: v[b] for k, v in ps.items()}, ss, f"lane {b}")


def test_streams1_equals_unbatched():
    tr = lanes_trace(7, 800)[0]
    r1, s1, h1 = pds.simulate_trace(tr, C, streams=1, device="cpu",
                                    return_state=True)
    r0, s0, h0 = pds.simulate_trace(tr, C, device="cpu", return_state=True)
    np.testing.assert_array_equal(h1.numpy(), h0.numpy())
    assert_state_equal(s1, s0, "streams=1")
    assert (r1.hits, r1.extra) == (r0.hits, r0.extra)
    assert pds.DeviceWTinyLFU(C, streams=1).spec() == \
        pds.DeviceWTinyLFU(C).spec()


@pytest.mark.parametrize("assoc", [None, 8], ids=["flat", "ways 8"])
def test_init_state_lane_axis(assoc):
    spec = pds.DeviceWTinyLFU(C, streams=B, assoc=assoc).spec()
    base = pks.init_step_state(pds.DeviceWTinyLFU(C, assoc=assoc).spec(),
                               device="cpu")
    state = pks.init_step_state(spec, device="cpu")
    jstate = jks.init_step_state(jds.DeviceWTinyLFU(C, streams=B,
                                                    assoc=assoc).spec())
    for k, v in base.items():
        assert state[k].shape == (B,) + v.shape and state[k].is_contiguous()
        for b in range(B):
            assert torch.equal(state[k][b], v)
    assert_state_equal({k: v.numpy() for k, v in state.items()}, jstate,
                       "init")


def test_validation_names_the_field(tmp_path):
    tr = lanes_trace(12, 100)
    with pytest.raises(ValueError, match="streams 0"):
        pds.DeviceWTinyLFU(C, streams=0)
    with pytest.raises(ValueError, match="streams 2 cannot combine"):
        pds.DeviceWTinyLFU(C, streams=2, shards=4, mesh=object())
    with pytest.raises(ValueError, match=r"streams 3 expects a \(B, T\)"):
        pds.simulate_trace(tr[0], C, streams=B, device="cpu")
    with pytest.raises(ValueError, match=r"streams 2 expects a \(B, T\)"):
        pds.simulate_trace(tr, C, streams=2, device="cpu")
    with pytest.raises(ValueError, match="streams is 1"):
        pds.simulate_trace(tr, C, device="cpu")
    # checkpoints hold one stream's state: lanes refuse them, as the
    # reference does
    with pytest.raises(ValueError, match="streams 3 does not combine with "
                       "checkpoint_dir"):
        pds.DeviceWTinyLFU(C, streams=B).run(
            tr, device="cpu", checkpoint_dir=str(tmp_path / "ckpt"))
    # the step level: lane shapes, per-lane params and n_valid
    spec = pds.DeviceWTinyLFU(C, streams=B).spec()
    state = pks.init_step_state(spec, device="cpu")
    p = pds.DeviceWTinyLFU(C).params(device="cpu")
    lo = torch.zeros((B, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"streams=3 expects \(B, T\) key"):
        pks.step(spec, p, state, lo[0], lo[0])
    with pytest.raises(ValueError, match="params must be"):
        pks.step(spec, p.repeat(2, 1), state, lo, lo)
    with pytest.raises(ValueError, match="one entry per lane"):
        pks.step(spec, p, state, lo, lo, [8, 8])
    with pytest.raises(ValueError, match="n_valid"):
        pks.step(spec, p, state, lo, lo, [8, 9, 8])


def test_per_lane_params_and_counts_equal_jax():
    """step with per-lane params and per-lane n_valid == JAX step_ref
    through _step_lanes, chunk by chunk: three configurations padded to one
    geometry (the vmap sweep's lanes)."""
    cfgs = [pds.DeviceWTinyLFU(C, assoc=4, window_frac=wf, sample_factor=sf)
            for wf, sf in ((0.01, 8), (0.2, 8), (0.05, 3))]
    spec, states = pds._padded_grid(cfgs, "cpu")
    spec = replace(spec, streams=B)
    jspec = jks.StepSpec(**{f.name: getattr(spec, f.name)
                            for f in fields(spec)})
    tr = lanes_trace(13, 600)
    lo = np.ascontiguousarray((tr & 0xFFFFFFFF).astype(np.uint32)
                              .view(np.int32))
    hi = np.zeros_like(lo)
    pp = torch.stack([c.params(warmup=50, device="cpu") for c in cfgs])
    jp = pp.numpy().copy()
    ps = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    js = {k: v.numpy().copy() for k, v in ps.items()}
    for s, e, nv in ((0, 256, [256, 256, 256]), (256, 512, [100, 256, 0]),
                     (512, 600, [88, 88, 88])):
        _, ph = pks.step(spec, pp, ps, torch.from_numpy(lo[:, s:e]),
                         torch.from_numpy(hi[:, s:e]), nv)
        js, jh = jks.step_ref(jspec, jp, js, lo[:, s:e], hi[:, s:e],
                              np.asarray(nv, np.int32))
        np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
        assert_state_equal({k: v.numpy() for k, v in ps.items()}, js,
                           f"chunk at {s}")


def test_lanes_equal_jax_pallas_interpret():
    """Two lanes of a few hundred accesses against the JAX Pallas kernel
    (interpret mode), both chunked at 128 with a padded tail."""
    tr = psyn.tenant_lanes_trace(2, 300, n_items=400, alpha=1.1, seed=4)
    _, ps, ph = pds.simulate_trace(tr, 32, streams=2, assoc=4, chunk=128,
                                   device="cpu", return_state=True)
    _, js, jh = jds.simulate_trace(tr, 32, streams=2, assoc=4, chunk=128,
                                   backend="pallas", interpret=True,
                                   return_state=True)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js, "pallas")

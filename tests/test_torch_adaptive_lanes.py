"""The adaptive window with tenant lanes (``streams=B``) and adaptive sweeps
on the port against the JAX engine's contracts (tests/test_streams.py,
tests/test_adaptive.py), on the CPU.

Each lane climbs on its own: the port's lane run (``device="cpu"``: the
plain ``step_ref`` over the lanes, the climb and ``rebalance`` on the lane
axis) must equal the JAX engine's (``backend="jit"``) leaf for leaf, with
per-lane trajectories and final quotas, and each lane its solo run.  An
adaptive ``simulate_sweep`` as lanes (``mode="vmap"``: per-lane params,
state, climb vector and climber registers) must equal the sequential runs
and the JAX rows, for a window grid and for a climb hyperparameter grid;
mixed geometries, mixed epoch lengths and a climb sequence of the wrong
length raise the reference's messages.
"""
import functools

import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro_torch.core import device_simulate as pds
from repro_torch.traces import synthetic as psyn

torch.set_num_threads(1)

B, C, T, EPOCH = 3, 64, 900, 200


@functools.lru_cache(maxsize=None)
def lane_trace():
    """Two phase shifts of different pace around a stationary Zipf lane."""
    return np.stack([
        psyn.phase_shift_trace(T, n_hot=200, working_set=40, advance=0.1,
                               seed=0),
        psyn.zipf_trace(T, n_items=400, alpha=0.8, seed=1),
        psyn.phase_shift_trace(T, n_hot=100, working_set=60, advance=0.3,
                               seed=2)])


def assert_state_equal(got: dict, want: dict, what: str = ""):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what} state[{k!r}]")


def test_adaptive_lanes_equal_jax_and_solo_runs():
    """streams=3, adaptive: every leaf, the (B, T) hit flags, lane_hits,
    the per-lane final quotas and trajectories equal the JAX engine's, and
    each lane equals its solo run."""
    tr = lane_trace()
    kw = dict(adaptive=True, assoc=4, warmup=100, return_state=True)
    pr, ps, ph = pds.simulate_trace(tr, C, streams=B, device="cpu",
                                    climb=pds.ClimbSpec(epoch_len=EPOCH),
                                    **kw)
    jr, js, jh = jds.simulate_trace(tr, C, streams=B,
                                    climb=jds.ClimbSpec(epoch_len=EPOCH),
                                    **kw)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js, "lanes")
    for k in ("lane_hits", "final_quota", "trajectory", "streams"):
        assert pr.extra[k] == jr.extra[k], k
    assert len(set(pr.extra["final_quota"])) > 1     # the lanes climb apart
    traj = pr.extra["trajectory"]
    for b in range(B):
        r, s, h = pds.simulate_trace(tr[b], C, device="cpu",
                                     climb=pds.ClimbSpec(epoch_len=EPOCH),
                                     **kw)
        np.testing.assert_array_equal(h.numpy(), ph[b].numpy())
        assert_state_equal({k: v.numpy() for k, v in s.items()},
                           {k: v[b].numpy() for k, v in ps.items()},
                           f"lane {b}")
        assert r.extra["trajectory"]["quota"] == [q[b] for q in
                                                  traj["quota"]]
        assert r.extra["trajectory"]["epoch_hits"] == [
            e[b] for e in traj["epoch_hits"]]


def sweep_rows(pkg, mode, **kw):
    tr = lane_trace()[0]
    dev = dict(device="cpu") if pkg is pds else {}
    return pkg.simulate_sweep(tr, [C], assoc=4, adaptive=True, warmup=100,
                              mode=mode, **dev, **kw)


def row_keys(rows):
    return [(r.hits, r.extra["final_quota"], r.extra["window_frac"],
             r.policy) for r in rows]


def test_adaptive_sweep_lanes_equal_sequential_and_jax():
    """A window grid as two lanes == one run after another == the JAX
    rows (hits, final quotas)."""
    kw = dict(window_fracs=(0.01, 0.4))
    vm = sweep_rows(pds, "vmap", climb=pds.ClimbSpec(epoch_len=EPOCH), **kw)
    sq = sweep_rows(pds, "sequential", climb=pds.ClimbSpec(epoch_len=EPOCH),
                    **kw)
    jv = sweep_rows(jds, "vmap", climb=jds.ClimbSpec(epoch_len=EPOCH), **kw)
    assert row_keys(vm) == row_keys(sq) == row_keys(jv)
    assert vm[0].extra["backend"] == "plain+vmap"
    assert sq[0].extra["backend"] == "plain+sequential"
    assert len({r.extra["final_quota"] for r in vm}) > 1


def test_climb_hyperparameter_grid_as_lanes():
    """One ClimbSpec per grid point, run as lanes, equals the JAX rows."""
    fracs = (0.05, 0.05, 0.05)
    specs = [dict(epoch_len=EPOCH), dict(epoch_len=EPOCH, delta0=6, tol=1),
             dict(epoch_len=EPOCH, warm_epochs=1, restart=4)]
    vm = sweep_rows(pds, "vmap", window_fracs=fracs,
                    climb=[pds.ClimbSpec(**c) for c in specs])
    jv = sweep_rows(jds, "vmap", window_fracs=fracs,
                    climb=[jds.ClimbSpec(**c) for c in specs])
    assert row_keys(vm) == row_keys(jv)
    assert len({r.extra["final_quota"] for r in vm}) > 1


@pytest.mark.parametrize("caps,fracs,climb", [
    ((64, 128), (0.01,), None),
    ((64,), (0.01, 0.2), "mixed epochs"),
    ((64,), (0.01, 0.2), "short sequence"),
], ids=["mixed geometry", "mixed epoch_len", "climb sequence length"])
def test_adaptive_sweep_errors_equal_reference(caps, fracs, climb):
    tr = lane_trace()[0][:50]

    def climbs(pkg):
        if climb == "mixed epochs":
            return [pkg.ClimbSpec(epoch_len=200), pkg.ClimbSpec(epoch_len=256)]
        if climb == "short sequence":
            return [pkg.ClimbSpec()]
        return None

    kw = dict(window_fracs=fracs, assoc=4, adaptive=True, mode="vmap")
    with pytest.raises(ValueError) as pe:
        pds.simulate_sweep(tr, list(caps), device="cpu", climb=climbs(pds),
                           **kw)
    with pytest.raises(ValueError) as je:
        jds.simulate_sweep(tr, list(caps), climb=climbs(jds), **kw)
    assert str(pe.value) == str(je.value)


def test_adaptive_sweep_auto_is_sequential_and_sharded_stays_sequential():
    rows = sweep_rows(pds, "auto", window_fracs=(0.01,),
                      climb=pds.ClimbSpec(epoch_len=EPOCH))
    assert rows[0].extra["backend"] == "plain+sequential"
    assert rows[0].extra["adaptive"] is True
    tr = lane_trace()[0][:50]
    kw = dict(window_fracs=(0.01, 0.2), adaptive=True, shards=2,
              mode="vmap")
    with pytest.raises(ValueError) as pe:
        pds.simulate_sweep(tr, [C], device="cpu", **kw)
    with pytest.raises(ValueError) as je:
        jds.simulate_sweep(tr, [C], **kw)
    assert str(pe.value) == str(je.value)

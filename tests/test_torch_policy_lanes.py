"""The policy panel with tenant lanes (``streams=B``) and in policy sweeps
(``simulate_sweep(..., policies=...)``) on the port against the JAX engine,
on the CPU.

``streams=3`` for each competitor: every state leaf (ARC's lane-axis
``ghost`` too), the ``(B, T)`` hit flags, ``lane_hits`` and ``extra`` equal
the JAX engine's, and each lane equals its solo run.  A grid of all four
policies runs one configuration after another (``"auto"``) with the
reference's rows, each equal to its single run; a grid of one competitor
runs as lanes padded to the largest geometry with per-lane params (ARC: a
per-lane ``P_MAIN_CAP``) and gives JAX's vmapped rows; a multi-policy
``mode="vmap"`` raises the reference's ``ValueError``.
"""
import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro_torch.check_runs import PANEL_FRACS, PANEL_POLICIES
from repro_torch.core import device_simulate as pds
from repro_torch.kernels.sketch_common import POLICIES
from repro_torch.traces import synthetic as psyn

torch.set_num_threads(1)

B, C, T = 3, 48, 700
TR = psyn.zipf_trace(800, n_items=600, alpha=0.9, seed=5)
DROP = ("backend", "device", "grid_wall_s")


def row_extra(r) -> dict:
    return {k: v for k, v in r.extra.items() if k not in DROP}


@pytest.mark.parametrize("policy", PANEL_POLICIES)
def test_lanes_equal_jax_and_their_solo_runs(policy):
    tr = psyn.tenant_lanes_trace(B, T, n_items=3000, alpha=1.1, seed=2)
    kw = dict(streams=B, assoc=4, policy=policy, warmup=200,
              window_frac=PANEL_FRACS[policy], return_state=True)
    pr, ps, ph = pds.simulate_trace(tr, C, device="cpu", **kw)
    jr, js, jh = jds.simulate_trace(tr, C, **kw)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert set(ps) == set(js)
    for k in js:
        np.testing.assert_array_equal(ps[k].numpy(), np.asarray(js[k]),
                                      err_msg=f"state[{k!r}]")
    assert ps["regs"].shape == (B, 8)
    if policy == "arc":
        assert ps["ghost"].shape[0] == B and ps["ghost"].any()
    assert (pr.hits, pr.accesses, pr.policy) == (jr.hits, jr.accesses,
                                                 jr.policy)
    assert row_extra(pr) == row_extra(jr)
    assert pr.extra["lane_hits"] == jr.extra["lane_hits"]
    for b in range(B):
        kw_solo = dict(kw, streams=1)
        sr, ss, sh = pds.simulate_trace(tr[b], C, device="cpu", **kw_solo)
        assert sr.hits == pr.extra["lane_hits"][b] > 0
        np.testing.assert_array_equal(sh.numpy(), ph[b].numpy())
        for k in ss:
            np.testing.assert_array_equal(ss[k].numpy(), ps[k][b].numpy(),
                                          err_msg=f"lane {b} state[{k!r}]")


def test_policy_grid_rows_equal_jax_and_single_runs():
    """All four policies: "auto" runs them one after another; the rows'
    labels, hits and extra are the reference's, each row its single run."""
    kw = dict(policies=POLICIES, assoc=4, window_fracs=(0.1,), warmup=200)
    prow = pds.simulate_sweep(TR, [C], device="cpu", **kw)
    jrow = jds.simulate_sweep(TR, [C], **kw)
    assert [r.policy for r in prow] == [r.policy for r in jrow] == [
        "w-tinylfu(device)", "s3fifo(device)", "arc(device)", "lfu(device)"]
    assert [r.hits for r in prow] == [r.hits for r in jrow]
    assert [row_extra(r) for r in prow] == [row_extra(r) for r in jrow]
    assert "policy" not in prow[0].extra
    assert all(r.extra["backend"] == "plain+sequential" for r in prow)
    for r in prow:
        pol = r.extra.get("policy", "wtinylfu")
        single = pds.simulate_trace(TR, C, assoc=4, policy=pol,
                                    window_frac=0.1, warmup=200,
                                    device="cpu")
        assert r.hits == single.hits > 0, pol


@pytest.mark.parametrize("policy", PANEL_POLICIES)
def test_single_policy_grid_as_lanes_equals_jax_vmap(policy):
    """One competitor over two capacities as lanes of one run (padded to
    the larger geometry, per-lane params) == JAX's vmapped rows, and the
    sequential rows of the same grid == JAX's."""
    kw = dict(policies=(policy,), assoc=4, warmup=200,
              window_fracs=(PANEL_FRACS[policy],))
    for mode in ("vmap", "sequential"):
        prow = pds.simulate_sweep(TR, [32, 64], device="cpu", mode=mode,
                                  **kw)
        jrow = jds.simulate_sweep(TR, [32, 64], mode=mode, **kw)
        assert [r.hits for r in prow] == [r.hits for r in jrow], mode
        assert [row_extra(r) for r in prow] == [row_extra(r) for r in jrow]
        assert all(r.extra["backend"] == f"plain+{mode}" for r in prow)
        assert all(r.hits > 0 for r in prow)


def test_multi_policy_vmap_raises_the_reference_error():
    kw = dict(policies=("wtinylfu", "lfu"), assoc=8, mode="vmap")
    with pytest.raises(ValueError) as pe:
        pds.simulate_sweep(TR[:10], [64], device="cpu", **kw)
    with pytest.raises(ValueError) as je:
        jds.simulate_sweep(TR[:10], [64], **kw)
    assert str(pe.value) == str(je.value)
    assert "use mode='sequential'" in str(pe.value)

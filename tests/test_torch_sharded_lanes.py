"""Sharded tenant lanes and sharded sweeps on the port against the JAX
engine (tests/test_streams.py:63-71, tests/test_device_simulate.py:245-261),
and one sharded run against the JAX Pallas kernel in interpret mode, on the
CPU.  Same inputs to both packages; every state leaf and hit flag equal.
"""
import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro_torch.core import device_simulate as pds
from repro_torch.traces import synthetic as psyn
from test_torch_sharded import C, assert_runs_equal, assert_state_equal, \
    both, zipf

torch.set_num_threads(1)

B = 3


def lanes_trace(seed):
    return psyn.tenant_lanes_trace(B, 1100, n_items=5000, alpha=1.1,
                                   seed=seed)


@pytest.mark.parametrize("integrity", [False, True],
                         ids=["plain", "integrity"])
def test_lanes_equal_solo_runs_and_jax(integrity):
    """streams=3 with shards=4, merge_every=512 (reference
    tests/test_streams.py:63-71): every leaf and the (B, T) hit flags equal
    JAX's, and each lane its solo run."""
    kw = dict(shards=4, merge_every=512, integrity=integrity, warmup=100)
    tr = lanes_trace(2 + integrity)
    p, j = both(tr, streams=B, **kw)
    assert_runs_equal(p, j)
    assert p[0].extra["lane_hits"] == j[0].extra["lane_hits"]
    pr, ps, ph = p
    for b in range(B):
        sr, ss, sh = pds.simulate_trace(tr[b], C, device="cpu",
                                        return_state=True, **kw)
        np.testing.assert_array_equal(ph[b].numpy(), sh.numpy())
        assert_state_equal({k: v[b] for k, v in ps.items()}, ss,
                           f"lane {b}")
        assert pr.extra["lane_hits"][b] == sr.hits


def test_sharded_sweep_rows_equal_single_runs_and_jax():
    """Sequential sharded rows equal their single runs and the JAX rows;
    auto resolves to sequential; vmap raises the reference's message
    (reference tests/test_device_simulate.py:245-261)."""
    tr = zipf(700, seed=3)
    kw = dict(window_fracs=(0.01,), warmup=100, shards=2, merge_every=256)
    rows = pds.simulate_sweep(tr, [40, 80], device="cpu", **kw)
    jrows = jds.simulate_sweep(tr, [40, 80], mode="sequential", **kw)
    assert [r.hits for r in rows] == [r.hits for r in jrows]
    for r, jr in zip(rows, jrows):
        assert r.extra["backend"] == "plain+sequential"
        assert jr.extra["backend"] == "jit+sequential"
        assert sorted(r.extra) == sorted(jr.extra)
        assert (r.extra["shards"], r.extra["merge_every"]) == (2, 256)
    one = pds.simulate_trace(tr, 80, device="cpu", warmup=100, shards=2,
                             merge_every=256)
    assert one.hits == rows[1].hits
    with pytest.raises(ValueError) as pe:
        pds.simulate_sweep(tr, [40], device="cpu", mode="vmap", shards=2)
    with pytest.raises(ValueError) as je:
        jds.simulate_sweep(tr, [40], mode="vmap", shards=2)
    assert str(pe.value) == str(je.value)


def test_sharded_equals_jax_pallas_interpret():
    """shards=4 against the JAX Pallas kernel in interpret mode."""
    tr = zipf(300, seed=4)
    kw = dict(shards=4, merge_every=128, assoc=8)
    p = pds.simulate_trace(tr, 40, device="cpu", return_state=True, **kw)
    j = jds.simulate_trace(tr, 40, backend="pallas", interpret=True,
                           return_state=True, **kw)
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    assert_state_equal({k: v.numpy() for k, v in p[1].items()}, j[1])

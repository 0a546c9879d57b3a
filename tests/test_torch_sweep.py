"""The port's ``simulate_sweep`` against the JAX package's, on the CPU: the
contracts of tests/test_device_simulate.py for static grids, in both modes.

``mode="sequential"`` runs each grid point with its own tight geometry and
must equal the single runs; ``mode="vmap"`` runs the grid as lanes of one
run (the largest configuration's geometry, per-lane padding and params) and
must equal the JAX vmap rows.  Every case requires the port's rows to equal
the JAX rows: hits, accesses, the row's ``extra`` keys.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro_torch.core import device_simulate as pds
from repro_torch.distributed.mesh import make_shard_mesh
from repro_torch.traces.synthetic import zipf_trace

torch.set_num_threads(1)

N, WARMUP = 1500, 300


@functools.lru_cache(maxsize=None)
def golden_zipf(n=N):
    return zipf_trace(60_000, n_items=50_000, alpha=0.9, seed=7)[:n]


@functools.lru_cache(maxsize=None)
def port_rows(mode, caps=(100,), assoc=None, n=N):
    return pds.simulate_sweep(golden_zipf(n), list(caps),
                              window_fracs=(0.01, 0.2), warmup=WARMUP,
                              mode=mode, assoc=assoc, device="cpu")


def assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.cache_size, g.hits, g.accesses, g.hit_ratio, g.policy) == \
            (w.cache_size, w.hits, w.accesses, w.hit_ratio, w.policy)
        assert list(g.extra) == list(w.extra)
        for k in ("window_frac", "grid", "assoc"):
            assert g.extra[k] == w.extra[k], k


@pytest.mark.parametrize("assoc", [None, 8], ids=["flat", "ways 8"])
def test_sweep_sequential_matches_single_runs(assoc):
    rows = port_rows("sequential", assoc=assoc)
    assert_rows_equal(rows, jds.simulate_sweep(
        golden_zipf(), [100], window_fracs=(0.01, 0.2), warmup=WARMUP,
        mode="sequential", assoc=assoc))
    for row in rows:
        single = jds.simulate_trace(golden_zipf(), 100, assoc=assoc,
                                    window_frac=row.extra["window_frac"],
                                    warmup=WARMUP)
        assert row.hits == single.hits
        assert row.extra["grid"] == 2 and row.extra["assoc"] == assoc
        assert row.extra["backend"] == "plain+sequential"


def test_sweep_vmap_matches_sequential():
    """One capacity: the lanes share its geometry, so vmap == sequential
    bit for bit (padding slots are inert)."""
    vm = port_rows("vmap")
    assert [r.hits for r in vm] == [r.hits for r in port_rows("sequential")]
    assert_rows_equal(vm, jds.simulate_sweep(
        golden_zipf(), [100], window_fracs=(0.01, 0.2), warmup=WARMUP,
        mode="vmap"))
    assert vm[0].extra["backend"] == "plain+vmap"


def test_sweep_vmap_two_capacities_padded_ways():
    """Two capacities with assoc=4 as four lanes padded to C=100's geometry:
    the rows equal the JAX vmap rows (padded lanes, per-lane params)."""
    got = port_rows("vmap", caps=(64, 100), assoc=4, n=1000)
    want = jds.simulate_sweep(golden_zipf(1000), [64, 100],
                              window_fracs=(0.01, 0.2), warmup=WARMUP,
                              mode="vmap", assoc=4)
    assert_rows_equal(got, want)
    assert len({r.hits for r in got}) > 1


def test_sweep_per_config_traces():
    """(G, N) traces, one per grid point (seed sweeps), both modes."""
    tr = np.stack([zipf_trace(800, n_items=3000, alpha=0.9, seed=s)
                   for s in (1, 2)])
    for mode in ("auto", "vmap"):
        rows = pds.simulate_sweep(tr, [100], window_fracs=[0.01, 0.2],
                                  warmup=200, mode=mode, device="cpu")
        want = jds.simulate_sweep(tr, [100], window_fracs=[0.01, 0.2],
                                  warmup=200, mode=mode)
        assert_rows_equal(rows, want)
        assert rows[0].hits != rows[1].hits          # different traces
    with pytest.raises(ValueError, match="trace grid dim 2 != 4"):
        pds.simulate_sweep(tr, [100, 200], window_fracs=[0.01, 0.2],
                           device="cpu")


def test_sweep_reports_amortized_wall():
    rows = port_rows("sequential")
    for r in rows:
        assert r.extra["grid"] == 2
        assert r.extra["grid_wall_s"] == pytest.approx(
            rows[0].extra["grid_wall_s"])
        assert r.wall_s == pytest.approx(r.extra["grid_wall_s"] / 2)


def test_sweep_vmap_rejects_main_below_the_shared_sets():
    kw = dict(window_fracs=(0.01,), assoc=8, mode="vmap")
    with pytest.raises(ValueError) as pe:
        pds.simulate_sweep(np.arange(10), [8, 4096], device="cpu", **kw)
    with pytest.raises(ValueError) as je:
        jds.simulate_sweep(np.arange(10), [8, 4096], **kw)
    assert str(pe.value) == str(je.value)


_MESH2 = SimpleNamespace(axis_names=("shard",), devices=np.zeros(2))


@pytest.mark.parametrize("kw,what", [
    (dict(shards=2, mode="sequential"), "chunk"),
    (dict(shards=2, adaptive=True), "chunk"),
    (dict(shards=4, assoc=4), "chunk"),
    (dict(shards=2, mesh_exchange="stale"), "stale"),
])
def test_sweep_unported_grids_raise(kw, what):
    """Meshed grids run, as the reference's do: sequentially, each row on
    the configuration's (one-rank) mesh; mode="vmap" and a stand-in mesh
    that is not a ShardMesh raise."""
    mesh = make_shard_mesh(kw["shards"])
    rows = pds.simulate_sweep(np.arange(10), [16], device="cpu", mesh=mesh,
                              **kw)
    assert rows[0].extra["backend"] == "plain+sequential"
    assert rows[0].extra["mesh_exchange"] == what
    with pytest.raises(ValueError, match="mesh sweeps"):
        pds.simulate_sweep(np.arange(10), [16], device="cpu", mesh=mesh,
                           **{**kw, "mode": "vmap"})
    with pytest.raises(ValueError, match="ShardMesh"):
        pds.simulate_sweep(np.arange(10), [16], device="cpu", mesh=_MESH2,
                           **kw)
    with pytest.raises(ValueError, match="unknown mode"):
        pds.simulate_sweep(np.arange(10), [16], device="cpu", mode="x")

"""The port's ``("shard",)`` mesh (``repro_torch.distributed``) on the CPU,
against the port's single-device runs and the JAX package.

Ranks are processes of a gloo group spawned by
``distributed.launch.run_ranks`` (a ``FileStore`` under a temporary
directory: no port is opened), two and four of them, each under a time
limit.  Chunk mode (the exact exchange) equals the single-device sharded
run: every state leaf of the canonical layout and every hit flag, flat and
set tables, static and adaptive, on traces with and without a partial last
epoch.  Stale mode equals the reference's stale step (``step_ref`` with
``mesh_devices``) and ``merge_halve_mesh`` under ``jax.vmap(...,
axis_name="shard")``, which supplies the mesh axis on the CPU, bit for bit,
with the epoch folds halving the sketch; and its hit flags equal the
reference's host twin ``WTinyLFU(stale_admission=True)`` under
collision-free sketches.  Placement, ``make_shard_mesh``'s errors and the
sweep's mesh rules are the reference's.  The stale goldens are in
``test_torch_mesh_goldens.py``.
"""
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro.core.wtinylfu import WTinyLFU
from repro.traces import phase_shift_trace, zipf_trace
from repro_torch.core import device_simulate as pds
from repro_torch.distributed import mesh as pmesh
from repro_torch.distributed.launch import run_ranks

import torch_mesh_ranks

torch.set_num_threads(1)

TR = zipf_trace(1_000, n_items=300, alpha=0.9, seed=3)
TP = phase_shift_trace(1_000, n_hot=150, working_set=60, advance=0.05,
                       seed=2)
CLIMB = pds.ClimbSpec(epoch_len=256)
# chunk mode: name -> (capacity, trace, DeviceWTinyLFU / simulate_trace kw)
CHUNK = {
    "flat": (100, TR, dict(shards=4, merge_every=256)),
    "set": (150, TR, dict(shards=4, merge_every=256, assoc=8)),
    "flat adaptive": (100, TP, dict(shards=4, adaptive=True, climb=CLIMB)),
    "set adaptive": (150, TP, dict(shards=4, adaptive=True, assoc=8,
                                   climb=CLIMB)),
    "tail only": (100, TR[:600], dict(shards=4, merge_every=4_096)),
    "exact epochs, no doorkeeper": (100, TR, dict(shards=4, merge_every=250,
                                                  doorkeeper=False)),
}
# stale mode against the JAX vmap reference: W = 2 C < the fold's epoch
# count, so every fold from the second halves the sketch
STALE = {
    "flat": (100, TR, dict(shards=4, sample_factor=2, merge_every=256)),
    "set": (150, TR, dict(shards=4, sample_factor=2, merge_every=256,
                          assoc=8)),
}
# tests/test_distributed.py's host-twin settings
TWIN_C = 60
TWIN_KW = dict(window_frac=0.01, sample_factor=8, doorkeeper=False,
               counters_per_item=550.0)


def _twin_trace():
    return zipf_trace(5_000, n_items=300, alpha=0.9, seed=5)


def _calls(n: int) -> list:
    runs = [(C, tr, kw) for C, tr, kw in CHUNK.values()]
    runs += [(C, tr, dict(kw, mesh_exchange="stale"))
             for C, tr, kw in STALE.values()]
    calls = [("mesh_runs", (runs,)), ("placement", (4,))]
    if n == 2:
        calls += [("mesh_runs", ([(TWIN_C, _twin_trace(),
                                   dict(TWIN_KW, shards=2, merge_every=512,
                                        mesh_exchange="stale"))],)),
                  ("sweep_rows", (np.arange(600) % 80, [50],
                                  dict(shards=2, merge_every=256))),
                  ("mesh_runs", ([(50, np.arange(600) % 80,
                                   dict(shards=2, merge_every=256))],))]
    return calls


def jax_stale(trace, C, D, warmup=0, **kw):
    """The reference's stale mesh run of ``trace`` on D devices, as
    ``jax.vmap`` over the mesh axis of the per-device states: the epochs of
    ``step_ref`` (with ``mesh_devices=D``) and ``merge_halve_mesh``, then
    the tail.  Returns (canonical state, hit flags); every device's hit
    flags are equal."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import sketch_step as js
    from repro.kernels.sketch_merge import merge_halve_mesh
    cfg = jds.DeviceWTinyLFU(C, **kw)
    spec = replace(cfg.spec(), mesh_devices=D, mesh_exchange="stale")
    params = cfg.params(warmup=warmup)
    split = ("dcounters", "ddoorkeeper")
    L = spec.local_shards
    st0 = js.init_step_state(spec, cfg.window_cap, cfg.main_cap)
    states = {k: (v.reshape((D, L) + v.shape[1:]) if k in split
                  else jnp.broadcast_to(v, (D,) + v.shape))
              for k, v in st0.items()}
    lo, hi = jds._trace_lanes(np.asarray(trace))
    E, n = cfg.merge_epoch, len(trace)
    ne = n // E

    def run(s):
        def body(s, x):
            s, h = js.step_ref(spec, params, s, x[0], x[1])
            return merge_halve_mesh(spec, params, s), h
        s, h = jax.lax.scan(body, s, (lo[:ne * E].reshape(ne, E),
                                      hi[:ne * E].reshape(ne, E)))
        s, t = js.step_ref(spec, params, s, lo[ne * E:], hi[ne * E:])
        return s, jnp.concatenate([h.reshape(-1), t])

    out, hits = jax.jit(jax.vmap(run, axis_name="shard"))(states)
    hits = np.asarray(hits)
    assert all(np.array_equal(hits[0], hits[d]) for d in range(D))
    H, HD = spec.counter_words, spec.dk_words
    canon = {k: np.asarray(v[0]) for k, v in out.items() if k not in split}
    cd = np.asarray(out["dcounters"]).reshape(spec.shards, spec.rows,
                                              spec.wps_shard)
    canon["counters"] = np.concatenate(
        [canon["counters"], cd.transpose(1, 0, 2).reshape(H)])
    dd = (np.asarray(out["ddoorkeeper"]).reshape(HD) if spec.dk_bits
          else np.zeros(HD, np.int32))
    canon["doorkeeper"] = np.concatenate([canon["doorkeeper"], dd])
    return canon, hits[0]


@pytest.fixture(scope="module")
def world():
    """Both groups (2 and 4 ranks) run concurrently while this process
    computes the single-device and JAX references."""
    tmp = tempfile.mkdtemp(prefix="mesh-")
    with ThreadPoolExecutor(2) as ex:
        jobs = {n: ex.submit(run_ranks, torch_mesh_ranks.many, n,
                             os.path.join(tmp, str(n)), _calls(n),
                             timeout=240) for n in (2, 4)}
        single = {}
        for name, (C, tr, kw) in CHUNK.items():
            r, st, h = pds.simulate_trace(tr, C, return_state=True,
                                          device="cpu", **kw)
            single[name] = (r, {k: v.numpy() for k, v in st.items()},
                            h.numpy())
        jax_ref = {(name, D): jax_stale(tr, C, D, **kw)
                   for name, (C, tr, kw) in STALE.items() for D in (2, 4)}
        host = WTinyLFU(TWIN_C, shards=2, merge_every=512,
                        stale_admission=True, **TWIN_KW)
        twin = np.array([host.access(int(k)) for k in _twin_trace()],
                        np.int32)
        ranks = {n: j.result() for n, j in jobs.items()}
    return dict(ranks=ranks, single=single, jax=jax_ref, twin=twin)


def _same_state(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", list(CHUNK))
@pytest.mark.parametrize("n", [2, 4])
def test_chunk_mode_equals_single_device(world, n, name):
    r, st, h = world["single"][name]
    i = list(CHUNK).index(name)
    per_rank = [out[0][i] for out in world["ranks"][n]]
    for hits, extra, flags, state in per_rank:     # every rank alike
        assert hits == r.hits
        assert extra["mesh_devices"] == n and extra["mesh_exchange"] == (
            "chunk")
        assert np.array_equal(flags, h)
        _same_state(state, st)
        for k in ("trajectory", "final_quota"):
            assert extra.get(k) == r.extra.get(k), k


@pytest.mark.parametrize("name", list(STALE))
@pytest.mark.parametrize("n", [2, 4])
def test_stale_mode_equals_jax_vmap(world, n, name):
    canon, flags = world["jax"][(name, n)]
    i = len(CHUNK) + list(STALE).index(name)
    for hits, extra, got_flags, state in (out[0][i]
                                          for out in world["ranks"][n]):
        assert extra["mesh_exchange"] == "stale"
        assert np.array_equal(got_flags, flags)
        _same_state(state, canon)


def test_stale_mode_equals_host_twin(world):
    for out in world["ranks"][2]:
        assert np.array_equal(out[2][0][2], world["twin"])


@pytest.mark.parametrize("n", [2, 4])
def test_placement_over_the_group(world, n):
    """On n ranks, make_shard_mesh(4) takes all n, rank r owns its block
    of 4/n shards, shard_placement agrees, and all_gather is in rank
    order."""
    for r, out in enumerate(world["ranks"][n]):
        size, rank, owned, pl, gathered = out[1]
        per = 4 // n
        assert (size, rank) == (n, r)
        assert owned == list(range(r * per, (r + 1) * per))
        assert pl == [s // per for s in range(4)]
        assert gathered == [[d] * 3 for d in range(n) for _ in range(2)]


def test_simulate_sweep_mesh_guards(world):
    """simulate_sweep resolves a meshed grid to sequential runs, each
    equal to the single configuration's meshed run; mode="vmap" and a
    meshed grid with shards=1 raise, as in the reference."""
    for out in world["ranks"][2]:
        rows, errs = out[3]
        single = out[4][0]
        assert len(rows) == 1 and rows[0][0] == single[0]
        assert rows[0][1]["backend"] == "plain+sequential"
        assert rows[0][1]["mesh_devices"] == 2
        assert rows[0][1]["mesh_exchange"] == "chunk"
        assert "mesh sweeps" in errs[0] and "shards > 1" in errs[1]


def test_sketch_shard_placement_block():
    """The reference's placement test, on this process (no group: a
    one-rank mesh) and on stand-in devices: block placement, and the mesh
    size the largest divisor of the shards that fits."""
    pl = pmesh.shard_placement(8)
    assert pl == [0] * 8
    d = [object() for _ in range(4)]
    pl = pmesh.shard_placement(8, d)
    per = 8 // len({id(x) for x in pl})
    assert all(pl[s] is pl[(s // per) * per] for s in range(8))
    mesh = pmesh.make_shard_mesh(4)
    assert mesh.axis_names == ("shard",)
    assert 4 % mesh.size == 0 and mesh.size == 1
    assert mesh.layout(["counters", "dcounters", "ddoorkeeper", "mtab"]) == {
        "counters": "replicated", "dcounters": "split",
        "ddoorkeeper": "split", "mtab": "replicated"}


def test_shard_placement_matches_mesh_n4_d2():
    d0, d1 = object(), object()
    assert pmesh.shard_placement(4, [d0, d1]) == [d0, d0, d1, d1]
    assert pmesh._shard_mesh_size(4, 3) == 2
    assert pmesh.shard_placement(4, [d0, d1, object()]) == [d0, d0, d1, d1]
    assert pmesh.shard_placement(4, [d0]) == [d0] * 4


def test_make_shard_mesh_require_and_config_errors():
    with pytest.raises(ValueError, match="require=2"):
        pmesh.make_shard_mesh(4, require=2)
    mesh = pmesh.make_shard_mesh(2)
    with pytest.raises(ValueError, match="shards > 1"):
        pds.DeviceWTinyLFU(50, shards=1, mesh=mesh).spec()
    with pytest.raises(ValueError, match="ShardMesh"):
        pds.DeviceWTinyLFU(50, shards=2, mesh=object()).spec()
    with pytest.raises(ValueError, match="mesh_exchange"):
        pds.DeviceWTinyLFU(50, shards=2, mesh_exchange="bogus").spec()
    with pytest.raises(ValueError, match="requires mesh"):
        pds.DeviceWTinyLFU(50, shards=2, mesh_exchange="stale").spec()


def f4_stale_pins():
    """The JAX pins of chip_smoke's stale mesh run: F4 (F's trace, C=65,536,
    assoc=8, shards=4, epoch 4,096, warmup 480,000) in stale mode on a
    one-device mesh (the stale result does not depend on the mesh size:
    every rank takes the same verdicts and the gathered deltas are the
    same) -> (hits, regs, canonical state digest)."""
    from repro_torch.check_runs import digest
    tr = zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9, seed=11)
    canon, flags = jax_stale(tr, 65_536, 1, warmup=480_000, assoc=8,
                             shards=4, merge_every=4_096)
    st = {k: torch.from_numpy(np.array(v)) for k, v in canon.items()}
    return (int(flags[480_000:].sum()), st["regs"].tolist(), digest(st))


if __name__ == "__main__":
    import time
    t0 = time.perf_counter()
    print("F4S_PINS =", f4_stale_pins())
    print(f"# {time.perf_counter() - t0:.1f} s")

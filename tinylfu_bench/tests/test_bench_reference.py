"""The benchmark's references against the port's plain versions on the CPU
and against numbers the JAX package produced (copied as constants)."""
import hashlib

import numpy as np
import pytest
import torch

from tinylfu_bench.reference import hashing, tinylfu, wtinylfu
from tinylfu_bench.tests.bench_cases import zipf_keys

# Run F of the port's chip runs: the JAX engine's hits, registers and
# state digest for zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9,
# seed=11) at C = 65,536, assoc 8, warmup 480,000
F_PINS = (455_639, [413568, 0, 1200000, 455639, 0, 0, 0, 0],
          "822de2a898615740")
# Run S: the JAX ops' state digest, resets, estimate digest and admitted
# count for DeviceTinyLFU(65_536) recording F's trace in 4,096-key batches,
# then estimating its first 50,000 keys and admitting them against
# np.roll(cands, 1)
S_PINS = ("b0683a28b7852844", 3, "f40dc4a77ca0f007", 17188)


def digest(state: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k], dtype="<i4").tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("cap,n,items,warmup,frac", [
    (200, 2500, 1500, 500, 0.01), (64, 2000, 300, 0, 0.05),
    (1000, 3000, 5000, 1000, 0.01), (24, 1500, 60, 10, 0.2)])
def test_replay_matches_the_plain_engine(cap, n, items, warmup, frac):
    from repro_torch.core.device_simulate import simulate_trace
    trace = zipf_keys(n, items, seed=cap)
    geo = wtinylfu.Geometry(cap, assoc=8, window_frac=frac)
    ref = wtinylfu.replay(geo, trace, warmup=warmup)
    res, state, hits = simulate_trace(trace, cap, assoc=8, window_frac=frac,
                                      warmup=warmup, device="cpu", chunk=256,
                                      return_state=True)
    assert np.array_equal(hits.numpy(), ref.hits)
    assert res.hits == ref.counted_hits
    assert set(state) == set(ref.state)
    for k, v in state.items():
        assert np.array_equal(v.numpy(), ref.state[k]), k


def test_replay_lanes_match_the_plain_engine():
    from repro_torch.core.device_simulate import simulate_trace
    from tinylfu_bench.gen import synthetic
    trace = synthetic.tenant_lanes_trace(3, 700, n_items=400, seed=4)
    _, state, hits = simulate_trace(trace, 48, assoc=8, window_frac=0.05,
                                    warmup=50, device="cpu", chunk=128,
                                    streams=3, return_state=True)
    geo = wtinylfu.Geometry(48, assoc=8, window_frac=0.05)
    for b in range(3):
        ref = wtinylfu.replay(geo, trace[b], warmup=50)
        assert np.array_equal(hits[b].numpy(), ref.hits)
        for k, v in ref.state.items():
            assert np.array_equal(state[k][b].numpy(), v), (b, k)


def test_replay_matches_the_jax_pins_of_run_f():
    trace = zipf_keys(1_200_000, 1_000_000, seed=11)
    r = wtinylfu.replay(wtinylfu.Geometry(65_536, assoc=8), trace,
                        warmup=480_000)
    assert (r.counted_hits, r.state["regs"].tolist(),
            digest(r.state)) == F_PINS


def test_filter_matches_the_plain_ops():
    from repro_torch.kernels.ops import DeviceTinyLFU
    keys = zipf_keys(6000, 700, seed=3)
    prog = DeviceTinyLFU(64, device="cpu")
    ref = tinylfu.TinyLFU(64)
    for s in range(0, len(keys), 500):
        batch = keys[s:s + 500]
        prog.record(batch)
        ref.record(batch)
        victims = np.roll(batch, 1)
        assert np.array_equal(prog.admit(batch, victims),
                              ref.admit(batch, victims))
        assert np.array_equal(prog.estimate(batch), ref.estimate(batch))
    assert ref.resets > 0
    for k, v in ref.state().items():
        assert np.array_equal(prog.state[k].numpy(), v), k


def test_filter_matches_the_jax_pins_of_run_s():
    keys = zipf_keys(1_200_000, 1_000_000, seed=11)
    f = tinylfu.TinyLFU(65_536)
    for s in range(0, len(keys), 4096):
        f.record(keys[s:s + 4096])
    cands = keys[:50_000]
    est = f.estimate(cands)
    got = (digest(f.state()), f.resets,
           digest({"estimate": est.astype(np.int32)}),
           int(f.admit(cands, np.roll(cands, 1)).sum()))
    assert got == S_PINS


def test_hashing_matches_the_port_lanes():
    from repro_torch.kernels import sketch_common as sc
    keys = np.concatenate([zipf_keys(500, 10_000, seed=1),
                           np.array([2**64 - 1, 2**63, 2**32 + 5],
                                    np.uint64)])
    lo, hi = hashing.lanes(keys)
    tlo, thi = (torch.from_numpy(x) for x in sc.keys_to_lanes(keys))
    assert np.array_equal(
        hashing.counter_probes(lo, hi, 4, 1024),
        sc.probe_matrix(tlo, thi, sc.probe_salts(4), 1023).numpy())
    assert np.array_equal(
        hashing.doorkeeper_probes(lo, hi, 3, 4096),
        sc.probe_matrix(tlo, thi, sc.dk_probe_salts(3), 4095).numpy())
    assert np.array_equal(
        hashing.set_index(lo, hi, 64, hashing.MAIN_SET2_SALT),
        sc.set_index(tlo, thi, 64, hashing.MAIN_SET2_SALT).numpy())


def test_packing_layouts():
    vals = np.arange(64, dtype=np.uint8) % 16
    words = hashing.pack_counters(vals, 2, 32).view(np.uint32)
    assert words[0] == 0x76543210 and words[1] == 0xFEDCBA98
    bits = np.zeros(64, np.uint8)
    bits[[0, 33, 63]] = 1
    assert hashing.pack_bits(bits).view(np.uint32).tolist() == [
        1, 2 | (1 << 31)]


def test_geometry_refuses_what_it_does_not_replay():
    with pytest.raises(ValueError):
        wtinylfu.Geometry(64, rows=3)
    with pytest.raises(ValueError):
        wtinylfu.Geometry(64, doorkeeper=False)

"""The port's host engine (``repro_torch.core``: hashing twins, the exact
histogram, the cache policies, TinyLFU admission, W-TinyLFU and its
adaptive twin, the simulation harness) against the reference's, on the CPU.

Every policy replays the first 6,000 accesses of each of the paper's four
trace families (``check_runs.PF_CELLS``) in both packages and must give the
same per-access hit flags: the policies the reference runs in Python ints
live, the set-associative twins (whose reference hashes each new key with a
numpy call, ~60 us) live on the first 1,000 accesses and on all 6,000
against the sha256 of the reference's flags, pinned in
``PF_TWIN_FLAGS_SHA256`` (``PYTHONPATH=src python
tests/test_torch_paper_traces.py`` prints them).  The numpy hashing twins
equal the reference's and the torch lanes of ``kernels/sketch_common.py``;
``benchmarks/common.py``'s ``policy_factories`` runs unchanged against the
port's ``core``; results saved by either package load in the other.
"""
import functools
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core import hashing as jh
from repro_torch import check_runs as cr
import repro_torch.core as pc
from repro_torch.core import hashing as ph
from repro_torch.kernels import sketch_common as sc
from repro_torch.traces import zipf_probs

ROOT = Path(__file__).resolve().parents[1]
N_LIVE, N_TWIN_LIVE = 6_000, 1_000
C, SF = 256, 8
C_ADAPT = 64            # the adaptive twin scans its tables on every miss


@functools.lru_cache(maxsize=None)
def family(cell: str) -> np.ndarray:
    return cr.pf_trace(cell)[:N_LIVE]


def flags(policy, trace) -> np.ndarray:
    return np.fromiter((policy.access(k) for k in trace.tolist()), np.int8,
                       len(trace))


# name -> factory(core package) of a policy the reference runs in ints
LIVE = {
    "lru": lambda m: m.Cache(m.LRUEviction(C)),
    "fifo": lambda m: m.Cache(m.FIFOEviction(C)),
    "random": lambda m: m.Cache(m.RandomEviction(C, seed=3)),
    "lfu": lambda m: m.Cache(m.LFUEviction(C)),
    "slru": lambda m: m.Cache(m.SLRUEviction(C)),
    **{f"tinylfu+{ev}": functools.partial(
        lambda ev, m: m.tinylfu_cache(C, ev, sample_factor=SF), ev)
       for ev in ("lru", "random", "fifo", "slru", "lfu")},
    "exact+lru": lambda m: m.Cache(m.LRUEviction(C), m.TinyLFUAdmission(
        m.ExactHistogram(SF * C, cap=SF - 1))),
    "exact-float+lru": lambda m: m.Cache(m.LRUEviction(C),
                                         m.TinyLFUAdmission(m.ExactHistogram(
                                             SF * C, integer_division=False))),
    "plfu": lambda m: m.PLFU(C),
    "wlfu": lambda m: m.WLFU(C, window=SF * C),
    "2q": lambda m: m.TwoQ(C),
    "arc": lambda m: m.ARC(C),
    "lirs": lambda m: m.LIRS(C),
    "w-tinylfu": lambda m: m.WTinyLFU(C, sample_factor=SF),
    "w-tinylfu 20%": lambda m: m.WTinyLFU(C, window_frac=0.2,
                                          sample_factor=SF),
    "w-tinylfu shards 4": lambda m: m.WTinyLFU(C, shards=4, merge_every=512),
    "w-tinylfu stale": lambda m: m.WTinyLFU(C, shards=2,
                                            stale_admission=True),
    "adaptive": lambda m: m.AdaptiveWTinyLFU(C_ADAPT, window_frac=0.05,
                                             epoch_len=500),
    "adaptive shards 2": lambda m: m.AdaptiveWTinyLFU(C_ADAPT, epoch_len=500,
                                                      shards=2),
}
# the set-associative twins (set hashes, ARC's ghost bits)
TWINS = {
    "slru-assoc": lambda m: m.Cache(m.policies.SetAssociativeSLRU(C,
                                                                   assoc=8)),
    "w-tinylfu assoc 8": lambda m: m.WTinyLFU(C, sample_factor=SF, assoc=8),
    "w-tinylfu assoc 4 shards 2": lambda m: m.WTinyLFU(C, assoc=4, shards=2),
    "s3fifo-assoc": lambda m: m.SetAssocS3FIFO(C, assoc=8),
    "arc-assoc": lambda m: m.SetAssocARC(C, assoc=8, dk_bits=512),
    "lfu-assoc": lambda m: m.SetAssocLFU(C, assoc=8),
}


@pytest.mark.parametrize("cell", list(cr.PF_CELLS))
def test_every_policy_equals_reference_per_access(cell):
    tr = family(cell)
    for name, make in LIVE.items():
        got, want = flags(make(pc), tr), flags(make(jc), tr)
        assert np.array_equal(got, want), (cell, name)
        assert 0 < got.sum() < len(tr), (cell, name)


@pytest.mark.parametrize("cell", list(cr.PF_CELLS))
def test_set_associative_twins_equal_reference(cell):
    tr = family(cell)
    for name, make in TWINS.items():
        got = flags(make(pc), tr)
        want = flags(make(jc), tr[:N_TWIN_LIVE])
        assert np.array_equal(got[:N_TWIN_LIVE], want), (cell, name)
        sha = hashlib.sha256(got.tobytes()).hexdigest()[:16]
        assert sha == cr.PF_TWIN_FLAGS_SHA256[(cell, name)], (cell, name)


def test_policy_factories_run_unchanged_against_the_port():
    """benchmarks/common.py with its one import pointed at repro_torch.core:
    all fourteen of the paper's cast give the reference's hits."""
    src = (ROOT / "benchmarks" / "common.py").read_text()
    assert src.count("from repro.core import") == 1
    ns = {"__name__": "port_common",
          "__file__": str(ROOT / "benchmarks" / "common.py")}
    exec(compile(src.replace("from repro.core import",
                             "from repro_torch.core import"),
                 "port_common", "exec"), ns)
    ref = {"__name__": "ref_common",
           "__file__": str(ROOT / "benchmarks" / "common.py")}
    exec(compile(src, "ref_common", "exec"), ref)
    tr = family("PF-oltp")[:6_000]
    port_f, ref_f = ns["policy_factories"](9), ref["policy_factories"](9)
    assert list(port_f) == list(ref_f) and len(port_f) == 14
    for name in port_f:
        a = pc.run_trace(port_f[name](128), tr, warmup=600)
        b = jc.run_trace(ref_f[name](128), tr, warmup=600)
        assert (a.policy, a.hits, a.accesses) == (b.policy, b.hits,
                                                  b.accesses), name


def test_core_exports_equal_reference():
    assert pc.__all__ == jc.__all__
    for name in jc.__all__:
        assert hasattr(pc, name), name
    import repro.traces as jt
    import repro_torch.traces as pt
    for name in ("youtube_dynamic_trace", "wiki_drift_trace",
                 "spc1_like_trace", "oltp_like_trace"):
        assert name in jt.__all__ and name in pt.__all__


def test_hashing_twins_equal_reference_and_torch_lanes():
    rng = np.random.default_rng(5)
    keys = np.concatenate([rng.integers(0, 2**63, 3000, dtype=np.uint64),
                           rng.integers(0, 10**6, 3000, dtype=np.uint64),
                           np.array([0, 2**64 - 1, 2**32, 2**32 - 1],
                                    np.uint64)])
    np.testing.assert_array_equal(ph.splitmix64(keys), jh.splitmix64(keys))
    for probes, width, seed in ((4, 1 << 12, 0), (3, 1000, 7)):
        np.testing.assert_array_equal(
            ph.probe_indices(keys, probes, width, seed),
            jh.probe_indices(keys, probes, width, seed))
    lo, hi = ph.key_to_lanes(keys)
    jlo, jhi = jh.key_to_lanes(keys)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    # both mix a uint32 array in place, as the reference does
    np.testing.assert_array_equal(ph.mix32_np(lo.copy()),
                                  jh.mix32_np(lo.copy()))
    tlo, thi = (torch.from_numpy(x.view(np.int32)) for x in (lo, hi))
    np.testing.assert_array_equal(ph.mix32_np(lo.copy()),
                                  sc.mix32(tlo).numpy().astype(np.uint32))
    # the reference's numpy salt overflows np.uint32 past 8 probes; the
    # port takes it modulo 2^32 like the torch lanes
    np.testing.assert_array_equal(ph.probe_indices32_np(lo, hi, 8, 1 << 10),
                                  jh.probe_indices32_np(lo, hi, 8, 1 << 10))
    np.testing.assert_array_equal(
        ph.probe_indices32_np(lo, hi, 16, 1 << 10),
        sc.probe_matrix(tlo, thi, sc.probe_salts(16), (1 << 10) - 1).numpy())
    dk = sc.probe_matrix(tlo, thi, sc.dk_probe_salts(20), 255).numpy()
    for p in range(20):
        got = ph.dk_probe_index_np(lo, hi, p, 256)
        np.testing.assert_array_equal(got, jh.dk_probe_index_np(lo, hi, p,
                                                                256))
        np.testing.assert_array_equal(got, dk[:, p])
    for p in (0, 3, 9, 17):
        assert [ph.dk_probe_index(int(a), int(b), p, 256)
                for a, b in zip(lo[:500], hi[:500])] == \
            ph.dk_probe_index_np(lo[:500], hi[:500], p, 256).tolist()
    for n, salt in ((1, ph.MSET_SALT), (64, ph.MSET2_SALT),
                    (1024, ph.WSET_SALT)):
        got = ph.set_index32_np(keys, n, salt)
        np.testing.assert_array_equal(got, jh.set_index32_np(keys, n, salt))
        np.testing.assert_array_equal(got, sc.set_index(tlo, thi, n,
                                                        salt).numpy())
        assert [ph.set_index32(int(k), n, salt) for k in keys] == \
            got.tolist()
    for s in (1, 4, 16):
        got = ph.shard_index32_np(keys, s)
        np.testing.assert_array_equal(got, jh.shard_index32_np(keys, s))
        np.testing.assert_array_equal(got, sc.shard_index(tlo, thi,
                                                          s).numpy())
    with pytest.raises(OverflowError):
        ph.set_index32(-1, 8, ph.MSET_SALT)


@pytest.mark.parametrize("integer_division", [True, False])
def test_exact_histogram_equals_reference(integer_division):
    keys = cr.pf_trace("PF-yt")[:5_000].tolist()
    a = pc.ExactHistogram(700, cap=12, integer_division=integer_division)
    b = jc.ExactHistogram(700, cap=12, integer_division=integer_division)
    for k in keys:
        a.add(k)
        b.add(k)
        assert a.estimate(k) == b.estimate(k)
    assert (a.counts, a.size, a.resets) == (b.counts, b.size, b.resets)
    assert a.resets == 5_000 // 350 - 1
    assert all(type(v) is type(b.counts[k]) for k, v in a.counts.items())


def test_lfu_eviction_and_random_eviction_state_equal_reference():
    """LFU's buckets and minimum through bumps, removals and halvings;
    Random's swap-with-last removal and its draws."""
    rng = np.random.default_rng(9)
    ops = rng.integers(0, 4, 4_000).tolist()
    ks = rng.integers(0, 60, 4_000).tolist()
    lp, lj = pc.LFUEviction(40), jc.LFUEviction(40)
    rp, rj = pc.RandomEviction(40, seed=4), jc.RandomEviction(40, seed=4)
    for op, k in zip(ops, ks):
        for ev in (lp, lj, rp, rj):
            if k in ev:
                if op == 0:
                    ev.remove(k)
                else:
                    ev.on_hit(k)
            elif len(ev) < ev.capacity:
                ev.add(k)
            else:
                ev.remove(ev.peek_victim())
        if op == 3:
            lp.halve_all()
            lj.halve_all()
        assert (lp.freq, lp.minf, list(lp.buckets)) == \
            (lj.freq, lj.minf, list(lj.buckets))
        assert {f: list(b) for f, b in lp.buckets.items()} == \
            {f: list(b) for f, b in lj.buckets.items()}
        assert (rp.items, rp.pos) == (rj.items, rj.pos)
    assert rp.rng.getstate() == rj.rng.getstate()


def test_simulate_harness_equals_reference(tmp_path):
    """run_trace's labels, run_matrix's rows, theoretical_max_hit_ratio,
    and results saved by one package loaded by the other."""
    tr = family("PF-wiki")[:4_000]
    pf = {"TLRU": (lambda m: lambda n: m.tinylfu_cache(n, "lru")),
          "W": (lambda m: lambda n: m.WTinyLFU(n)),
          "ARC": (lambda m: lambda n: m.ARC(n))}
    rows = {}
    for m in (pc, jc):
        factories = {k: f(m) for k, f in pf.items()}
        rows[m] = m.run_matrix(factories, {"wiki": tr, "wiki-half": tr[:2000]},
                               [64, 200], warmup_frac=0.1, verbose=False)
        r = m.run_trace(m.tinylfu_cache(64, "slru"), tr, warmup=10)
        assert (r.policy, r.trace, r.accesses) == ("tinylfu+slru", "?", 3990)
        assert m.run_trace(m.Cache(m.FIFOEviction(8)), tr,
                           trace_name="x").policy == "fifo"
    key = [(r.policy, r.cache_size, r.trace, r.accesses, r.hits,
            r.hit_ratio) for r in rows[pc]]
    assert key == [(r.policy, r.cache_size, r.trace, r.accesses, r.hits,
                    r.hit_ratio) for r in rows[jc]]
    assert len(key) == 12
    for i, (save, load) in enumerate(((pc.save_results, jc.load_results),
                                      (jc.save_results, pc.load_results))):
        path = str(tmp_path / f"run{i}" / "results.json")
        src = rows[pc] if i == 0 else rows[jc]
        src[0].extra = {"note": i, "nested": [1, 2]}
        save(src, path)
        back = load(path)
        assert [vars(r) for r in back] == [vars(r) for r in src]
    probs = zipf_probs(500, 0.9)
    for n in (None, 10_000):
        assert pc.theoretical_max_hit_ratio(probs, n) == \
            jc.theoretical_max_hit_ratio(probs, n)


def test_tinylfu_admission_is_strict_and_syncs_lfu():
    """Ties keep the incumbent; every sketch reset halves the LFU cache's
    counters (the on_reset hook), as in the reference."""
    for m in (pc, jc):
        sk = m.default_sketch(16, sample_factor=4, counters_per_item=64.0,
                              doorkeeper=False)
        adm = m.TinyLFUAdmission(sk)
        adm.record(1)
        adm.record(2)
        assert not adm.admit(1, 2) and adm.rejected == 1
        adm.record(1)
        assert adm.admit(1, 2) and adm.admitted == 1
    cache = pc.tinylfu_cache(32, "lfu", sample_factor=2)
    calls = []
    orig = cache.ev.halve_all
    cache.ev.halve_all = lambda: (calls.append(1), orig())
    cache.admission.on_reset = cache.ev.halve_all
    for k in family("PF-yt")[:2_000].tolist():
        cache.access(k)
    assert len(calls) == cache.admission.sketch.resets > 0
    with pytest.raises(ValueError):
        pc.tinylfu_cache(8, "mru")

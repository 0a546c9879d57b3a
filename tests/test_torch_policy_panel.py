"""The policy panel (``policy="s3fifo" | "arc" | "lfu"``) on the port
against the JAX engine, on the CPU.

Every case feeds the same numpy inputs to the port (``device="cpu"``, the
plain ``step_ref`` with the competitor bodies) and to the JAX package (JAX
on the CPU) and requires ``np.array_equal`` on every state leaf (ARC's
``ghost`` Blooms too) and on the hit flags: whole runs through
``simulate_trace`` (1, 4 and 8 ways; 4- and 8-bit counters; the doorkeeper
on and off; sketch resets; ARC's ghost at the reference's tiny 256 bits)
against JAX ``jit``, with their ``extra`` and ``policy`` label; a few hundred
accesses per policy against the JAX Pallas kernel (interpret mode); and the
step-level contract on hand-built states (an S3-FIFO window set of zero
ways, a main set full of CLOCK-marked records, LFU's ties broken by stamp,
a saturated ARC ghost half cleared before its insert).  The reference's
property contracts (tests/test_policy_panel.py) run on the port alone:
residents never above capacity, a hit never changes the resident set, a
poisoned lane cannot move its neighbour.  ``panel_traces`` equals the
reference's.

Run as a script, it prints the JAX pins of runs FP, GP and WP
(``repro_torch.check_runs``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro.kernels import sketch_step as jks
from repro.traces import synthetic as jsyn
from repro_torch.check_runs import PANEL_FRACS
from repro_torch.core import device_simulate as pds
from repro_torch.kernels import sketch_step as pks
from repro_torch.kernels.sketch_common import POLICIES, keys_to_lanes
from repro_torch.traces import synthetic as psyn

torch.set_num_threads(1)

C = 48
TRACE = psyn.zipf_trace(1500, n_items=500, alpha=0.9, seed=11)
# (policy, assoc, DeviceWTinyLFU kwargs): at C=48 one way per set is 64
# sets, 4 ways 16 and 8 ways 8 (the choices alias often); sample_factor 2
# resets the sketch every 96 accesses
RUNS = [
    ("s3fifo", 1, {}),
    ("s3fifo", 4, dict(counter_bits=8, doorkeeper=False)),
    ("s3fifo", 8, dict(sample_factor=2)),
    ("arc", 1, {}),
    ("arc", 4, dict(dk_bits_per_item=256 / (8 * C))),     # dk_bits 256
    ("arc", 8, dict(sample_factor=2)),
    ("lfu", 1, dict(counter_bits=8, doorkeeper=False)),
    ("lfu", 4, {}),
    ("lfu", 8, dict(sample_factor=2)),
]


def assert_state_equal(got: dict, want: dict, what: str = ""):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what} state[{k!r}]")


@pytest.mark.parametrize("policy,assoc,kw", RUNS,
                         ids=[f"{p}-ways{a}-{'-'.join(k) or 'default'}"
                              for p, a, k in RUNS])
def test_run_equals_jax(policy, assoc, kw):
    """simulate_trace with a competitor == the JAX engine (jit): every
    leaf, the hit flags, hits, the label and extra."""
    args = dict(assoc=assoc, policy=policy, window_frac=PANEL_FRACS[policy],
                warmup=300, trace_name="zipf", return_state=True, **kw)
    jr, js, jh = jds.simulate_trace(TRACE, C, **args)
    pr, ps, ph = pds.simulate_trace(TRACE, C, device="cpu", chunk=512, **args)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js)
    assert ("ghost" in ps) == (policy == "arc")
    assert (pr.hits, pr.accesses, pr.hit_ratio, pr.policy, pr.trace) == (
        jr.hits, jr.accesses, jr.hit_ratio, jr.policy, jr.trace)
    assert pr.policy == f"{policy}(device)"
    drop = ("backend", "device")
    assert ({k: v for k, v in pr.extra.items() if k not in drop}
            == {k: v for k, v in jr.extra.items() if k not in drop})
    assert pr.extra["policy"] == policy and pr.extra["backend"] == "plain"


@pytest.mark.parametrize("policy", ("s3fifo", "arc", "lfu"))
def test_run_equals_jax_pallas_kernel(policy):
    """A few hundred accesses against the JAX Pallas kernel (interpret
    mode), chunked at 128 with a padded tail on the port's side."""
    tr = TRACE[:260]
    args = dict(assoc=4, policy=policy, window_frac=PANEL_FRACS[policy],
                return_state=True)
    jr, js, jh = jds.simulate_trace(tr, 24, backend="pallas", **args)
    pr, ps, ph = pds.simulate_trace(tr, 24, device="cpu", chunk=128, **args)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js)
    assert pr.hits == jr.hits > 0


# ---------------------------------------------------------------------------
# the step-level contract on hand-built states
# ---------------------------------------------------------------------------

_ONE_SET = dict(width=256, rows=4, window_slots=4, main_slots=4, assoc=4)


def _records(spec, keys, metas):
    """Main-table rows [lo, hi, meta, idx[rows], dkb[dkp]] of ``keys``."""
    lo, hi = keys_to_lanes(np.asarray(keys, np.uint64))
    idx, dkb, _, _ = pks.precompute_probes(spec, torch.from_numpy(lo),
                                           torch.from_numpy(hi))
    return np.concatenate([np.stack([lo.view(np.int32), hi.view(np.int32),
                                     np.asarray(metas, np.int32)], axis=1),
                           idx.numpy(), dkb.numpy()], axis=1)


def _both(spec_kw, pargs, arrays, keys):
    """Step the same numpy state through the JAX and the port step_ref;
    both must agree on every leaf and hit.  Returns the port's (numpy
    state, hit flags)."""
    lo, hi = keys_to_lanes(np.asarray(keys, np.uint64))
    js_ = jks.StepSpec(**spec_kw)
    jst, jh = jks.step_ref(
        js_, jks.make_step_params(*pargs, counter_bits=js_.counter_bits),
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(lo),
        jnp.asarray(hi))
    ps_ = pks.StepSpec(**spec_kw)
    pst = pks.state_from_numpy(ps_, arrays, "cpu")
    _, ph = pks.step_ref(ps_, pks.make_step_params(
        *pargs, counter_bits=ps_.counter_bits, device="cpu"), pst,
        torch.from_numpy(lo), torch.from_numpy(hi))
    got = pks.state_to_numpy(pst)
    assert_state_equal(got, {k: np.asarray(v) for k, v in jst.items()})
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    return got, ph.numpy()


def _init(spec_kw, wcap, mcap):
    spec = pks.StepSpec(**spec_kw)
    return spec, pks.state_to_numpy(pks.init_step_state(spec, wcap, mcap,
                                                        device="cpu"))


def test_wtinylfu_policy_is_the_identical_program():
    """The panel dispatch is static: spelling out the default policy
    records the identical program (R7 through the port's fingerprint
    registry), as tests/test_policy_panel.py pins the reference's; a
    competitor's launches carry their own build and policy index."""
    from repro_torch.analysis.program_lint import (assert_identical_program,
                                                   pin_program_text)
    assert_identical_program("policy-default", device="cpu")
    arc = pin_program_text("cpu", policy="arc")
    assert "SKETCH_STEP_PANEL" in arc and "policy=2" in arc


def test_s3fifo_zero_way_window_set_bypasses_to_main():
    """A key whose window set has no way is its own candidate: its first
    access (estimate 1, the doorkeeper bit) stays out, its second (estimate
    2) enters main unmarked with its stamp."""
    kw = dict(_ONE_SET, dk_bits=1024, window_slots=8, policy="s3fifo")
    spec, arrays = _init(kw, 1, 4)          # window sets of 1 and 0 ways
    wmeta = arrays["wtab"][:, pks.WT_META].reshape(2, 4)
    zero = int(np.flatnonzero((wmeta == pks._I32_MAX).all(axis=1))[0])
    key = next(k for k in range(1, 10_000) if int(pks.precompute_probes(
        spec, *map(torch.from_numpy, keys_to_lanes(
            np.asarray([k], np.uint64))))[2][0]) == zero)
    got, hits = _both(kw, (1, 4, 3, 64, 7, 0), arrays, [key])
    assert (got["mtab"][:, pks.MT_META] == pks._EMPTY).all()
    got, hits = _both(kw, (1, 4, 3, 64, 7, 0), got, [key])
    assert not hits.any()
    lo = keys_to_lanes(np.asarray([key], np.uint64))[0].view(np.int32)[0]
    row = got["mtab"][got["mtab"][:, pks.MT_LO] == lo]
    assert len(row) == 1 and row[0, pks.MT_META] == 1     # stamp t, no mark


def test_s3fifo_main_set_full_of_marked_records():
    """With every main record CLOCK-marked, the admitted candidate takes the
    oldest marked record's way, unmarked."""
    kw = dict(_ONE_SET, dk_bits=1024, policy="s3fifo")
    spec, arrays = _init(kw, 1, 4)
    stamps = [13, 11, 14, 12]
    arrays["mtab"] = _records(spec, [101, 102, 103, 104],
                              [pks._PROT | s for s in stamps])
    got, hits = _both(kw, (1, 4, 3, 64, 7, 0), arrays, [1, 1, 2])
    assert hits.tolist() == [0, 1, 0]
    keys = got["mtab"][:, pks.MT_LO].tolist()
    assert keys == [101, 1, 103, 104]       # 102 (stamp 11) was the oldest
    assert got["mtab"][1, pks.MT_META] == 2


def test_lfu_ties_broken_by_the_oldest_stamp():
    """A fresh sketch gives every record the same estimate: the victim is
    the oldest stamp; a hit refreshes the stamp, unmarked."""
    kw = dict(_ONE_SET, dk_bits=0, policy="lfu")
    spec, arrays = _init(kw, 1, 4)
    arrays["mtab"] = _records(spec, [101, 102, 103, 104], [13, 11, 14, 12])
    arrays["regs"][pks.R_T] = 20
    got, hits = _both(kw, (1, 4, 3, 64, 7, 0), arrays, [1, 104])
    assert hits.tolist() == [0, 1]
    assert got["mtab"][:, pks.MT_LO].tolist() == [101, 1, 103, 104]
    assert got["mtab"][:, pks.MT_META].tolist() == [13, 20, 14, 21]


def test_arc_saturated_ghost_half_clears_before_its_insert():
    """Evicting a T1 record into a B1 half whose count reached main_cap
    clears the half first: afterwards it holds the victim's probe bits
    alone and its count is 1; the missing key that B1 remembered (every bit
    set) raises p and enters T2."""
    kw = dict(_ONE_SET, dk_bits=256, policy="arc")
    spec, arrays = _init(kw, 1, 4)
    arrays["mtab"] = _records(spec, [101, 102, 103, 104], [13, 11, 14, 12])
    arrays["ghost"][:spec.dk_words] = -1            # B1: every bit set
    arrays["regs"][[pks.R_T, pks.R_WQUOTA, pks.R_WCOUNT, pks.R_MCOUNT]] = (
        20, 0, 4, 4)
    got, hits = _both(kw, (1, 4, 3, 64, 7, 0), arrays, [1])
    vdkb = arrays["mtab"][1, 3 + spec.rows:]       # 102: the T1 LRU
    b1 = np.zeros(spec.dk_words, np.int64)
    for b in vdkb:
        b1[b >> 5] |= 1 << (b & 31)
    np.testing.assert_array_equal(got["ghost"][:spec.dk_words],
                                  b1.astype(np.uint32).view(np.int32))
    assert not got["ghost"][spec.dk_words:].any()
    regs = got["regs"]
    assert (regs[pks.R_WQUOTA], regs[pks.R_WCOUNT], regs[pks.R_MCOUNT]) == (
        1, 3, 1)
    assert got["mtab"][1, pks.MT_META] == pks._PROT | 20


# ---------------------------------------------------------------------------
# the reference's property contracts, on the port alone
# ---------------------------------------------------------------------------

def _prop_cfg(policy: str) -> pds.DeviceWTinyLFU:
    return pds.DeviceWTinyLFU(24, assoc=4, policy=policy,
                              window_frac=PANEL_FRACS[policy])


def _resident(state) -> set:
    """(lo, hi, table) of every resident record."""
    out = set()
    for name, meta_col in (("wtab", pks.WT_META), ("mtab", pks.MT_META)):
        tab = state[name].numpy()
        ok = (tab[:, meta_col] != pks._I32_MAX) & (tab[:, meta_col]
                                                   != pks._EMPTY)
        out |= {(int(r[0]), int(r[1]), name) for r in tab[ok]}
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_resident_count_never_exceeds_capacity(policy):
    cfg = _prop_cfg(policy)
    tr = np.random.default_rng(5).integers(0, 300, size=600)
    _, state, _ = pds.simulate_trace(tr, cfg.capacity, return_state=True,
                                     assoc=4, policy=policy, device="cpu",
                                     window_frac=cfg.window_frac)
    res = _resident(state)
    w = sum(1 for r in res if r[2] == "wtab")
    m = len(res) - w
    assert w <= cfg.window_cap and m <= cfg.main_cap
    assert w + m <= cfg.capacity + (1 if policy in ("arc", "lfu") else 0)


@pytest.mark.parametrize("policy", POLICIES)
def test_hit_never_changes_resident_set(policy):
    """Stepping one access at a time, the resident keys after a hit are
    those before it (stamps and marks may change, membership may not)."""
    cfg = _prop_cfg(policy)
    spec, params = cfg.spec(), cfg.params(device="cpu")
    state = pks.init_step_state(spec, cfg.window_cap, cfg.main_cap,
                                device="cpu")
    tr = np.random.default_rng(6).zipf(1.4, size=250).astype(np.int64) % 200
    lo, hi = map(torch.from_numpy, keys_to_lanes(tr.astype(np.uint64)))
    nhits = 0
    for i in range(len(tr)):
        before = {r[:2] for r in _resident(state)}
        _, hit = pks.step_ref(spec, params, state, lo[i:i + 1], hi[i:i + 1])
        if int(hit[0]):
            nhits += 1
            assert {r[:2] for r in _resident(state)} == before, i
    assert nhits > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_poisoned_lane_cannot_perturb_neighbor(policy):
    """streams=2: lane 1 replaying pure pollution (every key unique) leaves
    lane 0's hits equal to the streams=1 run of its trace."""
    cfg = _prop_cfg(policy)
    good = np.random.default_rng(7).zipf(1.3, size=500).astype(np.int64) % 300
    poison = (10**9 + np.arange(500)).astype(np.int64)
    kw = dict(assoc=4, policy=policy, window_frac=cfg.window_frac,
              device="cpu")
    solo = pds.simulate_trace(good, cfg.capacity, **kw)
    duo = pds.simulate_trace(np.stack([good, poison]), cfg.capacity,
                             streams=2, **kw)
    assert duo.extra["lane_hits"][0] == solo.hits > 0


def test_panel_traces_equal_the_reference():
    got = psyn.panel_traces(length=4_000, seed=3)
    want = jsyn.panel_traces(length=4_000, seed=3)
    assert set(got) == set(want) == {"zipf", "scan-hot", "churn", "loop"}
    for k in want:
        assert got[k].dtype == np.int64
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


if __name__ == "__main__":
    from repro_torch.check_runs import GP_RUNS, digest

    def leaves(s):
        return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
                s.items()}

    f = jsyn.zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9, seed=11)
    for pol in ("s3fifo", "lfu", "arc"):        # ARC ~6 min of JAX on a CPU
        r, s, _ = jds.simulate_trace(f, 65_536, warmup=480_000, assoc=8,
                                     policy=pol, window_frac=PANEL_FRACS[pol],
                                     return_state=True)
        print(f"FP {pol}: hits {r.hits} regs {np.asarray(s['regs']).tolist()}"
              f" digest {digest(leaves(s))}", flush=True)
    r = jds.simulate_trace(f, 65_536, warmup=480_000, assoc=8,
                           window_frac=0.1)
    print(f"WP wtinylfu at window_frac 0.1: hits {r.hits}")
    traces = {"zipf": jsyn.zipf_trace(60_000, n_items=50_000, alpha=0.9,
                                      seed=7),
              "scanhot": psyn.scan_then_hotspot_trace()}
    for tr, cap, warmup, kw in GP_RUNS:
        print(f"GP {tr} C={cap} {kw}:", {
            pol: jds.simulate_trace(traces[tr], cap, assoc=8, policy=pol,
                                    window_frac=PANEL_FRACS[pol],
                                    warmup=warmup, **kw).hits
            for pol in POLICIES})

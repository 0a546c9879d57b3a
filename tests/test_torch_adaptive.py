"""The adaptive window (``adaptive=True``) of the port against the JAX
package's adaptive contracts (tests/test_adaptive.py), on the CPU.

Each case feeds the same numpy keys to the port (``device="cpu"``: the plain
``step_ref``, the tensor ``rebalance`` and the tensor climb) and to the JAX
package (``step_ref``/``rebalance`` and the engine with ``backend="jit"``,
JAX on the CPU) and requires every state leaf (``wsl``/``wuw`` included),
the hit flags, ``trajectory`` and ``final_quota`` to be equal:
``core/adaptive.py`` function by function; a pinned quota against the
static step; a rebalance to the same quota; ``rebalance`` itself on flat and
set states, growing and shrinking, across the window set count, with
migrants that share a main set and sets that are full; the load-aware
window ways; the protected budget shrinking under a window grow; whole runs
(flat, 4 and 8 ways, 4- and 8-bit counters, doorkeeper on and off,
``shards=4``, a partial tail epoch, shorter than one epoch, empty).  Tenant
lanes, adaptive sweeps and the JAX Pallas kernel are in
test_torch_adaptive_lanes.py.

Run as a script, it prints the JAX pins of runs FA, FA4, WA and GA
(``repro_torch.check_runs``, run on the card by ``chip_smoke.py``):
``PYTHONPATH=src python tests/test_torch_adaptive.py``, ~2 min.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as jad
from repro.core import device_simulate as jds
from repro.core.hashing import WSET_SALT, set_index32_np
from repro.kernels import sketch_step as jks
from repro.traces import synthetic as jsyn
from repro_torch.core import adaptive as pad
from repro_torch.kernels import sketch_step as pks
from repro_torch.kernels.sketch_common import keys_to_lanes
from repro_torch.traces import synthetic as psyn

torch.set_num_threads(1)


def lanes(keys):
    lo, hi = keys_to_lanes(np.asarray(keys, np.uint64))
    return lo, hi


def step_both(kw, pargs, keys, wcap, mcap=None, state=None):
    """(port state, port hits), (JAX state, JAX hits) of one step_ref over
    ``keys`` from init (or from the numpy ``state``)."""
    pspec, jspec = pks.StepSpec(**kw), jks.StepSpec(**kw)
    pp = pks.make_step_params(*pargs, counter_bits=pspec.counter_bits,
                              device="cpu")
    jp = jks.make_step_params(*pargs, counter_bits=jspec.counter_bits)
    if state is None:
        ps = pks.init_step_state(pspec, wcap, mcap, device="cpu")
        js = jks.init_step_state(jspec, wcap, mcap)
    else:
        ps = pks.state_from_numpy(pspec, state, device="cpu")
        js = {k: jnp.asarray(v) for k, v in state.items()}
    lo, hi = lanes(keys)
    ps, ph = pks.step_ref(pspec, pp, ps, torch.from_numpy(lo),
                          torch.from_numpy(hi))
    js, jh = jds._jit_step(jspec, jp, js, jnp.asarray(lo), jnp.asarray(hi))
    return (ps, ph.numpy()), (js, np.asarray(jh))


def assert_state_equal(got: dict, want: dict, what: str = ""):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what} state[{k!r}]")


def numpy_state(state: dict) -> dict:
    return {k: np.asarray(v).copy() for k, v in state.items()}


# --- core/adaptive.py ------------------------------------------------------

def test_adaptive_module_equals_reference():
    """Every function of the port's core/adaptive.py equals the reference's
    over a grid of inputs, negative diffs and trends included."""
    for cap in (1, 2, 7, 100, 800, 65_536):
        for frac in (0.01, 0.3, 0.5, 0.99):
            wcap = max(1, round(cap * 0.01))
            assert pad.window_cap_max(cap, wcap, frac) == \
                jad.window_cap_max(cap, wcap, frac)
    rng = np.random.default_rng(0)
    for _ in range(300):
        args = [int(x) for x in rng.integers(0, 5000, 7)] + [
            int(rng.integers(1, 40_000))]
        args[1:6] = [a if rng.random() < 0.5 else 0 for a in args[1:6]]
        assert pad.resolve_climb(*args) == jad.resolve_climb(*args)
    for _ in range(3000):
        climb = jad.resolve_climb(int(rng.integers(64, 8192)), 0,
                                  int(rng.integers(1, 4)), 0, 0, 0,
                                  int(rng.integers(1, 5)),
                                  int(rng.integers(2, 40_000)))
        regs = [int(rng.integers(-500, 5000)),            # ehits
                int(rng.integers(-1, 5000)),              # prev (-1: fresh)
                int(rng.choice([-1, 1])),                 # dirn
                int(rng.integers(1, 3000)),               # delta
                int(rng.integers(-1, 5000)),              # ewma
                int(rng.integers(-900, 900)),             # trend
                int(rng.integers(0, 8)),                  # k
                int(rng.integers(climb[1], climb[2] + 1))]    # quota
        assert pad.climb_update(climb, *regs) == jad.climb_update(climb,
                                                                  *regs)
    for n_sets in (1, 4, 8, 2048):
        load = rng.integers(0, 6, n_sets)
        for quota in sorted({1, 2, n_sets // 2 or 1, n_sets - 1 or 1, n_sets,
                             n_sets + 3, 3 * n_sets}):
            assert pad.window_set_ways(quota, n_sets, load) == \
                jad.window_set_ways(quota, n_sets, load)


def test_phase_shift_trace_equals_reference():
    np.testing.assert_array_equal(psyn.phase_shift_trace(5000, seed=3),
                                  jsyn.phase_shift_trace(5000, seed=3))
    kw = dict(n_hot=300, working_set=80, advance=0.05, seed=2)
    np.testing.assert_array_equal(psyn.phase_shift_trace(3001, **kw),
                                  jsyn.phase_shift_trace(3001, **kw))


# --- the plain step with the adaptive branches ------------------------------

@pytest.mark.parametrize("wslots,mslots,assoc,pargs,wcap", [
    (2, 40, None, (2, 40, 32, 500, 7, 0), 2),
    (16, 128, None, (2, 40, 32, 500, 7, 0), 2),
    (8, 64, 8, (4, 48, 38, 700, 7, 0), 4),
], ids=["flat exact", "flat padded up", "ways 8"])
def test_pinned_quota_equals_static(wslots, mslots, assoc, pargs, wcap):
    """adaptive=True with the quota never rebalanced gives the static
    step's hit sequence (exact and padded-up flat tables, 8 ways), and
    equals the JAX adaptive step leaf for leaf."""
    keys = np.random.default_rng(0).integers(0, 300, 500, dtype=np.uint64)
    kw = dict(width=256, rows=4, dk_bits=1024, window_slots=wslots,
              main_slots=mslots, assoc=assoc)
    static = dict(kw, window_slots=2, main_slots=40) if assoc is None else kw
    (_, h_static), _ = step_both(static, pargs, keys, wcap, pargs[1])
    (ps, ph), (js, jh) = step_both(dict(kw, adaptive=True), pargs, keys, wcap)
    np.testing.assert_array_equal(ph, h_static)
    np.testing.assert_array_equal(ph, jh)
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js)


@pytest.mark.parametrize("assoc", [None, 8], ids=["flat", "ways 8"])
def test_rebalance_to_the_same_quota_changes_no_hit(assoc):
    keys = np.random.default_rng(1).integers(0, 300, 800, dtype=np.uint64)
    spec = pks.StepSpec(width=256, rows=4, dk_bits=1024, window_slots=8,
                        main_slots=64, assoc=assoc, adaptive=True)
    params = pks.make_step_params(4, 48, 38, 600, 7, 0, device="cpu")
    lo, hi = (torch.from_numpy(x) for x in lanes(keys))
    _, whole = pks.step_ref(spec, params, pks.init_step_state(
        spec, 4, device="cpu"), lo, hi)
    st = pks.init_step_state(spec, 4, device="cpu")
    st, ha = pks.step_ref(spec, params, st, lo[:400], hi[:400])
    pks.rebalance(spec, params, st, st["regs"][pks.R_WQUOTA].clone())
    st, hb = pks.step_ref(spec, params, st, lo[400:], hi[400:])
    np.testing.assert_array_equal(whole.numpy(),
                                  torch.cat([ha, hb]).numpy())


# --- rebalance against the reference's --------------------------------------

_FLAT = dict(width=256, rows=4, dk_bits=1024, window_slots=30, main_slots=60,
             adaptive=True)
_SET = dict(width=256, rows=4, dk_bits=1024, window_slots=32, main_slots=64,
            assoc=8, adaptive=True)
# 16 window sets over 2 main sets of 16 ways: a shrink of a full window
# sends many records to the same main set, and a set fills up
_COLLIDE = dict(width=256, rows=4, dk_bits=0, window_slots=256,
                main_slots=32, assoc=16, adaptive=True)
REBALANCE_CASES = [
    ("flat grow and shrink", _FLAT, (3, 57, 45, 300, 7, 0), 3,
     [12, 2, 30, 1, 25, 40]),
    ("flat shrink into a full main", _FLAT, (20, 40, 32, 300, 7, 0), 20,
     [1, 20, 3]),
    ("set across the set count", _SET, (4, 48, 38, 700, 7, 0), 4,
     [12, 3, 26, 1, 9, 4, 31]),
    ("set, migrants share a main set, full sets", _COLLIDE,
     (16, 17, 13, 500, 7, 0), 16, [1, 16, 2, 12, 1]),
]


@pytest.mark.parametrize("case", range(len(REBALANCE_CASES)),
                         ids=[c[0] for c in REBALANCE_CASES])
def test_rebalance_equals_reference(case):
    """The port's rebalance == the reference's, leaf for leaf, on states the
    JAX step filled: each epoch of keys, then a rebalance of the same state
    in both packages; the port's closed-form set migration against the
    reference's loop over the migrants."""
    _, kw, pargs, wcap, quotas = REBALANCE_CASES[case]
    pspec, jspec = pks.StepSpec(**kw), jks.StepSpec(**kw)
    jp = jks.make_step_params(*pargs)
    pp = pks.make_step_params(*pargs, device="cpu")
    keys = np.random.default_rng(case).integers(0, 200, 300 * len(quotas),
                                                dtype=np.uint64)
    lo, hi = lanes(keys)
    js = jks.init_step_state(jspec, wcap)
    shared = 0
    for e, q in enumerate(quotas):
        s = slice(300 * e, 300 * (e + 1))
        js, _ = jds._jit_step(jspec, jp, js, jnp.asarray(lo[s]),
                              jnp.asarray(hi[s]))
        before = numpy_state(js)
        ps = pks.state_from_numpy(pspec, before, device="cpu")
        js = jks.rebalance(jspec, jp, js, q)
        pks.rebalance(pspec, pp, ps, q)
        assert_state_equal({k: v.numpy() for k, v in ps.items()}, js,
                           f"epoch {e} quota {q}")
        if pspec.assoc is not None:
            w = before["wtab"]
            mig = w[:, pks.WT_META] >= 0
            sets = w[mig, pks.WT_MSET]
            shared = max(shared, int(np.bincount(sets).max()) if len(sets)
                         else 0)
    if kw is _COLLIDE:
        assert shared > 2          # several migrants had one first choice


def test_rebalance_migration_fills_sets_and_drops_the_rest():
    """A shrink to quota 1 from a full window over two main sets of 16
    ways: migrants that share a first-choice set fill its free ways in
    order and the rest are dropped, as the reference's loop does."""
    pspec, jspec = pks.StepSpec(**_COLLIDE), jks.StepSpec(**_COLLIDE)
    pargs = (16, 17, 13, 500, 7, 0)
    keys = np.arange(1, 200, dtype=np.uint64)         # 199 distinct keys
    lo, hi = lanes(keys)
    js, _ = jds._jit_step(jspec, jks.make_step_params(*pargs),
                          jks.init_step_state(jspec, 16), jnp.asarray(lo),
                          jnp.asarray(hi))
    before = numpy_state(js)
    n_main = int((before["mtab"][:, pks.MT_META] >= 0).sum())
    n_win = int((before["wtab"][:, pks.WT_META] >= 0).sum())
    assert n_main == 17 and n_win == 16                # both tables full
    ps = pks.state_from_numpy(pspec, before, device="cpu")
    pks.rebalance(pspec, pks.make_step_params(*pargs, device="cpu"), ps, 1)
    js = jks.rebalance(jspec, jks.make_step_params(*pargs), js, 1)
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js)
    after = ps["mtab"][:, pks.MT_META].numpy().reshape(2, 16)
    moved = int((after >= 0).sum()) - n_main
    assert 0 < moved < n_win - 1           # a migrant found no free way
    assert (after >= 0).all(axis=1).any()  # in its full first-choice set


# six ways: a stored main set s whose int32 product 6 s wraps lands its
# block at a start that is not a multiple of 6, across two sets
_WRAP = dict(width=256, rows=4, dk_bits=0, window_slots=12, main_slots=24,
             assoc=6, adaptive=True)
_WRAP_ARGS = (10, 14, 11, 500, 7, 0)
# 6 * 715,827,883 wraps to 2, 6 * -715,827,882 to 4; a start past the
# table's last block clamps to it
_WRAP_SETS = (715_827_883, -715_827_882)


def _wrapped_state(stored_set: int) -> dict:
    """The JAX step's state after 600 keys, with every resident window
    record's first-choice main set replaced by ``stored_set``."""
    jspec = jks.StepSpec(**_WRAP)
    keys = np.random.default_rng(3).integers(1, 400, 600, dtype=np.uint64)
    lo, hi = lanes(keys)
    js, _ = jds._jit_step(jspec, jks.make_step_params(*_WRAP_ARGS),
                          jks.init_step_state(jspec, _WRAP_ARGS[0]),
                          jnp.asarray(lo), jnp.asarray(hi))
    st = numpy_state(js)
    res = st["wtab"][:, pks.WT_META] >= 0
    st["wtab"][res, pks.WT_MSET] = stored_set
    return st


@pytest.mark.parametrize("stored_set", _WRAP_SETS)
def test_rebalance_with_a_wrapped_stored_set_equals_reference(stored_set):
    """A stored main set out of range whose product with a way count that
    is not a power of two wraps into the table at a start that is not a
    multiple of it (a fault's state): the migrants' blocks overlap two
    sets, and the port's rebalance writes them one at a time as the
    reference's loop does, leaf for leaf, then marks the state in range
    only once no such set is left."""
    pspec, jspec = pks.StepSpec(**_WRAP), jks.StepSpec(**_WRAP)
    before = _wrapped_state(stored_set)
    n_win = int((before["wtab"][:, pks.WT_META] >= 0).sum())
    assert n_win > 2 and pks.tables_out_of_range(pspec, before)
    ps = pks.state_from_numpy(pspec, before, device="cpu")
    pks.rebalance(pspec, pks.make_step_params(*_WRAP_ARGS, device="cpu"),
                  ps, 1)
    js = jks.rebalance(jspec, jks.make_step_params(*_WRAP_ARGS),
                       {k: jnp.asarray(v) for k, v in before.items()}, 1)
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js)
    moved = (np.asarray(js["mtab"])[:, pks.MT_META] >= 0).sum() - (
        before["mtab"][:, pks.MT_META] >= 0).sum()
    assert moved > 0                       # some migrant found a free way
    assert pks._in_range_marked(pspec, ps) == (
        not pks.tables_out_of_range(pspec, ps))


def test_rebalance_with_wrapped_stored_sets_on_lanes_equals_reference():
    """Two lanes, each with its own wrapped stored set and its own quota:
    each lane equals the reference's rebalance of that lane alone."""
    pspec = pks.StepSpec(**_WRAP, streams=2)
    jspec = jks.StepSpec(**_WRAP)
    lanes_in = [_wrapped_state(s) for s in _WRAP_SETS]
    ps = pks.state_from_numpy(pspec, {k: np.stack([st[k] for st in lanes_in])
                                      for k in lanes_in[0]}, device="cpu")
    pp = pks.make_step_params(*_WRAP_ARGS, device="cpu")
    quotas = (1, 3)
    pks.rebalance(pspec, torch.stack([pp, pp]), ps, torch.tensor(quotas))
    for b, (st, q) in enumerate(zip(lanes_in, quotas)):
        js = jks.rebalance(jspec, jks.make_step_params(*_WRAP_ARGS),
                           {k: jnp.asarray(v) for k, v in st.items()}, q)
        assert_state_equal({k: v[b].numpy() for k, v in ps.items()}, js,
                           f"lane {b}")


def test_load_aware_ways_follow_the_hot_sets():
    """Below the window set count the quota's ways go to the sets with the
    most traffic last epoch (not a fixed prefix of sets), and the window
    then hits there: bursts of three accesses to fresh keys of window sets
    2 and 3, which the uniform rule leaves without a way at quota 2."""
    nws = 4
    kw = dict(width=256, rows=4, dk_bits=1024, window_slots=32,
              main_slots=64, assoc=8)
    pargs = (2, 50, 40, 700, 7, 0)
    pool = np.arange(1, 40_000, dtype=np.uint64)
    wset = set_index32_np(pool, nws, WSET_SALT)
    hot = [pool[wset == 2], pool[wset == 3]]
    keys = np.repeat([hot[b % 2][b // 2] for b in range(300)], 3)
    head, tail = keys[:450], keys[450:]
    (ps, _), (js, _) = step_both(dict(kw, adaptive=True), pargs, head, 2)
    load = ps["wsl"].numpy().copy()
    assert load[2] + load[3] == 450
    spec = pks.StepSpec(**kw, adaptive=True)
    pks.rebalance(spec, pks.make_step_params(*pargs, device="cpu"), ps, 2)
    js = jks.rebalance(jks.StepSpec(**kw, adaptive=True),
                       jks.make_step_params(*pargs), js, 2)
    np.testing.assert_array_equal(ps["wuw"].numpy(), [0, 0, 1, 1])
    np.testing.assert_array_equal(ps["wuw"].numpy(),
                                  pad.window_set_ways(2, nws, load))
    (ps, aware), (js, jaware) = step_both(dict(kw, adaptive=True), pargs,
                                          tail, 2, state=numpy_state(js))
    np.testing.assert_array_equal(aware, jaware)
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js)
    (_, starved), _ = step_both(kw, pargs, keys, 2, 50)
    assert aware.sum() > 0.5 * len(tail)
    assert aware.sum() > starved[450:].sum() + 0.3 * len(tail)


def test_protected_budget_shrink_equals_reference():
    """A window grow shrinks main's runtime protected budget below the
    resident protected count; the drain, one demotion per main hit, must
    match the reference leaf for leaf."""
    kw = dict(width=1 << 16, rows=4, dk_bits=0, window_slots=20,
              main_slots=39, adaptive=True)
    pargs = (2, 38, 30, 320, 8, 0)
    fill = psyn.zipf_trace(900, n_items=60, alpha=0.9, seed=4)
    tail = psyn.zipf_trace(500, n_items=80, alpha=0.8, seed=9)
    (ps, _), (js, _) = step_both(kw, pargs, fill, 2)
    pks.rebalance(pks.StepSpec(**kw), pks.make_step_params(
        *pargs, device="cpu"), ps, 18)
    js = jks.rebalance(jks.StepSpec(**kw), jks.make_step_params(*pargs), js,
                       18)
    assert int(ps["regs"][pks.R_PCOUNT]) > 17     # budget max(1, 22*30//38)
    (ps, ph), (js, jh) = step_both(kw, pargs, tail, 2,
                                   state={k: v.numpy() for k, v in
                                          ps.items()})
    np.testing.assert_array_equal(ph, jh)
    assert_state_equal({k: v.numpy() for k, v in ps.items()}, js)
    assert int(ps["regs"][pks.R_PCOUNT]) <= 17


if __name__ == "__main__":
    from repro_torch.check_runs import (GA_ACCESSES, GA_CAPACITY, GA_FRACS,
                                        GA_SEED, GA_TRACES, WA_FRACS, digest,
                                        trajectory_digest)

    def leaves(s):
        return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
                s.items()}

    f = jsyn.zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9, seed=11)
    for name, kw in (("FA", {}), ("FA4", dict(shards=4))):
        r, s, _ = jds.simulate_trace(f, 65_536, warmup=480_000, assoc=8,
                                     adaptive=True, climb=jds.ClimbSpec(),
                                     return_state=True, **kw)
        tj = r.extra["trajectory"]
        print(f"{name}: hits {r.hits} regs {np.asarray(s['regs']).tolist()} "
              f"digest {digest(leaves(s))} final quota "
              f"{r.extra['final_quota']} trajectory ({len(tj['quota'])}, "
              f"{trajectory_digest(tj)!r})")
    rows = jds.simulate_sweep(f, [65_536], window_fracs=WA_FRACS, assoc=8,
                              adaptive=True, warmup=480_000,
                              mode="sequential")
    print("WA:", {r.extra["window_frac"]: (r.hits, r.extra["final_quota"])
                  for r in rows})
    for gen in GA_TRACES:
        tr = getattr(jsyn, gen)(GA_ACCESSES, seed=GA_SEED)
        rows = jds.simulate_sweep(tr, [GA_CAPACITY], window_fracs=GA_FRACS,
                                  mode="sequential", assoc=8)
        r, s, _ = jds.simulate_trace(tr, GA_CAPACITY, adaptive=True, assoc=8,
                                     climb=jds.ClimbSpec(), return_state=True)
        print(f"GA {gen}: static {tuple(x.hits for x in rows)} adaptive "
              f"{r.hits} final quota {r.extra['final_quota']} digest "
              f"{digest(leaves(s))}")

"""The port's fault harness (``repro_torch.core.faults``) against the
reference's (``repro.core.faults``), on the CPU.

The mutators equal the reference's on the same numpy input, on tensors
too, and leave their input untouched.  Faulted runs (a cache-table flip; a
flip in a shard's global sketch slice caught by the checksums and
quarantined; a shard's global slice lost twice; stored main sets and ARC
ghost positions put out of range) equal the JAX engine's
run under the same hook bit for bit, on short traces.  And the SIGKILL drill:
a port script on the CPU is killed after two checkpoints, and the resume
equals the JAX engine's uninterrupted run.
"""
import os
import signal

import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro.core import faults as jfaults
from repro.kernels.sketch_step import StepSpec as JStepSpec
from repro.traces import zipf_trace
from repro_torch.check_runs import (_A8, _TINY4, _TINY16,
                                    corrupt_stored_probes, table_flips)
from repro_torch.checkpoint.store import latest_step
from repro_torch.core import device_simulate as pds
from repro_torch.core import faults
from repro_torch.kernels import sketch_step as ks
from repro_torch.kernels.sketch_step import StepSpec

from test_torch_checkpoint_resume import C, N, SF, WARMUP, trace

torch.set_num_threads(1)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def words(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def test_flip_words_matches_reference_and_copies():
    st = {"counters": words(0, 16), "regs": np.arange(8, dtype=np.int32)}
    flips = [(3, 7), (5, 31), (0, 0), (3, 31)]
    want = jfaults.flip_words(st, "counters", flips)
    keep = st["counters"].copy()
    got = faults.flip_words(st, "counters", flips)
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    tgot = faults.flip_words(tst, "counters", flips)
    assert isinstance(got["counters"], np.ndarray)
    assert np.array_equal(got["counters"], want["counters"])
    assert tgot["counters"].dtype == torch.int32
    assert np.array_equal(tgot["counters"].numpy(), want["counters"])
    assert np.array_equal(st["counters"], keep)              # untouched
    assert np.array_equal(tst["counters"].numpy(), keep)
    assert tgot["regs"] is tst["regs"] and got["regs"] is st["regs"]
    diff = keep.view(np.uint32) ^ tgot["counters"].numpy().view(np.uint32)
    assert diff[5] == np.uint32(1) << 31 and diff[3] == np.uint32(
        (1 << 7) | (1 << 31))


@pytest.mark.parametrize("half", ["delta", "global", "both"])
def test_drop_shard_delta_matches_reference(half):
    kw = dict(width=1 << 10, rows=4, dk_bits=1 << 8, window_slots=2,
              main_slots=16, shards=4)
    spec, jspec = StepSpec(**kw), JStepSpec(**kw)
    st = {"counters": words(1, 2 * spec.counter_words),
          "doorkeeper": words(2, 2 * spec.dk_words),
          "regs": np.arange(8, dtype=np.int32)}
    keep = {k: v.copy() for k, v in st.items()}
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    for shard in (0, 3):
        want = jfaults.drop_shard_delta(jspec, st, shard, half)
        got = faults.drop_shard_delta(spec, st, shard, half)
        tgot = faults.drop_shard_delta(spec, tst, shard, half)
        for k in ("counters", "doorkeeper"):
            assert np.array_equal(got[k], want[k]), k
            assert np.array_equal(tgot[k].numpy(), want[k]), k
            assert not np.array_equal(want[k], keep[k]), k
    for k in st:
        assert np.array_equal(st[k], keep[k])
        assert np.array_equal(tst[k].numpy(), keep[k])


def faulted(kw, make_hook, every=512, integrity=False, climb=None):
    """The JAX engine's and the port's runs of ``trace()`` under the same
    hook (``make_hook(faults_module, spec)``), with the cursors each
    hook saw (adaptive: ``climb``, a (JAX, port) pair of ClimbSpecs)."""
    tr = trace()
    kw = dict(kw, integrity=integrity) if integrity else kw
    jcfg = jds.DeviceWTinyLFU(C, sample_factor=SF, **kw)
    pcfg = pds.DeviceWTinyLFU(C, sample_factor=SF, **kw)
    seen = {"jax": [], "port": []}

    def hooked(name, fmod, spec):
        hook = make_hook(fmod, spec)

        def run(cursor, state):
            seen[name].append(cursor)
            return hook(cursor, state)
        return run

    jc, pc = climb or (None, None)
    want = jcfg.run(tr, warmup=WARMUP, checkpoint_every=every,
                    fault_hook=hooked("jax", jfaults, jcfg.spec()),
                    return_state=True, climb=jc)
    got = pcfg.run(tr, warmup=WARMUP, checkpoint_every=every,
                   fault_hook=hooked("port", faults, pcfg.spec()),
                   return_state=True, device="cpu", climb=pc)
    assert seen["jax"] == seen["port"] == list(range(every, N, every))
    (rj, sj, hj), (rp, sp, hp) = want, got
    assert np.array_equal(np.asarray(hj), hp.numpy())
    assert set(sj) == set(sp)
    for k in sj:
        assert np.array_equal(np.asarray(sj[k]), sp[k].numpy()), k
    assert rp.hits == rj.hits
    return rp, sp


def test_cache_table_flip_equals_jax():
    def make(fmod, spec):
        def hook(cursor, state):
            if cursor == 512:
                state = fmod.flip_words(state, "wtab", [(1, 4)])
                return fmod.flip_words(state, "mtab", [(7, 30), (9, 31)])
            return None
        return hook
    faulted(dict(assoc=8), make)


def test_checksum_quarantine_equals_jax():
    """A bit flipped in shard 1's global slice is caught at the next fold
    and the shard quarantined once, in both engines alike."""
    def make(fmod, spec):
        def hook(cursor, state):
            if cursor == 512:
                return fmod.flip_words(state, "counters",
                                       [(spec.wps_shard, 2)])
            return None
        return hook
    _, st = faulted(dict(shards=2, merge_every=128), make, every=256,
                    integrity=True)
    assert int(st["csum"][-1]) == 1


def test_shard_global_loss_equals_jax():
    def make(fmod, spec):
        def hook(cursor, state):
            if cursor in (512, 1024):
                return fmod.drop_shard_delta(spec, state, 0, half="global")
            return None
        return hook
    faulted(dict(shards=2, merge_every=128), make)


@pytest.mark.parametrize("kw", [dict(assoc=8), dict(),
                                dict(assoc=8, shards=2, merge_every=128),
                                dict(shards=2, merge_every=128)],
                         ids=["set", "flat", "set-sharded", "flat-sharded"])
def test_corrupted_stored_probes_equal_jax(kw):
    """Every stored probe of both tables gets bit 30 or 31 flipped, so
    victims' estimates read word indices far out of range; the port
    clamps them as the reference's gathers do (no crash, the same
    decisions)."""
    def make(fmod, spec):
        def hook(cursor, state):
            if cursor != 512:
                return None
            return corrupt_stored_probes(fmod, spec, state)
        return hook
    faulted(kw, make)


@pytest.mark.parametrize("kw,what", [
    (dict(assoc=8), ("wtab", 3, 30)),              # WT_MSET, too large
    (dict(assoc=8), ("wtab", 4, 31)),              # WT_MSET2, negative
    (dict(assoc=8, policy="arc"), ("mtab", None, 31)),  # a ghost position
    (dict(assoc=8), "sets"),
    (dict(assoc=8, shards=2, merge_every=128), "sets"),
    (dict(assoc=8, policy="s3fifo", window_frac=0.1), "sets"),
    (dict(assoc=8, policy="arc"), "ghost"),
    (dict(assoc=8, adaptive=True), "sets")],
    ids=["mset", "mset2", "arc-ghost", "sets", "sets-sharded",
         "sets-s3fifo", "ghost-arc", "sets-adaptive"])
def test_hook_out_of_range_table_index_equals_jax(kw, what):
    """Queue 3 fault 4: a hook that puts table words the step takes as
    addresses out of range (a window record's stored main sets, one of
    them or every record's by ``check_runs.table_flips``, or ARC's ghost
    positions) is taken, and the run degrades as the reference's does: it
    equals the JAX engine's under the same hook, every leaf and hit flag.
    The stored sets clamp and their blocks overwrite one another as the
    reference's dynamic slices do; the adaptive case's rebalances migrate
    window records by them (climb epoch 256)."""
    def make(fmod, spec):
        def hook(cursor, state):
            if cursor != 512:
                return None
            if isinstance(what, str):
                leaf, flips = table_flips(spec, what)
            else:
                leaf, col, bit = what
                ncols = spec.wcols if leaf == "wtab" else spec.mcols
                c = 3 + spec.rows if col is None else col
                flips = [(2 * ncols + c, bit)]
            return fmod.flip_words(state, leaf, flips)
        return hook
    climb = ((jds.ClimbSpec(epoch_len=256), pds.ClimbSpec(epoch_len=256))
             if kw.get("adaptive") else None)
    faulted(kw, make, climb=climb)


@pytest.mark.parametrize("kw,leaf,col,lim", [
    (dict(_A8, adaptive=True), "wtab", 3, "main_sets"),
    (dict(_TINY4, dk_bits=256, policy="arc"), "mtab", 7, "ghost"),
    (dict(_TINY16, policy="lfu"), None, None, None)],
    ids=["wtinylfu-adaptive", "arc", "lfu"])
def test_step_finds_out_of_range_addresses_itself(kw, leaf, col, lim):
    """``step`` takes the exact instances by itself, from
    ``sketch_step._needs_exact``: a state from ``init_step_state`` or from
    arrays in range is marked in range (its table is not read at a launch),
    a torch write into the table clears the mark, an address out of range
    is found at every launch until it has left, ``rebalance`` keeps the
    mark, and a state built from arrays out of range carries none.  LFU's
    tables hold no address."""
    spec = StepSpec(**kw)
    st = ks.init_step_state(spec, device="cpu")
    assert ks._in_range_marked(spec, st) and not ks._needs_exact(spec, st)
    if leaf is None:
        st["mtab"][0, 3] = -5
        assert ks._in_range_marked(spec, st)
        assert not ks._needs_exact(spec, st)
        return
    bad = spec.main_sets if lim == "main_sets" else 32 * spec.dk_words
    st[leaf][1, col] = bad
    assert not ks._in_range_marked(spec, st)
    assert ks._needs_exact(spec, st) and ks._needs_exact(spec, st)
    arrays = ks.state_to_numpy(st)
    st[leaf][1, col] = 0
    assert not ks._needs_exact(spec, st) and ks._in_range_marked(spec, st)
    if spec.adaptive:
        params = ks.make_step_params(20, 44, 35, 200, 7, 0, device="cpu")
        ks.rebalance(spec, params, st, 30)
        assert ks._in_range_marked(spec, st)
    st2 = ks.state_from_numpy(spec, arrays, "cpu")
    assert not ks._in_range_marked(spec, st2) and ks._needs_exact(spec, st2)
    arrays[leaf][1, col] = -1
    assert ks._needs_exact(spec, ks.state_from_numpy(spec, arrays, "cpu"))
    arrays[leaf][1, col] = 0
    assert ks._in_range_marked(spec, ks.state_from_numpy(spec, arrays,
                                                         "cpu"))
    with torch.inference_mode():        # keeps no version: read each time
        st3 = ks.init_step_state(spec, device="cpu")
        assert not ks._in_range_marked(spec, st3)
        assert not ks._needs_exact(spec, st3)


KILL_SCRIPT = r"""
import sys
sys.path.insert(0, %(src)r)
for m in ("jax", "jaxlib", "repro"):
    sys.modules[m] = None
from repro_torch.core.device_simulate import DeviceWTinyLFU
from repro_torch.traces.synthetic import zipf_trace

tr = zipf_trace(%(n)d, n_items=600, alpha=0.9, seed=12)
cfg = DeviceWTinyLFU(%(c)d, sample_factor=%(sf)d)
cfg.run(tr, warmup=%(warmup)d, checkpoint_dir=%(dir)r, checkpoint_every=400,
        device="cpu", on_checkpoint=lambda c: print("CKPT", c, flush=True))
print("DONE", flush=True)
"""


def test_sigkill_resume_equals_jax(tmp_path):
    """SIGKILL a port run on the CPU after two checkpoints; the resume
    from the latest durable one equals JAX's uninterrupted run (a kill
    during a save leaves a torn .tmp that latest_step ignores)."""
    d = str(tmp_path / "ck")
    n = 2_000
    seen, rc = faults.run_to_kill(
        KILL_SCRIPT % dict(src=SRC, n=n, c=C, sf=SF, warmup=WARMUP, dir=d),
        kills=2, timeout=300, env={"OMP_NUM_THREADS": "1"})
    assert seen == 2
    assert rc == -signal.SIGKILL
    step = latest_step(d)
    assert step in (400, 800)                 # died mid-run
    tr = zipf_trace(n, n_items=600, alpha=0.9, seed=12)
    rj, sj, hj = jds.simulate_trace(tr, C, sample_factor=SF, warmup=WARMUP,
                                    return_state=True)
    rp, sp, hp = pds.resume_trace(tr, pds.DeviceWTinyLFU(C, sample_factor=SF),
                                  checkpoint_dir=d, warmup=WARMUP,
                                  checkpoint_every=400, return_state=True,
                                  device="cpu")
    assert rp.extra["resumed_at"] == step
    assert np.array_equal(np.asarray(hj), hp.numpy())
    for k in sj:
        assert np.array_equal(np.asarray(sj[k]), sp[k].numpy()), k
    assert latest_step(d) == n


def fd_pins():
    """The JAX engine's hits and state digest for each of
    check_runs.FD_DRILLS under its hook, and the reference's own bounds."""
    from repro_torch.check_runs import (FD_DRILLS, FD_FLIP_BOUNDED,
                                        FD_FLIP_TOL, FD_GOLDEN, FD_TAIL,
                                        GP_TOL, digest, fd_hook)
    pins = {}
    for name, (tkw, cap, kw, warmup, every) in FD_DRILLS.items():
        tr = zipf_trace(**tkw)
        cfg = jds.DeviceWTinyLFU(cap, **kw)
        res, st, h = cfg.run(tr, warmup=warmup, checkpoint_every=every,
                             fault_hook=fd_hook(name, jfaults, cfg.spec()),
                             return_state=True)
        clean, _, h0 = jds.simulate_trace(tr, cap, warmup=warmup,
                                          return_state=True, **kw)
        pins[name] = (res.hits, digest({k: torch.from_numpy(np.array(v))
                                        for k, v in st.items()}))
        if name in ("quarantine", "loss"):
            assert abs(res.hit_ratio - FD_GOLDEN) < GP_TOL, res.hit_ratio
        elif name in FD_FLIP_BOUNDED:
            assert abs(res.hit_ratio - clean.hit_ratio) < FD_FLIP_TOL
        if name == "quarantine":
            assert int(np.asarray(st["csum"])[-1]) == 1
            tail = [float(np.asarray(x)[-FD_TAIL:].mean()) for x in (h, h0)]
            assert abs(tail[0] - tail[1]) < GP_TOL, tail
        print(f"# {name}: hit ratio {res.hit_ratio:.6f}, without the "
              f"fault {clean.hit_ratio:.6f}")
    return pins


if __name__ == "__main__":
    import time
    t0 = time.perf_counter()
    print("FD_PINS =", fd_pins())
    print(f"# {time.perf_counter() - t0:.1f} s")

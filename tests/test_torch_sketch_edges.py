"""The port's plain estimate, admit and reset at the sketch kernels' edge
geometries (``check_runs.SKETCH_EDGE_CFGS``: one-word rows and doorkeepers,
rows 1 to 8, doorkeeper probes 0 to 20) against the JAX package, bitwise;
the add past 8 doorkeeper probes against the reference's numpy hashing
twins; and the plain step at the geometries of the step kernel's wide
instances (more than 8 doorkeeper probes, 256 ways) and with table
addresses put out of range (``check_runs.STEP12_CASES``) against the JAX
step where it runs (up to 10 doorkeeper probes), and past that its probes
and sketch against the numpy twins.

Both sides get the same state and keys (numpy, from a seed).  JAX runs on
the CPU with its jnp oracles (``use_pallas=False``) and, for one small
case, its Pallas kernels in interpret mode.  The reference's jnp hashing
builds each probe salt as a ``jnp.uint32`` from a Python int, and for
doorkeeper probes 11, 12 and 15 and up that int is 2^32 or more, so
``jops.estimate`` and ``jops.admit`` raise ``OverflowError`` there; at
those counts the port is held to the reference's numpy twins of its
hashing (``repro.core.hashing.probe_indices32_np`` and
``dk_probe_index_np``, which take the salt modulo 2^32, bit for bit with
the device's uint32 arithmetic).
"""
import numpy as np
import pytest
import torch

from repro.core import hashing as jhash
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sketch_common as jsc
from repro_torch.check_runs import (SKETCH_EDGE_CFGS, STEP12_CASES,
                                    hazard_keys, mixed_keys, random_sketch,
                                    run_step_case, table_flips)
from repro_torch.kernels import sketch_common as psc
from repro_torch.kernels import sketch_step, sketch_update
from repro_torch.kernels.admission import admission_ref
from repro_torch.kernels.sketch_estimate import estimate_ref
from repro_torch.kernels.sketch_reset import reset_ref

_M32 = 1 << 32


def jax_takes(dk_probes: int) -> bool:
    """Whether the reference's jnp ``dk_probe_index`` builds every salt of
    probes 0..dk_probes-1 (each below 2^32)."""
    salts = jhash.PROBE_SALTS
    return all((salts[p % 8] ^ 0xDEADBEEF) + 0x9E3779B9 * (p // 8) < _M32
               for p in range(dk_probes))


def twin_estimate(kw: dict, arrays: dict, keys: np.ndarray) -> np.ndarray:
    """The estimate from the reference's numpy hashing twins: min over rows
    of the 4-bit counters (from 15), +1 iff every doorkeeper bit is set."""
    lo, hi = jhash.key_to_lanes(keys)
    idx = jhash.probe_indices32_np(lo, hi, kw["rows"], kw["width"])
    rows = np.arange(kw["rows"])
    words = arrays["counters"].view(np.uint32)[rows, idx >> 3]
    nib = (words >> ((idx & 7) * 4).astype(np.uint32)) & 0xF
    est = np.minimum(15, nib.min(axis=1)).astype(np.int32)
    if kw["dk_bits"]:
        dk = arrays["doorkeeper"].view(np.uint32).reshape(-1)
        ok = np.ones(len(keys), bool)
        for p in range(kw.get("dk_probes", 3)):
            bit = jhash.dk_probe_index_np(lo, hi, p, kw["dk_bits"])
            ok &= ((dk[bit >> 5] >> (bit & 31).astype(np.uint32)) & 1) == 1
        est = est + ok
    return est


def port_lanes(keys):
    return [torch.from_numpy(x.copy()) for x in psc.keys_to_lanes(keys)]


@pytest.mark.parametrize("case", range(len(SKETCH_EDGE_CFGS)),
                         ids=[f"rows{c['rows']}-w{c['width']}-dk{c['dk_bits']}"
                              f"x{c.get('dk_probes', 0)}"
                              for c in SKETCH_EDGE_CFGS])
def test_estimate_and_admit_match_jax_at_edges(case):
    """estimate_ref and admission_ref == JAX's (or, where JAX's salts
    overflow, the reference's numpy twins), on a random state."""
    kw = SKETCH_EDGE_CFGS[case]
    jcfg, pcfg = jsc.DeviceSketchConfig(**kw), psc.DeviceSketchConfig(**kw)
    arrays = random_sketch(pcfg, case)
    ps = psc.sketch_state_from_numpy(pcfg, arrays, device="cpu")
    keys = mixed_keys(case, 48)
    victims = np.roll(keys, 5)
    est = estimate_ref(pcfg, ps, *port_lanes(keys)).numpy()
    adm = admission_ref(pcfg, ps, *port_lanes(keys),
                        *port_lanes(victims)).numpy()
    twin = twin_estimate(kw, arrays, keys)
    assert np.array_equal(est, twin)
    assert np.array_equal(adm, twin > twin_estimate(kw, arrays, victims))
    assert 0 < int((est > est.min()).sum()) < len(keys)    # not constant
    js = {k: np.asarray(v) for k, v in arrays.items()}
    jl = [*jsc.keys_to_lanes(keys), *jsc.keys_to_lanes(victims)]
    if kw["dk_bits"] == 0 or jax_takes(kw["dk_probes"]):
        assert np.array_equal(
            est, np.asarray(jops.estimate(jcfg, js, *jl[:2], False)))
        assert np.array_equal(
            adm, np.asarray(jops.admit(jcfg, js, *jl, False)))
    else:
        with pytest.raises(OverflowError):
            jops.estimate(jcfg, js, *jl[:2], False)


def test_estimate_and_admit_match_pallas_interpret_past_8_probes():
    """The reference's Pallas estimate and admit kernels (interpret mode)
    at 9 doorkeeper probes on a one-word doorkeeper and two-word rows."""
    kw = dict(width=16, rows=3, cap=15, dk_bits=32, dk_probes=9)
    jcfg, pcfg = jsc.DeviceSketchConfig(**kw), psc.DeviceSketchConfig(**kw)
    arrays = random_sketch(pcfg, 99)
    ps = psc.sketch_state_from_numpy(pcfg, arrays, device="cpu")
    keys = mixed_keys(99, 40)
    victims = np.roll(keys, 3)
    js = {k: np.asarray(v) for k, v in arrays.items()}
    jl = [*jsc.keys_to_lanes(keys), *jsc.keys_to_lanes(victims)]
    assert np.array_equal(
        estimate_ref(pcfg, ps, *port_lanes(keys)).numpy(),
        np.asarray(jops.estimate(jcfg, js, *jl[:2], True)))
    assert np.array_equal(
        admission_ref(pcfg, ps, *port_lanes(keys),
                      *port_lanes(victims)).numpy(),
        np.asarray(jops.admit(jcfg, js, *jl, True)))


@pytest.mark.parametrize("kw", [
    dict(width=8, rows=3, dk_bits=32),       # 3 counter words, 1 doorkeeper
    dict(width=8, rows=1, dk_bits=0),        # 1 and 1
    dict(width=16, rows=5, dk_bits=64),      # 10 and 2
    dict(width=8, rows=7, dk_bits=128),      # 7 and 4
], ids=["3x1", "1x1", "10x2", "7x4"])
def test_reset_matches_jax_at_word_counts_off_16_bytes(kw):
    """reset_ref == the reference's reset_ref on random full-range words
    (sign bits included) at word counts that are not a multiple of 4."""
    jcfg, pcfg = jsc.DeviceSketchConfig(**kw), psc.DeviceSketchConfig(**kw)
    arrays = random_sketch(pcfg, kw["rows"])
    ps = reset_ref(pcfg, psc.sketch_state_from_numpy(pcfg, arrays,
                                                     device="cpu"))
    js = jref.reset_ref(jcfg, {k: np.asarray(v) for k, v in arrays.items()})
    for k in ("counters", "doorkeeper", "size"):
        assert np.array_equal(ps[k].numpy(), np.asarray(js[k])), k


def twin_add(kw: dict, arrays: dict, keys: np.ndarray) -> dict:
    """The sequential add from the reference's numpy hashing twins: per
    key in order, each doorkeeper probe tests its bit and sets it (a later
    probe sees an earlier one's bit), then, iff every bit was set, +1 on
    every row at the minimum nibble when that minimum is below ``cap``."""
    lo, hi = jhash.key_to_lanes(keys)
    idx = jhash.probe_indices32_np(lo, hi, kw["rows"], kw["width"])
    counters = arrays["counters"].view(np.uint32).copy()
    dk = arrays["doorkeeper"].view(np.uint32).reshape(-1).copy()
    bits = [jhash.dk_probe_index_np(lo, hi, p, kw["dk_bits"])
            for p in range(kw["dk_probes"])]
    for i in range(len(keys)):
        gate = True
        for b in bits:
            w, m = b[i] >> 5, np.uint32(1) << np.uint32(b[i] & 31)
            gate = gate and bool(dk[w] & m)
            dk[w] |= m
        if not gate:
            continue
        w, sh = idx[i] >> 3, ((idx[i] & 7) * 4).astype(np.uint32)
        rows = np.arange(kw["rows"])
        vals = (counters[rows, w] >> sh) & 0xF
        if vals.min() < kw["cap"]:
            bump = rows[vals == vals.min()]
            counters[bump, w[bump]] += np.uint32(1) << sh[bump]
    return {"counters": counters.view(np.int32),
            "doorkeeper": dk.view(np.int32).reshape(1, -1)}


@pytest.mark.parametrize("dk_probes", [9, 13, 20])
def test_add_past_8_probes_matches_numpy_twins(dk_probes):
    """add_ref at 9, 13 and 20 doorkeeper probes (the add kernel's loop
    instance) == the sequential add built on the reference's numpy hashing
    twins (and JAX's add_ref at 9, where its salts fit), from a random sketch with a dense doorkeeper (some keys pass
    it, some set bits) on a doorkeeper of 32 and of 1,024 bits."""
    for dk_bits in (32, 1024):
        kw = dict(width=16, rows=3, cap=15, dk_bits=dk_bits,
                  dk_probes=dk_probes)
        pcfg = psc.DeviceSketchConfig(**kw)
        arrays = random_sketch(pcfg, dk_probes)
        keys = mixed_keys(dk_probes, 64)
        ps = psc.sketch_state_from_numpy(pcfg, arrays, device="cpu")
        sketch_update.add_ref(pcfg, ps, *port_lanes(keys))
        twin = twin_add(kw, arrays, keys)
        for k in ("counters", "doorkeeper"):
            assert np.array_equal(ps[k].numpy(), twin[k]), k
        assert not np.array_equal(twin["counters"], arrays["counters"])
        assert int(ps["size"]) == 1001 + len(keys)
        if jax_takes(dk_probes):          # and JAX's add_ref where it runs
            js = jref.add_ref(jsc.DeviceSketchConfig(**kw),
                              {k: np.asarray(v) for k, v in arrays.items()},
                              *jsc.keys_to_lanes(keys))
            for k in ("counters", "doorkeeper"):
                assert np.array_equal(ps[k].numpy(), np.asarray(js[k])), k


def jax_step_case(case):
    """``check_runs.run_step_case`` on the JAX package: the same chunks
    through its ``step_ref``, its ``merge_halve`` after each chunk
    (sharded), its ``rebalance`` to the case's quotas (adaptive) and its
    ``flip_words`` after the first chunk."""
    import jax.numpy as jnp
    from repro.core import faults as jfaults
    from repro.kernels import sketch_step as js
    from repro.kernels.sketch_merge import merge_halve as jmerge
    _, kw, pargs, wcap, mcap, kind, n, chunk, opt = case
    spec = js.StepSpec(**kw)
    params = js.make_step_params(*pargs, counter_bits=spec.counter_bits)
    state = js.init_step_state(spec, wcap, mcap)
    lo, hi = psc.keys_to_lanes(hazard_keys(kind, n, seed=3))
    quotas = list(opt.get("quotas", ()))
    hits = []
    for c in range(0, n, chunk):
        if c == chunk and opt.get("flip"):
            leaf, flips = table_flips(spec, opt["flip"])
            state = jfaults.flip_words(state, leaf, flips)
        state, h = js.step_ref(spec, params, state,
                               jnp.asarray(lo[c:c + chunk]),
                               jnp.asarray(hi[c:c + chunk]))
        hits.append(np.asarray(h))
        if spec.shards > 1:
            state = jmerge(spec, params, state)
        if spec.adaptive and quotas:
            state = js.rebalance(spec, params, state,
                                 quotas[(c // chunk) % len(quotas)])
    return {k: np.asarray(v) for k, v in state.items()}, np.concatenate(hits)


def _jax_runs(case) -> bool:
    kw = case[1]
    return not kw.get("mesh_devices") and jax_takes(kw.get("dk_probes", 3))


@pytest.mark.parametrize(
    "case", [c for c in STEP12_CASES if _jax_runs(c)],
    ids=[c[0] for c in STEP12_CASES if _jax_runs(c)])
def test_step_at_wide_geometries_and_faulted_tables_matches_jax(case):
    """The plain step at 256 ways (W-TinyLFU static, adaptive and sharded,
    S3-FIFO), at the largest doorkeeper-probe counts JAX's step runs, and
    with every window record's stored main sets put out of range (flat,
    sharded, adaptive through its rebalances, S3-FIFO) or ARC's ghost
    positions: every state leaf and hit flag equal to the JAX step's."""
    got = run_step_case(case, sketch_step.step_ref, "cpu")
    want = jax_step_case(case)
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        assert np.array_equal(got[0][k], want[0][k]), k
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("dkp", [9, 10])
@pytest.mark.parametrize("assoc", [None, 8], ids=["flat", "ways 8"])
def test_step_past_8_probes_matches_jax(dkp, assoc):
    """The largest doorkeeper-probe counts the JAX step runs (its salts
    overflow at 11): the plain step equals it, every leaf and hit flag."""
    kw = dict(width=256, rows=4, dk_bits=1024, dk_probes=dkp,
              window_slots=8, main_slots=16 if assoc else 60)
    if assoc:
        kw["assoc"] = assoc
    case = ("", kw, (4, 12 if assoc else 56, 9 if assoc else 44, 300, 7, 0),
            4, 12 if assoc else 56, "skewed", 500, 250, {})
    assert jax_takes(dkp)
    got = run_step_case(case, sketch_step.step_ref, "cpu")
    want = jax_step_case(case)
    for k in want[0]:
        assert np.array_equal(got[0][k], want[0][k]), k
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("dkp", [13, 20])
def test_step_past_10_probes_matches_numpy_twins(dkp):
    """Past what the JAX step runs: the step's hashed probes equal the
    reference's numpy twins (``probe_indices32_np``, ``dk_probe_index_np``),
    and with no reset (W = 0) its sketch after a run of the keys equals the
    sequential add built on those twins, from a random sketch with a dense
    doorkeeper (the step's add is the batched add's per-key update; its
    estimates read the stored probes as at the counts JAX checks)."""
    kw = dict(width=16, rows=3, cap=15, dk_bits=1024, dk_probes=dkp)
    spec = sketch_step.StepSpec(width=16, rows=3, dk_bits=1024,
                                dk_probes=dkp, window_slots=4,
                                main_slots=16, assoc=4)
    keys = mixed_keys(dkp, 64)
    lo, hi = port_lanes(keys)
    idx, dkb, _, _ = sketch_step.precompute_probes(spec, lo, hi)
    jlo, jhi = jhash.key_to_lanes(keys)
    assert np.array_equal(idx.numpy(),
                          jhash.probe_indices32_np(jlo, jhi, 3, 16))
    for p in range(dkp):
        assert np.array_equal(dkb[:, p].numpy(),
                              jhash.dk_probe_index_np(jlo, jhi, p, 1024))
    arrays = random_sketch(psc.DeviceSketchConfig(**kw), dkp)
    state = sketch_step.init_step_state(spec, 4, 16, device="cpu")
    state["counters"].copy_(torch.from_numpy(
        arrays["counters"].reshape(-1).copy()))
    state["doorkeeper"].copy_(torch.from_numpy(
        arrays["doorkeeper"].reshape(-1).copy()))
    params = sketch_step.make_step_params(4, 16, 12, 0, 15, device="cpu")
    _, hits = sketch_step.step_ref(spec, params, state, lo, hi)
    twin = twin_add(kw, arrays, keys)
    assert np.array_equal(state["counters"].numpy(),
                          twin["counters"].reshape(-1))
    assert np.array_equal(state["doorkeeper"].numpy(),
                          twin["doorkeeper"].reshape(-1))
    assert int(state["regs"][sketch_step.R_T]) == len(keys)

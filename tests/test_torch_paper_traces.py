"""The paper's trace families in the port, and the port's host engine against
the JAX device engine, on the CPU.

The four generators (``youtube_dynamic_trace``, ``wiki_drift_trace``,
``spc1_like_trace``, ``oltp_like_trace``) give the reference's keys byte for
byte: at the PF cells' full sizes against the sha256 of the reference's
traces pinned in ``check_runs.PF_TRACE_SHA256`` (the reference's oltp
generator takes ~40 s at that size), and live against the reference at
smaller sizes and other seeds.  With collision-free sketches on both sides
(~550 counters an item, no doorkeeper) the port's host engine reproduces
the JAX device engine's per-access hit flags (``step_ref`` and its ``jit``
scan, which the port's plain step equals bit for bit): W-TinyLFU on the
exact flat tables and at 8 ways, zero-way window sets, the policy panel's
twins and the adaptive climber with its trajectory (the sharded twins are
held to the reference's host twins in test_torch_host_engine.py)
(the reference's tests/test_sketch_step.py:183-310, test_policy_panel.py
§1 and test_adaptive.py §3), on a Zipf trace and on a prefix of PF-oltp.

Run as a script, it prints every PF pin of ``check_runs`` (the JAX engine
on the card's cells, the reference host engine, the cast, the traces, the
set-associative twins' flags), ~5 min on 8 cores:
``PYTHONPATH=src python tests/test_torch_paper_traces.py``.
"""
import functools
import hashlib

import numpy as np
import pytest

import repro.core as jc
from repro.core import device_simulate as jds
from repro.traces import synthetic as jsyn
from repro_torch import check_runs as cr
import repro_torch.core as pc
from repro_torch.traces import synthetic as psyn

FREE = dict(sample_factor=8, doorkeeper=False, counters_per_item=550.0)
ZIPF = psyn.zipf_trace(4_000, n_items=300, alpha=0.9, seed=5)


@functools.lru_cache(maxsize=None)
def full(cell: str) -> np.ndarray:
    return cr.pf_trace(cell)


@pytest.mark.parametrize("cell", list(cr.PF_CELLS))
def test_full_size_family_equals_reference_bytes(cell):
    gen, kw, *_ = cr.PF_CELLS[cell]
    tr = full(cell)
    assert tr.dtype == np.int64
    assert len(tr) == kw["length"] // kw.get("weeks", 1) * kw.get("weeks", 1)
    assert cr.trace_sha256(tr) == cr.PF_TRACE_SHA256[cell]
    short = dict(kw, length=10_500)
    for seed in (kw["seed"], 7):
        got = getattr(psyn, gen)(**dict(short, seed=seed))
        want = getattr(jsyn, gen)(**dict(short, seed=seed))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("gen,kw", [
    ("youtube_dynamic_trace", dict(length=20_000, weeks=5,
                                   items_per_week=300, churn=0.7)),
    ("wiki_drift_trace", dict(length=30_000, n_items=5_000, drift_every=999,
                              drift_frac=0.0001)),
    ("spc1_like_trace", dict(length=20_000, n_random=3_000, scan_frac=0.9,
                             mean_scan=30, scan_space=5_000)),
    ("oltp_like_trace", dict(length=20_000, n_pages=500, log_frac=0.2,
                             burst=7)),
])
def test_generators_equal_reference_off_the_defaults(gen, kw):
    for seed in (0, 123):
        got = getattr(psyn, gen)(**kw, seed=seed)
        want = getattr(jsyn, gen)(**kw, seed=seed)
        assert got.tobytes() == want.tobytes() and got.dtype == want.dtype


def host_flags(policy, trace) -> np.ndarray:
    return np.fromiter((policy.access(k) for k in trace.tolist()), np.int32,
                       len(trace))


def jax_flags(trace, capacity, **kw) -> tuple:
    r, _, hits = jds.simulate_trace(trace, capacity, return_state=True,
                                    **kw)
    return r, np.asarray(hits)


TRACES = {"zipf": lambda: ZIPF, "oltp": lambda: full("PF-oltp")[:4_000]}


@pytest.mark.parametrize("tname,kw", [
    ("zipf", {}), ("oltp", {}), ("zipf", dict(assoc=8)),
    ("oltp", dict(assoc=8))],
    ids=["flat-zipf", "flat-oltp", "assoc8-zipf", "assoc8-oltp"])
def test_host_engine_equals_jax_device_engine(tname, kw):
    tr = TRACES[tname]()
    _, want = jax_flags(tr, 60, window_frac=0.01, **FREE, **kw)
    got = host_flags(pc.WTinyLFU(60, window_frac=0.01, **FREE, **kw), tr)
    np.testing.assert_array_equal(got, want)


def test_zero_way_window_sets_bypass_like_jax_step_ref():
    """A window set count above the window's capacity leaves sets with no
    way: their keys go straight to admission on both engines."""
    from repro.kernels import sketch_step as jks
    import jax.numpy as jnp
    C = 69
    window_cap = max(1, int(round(C * 0.0725)))
    main_cap = C - window_cap
    host = pc.WTinyLFU(C, window_frac=0.0725, assoc=1, **FREE)
    assert 0 in host._wusable
    spec = jks.StepSpec(width=1 << 16, rows=4, dk_bits=0,
                        window_slots=host._n_wsets, main_slots=main_cap,
                        assoc=host.main.ways)
    params = jks.make_step_params(window_cap, main_cap, int(main_cap * 0.8),
                                  8 * C, 8, 0)
    tr = psyn.zipf_trace(4000, n_items=250, alpha=0.9, seed=5)
    lo, hi = jds._trace_lanes(tr)
    _, want = jds._jit_step(spec, params,
                            jks.init_step_state(spec, window_cap, main_cap),
                            jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(host_flags(host, tr), np.asarray(want))


@pytest.mark.parametrize("policy", ["s3fifo", "lfu", "arc", "arc-tiny"])
def test_panel_twins_equal_jax_device_engine(policy):
    C, tr = 60, psyn.zipf_trace(4_000, n_items=600, alpha=0.9, seed=11)
    if policy == "s3fifo":
        _, want = jax_flags(tr, C, assoc=8, policy="s3fifo", window_frac=0.1,
                            **FREE)
        twin = pc.SetAssocS3FIFO(C, window_frac=0.1, assoc=8, **FREE)
    elif policy == "lfu":
        _, want = jax_flags(tr, C, assoc=8, policy="lfu", **FREE)
        twin = pc.SetAssocLFU(C, assoc=8, **FREE)
    else:
        extra = ({"dk_bits_per_item": 256 / (8 * C)} if policy == "arc-tiny"
                 else {})
        cfg = jds.DeviceWTinyLFU(C, assoc=8, policy="arc", **extra)
        _, want = jax_flags(tr, C, assoc=8, policy="arc", **extra)
        twin = pc.SetAssocARC(C, assoc=8, dk_bits=cfg.dk_bits, dk_probes=3)
    np.testing.assert_array_equal(host_flags(twin, tr), want)


def test_adaptive_twin_equals_jax_climber():
    tr = psyn.phase_shift_trace(5000, n_hot=300, working_set=80,
                                advance=0.05, seed=2)
    kw = dict(window_frac=0.05, sample_factor=8)
    r, want = jax_flags(tr, 60, adaptive=True, doorkeeper=False,
                        counters_per_item=550.0,
                        climb=jds.ClimbSpec(epoch_len=500), **kw)
    host = pc.AdaptiveWTinyLFU(60, doorkeeper=False, counters_per_item=550.0,
                               epoch_len=500, **kw)
    np.testing.assert_array_equal(host_flags(host, tr), want)
    assert r.extra["trajectory"]["quota"] == host.quota_trajectory
    assert r.extra["final_quota"] == host.quota
    assert len(set(host.quota_trajectory)) > 1          # the climb moved


def twin_flag_pins() -> dict:
    """The reference's per-access flags of test_torch_host_engine.py's
    set-associative twins on each family's first 20,000 accesses."""
    import test_torch_host_engine as he
    out = {}
    for cell in cr.PF_CELLS:
        tr = he.family(cell)
        for name, make in he.TWINS.items():
            f = he.flags(make(jc), tr)
            out[(cell, name)] = hashlib.sha256(f.tobytes()).hexdigest()[:16]
    return out


def pf_device_pin(cell, assoc):
    import torch
    from repro_torch.check_runs import digest
    _, _, cap, sf, _ = cr.PF_CELLS[cell]
    tr = cr.pf_trace(cell)          # == the reference's (PF_TRACE_SHA256)
    r, s, _ = jds.simulate_trace(tr, cap, sample_factor=sf,
                                 warmup=cr.pf_warmup(cell, tr),
                                 assoc=assoc,
                                 return_state=True)
    leaves = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in
              s.items()}
    return r.hits, np.asarray(s["regs"]).tolist(), digest(leaves)


def pf_host_pin(cell, policy):
    return cr.pf_host_run(cell, policy, core=jc)[0]


def pf_trace_pin(cell):
    gen, kw, *_ = cr.PF_CELLS[cell]
    return cr.trace_sha256(getattr(jsyn, gen)(**kw))


if __name__ == "__main__":
    import multiprocessing
    import sys
    from concurrent.futures import ProcessPoolExecutor
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(8, mp_context=ctx) as ex:
        dev = {(c, a): ex.submit(pf_device_pin, c, a)
               for c in cr.PF_CELLS for a in (None, cr.PF_ASSOC)}
        host = {(c, a): ex.submit(pf_host_pin, c, a)
                for c in cr.PF_CELLS for a in (None, cr.PF_ASSOC)}
        cast = {n: ex.submit(pf_host_pin, cr.PF_CAST_CELL, n)
                for n in cr.PF_CAST}
        shas = {c: ex.submit(pf_trace_pin, c) for c in cr.PF_CELLS}
        twins = ex.submit(twin_flag_pins)
        print("PF_TRACE_SHA256 =", {c: f.result() for c, f in shas.items()})
        print("PF_HOST_PINS =", {k: f.result() for k, f in host.items()})
        print("PF_CAST_PINS =", {k: f.result() for k, f in cast.items()})
        print("PF_TWIN_FLAGS_SHA256 =", twins.result())
        print("PF_PINS =", {k: f.result() for k, f in dev.items()})

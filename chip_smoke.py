#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the TinyLFU engine on one GPU: the device
trace engine and the serving-admission path.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. print the card's name and power limit, build the five kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all at once) and
   print their ptxas register/spill lines;
2. hold the kernel (``step``) against its plain PyTorch version
   (``step_ref``) on the card: flat and set-associative tables, 4- and 8-bit
   counters, doorkeeper on and off, resets inside and across chunk
   boundaries, padded tails, and the main run's own geometry; every state
   leaf and hit flag must be equal;
3. run the golden traces G1-G6 through ``simulate_trace`` on the card; hit
   counts (and, for G1/G2/G4, the final registers and a digest of the whole
   state) must equal the values the JAX engine gives on the same traces;
4. run F, the main path at its real size (C=65,536, assoc=8, a 1.2M-access
   Zipf trace), through ``simulate_trace`` with the launch counts set to 0
   just before and read just after; hits, registers and state digest must
   equal the JAX engine's, and the call is timed on the host's clock;
5. run F again through the engine's chunk runner with CUDA events around
   each launch: the kernel's time per launch, and the share of the runner's
   stream time in which no kernel ran; the result must equal the main run's;
6. print the kernel's bound for F's chunks, counted from the words F's keys
   address;
7. hold the four batched sketch kernels (add, estimate, admit, reset)
   against their plain versions on the card: the tests/test_kernels.py
   configurations x batches 1, 7, 128, 300 and 1024, no doorkeeper, cap
   saturation, the automatic reset at W=256, a standalone reset of
   full-range words, and S's geometry; every leaf and output must be equal;
8. run S, the batched sketch ops at F's capacity, through ``DeviceTinyLFU``
   (counts set to 0 just before, read just after): record F's trace in
   4,096-key batches, then estimate and admit 50,000 keys; the state
   digest, the resets, the estimates' digest and the admitted count must
   equal the JAX package's; then time each kernel with CUDA events;
9. run P1 (benchmarks/bench_serving.py's grid) and P2 (its generator at
   C=65,536) through ``PrefixCache``, counts set to 0 around each run; every
   ``PrefixCacheStats`` field must equal the JAX cache's;
10. print the sketch kernels' bounds, then the ``kernels`` JSON line, the
   card line and the result line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.check_runs import (P1_CAPS, P1_TRACE, P2_CAP,  # noqa: E402
                                    P2_TRACE, P_PINS, S_BATCH, S_BLOCKS,
                                    S_DECISIONS, S_PINS, SKETCH_CFGS, digest,
                                    mixed_keys, replay)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate (data sheet)

# Exact results of the JAX engine (repro.core.device_simulate.simulate_trace,
# backend="jit", bit-identical to its Pallas kernel) on the same traces.
# (name, trace, capacity, assoc, warmup, hits, regs or None, digest or None)
GOLDEN = [
    ("G1", "zipf", 200, None, 10_000, 17488,
     [800, 158, 60000, 17488, 0, 0, 0, 0], "c9eae45be185632d"),
    ("G2", "scanhot", 400, None, 5_000, 26606,
     [2400, 316, 60000, 26606, 0, 0, 0, 0], "7f80aab0884ce4a6"),
    ("G3", "zipf", 1000, 4, 10_000, 23686, None, None),
    ("G4", "zipf", 1000, 8, 10_000, 23876,
     [4000, 0, 60000, 23876, 0, 0, 0, 0], "986da475ed57362b"),
    ("G5", "zipf", 1000, 16, 10_000, 23970, None, None),
    ("G6a", "scanhot", 400, 4, 5_000, 26253, None, None),
    ("G6b", "scanhot", 400, 8, 5_000, 26402, None, None),
    ("G6c", "scanhot", 400, 16, 5_000, 26488, None, None),
]
F_CAPACITY, F_ASSOC, F_WARMUP, F_CHUNK = 65536, 8, 480_000, 512
F_HITS = 455639
F_REGS = [413568, 0, 1200000, 455639, 0, 0, 0, 0]
F_DIGEST = "822de2a898615740"
# Runs S and P, the serving-admission path, and their JAX pins are defined
# in repro_torch.check_runs, which the CPU tests share.


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def compare_case(name, cfg, trace, chunk, timed=False):
    """Kernel vs plain on the card from the same initial state, both driven
    by the engine's chunk runner; returns (max abs difference, plain ms per
    chunk)."""
    import torch
    from repro_torch.core.device_simulate import _trace_lanes, run_chunks
    from repro_torch.kernels import sketch_step as ks
    spec = cfg.spec()
    params = cfg.params(device="cuda")
    lo, hi = _trace_lanes(trace, "cuda")
    outs, ms = [], []
    for fn in (ks.step, ks.step_ref):
        state = ks.init_step_state(spec, cfg.window_cap, cfg.main_cap,
                                   device="cuda")
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        state, hits = run_chunks(spec, params, state, lo, hi, chunk, fn=fn)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1) / math.ceil(len(trace) / chunk))
        outs.append((state, hits))
    (ks_state, k_hits), (p_state, p_hits) = outs
    err = int((k_hits - p_hits).abs().max())
    for k in p_state:
        d = int((ks_state[k].long() - p_state[k].long()).abs().max())
        err = max(err, d)
        check(d == 0, f"{name}: kernel and plain differ in state[{k!r}]")
    check(err == 0, f"{name}: kernel and plain differ in the hit flags")
    check(int(p_state["regs"][ks.R_T]) == len(trace),
          f"{name}: the plain run did not advance over the trace")
    timing = f"; plain {ms[1]:.1f} ms/chunk" if timed else ""
    print(f"phase 2  {name}: kernel == plain over {len(trace)} accesses "
          f"(chunk {chunk}, W={cfg.sample_size}){timing}")
    return err, ms[1]


def timed_launches(trace, cfg, chunk, warmup):
    """F through the engine's chunk runner with CUDA events around each
    launch; returns (state, hit flags, per-launch kernel ms, the runner's
    stream ms from its first launch to its last)."""
    import torch
    from repro_torch.core.device_simulate import _trace_lanes, run_chunks
    from repro_torch.kernels import sketch_step as ks
    spec = cfg.spec()
    params = cfg.params(warmup=warmup, device="cuda")
    state = ks.init_step_state(spec, cfg.window_cap, cfg.main_cap,
                               device="cuda")
    lo, hi = _trace_lanes(trace, "cuda")
    events = []

    def step(*args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = ks.step(*args)
        e1.record()
        events.append((e0, e1))
        return out

    state, hits = run_chunks(spec, params, state, lo, hi, chunk, fn=step)
    torch.cuda.synchronize()
    launch_ms = [a.elapsed_time(b) for a, b in events]
    return state, hits, launch_ms, events[0][0].elapsed_time(events[-1][1])


def bound_bytes(spec, trace, chunk, sample):
    """Bytes the step kernel must move over the whole trace, chunk by
    chunk: each access's key lanes and probes read and its hit flag written
    once; per chunk the params read and the registers read and written once,
    and every distinct state word its keys address (their window set and two
    main sets, their counter and doorkeeper words) read and written once;
    and the whole sketch read and written once at each section 3.3 reset.
    The candidates' sets and the victims' estimate words depend on the
    run's decisions and are left out, so this is a lower bound.  Returns
    (bytes, number of resets)."""
    import torch
    from repro_torch.core.device_simulate import _trace_lanes
    from repro_torch.kernels import sketch_step as ks
    lo, hi = _trace_lanes(trace, "cuda")
    kidx, kdkb, kwset, kmset = ks.precompute_probes(spec, lo, hi)
    n = lo.shape[0]
    c = torch.arange(n, device=lo.device) // chunk

    def distinct(ids, per_chunk):
        ids = ids.long().reshape(n, -1)
        return int(torch.unique(c[:, None] * per_chunk + ids).numel())

    word_shift = 3 if spec.counter_bits == 4 else 2
    rows = torch.arange(spec.rows, device=lo.device) * spec.words_per_row
    words = (distinct(kwset, spec.window_sets) * spec.assoc * spec.wcols
             + distinct(kmset, spec.main_sets) * spec.assoc * spec.mcols
             + distinct(rows + (kidx >> word_shift), spec.counter_words))
    if spec.dk_bits:
        words += distinct(kdkb >> 5, spec.dk_words)
    per_access = 4 * (2 + spec.rows + spec.dkp + 1 + 2) + 4
    nchunks = -(-n // chunk)
    size, resets = 0, 0
    for s in range(0, n, chunk):
        left = min(chunk, n - s)
        while size + left >= sample:       # the reset fires at size == W
            left -= sample - size
            size, resets = sample // 2, resets + 1
        size += left
    total = (2 * 4 * words + n * per_access
             + nchunks * 4 * (ks.NPARAMS + 2 * ks.NREGS)
             + resets * 2 * 4 * (spec.counter_words + spec.dk_words))
    return total, resets, size


SOURCES = ("sketch_step", "sketch_update", "sketch_estimate", "admission",
           "sketch_reset")
SKETCH_KERNELS = ("sketch_update", "sketch_estimate", "admission",
                  "sketch_reset")
L2_ROUND_TRIP_NS = 146.4        # phase_timing, H100 80GB HBM3 at 700 W
REPLACES = {"sketch_update": "src/repro/kernels/sketch_update.py:80",
            "sketch_estimate": "src/repro/kernels/sketch_estimate.py:71",
            "admission": "src/repro/kernels/admission.py:34",
            "sketch_reset": "src/repro/kernels/sketch_reset.py:33"}
# 32-bit integer operations per hashed probe: 20 for the salted hash (two
# mix32 finalizers of 8 each, the salt add and three xors), 5 to mask, index
# and test.  They are counted against the H100 SXM's 67 T/s 32-bit rate
# outside the tensor cores (data sheet, float32), as no integer rate is
# published beside it.
HASH_OPS_PER_PROBE = 25
F32_OPS_PER_S = 67e12


def sketch_fns():
    """name -> (kernel wrapper, plain version) of the four sketch kernels."""
    from repro_torch.kernels import (admission, sketch_estimate,
                                     sketch_reset, sketch_update)
    return {"sketch_update": (sketch_update.add, sketch_update.add_ref),
            "sketch_estimate": (sketch_estimate.estimate,
                                sketch_estimate.estimate_ref),
            "admission": (admission.admit, admission.admission_ref),
            "sketch_reset": (sketch_reset.reset, sketch_reset.reset_ref)}


def set_launches(n: int = 0):
    """Set every kernel wrapper's launch count to ``n``."""
    from repro_torch.kernels import sketch_step as ks
    ks.step.launches = n
    for kernel, _ in sketch_fns().values():
        kernel.launches = n


def read_launches() -> dict:
    from repro_torch.kernels import sketch_step as ks
    out = {name: kernel.launches for name, (kernel, _) in sketch_fns().items()}
    out["sketch_step"] = ks.step.launches
    return out


def lanes_on_card(keys):
    import torch
    from repro_torch.kernels.sketch_common import keys_to_lanes
    lo, hi = keys_to_lanes(np.asarray(keys, np.uint64))
    return torch.from_numpy(lo).cuda(), torch.from_numpy(hi).cuda()


def timed_ms(fn, reps: int = 1) -> float:
    """Mean ms of ``fn()`` on the card: CUDA events around ``reps`` calls,
    after one untimed call."""
    import torch
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def compare_sketch(name, cfg, batches, queries, errs, *, auto_reset=False,
                   plain_ms=None):
    """Kernel vs plain on the card, from two zeroed states: the batches
    added (with ``ops.add``'s automatic reset when ``auto_reset``), then
    estimates and verdicts of ``queries`` against their roll by one, then a
    standalone reset.  Every leaf and output must be equal; ``errs`` keeps
    the largest difference per kernel.  With ``plain_ms`` (a dict), the
    plain version of each kernel is timed on the last batch / the queries."""
    import torch
    from repro_torch.kernels import sketch_common as sc
    fns = sketch_fns()
    add, add_ref = fns["sketch_update"]
    reset, reset_ref = fns["sketch_reset"]
    k_state = sc.init_state(cfg, device="cuda")
    p_state = sc.init_state(cfg, device="cuda")
    resets = 0

    def leaf_err(a, b):
        return max(int((a[k].long() - b[k].long()).abs().max()) for k in a)

    for keys in batches:
        lo, hi = lanes_on_card(keys)
        add(cfg, k_state, lo, hi)
        add_ref(cfg, p_state, lo, hi)
        if auto_reset and int(k_state["size"]) >= cfg.sample_size:
            reset(cfg, k_state)
            reset_ref(cfg, p_state)
            resets += 1
        errs["sketch_update"] = max(errs["sketch_update"],
                                    leaf_err(k_state, p_state))
    if plain_ms is not None:                # zeroed states made untimed
        fresh = [sc.init_state(cfg, device="cuda") for _ in range(2)]
        plain_ms["sketch_update"] = timed_ms(
            lambda: add_ref(cfg, fresh.pop(), lo, hi))
    qlo, qhi = lanes_on_card(queries)
    vlo, vhi = lanes_on_card(np.roll(queries, 1))
    for kname, args in (("sketch_estimate", (qlo, qhi)),
                        ("admission", (qlo, qhi, vlo, vhi))):
        kernel, plain = fns[kname]
        got = kernel(cfg, k_state, *args).long()
        want = plain(cfg, p_state, *args).long()
        errs[kname] = max(errs[kname], int((got - want).abs().max()))
        if plain_ms is not None:
            plain_ms[kname] = timed_ms(lambda: plain(cfg, p_state, *args), 5)
    if plain_ms is not None:                # copies of the state made untimed
        copies = [{k: v.clone() for k, v in p_state.items()}
                  for _ in range(6)]
        plain_ms["sketch_reset"] = timed_ms(
            lambda: reset_ref(cfg, copies.pop()), 5)
    reset(cfg, k_state)
    reset_ref(cfg, p_state)
    errs["sketch_reset"] = max(errs["sketch_reset"],
                               leaf_err(k_state, p_state))
    for kname in SKETCH_KERNELS:
        check(errs[kname] == 0, f"{name}: {kname} kernel and plain differ")
    check(int(k_state["size"]) == int(p_state["size"]),
          f"{name}: sizes differ")
    n = sum(len(b) for b in batches)
    print(f"phase 7  {name}: kernel == plain for add ({n} keys"
          f"{f', {resets} resets' if auto_reset else ''}), estimate, admit "
          f"({len(queries)} keys) and reset")
    return k_state


def sketch_phase7(f_trace):
    """Phase 7: the four sketch kernels against their plain versions on the
    card.  Returns (max abs error per kernel, plain ms per kernel at S's
    shapes)."""
    import torch
    from repro_torch.kernels import sketch_common as sc
    from repro_torch.kernels.ops import make_config
    errs = {k: 0 for k in SKETCH_KERNELS}
    for ci, kw in enumerate(SKETCH_CFGS):
        cfg = sc.DeviceSketchConfig(**kw)
        for batch in (1, 7, 128, 300, 1024):
            keys = mixed_keys(ci * 10_000 + batch, batch)
            compare_sketch(f"cfg{ci} batch {batch}", cfg, [keys],
                           np.concatenate([keys[:64], mixed_keys(batch, 64)]),
                           errs)
    for dk in (1024, 0):
        compare_sketch(f"cap saturation dk_bits={dk}",
                       sc.DeviceSketchConfig(width=256, cap=7, dk_bits=dk),
                       [np.full(50, 123456, np.uint64)],
                       np.array([123456, 7], np.uint64), errs)
    w256 = sc.DeviceSketchConfig(width=256, cap=15, dk_bits=1024,
                                 sample_size=256)
    st = compare_sketch("auto-reset W=256", w256,
                        [np.tile(np.arange(100, dtype=np.uint64), 3)],
                        np.arange(128, dtype=np.uint64), errs,
                        auto_reset=True)
    check(int(st["size"]) == 75, "auto-reset: size 300 -> 150 -> reset 75")
    # standalone reset on words with every bit pattern, sign bit included
    cfg = sc.DeviceSketchConfig(width=4096, dk_bits=4096)
    rng = np.random.default_rng(5)
    arrays = {"counters": rng.integers(-2**31, 2**31, (4, 512),
                                       dtype=np.int64).astype(np.int32),
              "doorkeeper": rng.integers(-2**31, 2**31, (1, 128),
                                         dtype=np.int64).astype(np.int32),
              "size": np.array(1001, np.int32)}
    k = sc.sketch_state_from_numpy(cfg, arrays, device="cuda")
    p = sc.sketch_state_from_numpy(cfg, arrays, device="cuda")
    reset, reset_ref = sketch_fns()["sketch_reset"]
    reset(cfg, k)
    reset_ref(cfg, p)
    err = max(int((k[n].long() - p[n].long()).abs().max()) for n in k)
    errs["sketch_reset"] = max(errs["sketch_reset"], err)
    check(err == 0 and int(k["size"]) == 500,
          "standalone reset: kernel and plain differ")
    print("phase 7  standalone reset of random full-range words: kernel == "
          "plain, size 1001 -> 500")
    plain_ms = {}
    s_cfg = make_config(S_BLOCKS)
    compare_sketch("S geometry", s_cfg,
                   [f_trace[:S_BATCH], f_trace[S_BATCH:2 * S_BATCH]],
                   f_trace[:S_DECISIONS], errs, auto_reset=True,
                   plain_ms=plain_ms)
    torch.cuda.synchronize()
    return errs, plain_ms


SPIN_CYCLES = 1_000_000_000      # ~0.5 s of spin at the H100's clock


def kernel_ms(calls):
    """Device ms of each call, for ``calls`` an iterable of (name, function
    that launches one kernel): CUDA events around each call, all queued
    behind a spin kernel, so the events time the kernels back to back and
    not the host's enqueue.  Checks that the host finished queueing before
    the spin ended.  Returns ([(name, ms)], [each call's result])."""
    import torch
    torch.cuda.synchronize()
    s0 = torch.cuda.Event(enable_timing=True)
    s1 = torch.cuda.Event(enable_timing=True)
    s0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    s1.record()
    t0 = time.perf_counter()
    events, outs = [], []
    for name, fn in calls:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs.append(fn())
        e1.record()
        events.append((name, e0, e1))
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = s0.elapsed_time(s1)
    check(enqueue_ms < spin_ms, f"kernel timing: the host took {enqueue_ms:.1f}"
          f" ms to queue the launches, longer than the {spin_ms:.1f} ms spin")
    return [(n, a.elapsed_time(b)) for n, a, b in events], outs


def sketch_bound_bytes(cfg, batches, queries):
    """Bytes each sketch kernel must move at S's shapes, from the words the
    keys address: per add launch, every distinct counter and doorkeeper
    word of its batch read and written once and its lanes read; per
    estimate, the distinct words of the queries read once, their lanes read
    and the int32 estimates written; per admit the same over candidates and
    victims, with one byte out per pair; per reset the whole sketch (counter
    words read and written, doorkeeper words written).  Returns the mean
    bytes per launch of each kernel."""
    import torch
    from repro_torch.kernels.sketch_common import key_probes

    def words(keys):
        lo, hi = lanes_on_card(keys)
        idx, dkb = key_probes(lo, hi, cfg.rows, cfg.width, cfg.dk_bits,
                              cfg.dk_probes)
        rows = torch.arange(cfg.rows, device=idx.device) * cfg.words_per_row
        cw = torch.unique(rows + (idx >> 3)).numel()
        return cw + torch.unique(dkb >> 5).numel()

    add = sum(2 * 4 * words(b) + 8 * len(b) for b in batches) / len(batches)
    est = 4 * words(queries) + 8 * len(queries) + 4 * len(queries)
    both = np.concatenate([queries, np.roll(queries, 1)])
    adm = 4 * words(both) + 16 * len(queries) + len(queries)
    reset = 4 * (2 * cfg.rows * cfg.words_per_row + cfg.dk_words)
    return {"sketch_update": add, "sketch_estimate": est, "admission": adm,
            "sketch_reset": reset}


def sketch_phase8(f_trace, card):
    """Phase 8: run S through DeviceTinyLFU (the launch counts set to 0
    just before and read just after), check its pins, then time every
    kernel with CUDA events around each launch.  Returns (launches, ms per
    launch, the batches)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import sketch_common as sc
    batches = [f_trace[s:s + S_BATCH] for s in range(0, len(f_trace),
                                                     S_BATCH)]
    cands = f_trace[:S_DECISIONS]
    victims = np.roll(cands, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = ops.DeviceTinyLFU(S_BLOCKS)
    set_launches(0)
    t0 = time.perf_counter()
    for b in batches:
        t.record(b)
    torch.cuda.synchronize()
    rec_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    est = t.estimate(cands)
    verdicts = t.admit(cands, victims)
    dec_wall = time.perf_counter() - t0
    launches = read_launches()
    resets = launches["sketch_reset"]
    got = (digest(t.state), resets,
           digest({"estimate": torch.from_numpy(est)}), int(verdicts.sum()))
    check(got == S_PINS, f"S: (state digest, resets, estimate digest, "
          f"admitted) {got} != JAX {S_PINS}")
    check(launches["sketch_update"] == len(batches)
          and launches["sketch_estimate"] == 1
          and launches["admission"] == 1 and resets > 0,
          f"S: launches {launches}")
    print(f"phase 8  S: DeviceTinyLFU({S_BLOCKS}) width {t.cfg.width} rows "
          f"{t.cfg.rows} cap {t.cfg.cap} dk_bits {t.cfg.dk_bits} W "
          f"{t.cfg.sample_size}: state digest, {resets} resets, estimate "
          f"digest and {got[3]} admitted of {S_DECISIONS} == JAX")
    print(f"phase 8  S: record {len(f_trace)} keys in {len(batches)} "
          f"batches {rec_wall:.3f} s wall ({len(f_trace) / rec_wall:,.0f} "
          f"keys/s, host clock, lane upload included); estimate + admit of "
          f"{S_DECISIONS} keys {dec_wall * 1e3:.2f} ms wall; launches "
          f"{launches}; card {card}")

    # the same run again, CUDA events around each kernel launch
    fns = sketch_fns()
    add, reset = fns["sketch_update"][0], fns["sketch_reset"][0]
    cfg = t.cfg
    state = sc.init_state(cfg, device="cuda")
    lanes = [lanes_on_card(b) for b in batches]
    qlo, qhi = lanes_on_card(cands)
    vlo, vhi = lanes_on_card(victims)

    def record_calls():
        for lo, hi in lanes:
            yield "sketch_update", lambda: add(cfg, state, lo, hi)
            if int(state["size"]) >= cfg.sample_size:
                yield "sketch_reset", lambda: reset(cfg, state)

    ms = {k: [] for k in SKETCH_KERNELS}
    peak = {}
    for kinds, calls in (
            (("sketch_update", "sketch_reset"), record_calls()),
            (("sketch_estimate",), [("sketch_estimate", lambda: fns[
                "sketch_estimate"][0](cfg, state, qlo, qhi))] * 20),
            (("admission",), [("admission", lambda: fns["admission"][0](
                cfg, state, qlo, qhi, vlo, vhi))] * 20)):
        torch.cuda.reset_peak_memory_stats()
        timed, outs = kernel_ms(calls)
        for k in kinds:
            peak[k] = torch.cuda.max_memory_allocated()
        for k, v in timed:
            ms[k].append(v)
        if kinds == ("sketch_estimate",):
            e = outs[-1]
        elif kinds == ("admission",):
            a = outs[-1]
    check(digest(state) == got[0], "S: the timed run differs from the "
          "main run")
    check(np.array_equal(e.cpu().numpy(), est)
          and np.array_equal(a.cpu().numpy(), verdicts),
          "S: the timed estimates or verdicts differ from the main run's")
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    for k in SKETCH_KERNELS:
        print(f"phase 8  S: {k} {mean[k]:.4f} ms per launch over "
              f"{len(ms[k])} timed launches (min {min(ms[k]):.4f}, max "
              f"{max(ms[k]):.4f}); main-run launches {launches[k]}; "
              f"max_memory_allocated {peak[k]} bytes")
    busy = (sum(ms["sketch_update"]) + sum(ms["sketch_reset"])) / (
        rec_wall * 1e3)
    print(f"phase 8  S: the record kernels' time is a share {busy:.4f} of "
          f"the main run's record wall time")
    return launches, mean, batches


def serving_phase9(card):
    """Phase 9: P1 and P2 through PrefixCache on the card, each run with
    the launch counts set to 0 just before and read just after; every
    PrefixCacheStats field must equal the JAX cache's."""
    import dataclasses
    import torch
    from repro_torch.serve import PrefixCache
    from repro_torch.traces.synthetic import multi_tenant_prompt_trace
    p1 = multi_tenant_prompt_trace(**P1_TRACE)
    p2 = multi_tenant_prompt_trace(**P2_TRACE)
    runs = [("P1", p, c, p1) for p in ("lru", "tinylfu", "wtinylfu")
            for c in P1_CAPS] + [("P2", "wtinylfu", P2_CAP, p2)]
    totals = {}
    for name, policy, cap, stream in runs:
        pc = PrefixCache(cap, policy=policy, sample_factor=8)
        set_launches(0)
        t0 = time.perf_counter()
        stats = replay(pc, stream)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        got = dataclasses.astuple(stats)
        want = P_PINS[(name, policy, cap)]
        check(got == want, f"{name} {policy} C={cap}: stats {got} != JAX "
              f"{want}")
        decisions = stats.admitted + stats.rejected
        if policy != "lru":
            check(launches["sketch_update"] == stats.lookups
                  and launches["admission"] == decisions,
                  f"{name} {policy} C={cap}: launches {launches}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        print(f"phase 9  {name} {policy:8s} C={cap:<6d} stats == JAX, hit "
              f"ratio {stats.hit_ratio:.6f}; wall {wall:.3f} s, "
              f"{len(stream) / wall:,.0f} block accesses/s, "
              f"{decisions / wall:,.0f} admission decisions/s; launches add "
              f"{launches['sketch_update']} admit {launches['admission']} "
              f"reset {launches['sketch_reset']}")
    print(f"phase 9  {len(runs)} runs on {card}; launches in all {totals}")
    decision_breakdown(p2)


def decision_breakdown(stream, n: int = 2000):
    """Where one serving decision's time goes: wall µs per
    ``DeviceAdmission.admit`` (one batch-of-one launch and one verdict read
    each) against the device µs of the admit kernel at one pair and of the
    add kernel at one 32-block lookup (CUDA events, launches queued behind
    a spin kernel so the events time the kernels, not the enqueue)."""
    import torch
    from repro_torch.kernels import admission, sketch_update
    from repro_torch.serve.prefix_cache import DeviceAdmission
    adm = DeviceAdmission(P2_CAP)
    for s in range(0, 64 * 32, 32):
        adm.record_batch([int(x) for x in stream[s:s + 32]])
    pairs = [(int(stream[i % len(stream)]), int(stream[(i + 7) % len(stream)]))
             for i in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c, v in pairs:
        adm.admit(c, v)
    host_us = (time.perf_counter() - t0) / n * 1e6
    cfg, state = adm.t.cfg, adm.t.state
    lo, hi = lanes_on_card(stream[:32])

    def device_us(name, fn, reps=200):
        timed, _ = kernel_ms([(name, fn)] * reps)
        return sum(v for _, v in timed) / reps * 1e3

    admit_us = device_us("admission", lambda: admission.admit(
        cfg, state, lo[:1], hi[:1], lo[1:2], hi[1:2]))
    add_us = device_us("sketch_update",
                       lambda: sketch_update.add(cfg, state, lo, hi))
    print(f"phase 9  one decision: DeviceAdmission.admit {host_us:.1f} us "
          f"of wall (host clock over {n} calls, one verdict read each); "
          f"admit kernel at 1 pair {admit_us:.2f} us and add kernel at a "
          f"32-block lookup {add_us:.2f} us of device time; the host holds "
          f"{1 - admit_us / host_us:.3f} of a decision")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.device_simulate import DeviceWTinyLFU, simulate_trace
    from repro_torch.kernels import _build
    from repro_torch.kernels import sketch_step as ks
    from repro_torch.traces.synthetic import (zipf_trace,
                                              scan_then_hotspot_trace)

    # -- phase 1: card, build --------------------------------------------
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:     # one nvcc per source
        list(ex.map(_build.load_library, SOURCES))
    print(f"phase 1  build of {len(SOURCES)} sources in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        info = _build.build_info[(name, ())]
        nvcc = (f"nvcc {info['seconds']:.1f} s" if info["seconds"]
                else "built before; its ptxas log was kept")
        print(f"phase 1  {name}: {nvcc}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1  {name} ptxas:", line.strip())

    # -- phase 2: kernel vs plain on the card ------------------------------
    zipf = zipf_trace(60_000, n_items=50_000, alpha=0.9, seed=7)
    scanhot = scan_then_hotspot_trace()
    f_trace = zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9, seed=11)
    cases = [
        ("flat cb4 dk", DeviceWTinyLFU(200, sample_factor=2), zipf[:1500],
         256),
        ("flat cb8 no-dk", DeviceWTinyLFU(150, sample_factor=3, counter_bits=8,
                                          doorkeeper=False),
         scanhot[24_500:25_900], 500),
        ("assoc4 cb4 dk", DeviceWTinyLFU(300, sample_factor=1, assoc=4),
         zipf[:1500], 512),
        ("assoc8 cb8 dk", DeviceWTinyLFU(250, sample_factor=2, assoc=8,
                                         counter_bits=8),
         zipf[5000:6300], 256),
        ("assoc8 cb4 no-dk", DeviceWTinyLFU(200, sample_factor=2, assoc=8,
                                            doorkeeper=False),
         scanhot[24_800:26_000], 384),
    ]
    max_err = 0
    for name, cfg, tr, chunk in cases:
        max_err = max(max_err, compare_case(name, cfg, tr, chunk)[0])
    f_cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC)
    err, plain_ms = compare_case("F geometry", f_cfg, f_trace[:2 * F_CHUNK],
                                 F_CHUNK, timed=True)
    max_err = max(max_err, err)

    # -- phase 3: golden traces through the entry point --------------------
    traces = {"zipf": zipf, "scanhot": scanhot}
    ks.step.launches = 0
    for name, tr, cap, assoc, warmup, hits, regs, dig in GOLDEN:
        t0 = time.perf_counter()
        res, state, _ = simulate_trace(traces[tr], cap, warmup=warmup,
                                       assoc=assoc, chunk=F_CHUNK,
                                       trace_name=tr, return_state=True)
        check(res.hits == hits, f"{name}: hits {res.hits} != JAX {hits}")
        if regs is not None:
            got = state["regs"].cpu().tolist()
            check(got == regs, f"{name}: regs {got} != JAX {regs}")
            check(digest(state) == dig,
                  f"{name}: state digest {digest(state)} != JAX {dig}")
        also = "" if regs is None else ", regs and digest equal"
        print(f"phase 3  {name}: C={cap} assoc={assoc} hits {res.hits}/"
              f"{res.accesses} == JAX{also} ({time.perf_counter() - t0:.2f} s)")
    check(ks.step.launches > 0, "golden runs launched no kernel")

    # -- phase 4: F, the main path at its real size ------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    ks.step.launches = 0
    t0 = time.perf_counter()
    e0.record()
    res, state, hit_flags = simulate_trace(
        f_trace, F_CAPACITY, warmup=F_WARMUP, assoc=F_ASSOC, chunk=F_CHUNK,
        trace_name="zipf-1.2M", return_state=True)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ks.step.launches
    dev_ms = e0.elapsed_time(e1)
    nchunks = math.ceil(len(f_trace) / F_CHUNK)
    check(launches == nchunks,
          f"F: {launches} kernel launches, expected {nchunks}")
    regs = state["regs"].cpu().tolist()
    check(res.hits == F_HITS, f"F: hits {res.hits} != JAX {F_HITS}")
    check(regs == F_REGS, f"F: regs {regs} != JAX {F_REGS}")
    check(digest(state) == F_DIGEST,
          f"F: state digest {digest(state)} != JAX {F_DIGEST}")
    check(int(hit_flags[F_WARMUP:].sum()) == F_HITS and hit_flags.shape[0]
          == len(f_trace), "F: hit flags disagree with the hit register")
    print(f"phase 4  F: C={F_CAPACITY} assoc={F_ASSOC} hits {res.hits}/"
          f"{res.accesses} ratio {res.hit_ratio:.6f}, regs and digest == JAX")
    print(f"phase 4  F: wall {wall:.3f} s, {len(f_trace) / wall:,.0f} acc/s "
          f"(host clock around simulate_trace, trace upload and hashing "
          f"included); stream {dev_ms:.1f} ms between CUDA events around the "
          f"call; launches {launches}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes; card {card}")

    # -- phase 5: kernel time per launch, device idle share ---------------
    t_state, t_hits, step_launch_ms, stream_ms = timed_launches(
        f_trace, f_cfg, F_CHUNK, F_WARMUP)
    check(t_state["regs"].cpu().tolist() == F_REGS
          and digest(t_state) == F_DIGEST
          and bool((t_hits == hit_flags).all()),
          "F: the timed run differs from the main run")
    ms_chunk = sum(step_launch_ms) / len(step_launch_ms)
    idle = 1.0 - sum(step_launch_ms) / stream_ms
    print(f"phase 5  F: kernel {ms_chunk:.4f} ms per launch (CUDA events "
          f"around each of {len(step_launch_ms)} launches; min "
          f"{min(step_launch_ms):.4f}, max {max(step_launch_ms):.4f}), "
          f"{ms_chunk * 1e6 / F_CHUNK:.0f} ns/access; runner stream "
          f"{stream_ms:.1f} ms, device idle share {idle:.6f}")

    # -- phase 6: bound ----------------------------------------------------
    spec = f_cfg.spec()
    total, resets, size = bound_bytes(spec, f_trace, F_CHUNK,
                                      f_cfg.sample_size)
    check(size == F_REGS[0], f"F: reset count model ends at size {size}, "
          f"the kernel at {F_REGS[0]}")
    bound_ms = total / launches / HBM_BYTES_PER_S * 1e3
    print(f"phase 6  bound: {total} bytes over F ({resets} resets) = "
          f"{total / launches:.0f} bytes/chunk over 3.35 TB/s = "
          f"{bound_ms:.6f} ms/chunk; kernel is {ms_chunk / bound_ms:.0f}x "
          f"above it (a dependent per-access chain: latency-bound)")

    # -- phase 7: the sketch kernels vs plain on the card ------------------
    errs, s_plain_ms = sketch_phase7(f_trace)

    # -- phase 8: S, the batched sketch ops at real size ------------------
    s_launches, s_ms, s_batches = sketch_phase8(f_trace, card)

    # -- phase 9: P1 and P2, the serving path through PrefixCache ---------
    serving_phase9(card)

    # -- phase 10: the sketch kernels' bounds -------------------------------
    from repro_torch.kernels.ops import make_config
    s_cfg = make_config(S_BLOCKS)
    nbytes = sketch_bound_bytes(s_cfg, s_batches, f_trace[:S_DECISIONS])
    probe_ops = HASH_OPS_PER_PROBE * (s_cfg.rows + s_cfg.dk_probes)
    nops = {"sketch_update": probe_ops * S_BATCH,
            "sketch_estimate": probe_ops * S_DECISIONS,
            "admission": 2 * probe_ops * S_DECISIONS,
            "sketch_reset": 2 * s_cfg.rows * s_cfg.words_per_row}
    bounds = {}
    for k in SKETCH_KERNELS:
        b_ms = nbytes[k] / HBM_BYTES_PER_S * 1e3
        o_ms = nops[k] / F32_OPS_PER_S * 1e3
        bounds[k] = (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else
                     "operations")
        print(f"phase 10 bound {k}: {nbytes[k]:.0f} bytes per launch over "
              f"3.35 TB/s = {b_ms:.6f} ms; {nops[k]} 32-bit ops over "
              f"67 T/s = {o_ms:.6f} ms; kernel {s_ms[k]:.4f} ms is "
              f"{s_ms[k] / bounds[k][0]:.0f}x above the larger")
    floor_ms = S_BATCH * L2_ROUND_TRIP_NS * 1e-6
    print(f"phase 10 latency floor sketch_update: 1 dependent L2 round trip "
          f"per key x {L2_ROUND_TRIP_NS} ns x {S_BATCH} keys = {floor_ms:.4f}"
          f" ms per launch; kernel at {s_ms['sketch_update'] / floor_ms:.2f}x"
          f" of it")

    kernels = [{
        "name": "sketch_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sketch_step.cu",
        "replaces": "src/repro/kernels/sketch_step.py:2314",
        "launches": launches, "max_abs_err": max_err,
        "matches_plain": max_err == 0, "ms": ms_chunk,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None}]
    for k in SKETCH_KERNELS:
        kernels.append({
            "name": k, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{k}.cu",
            "replaces": REPLACES[k], "launches": s_launches[k],
            "max_abs_err": errs[k], "matches_plain": errs[k] == 0,
            "ms": s_ms[k], "plain_ms": s_plain_ms[k],
            "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
            "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)

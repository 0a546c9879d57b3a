#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the TinyLFU engine on one GPU: the device
trace engine (one stream, tenant lanes, sweeps), the serving-admission path
(device and host sketch) and the LLM serving path.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. print the card's name and power limit, build the six kernels and the
   empty-launch probe (``l2_chase.cu``) from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, all at once) and print their ptxas register/spill
   lines;
2. hold the kernel (``step``) against its plain PyTorch version
   (``step_ref``) on the card: flat and set-associative tables, 4- and 8-bit
   counters, doorkeeper on and off, resets inside and across chunk
   boundaries, padded tails, the hazard traces of ``check_runs.HAZARD_CASES``
   (runs of one key, one- and two-set tables, alternating keys, resets at
   every chunk boundary and mid-chunk; 4, 8 and 16 ways) and the main run's
   own geometry; every state leaf and hit flag must be equal;
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
   full-range words, and S's geometry; the add on every case of
   ``check_runs.ADD_HAZARD_CASES``; both paths of the admit (a warp per
   pair, a thread per pair) at ``check_runs.ADMIT_SIZES`` pairs, each size
   with the candidates and fresh victims both ways round; every leaf and
   output must be equal;
8. run S, the batched sketch ops at F's capacity, through ``DeviceTinyLFU``
   (counts set to 0 just before, read just after): record F's trace in
   4,096-key batches, then estimate and admit 50,000 keys; the state
   digest, the resets, the estimates' digest and the admitted count must
   equal the JAX package's; then time each kernel with CUDA events;
9. run P1 (benchmarks/bench_serving.py's grid) and P2 (its generator at
   C=65,536) through ``PrefixCache``, counts set to 0 around each run; every
   ``PrefixCacheStats`` field must equal the JAX cache's; then one
   decision's wall time beside the admit kernel at one pair, the add kernel
   at a 32-block lookup and an empty launch;
10. print the sketch kernels' bounds; run S through the numpy model of the
   add kernel's schedule (``check_runs.add_schedule``; its final state must
   equal S's pin) and print its longest sequential chain beside the bound;
   print the empty-launch floor beside the four sketch kernels; time the
   add and both paths of the admit over a range of batch sizes (where the
   admit wrapper's threshold comes from);
11. hold the flash-attention kernel against its plain version
   (``flash_attention_ref``) on the card, within max-abs 2e-2 in bf16:
   tests/test_flash_kernel.py's shapes causal and not, ragged lengths,
   q_offset 0, 512 and 1024 at run L's three shapes (K/V read from a slot
   of a KV cache), per-row kv_len, GQA groups 1, 4, 8 and 16, head dims 16
   to 128, softcap 0 and 30; and cache slots past kv_len holding NaN and
   +-3e38 must give an output bit-equal to a zeroed tail;
12. run L, qwen3-4b at full width (36 layers, random weights from a seed)
   serving 24 prompts of 1,280 tokens through ``ServeEngine`` (counts set
   to 0 just before, read just after); every ``stats`` field must equal
   the JAX engine's, with 36 flash launches per extend and one sketch add
   per lookup; then the same run again with its phases timed, and the
   flash kernel timed at each of L's attention shapes against its bound,
   its plain version and ``scaled_dot_product_attention``;
13. run qwen3-4b at full width and depth 2 with ``numpy_params`` weights:
   prefill 1,280 tokens, decode 4; each step's logits at the JAX top-8
   ids within 0.05 of the largest (the reference's decode bound);
14. hold the step kernel's lane grid (one CTA per lane, one launch per
   chunk) against ``step_ref`` with lanes on the card over
   ``check_runs.LANE_CASES`` (4 lanes; flat and set tables, shared and
   per-lane params, a lane with a shorter ``n_valid`` and one with none,
   F's geometry); every state leaf and hit flag must be equal;
15. run T, 64 tenant caches at F's geometry (1.2M accesses per lane, lane 0
   replaying F's trace), through ``simulate_trace(streams=64)`` (counts set
   to 0 just before, read just after: 2,344 launches for all lanes); lane
   0's hits, registers and digest must equal F's JAX pins, lanes 1, 32 and
   63 their solo runs; then the same run with CUDA events around each
   launch (ns per access per lane, device idle share) and its bound (bytes,
   and the latency floor of the lanes' chains side by side);
16. time F's geometry at 1, 8, 64, 132 and 264 lanes over each lane's first
   131,072 accesses, and one lane through the lane kernel (equal to the
   single-stream kernel's run): ns per access per lane, aggregate
   accesses/s, ``scaling_1_to_64`` and the state's bytes against the 50 MB
   L2;
17. run W, ``simulate_sweep`` over F's trace (capacities 32,768 / 65,536 /
   131,072 x window 0.01 / 0.05 / 0.2, assoc=8) as nine lanes of one run
   (counts set to 0 around it) and one configuration after another; the
   sequential (65,536, 0.01) row must equal F, and two lane rows solo runs
   of their padded configuration;
18. run P1's admitting policies through default-constructed
   ``PrefixCache``s (the host sketch, no launch); every stat must equal the
   default JAX cache's;
19. print the ``kernels`` JSON line (six kernels; the step kernel's entry
   with its lane-grid launches and check), the card line and the result
   line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import gc
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
from repro_torch.check_runs import (ADD_HAZARD_CASES,  # noqa: E402
                                    ADD_TILE, ADMIT_SIZES, FLASH_CASES,
                                    FLASH_TAIL, FLASH_TAIL_LENS,
                                    HAZARD_CASES, LANE_CASES, LANES,
                                    P1_CAPS, P1_HOST_PINS, P1_TRACE, P2_CAP,
                                    P2_TRACE, P_PINS,
                                    S_BATCH, S_BLOCKS, S_DECISIONS, S_PINS,
                                    SKETCH_CFGS, T_ACCESSES, T_LANES,
                                    T_SCALING, T_SCALING_ACCESSES, T_SOLO,
                                    T_TENANTS, W_CAPS, W_FRACS,
                                    add_hazard_batches, add_schedule,
                                    cache_tails, digest, hazard_keys,
                                    lane_keys, lane_n_valid, mixed_keys,
                                    replay)

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
    chunk).  ``cfg`` is a DeviceWTinyLFU or a (StepSpec, params, window_cap,
    main_cap) tuple."""
    import torch
    from repro_torch.core.device_simulate import _trace_lanes, run_chunks
    from repro_torch.kernels import sketch_step as ks
    if isinstance(cfg, tuple):
        spec, params, wcap, mcap = cfg
        sample = int(params[ks.P_SAMPLE])
    else:
        spec, params = cfg.spec(), cfg.params(device="cuda")
        wcap, mcap, sample = cfg.window_cap, cfg.main_cap, cfg.sample_size
    lo, hi = _trace_lanes(trace, "cuda")
    outs, ms = [], []
    for fn in (ks.step, ks.step_ref):
        state = ks.init_step_state(spec, wcap, mcap, device="cuda")
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
          f"(chunk {chunk}, W={sample}, {spec.assoc or 'flat'} ways)"
          f"{timing}")
    return err, ms[1]


def timed_launches(trace, cfg, chunk, warmup, fn=None):
    """F through the engine's chunk runner with CUDA events around each
    launch (of ``fn``, default the ``step`` wrapper); returns (state, hit
    flags, per-launch kernel ms, the runner's stream ms from its first
    launch to its last)."""
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
        out = (fn or ks.step)(*args)
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
           "sketch_reset", "flash_attention")
PROBES = ("l2_chase",)          # built beside them: the empty-launch floor
SKETCH_KERNELS = ("sketch_update", "sketch_estimate", "admission",
                  "sketch_reset")
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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sketch_step as ks
    ks.step.launches = n
    fa.flash_attention.launches = n
    for kernel, _ in sketch_fns().values():
        kernel.launches = n


def read_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sketch_step as ks
    out = {name: kernel.launches for name, (kernel, _) in sketch_fns().items()}
    out["sketch_step"] = ks.step.launches
    out["flash_attention"] = fa.flash_attention.launches
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
    add_hazards(errs)
    admit_sizes(s_cfg, f_trace, errs)
    torch.cuda.synchronize()
    return errs, plain_ms


def add_hazards(errs):
    """The add kernel against add_ref on every case of ADD_HAZARD_CASES,
    the batches added one after another to one sketch each."""
    from repro_torch.kernels import sketch_common as sc
    from repro_torch.kernels import sketch_update as su
    for case, (name, kw, _, sizes) in enumerate(ADD_HAZARD_CASES):
        cfg = sc.DeviceSketchConfig(**kw)
        kernel = sc.init_state(cfg, device="cuda")
        plain = sc.init_state(cfg, device="cuda")
        for keys in add_hazard_batches(case):
            lo, hi = lanes_on_card(keys)
            su._launch(cfg, kernel, lo, hi)
            su.add_ref(cfg, plain, lo, hi)
            err = max(int((kernel[k].long() - plain[k].long()).abs().max())
                      for k in ("counters", "doorkeeper"))
            errs["sketch_update"] = max(errs["sketch_update"], err)
            check(err == 0, f"add hazard {name}: kernel and add_ref differ")
        print(f"phase 7  add hazard {name} (width {cfg.width} rows "
              f"{cfg.rows} cap {cfg.cap} dk_bits {cfg.dk_bits}; batches "
              f"{list(sizes)}, tile {ADD_TILE}): kernel == add_ref")


def admit_pairs(f_trace, n):
    """The admit's two inputs at ``n`` pairs, both ways round: F's first
    ``n`` keys (recorded by S's first batch) and ``n`` keys drawn from a
    seed that no batch recorded.  With victims the candidates do not
    share, a wrong verdict can show at 1 and 2 pairs."""
    cands = f_trace[:n]
    fresh = np.random.default_rng(n).integers(1 << 62, 1 << 63, n,
                                              dtype=np.uint64)
    return [(*lanes_on_card(cands), *lanes_on_card(fresh)),
            (*lanes_on_card(fresh), *lanes_on_card(cands))]


def admit_sizes(cfg, f_trace, errs):
    """The admit kernel's two paths (a warp per pair, a thread per pair)
    against admission_ref at ADMIT_SIZES pairs, on S's geometry after two
    of its batches."""
    import torch
    from repro_torch.kernels import admission, sketch_update
    from repro_torch.kernels.sketch_common import init_state
    state = init_state(cfg, device="cuda")
    for s in (0, S_BATCH):
        sketch_update.add(cfg, state, *lanes_on_card(f_trace[s:s + S_BATCH]))
    admitted = []
    for n in ADMIT_SIZES:
        for args in admit_pairs(f_trace, n):
            want = admission.admission_ref(cfg, state, *args)
            admitted.append(int(want.sum()))
            for per_thread in (False, True):
                out = torch.empty(n, dtype=torch.bool, device="cuda")
                admission._launch(cfg, state, *args, out,
                                  per_thread=per_thread)
                err = int((out.long() - want.long()).abs().max())
                errs["admission"] = max(errs["admission"], err)
                check(err == 0, f"admit at {n} pairs: the "
                      f"{'thread' if per_thread else 'warp'}-per-pair path "
                      f"and admission_ref differ")
    check(admitted[:2] == [1, 0], f"admit at 1 pair: admission_ref admits "
          f"{admitted[:2]} both ways round, so a wrong verdict could hide")
    print(f"phase 7  admit at {', '.join(map(str, ADMIT_SIZES))} pairs, "
          f"candidates and fresh victims both ways round (admission_ref "
          f"admits {admitted}): the warp-per-pair and thread-per-pair paths "
          f"== admission_ref (the wrapper takes the warp path up to "
          f"{admission.WARP_MAX_PAIRS} pairs)")


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
    """Phase 9: P1 and P2 through PrefixCache on the card (the device
    sketch), each run with the launch counts set to 0 just before and read
    just after; every PrefixCacheStats field must equal the JAX cache's.
    Returns each run's admission decisions per second of wall."""
    import dataclasses
    import torch
    from repro_torch.serve import PrefixCache
    from repro_torch.traces.synthetic import multi_tenant_prompt_trace
    p1 = multi_tenant_prompt_trace(**P1_TRACE)
    p2 = multi_tenant_prompt_trace(**P2_TRACE)
    runs = [("P1", p, c, p1) for p in ("lru", "tinylfu", "wtinylfu")
            for c in P1_CAPS] + [("P2", "wtinylfu", P2_CAP, p2)]
    totals, rates = {}, {}
    for name, policy, cap, stream in runs:
        pc = PrefixCache(cap, policy=policy, sample_factor=8,
                         device_sketch=True)
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
        rates[(name, policy, cap)] = decisions / wall
        print(f"phase 9  {name} {policy:8s} C={cap:<6d} stats == JAX, hit "
              f"ratio {stats.hit_ratio:.6f}; wall {wall:.3f} s, "
              f"{len(stream) / wall:,.0f} block accesses/s, "
              f"{decisions / wall:,.0f} admission decisions/s; launches add "
              f"{launches['sketch_update']} admit {launches['admission']} "
              f"reset {launches['sketch_reset']}")
    print(f"phase 9  {len(runs)} runs on {card}; launches in all {totals}")
    decision_breakdown(p2)
    return rates


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
          f"32-block lookup {add_us:.2f} us of device time, against an "
          f"empty launch's {launch_floor_us():.2f} us; the host holds "
          f"{1 - admit_us / host_us:.3f} of a decision")


def launch_floor_us(reps: int = 200) -> float:
    """Device us of an empty launch through the kernels' ctypes path:
    csrc/l2_chase.cu with 0 steps (one thread writes one int), timed by
    kernel_ms like the sketch kernels."""
    import torch
    from repro_torch.kernels._build import launch
    buf = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")

    def empty():
        launch("l2_chase", "l2_chase_launch", buf, 0, out)
    empty()                         # its first launch loads the module
    timed, _ = kernel_ms([("floor", empty)] * reps)
    return sum(v for _, v in timed) / reps * 1e3


def add_schedule_stats(f_trace, cfg):
    """Run S's record loop through check_runs.add_schedule (the numpy model
    of the add kernel's schedule), with the section 3.3 resets; its final
    state must equal S's pin.  Returns per 4,096-key batch the model's
    per-tile statistics (gated keys, components, largest component's keys,
    largest several-key component's keys)."""
    import torch
    from repro_torch.kernels.sketch_common import key_probes, keys_to_lanes
    from repro_torch.kernels.sketch_reset import reset_ref
    lo, hi = (torch.from_numpy(x) for x in keys_to_lanes(f_trace))
    idx, dkb = (x.numpy() for x in key_probes(lo, hi, cfg.rows, cfg.width,
                                              cfg.dk_bits, cfg.dk_probes))
    counters = np.zeros((cfg.rows, cfg.words_per_row), np.int32)
    dk = np.zeros((1, cfg.dk_words), np.int32)
    # CPU tensors over the model's arrays: the plain reset halves them
    state = {"counters": torch.from_numpy(counters),
             "doorkeeper": torch.from_numpy(dk),
             "size": torch.tensor(0, dtype=torch.int32)}
    stats = []
    for s in range(0, len(f_trace), S_BATCH):
        stats.append(add_schedule(counters, dk, idx[s:s + S_BATCH],
                                  dkb[s:s + S_BATCH], width=cfg.width,
                                  cap=cfg.cap, dk_bits=cfg.dk_bits))
        state["size"] = state["size"] + len(idx[s:s + S_BATCH])
        if int(state["size"]) >= cfg.sample_size:
            reset_ref(cfg, state)
    got = digest(state)
    check(got == S_PINS[0], f"S through the add schedule model: state "
          f"digest {got} != JAX {S_PINS[0]}")
    return stats


ADD_SWEEP = (1, 2, 4, 8, 16, 32, 64, 256, 1024, 4096)
ADMIT_SWEEP = (1, 2, 8, 32, 128, 1024, 8192, 50_000)


def path_sweep(f_trace, cfg, card):
    """Device ms per launch of the add and of each path of the admit at a
    range of batch sizes, on S's geometry after 100 of its batches
    (kernel_ms, 20 launches each): where the admit wrapper's threshold
    comes from."""
    import torch
    from repro_torch.kernels import admission, ops, sketch_update
    t = ops.DeviceTinyLFU(S_BLOCKS)
    for s in range(0, 100 * S_BATCH, S_BATCH):
        t.record(f_trace[s:s + S_BATCH])
    state = t.state
    for n in ADD_SWEEP:
        lo, hi = lanes_on_card(f_trace[:n])

        def call():
            sketch_update._launch(cfg, state, lo, hi)
        call()                              # loads the module if first
        timed, _ = kernel_ms([("add", call)] * 20)
        print(f"phase 10 add at {n} keys: "
              f"{sum(v for _, v in timed) / len(timed):.4f} ms per launch; "
              f"card {card}")
    for n in ADMIT_SWEEP:
        args = admit_pairs(f_trace, n)[0]
        out = torch.empty(n, dtype=torch.bool, device="cuda")
        ms = {}
        for path in ("warp", "thread"):
            def call():
                admission._launch(cfg, state, *args, out,
                                  per_thread=path == "thread")
            call()                          # loads the module if first
            timed, _ = kernel_ms([(path, call)] * 20)
            ms[path] = sum(v for _, v in timed) / len(timed)
        print(f"phase 10 admit paths at {n} pairs: warp per pair "
              f"{ms['warp']:.4f} ms, thread per pair {ms['thread']:.4f} ms "
              f"per launch; the wrapper takes the "
              f"{'warp' if n <= admission.WARP_MAX_PAIRS else 'thread'} path;"
              f" card {card}")


FLASH_TOL = 2e-2    # max |kernel - plain| in bf16: the reference's bf16 bound
                    # (tests/test_flash_kernel.py)
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor rate (data sheet)
D2_TOL = 0.05       # the reference's decode bound (tests/test_models.py)


def flash_inputs(seed, B, Sq, Skv, Hq, Hkv, D):
    """Normal bf16 q (B,Sq,Hq,D) on the card, and k, v (B,Skv,Hkv,D) as
    rows 1.. of a (B+1)-row tensor: slots of a cache, as the engine hands
    them to the kernel."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)
    return (randn(B, Sq, Hq, D), randn(B + 1, Skv, Hkv, D)[1:],
            randn(B + 1, Skv, Hkv, D)[1:])


def flash_phase11():
    """Phase 11: the flash kernel against its plain version on the card.
    Returns the largest max-abs difference."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    worst = 0.0
    for i, (name, B, Sq, Skv, Hq, Hkv, D, causal, off, kvl,
            cap) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(i, B, Sq, Skv, Hq, Hkv, D)
        if isinstance(kvl, list):
            kvl = torch.tensor(kvl, device="cuda")
        kw = dict(causal=causal, q_offset=off, kv_len=kvl, softcap=cap)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()) and got.shape == q.shape
              and got.dtype == torch.bfloat16, f"flash {name}: bad output")
        check(err <= FLASH_TOL, f"flash {name}: kernel and plain differ by "
              f"{err} > {FLASH_TOL}")
        worst = max(worst, err)
        lens = kvl.tolist() if isinstance(kvl, torch.Tensor) else kvl
        print(f"phase 11 flash {name}: B={B} Sq={Sq} Skv={Skv} Hq={Hq} "
              f"Hkv={Hkv} D={D} causal={causal} q_offset={off} kv_len="
              f"{lens} softcap={cap}: max |kernel - plain| {err:.6f}")
    c = FLASH_TAIL
    q, k, v = flash_inputs(99, c["B"], c["Sq"], c["Skv"], c["Hq"], c["Hkv"],
                           c["D"])
    for kvl in FLASH_TAIL_LENS:
        lens = [kvl] * c["B"] if isinstance(kvl, int) else kvl
        zeroed, poisoned = cache_tails(k, v, lens)
        if isinstance(kvl, list):
            kvl = torch.tensor(kvl, device="cuda")
        kw = dict(causal=True, q_offset=c["q_offset"], kv_len=kvl)
        want = fa.flash_attention(q, *zeroed, **kw)
        got = fa.flash_attention(q, *poisoned, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()) and torch.equal(got, want),
              f"flash: cache slots past kv_len {lens} reach the output")
        print(f"phase 11 flash cache tail: slots past kv_len {lens} hold NaN "
              f"and +-3e38; output bit-equal to a zeroed tail")
    return worst


def flash_work(Sq, q_offset, kv_len, Hq=32, Hkv=8, D=128):
    """(flops, bytes) one causal launch must do at these shapes: 4*D per
    visible (query, key) pair per head; q, k, v (the visible keys) read
    once and the output written once, bf16."""
    pairs = sum(min(kv_len, q_offset + i + 1) for i in range(Sq))
    return (4 * D * Hq * pairs,
            2 * (2 * Sq * Hq * D + 2 * kv_len * Hkv * D))


def time_flash_shape(Sq, q_offset, kv_len, reps=20):
    """Device ms per launch of the kernel, the plain version and one
    ``scaled_dot_product_attention`` call (its yardstick: KV heads repeated
    and the mask built before the timer) at one of L's attention shapes,
    K/V in a slot of an L-sized cache."""
    import torch
    import torch.nn.functional as F
    from repro_torch.check_runs import L_ENGINE
    from repro_torch.kernels import flash_attention as fa
    q, k, v = flash_inputs(7, 1, Sq, L_ENGINE["max_len"], 32, 8, 128)
    kw = dict(q_offset=q_offset, kv_len=kv_len)
    timed, _ = kernel_ms([("flash", lambda: fa.flash_attention(
        q, k, v, **kw))] * reps)
    ms = sum(t for _, t in timed) / reps
    plain = timed_ms(lambda: fa.flash_attention_ref(q, k, v, **kw), 2)
    qt = q.transpose(1, 2)
    kt, vt = (x[:, :kv_len].repeat_interleave(4, dim=2).transpose(1, 2)
              for x in (k, v))
    pos = torch.arange(kv_len, device="cuda")
    mask = (q_offset + pos[:Sq, None]) >= pos[None, :]
    lib_kw = (dict(is_causal=True) if q_offset == 0 and Sq == kv_len
              else dict(attn_mask=mask))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
    sdpa()                                  # its first call loads kernels
    timed, outs = kernel_ms([("sdpa", sdpa)] * reps)
    lib = sum(t for _, t in timed) / reps
    lib_err = float((outs[-1].transpose(1, 2).float()
                     - fa.flash_attention_ref(q, k, v, **kw).float()
                     ).abs().max())
    return ms, plain, lib, lib_err


def llm_phase12(card):
    """Phase 12: run L through ServeEngine at full width (counts set to 0
    just before, read just after), then again with its phases timed, once
    more under torch.profiler, and the flash kernel at each of L's
    attention shapes.  Returns (flash
    launches, the kernel's JSON numbers as means per launch over L's
    launches: ms, plain ms, bound ms, bound_by, library ms)."""
    import torch
    from repro_torch.check_runs import (L_ENGINE, L_NEW_TOKENS, L_PINS,
                                        L_WORKLOAD)
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.driver import make_workload
    cfg = get_config("qwen3-4b")
    model = Model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    wl = dict(L_WORKLOAD)
    prompts = make_workload(cfg, wl.pop("n_requests"), **wl)

    def serve_l(engine_cls):
        eng = engine_cls(model, params, **L_ENGINE, device_sketch=True)
        for pr in prompts:
            eng.submit(pr, L_NEW_TOKENS)
        reqs = list(eng.queue)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        return eng, reqs, out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    set_launches(0)
    eng, reqs, out, wall = serve_l(ServeEngine)
    launches = read_launches()
    stats = eng.stats
    check(stats == L_PINS, f"L: stats {stats} != JAX {L_PINS}")
    check(len(out) == len(prompts) and all(
        len(t) == L_NEW_TOKENS and all(0 <= x < cfg.vocab_size for x in t)
        for t in out.values()), "L: missing or bad generated tokens")
    check(launches["flash_attention"] == cfg.n_layers * len(reqs),
          f"L: {launches['flash_attention']} flash launches, expected "
          f"{cfg.n_layers} per extend x {len(reqs)}")
    check(launches["sketch_update"] == eng.prefix_cache.stats.lookups
          and launches["admission"] == stats["admitted"] + stats["rejected"],
          f"L: sketch launches {launches}")
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 12 L: qwen3-4b full width ({cfg.n_layers} layers, "
          f"{n_params:,} parameters, bf16; init {init_s:.2f} s), "
          f"{len(prompts)} prompts of {len(prompts[0])} tokens: stats == "
          f"JAX {stats}")
    print(f"phase 12 L: wall {wall:.3f} s for {len(prompts)} requests "
          f"(host clock, ends in a sync); {stats['tokens_prefilled']} "
          f"tokens prefilled, {stats['tokens_prefilled'] / wall:,.0f} per "
          f"second of wall; launches {launches}; max_memory_allocated "
          f"{peak} bytes; card {card}")

    # the same run with each phase timed on the host clock (each ends in a
    # read of the card: the emitted token)
    spent = {"start": [], "tick": [], "finish": []}

    class Timed(ServeEngine):
        def _start(self, req):
            t0 = time.perf_counter()
            super()._start(req)
            spent["start"].append(time.perf_counter() - t0)

        def _decode_tick(self):
            t0 = time.perf_counter()
            super()._decode_tick()
            spent["tick"].append(time.perf_counter() - t0)

        def _finish(self, req):
            t0 = time.perf_counter()
            super()._finish(req)
            torch.cuda.synchronize()
            spent["finish"].append(time.perf_counter() - t0)

    del eng
    t_eng, t_reqs, t_out, t_wall = serve_l(Timed)
    check(t_eng.stats == stats and t_out == out,
          "L: the timed run differs from the main run")
    del t_eng

    # and once more under torch.profiler: device time by kind of kernel,
    # and the share of the run's wall time in which the card ran none
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        p_eng, _, p_out, p_wall = serve_l(ServeEngine)
    check(p_eng.stats == stats and p_out == out,
          "L: the profiled run differs from the main run")
    del p_eng
    kinds = {"flash": 0.0, "gemm": 0.0, "copy": 0.0, "other": 0.0}
    n_kernels = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        us = e.time_range.end - e.time_range.start
        kind = ("flash" if "flash_attention_kernel" in name else
                "gemm" if any(w in name for w in ("gemm", "xmma", "nvjet",
                                                  "cutlass")) else
                "copy" if "memcpy" in name or "memset" in name else "other")
        kinds[kind] += us / 1e6
        n_kernels += 1
    busy = sum(kinds.values())
    if busy:
        print(f"phase 12 L profiled run (torch.profiler): wall {p_wall:.3f}"
              f" s with the profiler on; {n_kernels} device activities, "
              f"busy {busy:.3f} s: gemm {kinds['gemm']:.3f}, flash "
              f"{kinds['flash']:.3f}, copies {kinds['copy']:.3f}, other "
              f"kernels {kinds['other']:.3f}; device idle share "
              f"{1 - busy / p_wall:.4f} of the profiled wall, "
              f"{1 - busy / t_wall:.4f} of the timed run's; card {card}")
    else:
        print("phase 12 L profiled run: the profiler saw no device "
              "activity; device time by kind not measured")
    mix = {}
    for r in reqs:
        start = r.prefix_blocks_reused * L_ENGINE["block_size"]
        key = (len(r.prompt) - start, start, len(r.prompt))
        mix[key] = mix.get(key, 0) + cfg.n_layers
    per = {}
    for (Sq, off, kvl), n in sorted(mix.items()):
        ms, plain, lib, lib_err = time_flash_shape(Sq, off, kvl)
        flops, nbytes = flash_work(Sq, off, kvl)
        o_ms = flops / BF16_FLOPS_PER_S * 1e3
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        per[(Sq, off, kvl)] = (ms, plain, lib, o_ms, b_ms)
        gp = 1                          # the kernel's work items and CTAs
        while gp < 16 and (cfg.n_heads // cfg.n_kv_heads) % (2 * gp) == 0:
            gp *= 2
        items = -(-Sq // (128 // gp)) * (cfg.n_heads // gp)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"phase 12 L flash Sq={Sq} q_offset={off} kv_len={kvl}: "
              f"{items} work items of {128 // gp} positions x {gp} heads on "
              f"{min(items, sms)} persistent CTAs (1 per SM); "
              f"{n} launches; kernel {ms:.4f} ms; plain {plain:.3f} ms; "
              f"scaled_dot_product_attention {lib:.4f} ms (max |sdpa - "
              f"plain| {lib_err:.4f}); bound: {flops / 1e9:.3f} GFLOP over "
              f"989 TFLOP/s = {o_ms:.4f} ms, {nbytes / 1e6:.2f} MB over "
              f"3.35 TB/s = {b_ms:.4f} ms; kernel at "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{max(o_ms, b_ms) / ms:.3f} of the bound; card {card}")
    total = sum(mix.values())

    def mean(i):
        return sum(per[k][i] * n for k, n in mix.items()) / total

    flash_s = sum(per[k][0] * n for k, n in mix.items()) / 1e3
    start_s, tick_s = sum(spent["start"]), sum(spent["tick"])
    finish_s = sum(spent["finish"])
    print(f"phase 12 L timed run: wall {t_wall:.3f} s; {len(spent['start'])}"
          f" starts (lookup, gather, extend, head) {start_s:.3f} s, "
          f"{stats['tokens_prefilled'] / start_s:,.0f} prefill tokens/s; "
          f"{len(spent['tick'])} decode ticks {tick_s:.3f} s, "
          f"{tick_s / len(spent['tick']) * 1e3:.2f} ms per tick; "
          f"{len(spent['finish'])} finishes (offers to the pool) "
          f"{finish_s:.3f} s; the flash kernel's time is a share "
          f"{flash_s / start_s:.4f} of the starts' wall time; card {card}")
    o_ms, b_ms = mean(3), mean(4)
    return launches["flash_attention"], dict(
        ms=mean(0), plain_ms=mean(1), library_ms=mean(2),
        bound_ms=max(o_ms, b_ms),
        bound_by="operations" if o_ms >= b_ms else "bytes")


def llm_phase13(card):
    """Phase 13: qwen3-4b at full width and depth 2 with numpy_params
    weights: prefill, then decode the JAX model's greedy tokens; each
    step's logits at the pinned top-8 ids against the JAX values."""
    import torch
    from repro_torch.check_runs import (D2_MAX_LEN, D2_PINS, D2_SEED,
                                        D2_STEPS, d2_prompt, numpy_params)
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.convert import params_from_numpy
    cfg = get_config("qwen3-4b").replace(n_layers=2)
    t0 = time.perf_counter()
    params = params_from_numpy(cfg, numpy_params(cfg, D2_SEED))
    load_s = time.perf_counter() - t0
    m = Model(cfg)
    cache = m.init_cache(1, D2_MAX_LEN)
    prompt = torch.from_numpy(d2_prompt(cfg.vocab_size)[None]).cuda()
    cache, h = m.prefill(params, {"tokens": prompt}, cache)
    logits = m.lm_head(params, h)[0, 0]
    worst = 0.0
    for step, (ids, want) in enumerate(D2_PINS):
        got = logits[list(ids)].cpu().numpy()
        rel = float(np.max(np.abs(got - np.asarray(want)))
                    / np.max(np.abs(want)))
        top = logits.topk(8).indices.tolist()
        check(bool(torch.isfinite(logits).all()) and rel < D2_TOL,
              f"D2 step {step}: logits at the JAX top-8 differ by {rel:.4f}"
              f" of the largest (> {D2_TOL})")
        worst = max(worst, rel)
        print(f"phase 13 D2 step {step}: max |port - JAX| over the JAX top-8"
              f" {rel:.5f} of the largest; top-1 {top[0]} (JAX {ids[0]}); "
              f"{len(set(top) & set(ids))} of 8 ids shared")
        if step < D2_STEPS:
            tok = torch.tensor([[ids[0]]], device="cuda")
            logits, cache = m.decode(params, tok, cache)
            logits = logits[0, 0]
    check(int(cache["pos"][0]) == len(prompt[0]) + D2_STEPS,
          "D2: cache position")
    print(f"phase 13 D2: qwen3-4b full width, 2 layers, numpy_params loaded "
          f"in {load_s:.1f} s: every step within {D2_TOL} (worst "
          f"{worst:.5f}); card {card}")


def lanes_phase14():
    """Phase 14: the step kernel's lane grid (one CTA per lane, one launch
    per chunk) against step_ref with lanes on the card, over
    check_runs.LANE_CASES: flat and set tables, shared and per-lane params,
    lane_n_valid's shorter and empty lanes, F's geometry; every state leaf
    and hit flag must be equal.  Returns the max abs difference."""
    import torch
    from repro_torch.kernels import sketch_step as ks
    err = 0
    for name, kw, prows, wcap, mcap, kind, n, chunk in LANE_CASES:
        spec = ks.StepSpec(**kw, streams=LANES)
        lo, hi = lanes_on_card(lane_keys(kind, n))
        counts = [lane_n_valid(chunk, c, n - s)
                  for c, s in enumerate(range(0, n, chunk))]
        outs = []
        for fn in (ks.step, ks.step_ref):
            params = torch.stack([ks.make_step_params(
                *p, counter_bits=spec.counter_bits, device="cuda")
                for p in prows])
            params = params[0] if len(prows) == 1 else params
            state = ks.init_step_state(spec, wcap, mcap, device="cuda")
            hits = [fn(spec, params, state, lo[:, s:s + chunk],
                       hi[:, s:s + chunk], nv)[1]
                    for s, nv in zip(range(0, n, chunk), counts)]
            outs.append((state, torch.cat(hits, dim=1)))
        (k_state, k_hits), (p_state, p_hits) = outs
        d = max([int((k_hits - p_hits).abs().max())]
                + [int((k_state[k].long() - p_state[k].long()).abs().max())
                   for k in p_state])
        check(d == 0, f"lanes {name}: kernel and plain differ")
        steps = [int(x) for x in np.sum(counts, axis=0)]
        check(p_state["regs"][:, ks.R_T].tolist() == steps,
              f"lanes {name}: the plain run did not take each lane's "
              f"n_valid")
        err = max(err, d)
        print(f"phase 14 lanes {name}: kernel == plain, {LANES} lanes x "
              f"{n} accesses (chunk {chunk}, accesses per lane {steps}, "
              f"{len(prows)} params row(s), {spec.assoc or 'flat'} ways)")
    return err


def t_trace(f_trace):
    """Run T's (T_LANES, T_ACCESSES) keys: lane 0 is F's trace."""
    from repro_torch.traces.synthetic import tenant_lanes_trace
    tr = np.empty((T_LANES, T_ACCESSES), np.int64)
    tr[0] = f_trace
    tr[1:] = tenant_lanes_trace(T_LANES - 1, T_ACCESSES, **T_TENANTS)
    return tr


def tenant_phase15(tr, card):
    """Phase 15: run T (T_LANES tenant caches at F's geometry) through
    simulate_trace, the launch counts set to 0 just before and read just
    after: one launch per chunk for all lanes; lane 0 must equal F's JAX
    pins and lanes T_SOLO their solo runs.  Then the same run with CUDA
    events around each launch, and the bound.  Returns (launches, ms per
    launch, bound ms per launch)."""
    import torch
    from repro_torch.core.device_simulate import (DeviceWTinyLFU,
                                                  simulate_trace)
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.phase_timing import RT_HIT, RT_MISS, \
        l2_round_trip_ns
    kw = dict(warmup=F_WARMUP, assoc=F_ASSOC, chunk=F_CHUNK,
              return_state=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_launches(0)
    t0 = time.perf_counter()
    res, state, flags = simulate_trace(tr, F_CAPACITY, streams=T_LANES,
                                       trace_name="tenants-64", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    nchunks = math.ceil(T_ACCESSES / F_CHUNK)
    check(launches["sketch_step"] == nchunks
          and sum(launches.values()) == nchunks,
          f"T: launches {launches}, expected {nchunks} step launches")
    lane_hits = res.extra["lane_hits"]

    def lane(b):
        return {k: v[b] for k, v in state.items()}

    check(lane_hits[0] == F_HITS
          and state["regs"][0].cpu().tolist() == F_REGS
          and digest(lane(0)) == F_DIGEST
          and int(flags[0, F_WARMUP:].sum()) == F_HITS,
          f"T: lane 0 (F's trace) hits {lane_hits[0]} regs "
          f"{state['regs'][0].cpu().tolist()} digest {digest(lane(0))} != "
          f"F's JAX pins")
    check(res.hits == sum(lane_hits)
          and res.accesses == (T_ACCESSES - F_WARMUP) * T_LANES
          and flags.shape == tr.shape, "T: aggregate result disagrees")
    state_bytes = sum(v.numel() * v.element_size() for v in state.values())
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 15 T: {T_LANES} lanes x {T_ACCESSES} accesses at F's "
          f"geometry; lane 0 hits, regs and digest == F's JAX pins; hits "
          f"{res.hits}/{res.accesses} ratio {res.hit_ratio:.6f}; lane hits "
          f"min {min(lane_hits)} max {max(lane_hits)}")
    print(f"phase 15 T: wall {wall:.3f} s, {tr.size / wall:,.0f} acc/s "
          f"aggregate (host clock around simulate_trace, upload and hashing "
          f"included); launches {launches['sketch_step']}; state "
          f"{state_bytes} bytes ({state_bytes / 2**20:.1f} MiB); "
          f"max_memory_allocated {peak} bytes; card {card}")
    for b in T_SOLO:
        r, s, h = simulate_trace(tr[b], F_CAPACITY, **kw)
        check(r.hits == lane_hits[b] and bool(torch.equal(h, flags[b]))
              and digest(s) == digest(lane(b)),
              f"T: lane {b} differs from its solo run")
    print(f"phase 15 T: lanes {T_SOLO} == their solo runs (hit flags, "
          f"state digest)")

    # the same run, CUDA events around each launch
    cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC, streams=T_LANES)
    t_state, t_hits, launch_ms, stream_ms = timed_launches(tr, cfg, F_CHUNK,
                                                           F_WARMUP)
    check(digest(t_state) == digest(state)
          and bool(torch.equal(t_hits, flags)),
          "T: the timed run differs from the main run")
    del t_state, t_hits
    ms = sum(launch_ms) / len(launch_ms)
    idle = 1.0 - sum(launch_ms) / stream_ms
    print(f"phase 15 T: kernel {ms:.4f} ms per launch (CUDA events around "
          f"each of {len(launch_ms)}; min {min(launch_ms):.4f}, max "
          f"{max(launch_ms):.4f}), {ms * 1e6 / F_CHUNK:.0f} ns per access "
          f"per lane, {T_LANES * F_CHUNK / ms * 1e3:,.0f} acc/s aggregate "
          f"of kernel time; runner stream {stream_ms:.1f} ms, device idle "
          f"share {idle:.6f}")

    # bound: each lane's words (bound_bytes), summed; the latency floor of
    # one lane's chain, the lanes running side by side
    spec1 = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC).spec()
    total = sum(bound_bytes(spec1, tr[b], F_CHUNK, cfg.sample_size)[0]
                for b in range(T_LANES))
    bound_ms = total / nchunks / HBM_BYTES_PER_S * 1e3
    h = float(flags.float().mean())
    rt = l2_round_trip_ns(load_library("l2_chase"))
    trips = RT_HIT * h + RT_MISS * (1 - h)
    floor_ms = F_CHUNK * trips * rt / 1e6
    print(f"phase 15 T: bound {total} bytes over the run = "
          f"{total / nchunks:.0f} bytes per launch over 3.35 TB/s = "
          f"{bound_ms:.6f} ms per launch (the kernel is "
          f"{ms / bound_ms:.0f}x above it); latency floor {trips:.2f} "
          f"dependent L2 round trips per access (hit share {h:.4f}) x "
          f"{rt:.1f} ns = {trips * rt:.0f} ns per access per lane, "
          f"{floor_ms:.4f} ms per launch with the {T_LANES} lanes side by "
          f"side (the kernel is {ms / floor_ms:.1f}x above it)")
    return launches["sketch_step"], ms, bound_ms


def lane_grid_step(spec, params, state, lo, hi, n_valid, probes):
    """One launch of the lane kernel over unbatched inputs: one lane."""
    import torch
    from repro_torch.kernels import sketch_step as ks
    hits = torch.empty_like(lo)
    ks._launch(spec, params, state, lo, hi, probes, n_valid, hits,
               lane_grid=True)
    return state, hits


def scaling_phase16(tr, card):
    """Phase 16: F's geometry at T_SCALING lanes over the first
    T_SCALING_ACCESSES accesses of each lane (lane b replays lane b %
    T_LANES), and at one lane through the lane kernel too: kernel ms per
    launch, ns per access per lane and aggregate accesses per second of
    kernel time, the state's bytes against the 50 MB L2.  Lanes replaying
    one trace, and the lane kernel at one lane, must give equal hit
    flags."""
    import torch
    from repro_torch.core.device_simulate import DeviceWTinyLFU
    agg, one = {}, None
    for B, fn in [(1, None), (1, lane_grid_step)] + [
            (B, None) for B in T_SCALING if B > 1]:
        sub = tr[np.arange(B) % T_LANES, :T_SCALING_ACCESSES]
        cfg = DeviceWTinyLFU(F_CAPACITY, assoc=F_ASSOC, streams=B)
        state, hits, launch_ms, stream_ms = timed_launches(
            sub[0] if B == 1 else sub, cfg, F_CHUNK, 0, fn)
        nbytes = sum(v.numel() * v.element_size() for v in state.values())
        if B > T_LANES:
            twins = np.arange(T_LANES, B)
            check(bool(torch.equal(hits[twins], hits[twins % T_LANES])),
                  f"scaling B={B}: lanes replaying one trace differ")
        if B == 1:
            check(one is None or (bool(torch.equal(hits, one[1]))
                                  and digest(state) == one[0]),
                  "scaling: the lane kernel at one lane differs from the "
                  "single-stream kernel")
            one = (digest(state), hits)
        dev_ms = sum(launch_ms)
        agg.setdefault(B, B * T_SCALING_ACCESSES / dev_ms * 1e3)
        kind = "lane kernel" if fn else "kernel"
        print(f"phase 16 B={B:<3d} {kind:11s} {dev_ms / len(launch_ms):.4f} "
              f"ms per launch, {dev_ms * 1e6 / T_SCALING_ACCESSES:.0f} ns per "
              f"access per lane, {B * T_SCALING_ACCESSES / dev_ms * 1e3:,.0f} "
              f"acc/s aggregate (kernel time, {len(launch_ms)} launches); "
              f"idle share {1 - dev_ms / stream_ms:.6f}; state {nbytes} "
              f"bytes ({nbytes / 2**20:.1f} MiB, {nbytes / 50e6:.2f}x the "
              f"50 MB L2)")
        del state, hits
        torch.cuda.empty_cache()
    print(f"phase 16 scaling_1_to_64 {agg[64] / agg[1]:.2f} (aggregate "
          f"acc/s at 64 lanes over 1 stream); card {card}")


def sweep_phase17(f_trace, card):
    """Phase 17: run W, simulate_sweep over F's trace as lanes of one run
    (mode="vmap", the launch counts set to 0 just before and read just
    after) and one configuration after another (mode="sequential"): the
    sequential (65,536, 0.01) row is F; two vmap rows must equal solo runs
    of their padded configuration."""
    import torch
    from repro_torch.core.device_simulate import (DeviceWTinyLFU,
                                                  _padded_grid, _trace_lanes,
                                                  run_chunks, simulate_sweep)
    from repro_torch.kernels import sketch_step as ks
    kw = dict(window_fracs=W_FRACS, assoc=F_ASSOC, warmup=F_WARMUP,
              chunk=F_CHUNK, trace_name="zipf-1.2M")
    seq = simulate_sweep(f_trace, W_CAPS, mode="sequential", **kw)
    set_launches(0)
    vm = simulate_sweep(f_trace, W_CAPS, mode="vmap", **kw)
    launches = read_launches()
    nchunks = math.ceil(len(f_trace) / F_CHUNK)
    check(launches["sketch_step"] == nchunks
          and sum(launches.values()) == nchunks, f"W: launches {launches}")
    key = [(r.cache_size, r.extra["window_frac"]) for r in seq]
    check(seq[key.index((65_536, 0.01))].hits == F_HITS,
          "W: the sequential (65536, 0.01) row differs from F")
    grid = [DeviceWTinyLFU(C, window_frac=wf, assoc=F_ASSOC)
            for C in W_CAPS for wf in W_FRACS]
    spec, states = _padded_grid(grid, "cuda")
    nbytes = sum(v.numel() * v.element_size() for s in states
                 for v in s.values())
    lo, hi = _trace_lanes(f_trace, "cuda")
    for cw in ((32_768, 0.01), (131_072, 0.2)):
        g = key.index(cw)
        st, _ = run_chunks(spec, grid[g].params(warmup=F_WARMUP,
                                                device="cuda"),
                           states[g], lo, hi, F_CHUNK)
        check(int(st["regs"][ks.R_HITS]) == vm[g].hits,
              f"W: the vmap row {cw} differs from its padded solo run")
    for s_row, v_row in zip(seq, vm):
        print(f"phase 17 W: C={s_row.cache_size:<6d} wf="
              f"{s_row.extra['window_frac']:<4} vmap hits {v_row.hits} "
              f"(ratio {v_row.hit_ratio:.6f}), sequential {s_row.hits} "
              f"(ratio {s_row.hit_ratio:.6f})")
    v_wall, s_wall = vm[0].extra["grid_wall_s"], seq[0].extra["grid_wall_s"]
    n = len(grid) * len(f_trace)
    print(f"phase 17 W: vmap {len(grid)} lanes padded to C={max(W_CAPS)}'s "
          f"geometry ({nbytes} bytes of state, {nbytes / 2**20:.1f} MiB): "
          f"wall {v_wall:.3f} s, {n / v_wall:,.0f} acc/s aggregate, "
          f"{launches['sketch_step']} launches; sequential {s_wall:.3f} s, "
          f"{n / s_wall:,.0f} acc/s ({s_wall / v_wall:.2f}x the vmap wall); "
          f"the (65536, 0.01) sequential row == F; vmap rows (32768, 0.01) "
          f"and (131072, 0.2) == their padded solo runs; card {card}")
    del states
    torch.cuda.empty_cache()


def host_phase18(card, device_rates):
    """Phase 18: P1's admitting policies through default-constructed
    caches (the host sketch; no kernel launch, counts set to 0 just before
    and read just after); every PrefixCacheStats field must equal the
    default JAX cache's."""
    import dataclasses
    from repro_torch.serve import PrefixCache
    from repro_torch.traces.synthetic import multi_tenant_prompt_trace
    p1 = multi_tenant_prompt_trace(**P1_TRACE)
    for policy in ("tinylfu", "wtinylfu"):
        for cap in P1_CAPS:
            pc = PrefixCache(cap, policy=policy)
            set_launches(0)
            t0 = time.perf_counter()
            stats = replay(pc, p1)
            wall = time.perf_counter() - t0
            launches = read_launches()
            got = dataclasses.astuple(stats)
            want = P1_HOST_PINS[(policy, cap)]
            check(got == want, f"P1-host {policy} C={cap}: stats {got} != "
                  f"JAX {want}")
            check(sum(launches.values()) == 0,
                  f"P1-host {policy} C={cap}: launches {launches}")
            decisions = stats.admitted + stats.rejected
            print(f"phase 18 P1-host {policy:8s} C={cap:<5d} stats == JAX "
                  f"(default PrefixCache, host sketch), hit ratio "
                  f"{stats.hit_ratio:.6f}; wall {wall:.3f} s, "
                  f"{len(p1) / wall:,.0f} block accesses/s, "
                  f"{decisions / wall:,.0f} decisions/s (device sketch, "
                  f"phase 9: {device_rates[('P1', policy, cap)]:,.0f}); no "
                  f"launch; {card}")


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
    builds = SOURCES + PROBES
    with ThreadPoolExecutor(len(builds)) as ex:      # one nvcc per source
        list(ex.map(_build.load_library, builds))
    print(f"phase 1  build of {len(builds)} sources in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for name in builds:
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
    for i, (name, kw, pargs, wcap, mcap, kind, n,
            chunk) in enumerate(HAZARD_CASES):
        spec = ks.StepSpec(**kw)
        params = ks.make_step_params(*pargs, counter_bits=spec.counter_bits,
                                     device="cuda")
        cases.append((f"hazard: {name}", (spec, params, wcap, mcap),
                      hazard_keys(kind, n, seed=i), chunk))
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
    p_rates = serving_phase9(card)

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
    stats = add_schedule_stats(f_trace, s_cfg)
    tiles = [t for batch in stats for t in batch]
    chain = max(max(t[2] for t in batch) for batch in stats)
    several = max(t[3] for t in tiles)
    print(f"phase 10 add schedule of S (check_runs.add_schedule, the numpy "
          f"model; its final state == S's pin): per {ADD_TILE}-key tile "
          f"{np.mean([t[0] for t in tiles]):.1f} gated keys in "
          f"{np.mean([t[1] for t in tiles]):.1f} components; longest "
          f"sequential chain (the largest component's keys) {chain} in a "
          f"tile, {max(sum(t[2] for t in batch) for batch in stats)} over a "
          f"{S_BATCH}-key batch's {-(-S_BATCH // ADD_TILE)} tiles in order; "
          f"largest component of several keys {several}; beside the bound "
          f"{bounds['sketch_update'][0]:.6f} ms and the kernel's "
          f"{s_ms['sketch_update']:.4f} ms")
    floor = launch_floor_us()
    print(f"phase 10 launch floor: an empty launch (l2_chase, 0 steps) "
          f"{floor:.2f} us of device time; at S's shapes "
          + ", ".join(f"{k} {s_ms[k] * 1e3:.2f} us "
                      f"({s_ms[k] * 1e3 / floor:.1f}x)"
                      for k in SKETCH_KERNELS) + f"; card {card}")
    path_sweep(f_trace, s_cfg, card)

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

    # -- phases 11-13: the LLM serving path ------------------------------
    flash_err = flash_phase11()
    flash_launches, flash = llm_phase12(card)
    gc.collect()
    torch.cuda.empty_cache()
    llm_phase13(card)
    gc.collect()
    torch.cuda.empty_cache()

    # -- phases 14-18: tenant lanes, sweeps, the host sketch ---------------
    lane_err = lanes_phase14()
    tr = t_trace(f_trace)
    t_launches, t_ms, t_bound_ms = tenant_phase15(tr, card)
    scaling_phase16(tr, card)
    del tr
    sweep_phase17(f_trace, card)
    host_phase18(card, p_rates)
    kernels[0].update(max_abs_err=max(max_err, lane_err),
                      matches_plain=max(max_err, lane_err) == 0,
                      lane_launches=t_launches, lane_max_abs_err=lane_err,
                      lane_ms=t_ms, lane_bound_ms=t_bound_ms)

    # -- phase 19: the kernels line ----------------------------------------
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:94",
        "launches": flash_launches, "max_abs_err": flash_err,
        "matches_plain": flash_err <= FLASH_TOL, **flash})
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

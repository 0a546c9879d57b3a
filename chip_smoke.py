#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the TinyLFU trace engine on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. print the card's name and power limit, build the step kernel from
   ``src/repro_torch/kernels/csrc`` and print its ptxas register/spill line;
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
   address, then the ``kernels`` JSON line, then the result line.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

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


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def digest(state: dict) -> str:
    """sha256 over the state leaves in sorted key order: the key's UTF-8
    bytes, then the leaf as contiguous little-endian int32; 16 hex chars."""
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k].cpu().numpy(),
                                      dtype="<i4").tobytes())
    return h.hexdigest()[:16]


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
    kernel_ms = [a.elapsed_time(b) for a, b in events]
    return state, hits, kernel_ms, events[0][0].elapsed_time(events[-1][1])


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
    _build.load_library()
    info = _build.build_info[("sketch_step", ())]
    nvcc = (f"nvcc {info['seconds']:.1f} s" if info["seconds"]
            else "built before; its ptxas log was kept")
    print(f"phase 1  build: {time.perf_counter() - t0:.1f} s ({nvcc})")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("phase 1  ptxas:", line.strip())

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
    t_state, t_hits, kernel_ms, stream_ms = timed_launches(
        f_trace, f_cfg, F_CHUNK, F_WARMUP)
    check(t_state["regs"].cpu().tolist() == F_REGS
          and digest(t_state) == F_DIGEST
          and bool((t_hits == hit_flags).all()),
          "F: the timed run differs from the main run")
    ms_chunk = sum(kernel_ms) / len(kernel_ms)
    idle = 1.0 - sum(kernel_ms) / stream_ms
    print(f"phase 5  F: kernel {ms_chunk:.4f} ms per launch (CUDA events "
          f"around each of {len(kernel_ms)} launches; min "
          f"{min(kernel_ms):.4f}, max {max(kernel_ms):.4f}), "
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

    kernels = [{
        "name": "sketch_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sketch_step.cu",
        "replaces": "src/repro/kernels/sketch_step.py:2314",
        "launches": launches, "max_abs_err": max_err,
        "matches_plain": max_err == 0, "ms": ms_chunk,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None}]
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

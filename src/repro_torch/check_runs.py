"""The check runs of the serving paths, their pinned JAX results, and the
helpers that drive them in either package.

``chip_smoke.py`` runs S, P, P1-host and L at full size on the card and
holds them to the pins below; ``tests/test_torch_sketch_ops.py``,
``tests/test_torch_prefix_cache.py``, ``tests/test_torch_host_sketch.py``,
``tests/test_torch_serving.py`` and ``tests/test_torch_models.py`` run the
same procedures at a small size against the JAX package, and, run as
scripts, print the JAX results that are pinned here.  The tenant-lane and
sweep runs T and W, their sharded counterparts F4, T4 and W4, the
adaptive-window runs FA, FA4, WA and GA, the policy panel's runs FP, GP and
WP with their JAX pins, the paper's trace families PF with the JAX and
reference host-engine pins, the hazard cases of the step and add kernels
(the step kernel's lane grid, sharded, adaptive and panel instances too)
and a numpy model of the add kernel's schedule live here as well.  Imports
numpy only.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np

# DeviceSketchConfig kwargs: the configurations of tests/test_kernels.py
SKETCH_CFGS = [dict(width=256, rows=4, cap=15, dk_bits=1024),
               dict(width=1024, rows=4, cap=7, dk_bits=4096),
               dict(width=512, rows=2, cap=15, dk_bits=0),
               dict(width=2048, rows=1, cap=3, dk_bits=2048)]

# The sketch kernels' edge geometries, beside SKETCH_CFGS: rows 1, 3 and 8
# (the reference's limit) x widths 8 and 16 (one and two counter words a
# row) x doorkeeper probes 0, 8, 9, 13 and 20 on a doorkeeper of one word
# (32 bits) or 1,024 bits, and three without a doorkeeper.  Every sketch
# kernel takes every one: the add past 8 probes through its loop instance
# (csrc/sketch_update.cu), whose plain version the CPU tests hold to the
# reference's numpy hashing twins at 9, 13 and 20 probes.
# tests/test_torch_sketch_edges.py holds the plain versions to the JAX
# package here, chip_smoke.py phase 7 and tests/test_torch_kernel_gpu.py
# the kernels to the plain versions.
SKETCH_EDGE_CFGS = [
    dict(width=w, rows=r, cap=15, dk_bits=32 if (r + p) % 2 else 1024,
         dk_probes=p)
    for r in (1, 3, 8) for w in (8, 16) for p in (0, 8, 9, 13, 20)] + [
    dict(width=8, rows=r, cap=7, dk_bits=0) for r in (1, 3, 8)]


def random_sketch(cfg, seed: int) -> dict:
    """Reference-layout numpy leaves of a random sketch of ``cfg``'s
    geometry (either package's DeviceSketchConfig): full-range counter
    words and a dense doorkeeper (each bit set with probability 31/32), so
    that keys of up to 20 probes pass it often enough to show."""
    rng = np.random.default_rng(seed)

    def words(*shape):
        return rng.integers(-2**31, 2**31, shape,
                            dtype=np.int64).astype(np.int32)
    dk = words(1, cfg.dk_words)
    for _ in range(4):
        dk |= words(1, cfg.dk_words)
    return {"counters": words(cfg.rows, cfg.words_per_row), "doorkeeper": dk,
            "size": np.array(1001, np.int32)}


# Run S: the batched sketch ops at the trace engine's real capacity.
# DeviceTinyLFU(S_BLOCKS) records zipf_trace(1_200_000, n_items=1_000_000,
# alpha=0.9, seed=11) in S_BATCH-key batches, then estimates its first
# S_DECISIONS keys and admits them against np.roll(cands, 1).  The pins are
# the JAX package's (ops with use_pallas=False, bit-equal to its Pallas
# kernels): state digest, resets, estimate digest, admitted count
# (``python tests/test_torch_sketch_ops.py`` prints them).
S_BLOCKS, S_BATCH, S_DECISIONS = 65_536, 4096, 50_000
S_PINS = ("b0683a28b7852844", 3, "f40dc4a77ca0f007", 17188)

# Runs P: benchmarks/bench_serving.py's replay through PrefixCache with the
# device sketch (device_sketch=True).  P1 is its full grid (lru / tinylfu /
# wtinylfu x P1_CAPS); P2 the same generator scaled to S's capacity,
# wtinylfu.  The pins are every PrefixCacheStats field (lookups,
# block_hits, block_misses, inserts, admitted, rejected, evicted) of the JAX
# PrefixCache with DeviceAdmission(use_pallas=False)
# (``python tests/test_torch_prefix_cache.py`` prints them).
P1_TRACE = dict(n_requests=6000, n_tenants=400, tenant_alpha=1.0, seed=81)
P1_CAPS = (1000, 2000, 4000)
P2_TRACE = dict(n_requests=30_000, n_tenants=4_000, tenant_alpha=1.0,
                seed=81)
P2_CAP = 65_536
P_PINS = {
    ("P1", "lru", 1000): (6779, 33236, 183667, 143909, 142909, 0, 142909),
    ("P1", "lru", 2000): (6779, 44339, 172564, 121745, 119745, 0, 119745),
    ("P1", "lru", 4000): (6779, 54812, 162091, 100251, 96251, 0, 96251),
    ("P1", "tinylfu", 1000): (6779, 45884, 171019, 120466, 3700, 115766,
                              3700),
    ("P1", "tinylfu", 2000): (6779, 55059, 161844, 103460, 2557, 98903,
                              2557),
    ("P1", "tinylfu", 4000): (6779, 63273, 153630, 87314, 1857, 81457,
                              1857),
    ("P1", "wtinylfu", 1000): (6779, 47856, 169047, 116584, 4719, 110865,
                               4719),
    ("P1", "wtinylfu", 2000): (6779, 55802, 161101, 103332, 2125, 99207,
                               2125),
    ("P1", "wtinylfu", 4000): (6779, 63346, 153557, 87308, 2459, 80849,
                               2459),
    ("P2", "wtinylfu", 65536): (33523, 334740, 737969, 376310, 1197, 309577,
                                1197),
}


# Run T: tenant lanes at run F's geometry, the reference's B=64 point of
# streams_acc_per_s_total (docs/BENCHMARKS.md).  DeviceWTinyLFU(65_536,
# assoc=8, streams=T_LANES) runs T_ACCESSES accesses per lane (warmup
# 480,000 per lane, chunk 512): lane 0 replays run F's trace
# (zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9, seed=11)) and must
# give F's JAX pins; lanes 1.. are tenant_lanes_trace(T_LANES - 1,
# T_ACCESSES, **T_TENANTS), and lanes T_SOLO must equal their solo runs.
# The lane-scaling phase runs the same geometry at T_SCALING lanes over the
# first T_SCALING_ACCESSES accesses of each lane (lane b replays lane
# b % T_LANES's trace).
T_LANES, T_ACCESSES = 64, 1_200_000
T_TENANTS = dict(n_items=1_000_000, alpha=0.9, tenant_alpha=1.0, seed=16)
T_SOLO = (1, 32, 63)
T_SCALING = (1, 8, 64, 132, 264)
T_SCALING_ACCESSES = 131_072

# Run W: simulate_sweep over run F's trace, W_CAPS x W_FRACS with assoc=8
# and warmup 480,000, as lanes of one run (mode="vmap": nine lanes padded to
# the largest configuration's geometry) and one run after another
# (mode="sequential", whose (65,536, 0.01) row is run F).
W_CAPS = (32_768, 65_536, 131_072)
W_FRACS = (0.01, 0.05, 0.2)

# Runs F4, T4 and W4: the sharded sketch (shards=SHARDS, kernel mode 1b) at
# run F's geometry, the reference's sharded benchmark point (assoc=8,
# shards=4: benchmarks/bench_device.py:347-370, docs/BENCHMARKS.md:40-42) at
# F's capacity and trace.  F4 is DeviceWTinyLFU(65_536, assoc=8, shards=4)
# over F's trace (warmup 480,000; auto merge epoch min(4096, W) = 4,096: 293
# step launches, 292 folds); F4I the same with integrity=True.  T4 is run T
# with shards=4 (lane 0 must give F4's pins, lanes T_SOLO their solo
# sharded runs).  W4 is simulate_sweep(F's trace, W_CAPS, window_fracs=
# (0.01,), assoc=8, shards=4, warmup=480,000), whose 65,536 row is F4.  The
# pins are the JAX engine's (backend="jit", bit-equal to its Pallas kernel):
# hits, registers, state digest (``python tests/test_torch_sharded.py``
# prints them).
SHARDS = 4
F4_EPOCH = 4096
F4_HITS = 455_655
F4_REGS = [413568, 0, 1200000, 455655, 0, 0, 0, 0]
F4_DIGEST = "0021147aefa66749"
# F4 in stale mesh mode (kernel mode 1e, merge_halve_mesh every epoch): the
# reference's stale step_ref and merge_halve_mesh under jax.vmap over the
# mesh axis (one device; the stale result does not depend on the mesh
# size): hits, regs, canonical state digest
# (``PYTHONPATH=src:tests python tests/test_torch_mesh.py`` prints them)
F4S_PINS = (453914, [413568, 0, 1200000, 453914, 0, 0, 0, 0],
            "ead61c444a9c6818")
F4I_DIGEST = "508ba2d17973ca92"
# G1's trace (zipf_trace(60_000, n_items=50_000, alpha=0.9, seed=7), C=200,
# warmup 10,000, flat tables, merge epoch 1,600) with shards=S: JAX hits
G1_SHARDED_HITS = {2: 17_709, 4: 17_695}

# Runs FA, FA4, WA and GA: the adaptive window (kernel mode 1c, the epoch
# hill climb and rebalance).  FA is run F's trace and geometry with
# adaptive=True and the default ClimbSpec (epoch 4,096: 293 step launches,
# 292 climbs and rebalances), the reference's adaptive benchmark point
# (assoc=8, adaptive=True: benchmarks/bench_device.py:327-344,
# docs/BENCHMARKS.md:38-39) at F's capacity and trace; FA4 the same with
# shards=4 (the fold rides the climb epochs).  WA is simulate_sweep(F's
# trace, [65,536], window_fracs=WA_FRACS, assoc=8, adaptive=True,
# warmup=480,000) as three lanes and one run after another; its 0.01 row is
# FA.  GA is the reference's adaptivity goldens (tests/test_adaptive.py:
# 383-396): GA_TRACES(120,000, seed=3) at C=800, assoc=8, the static rows
# at GA_FRACS and the default-ClimbSpec adaptive run, which must come within
# 0.01 of the best static row.  The pins are the JAX engine's (backend="jit",
# bit-equal to its Pallas kernel): hits, registers, state digest, final
# quota and the trajectory's digest (``python tests/test_torch_adaptive.py``
# prints them).
ADAPT_EPOCH = 4096
FA_HITS = 455_772
FA_REGS = [413568, 0, 1200000, 455772, 23, 0, 0, 2463]
FA_DIGEST = "2b8cc1ec1f0677d7"
FA_QUOTA = 23
FA_TRAJ = (292, "3b8bc07cb8c56922")
FA4_HITS = 455_816
FA4_REGS = [413568, 0, 1200000, 455816, 21, 0, 0, 2465]
FA4_DIGEST = "aa35e1096999966c"
FA4_QUOTA = 21
FA4_TRAJ = (292, "1b60785ea3e29449")
WA_FRACS = (0.01, 0.05, 0.2)
# window_frac -> (hits, final quota)
WA_PINS = {0.01: (455_772, 23), 0.05: (455_219, 2566),
           0.2: (453_776, 12397)}
GA_CAPACITY, GA_ACCESSES, GA_SEED = 800, 120_000, 3
GA_TRACES = ("fickle_churn_trace", "phase_shift_trace")
GA_FRACS = (0.01, 0.05, 0.10, 0.20, 0.40)
GA_GAP = 0.01
# trace -> (static hits at GA_FRACS, adaptive hits, final quota, digest)
GA_PINS = {
    "fickle_churn_trace": ((69_709, 69_339, 68_957, 68_778, 67_515), 69_841,
                           1, "7ce10e2949027991"),
    "phase_shift_trace": ((63_349, 64_721, 65_502, 65_256, 68_483), 69_224,
                          399, "4e95d713a7b19ce4"),
}


# Runs FP, GP and WP: the policy panel (kernel mode 1d).  FP is run F's
# trace, capacity and warmup through simulate_trace(..., assoc=8, policy=p)
# for each competitor, S3-FIFO at its documented small-queue share
# (window_frac 0.1; ARC and LFU have no window): the reference's panel
# benchmark (benchmarks/bench_device.py:463-495, docs/BENCHMARKS.md:58-61)
# at F's capacity and trace.  GP is the reference's golden panel
# (tests/test_policy_panel.py:175-202): all four policies on the golden Zipf
# (C=200, warmup 10,000), scan-then-hotspot (C=400, warmup 5,000) and the
# golden Zipf at C=1,000 with sample_factor=16 and 8-bit counters, where
# W-TinyLFU must be at least as good as every competitor; every hit ratio
# within GP_TOL of the reference's goldens.  WP is simulate_sweep(F's trace,
# [65,536], policies=POLICIES, window_fracs=(0.1,), assoc=8,
# warmup=480,000), sequential, whose competitor rows are FP's, and
# simulate_sweep(F's trace, WP_ARC_CAPS, policies=("arc",), assoc=8,
# warmup=480,000) as three lanes and one after another.  The pins are the
# JAX engine's (backend="jit", bit-equal to its Pallas kernel): hits,
# registers, state digest (``python tests/test_torch_policy_panel.py``
# prints them).
PANEL_POLICIES = ("s3fifo", "arc", "lfu")
PANEL_FRACS = {"wtinylfu": 0.01, "s3fifo": 0.1, "arc": 0.01, "lfu": 0.01}
FP_PINS = {
    "s3fifo": (458_580, [413568, 0, 1200000, 458580, 0, 0, 0, 0],
               "df4e7d26401c5a9c"),
    "arc": (454_185, [0, 0, 1200000, 454185, 18223, 18223, 45506, 32008],
            "68c9ad8c13b472e3"),
    "lfu": (439_592, [413568, 0, 1200000, 439592, 0, 0, 0, 0],
            "27a97d031433f2af"),
}
# (trace, capacity, warmup, DeviceWTinyLFU kwargs) -> hits per policy
GP_RUNS = [("zipf", 200, 10_000, {}), ("scanhot", 400, 5_000, {}),
           ("zipf", 1_000, 10_000, dict(sample_factor=16, counter_bits=8))]
GP_PINS = [
    {"wtinylfu": 17_035, "s3fifo": 17_349, "arc": 17_585, "lfu": 13_497},
    {"wtinylfu": 26_402, "s3fifo": 26_345, "arc": 26_323, "lfu": 25_577},
    {"wtinylfu": 24_501, "s3fifo": 24_358, "arc": 24_083, "lfu": 23_337},
]
# the reference's golden hit ratios (tests/test_policy_panel.py:52-57) of
# the first two GP runs, and its band
GP_GOLDENS = [{"wtinylfu": 0.3407, "s3fifo": 0.3470, "arc": 0.3517,
               "lfu": 0.2699},
              {"wtinylfu": 0.4800, "s3fifo": 0.4790, "arc": 0.4786,
               "lfu": 0.4650}]
GP_TOL = 0.01
GP_REF_CAPACITY = 8_192         # the reference benchmark's own point
WP_WTINYLFU_HITS = 454_639      # W-TinyLFU at window_frac 0.1
WP_ARC_CAPS = (32_768, 65_536, 131_072)


def trajectory_digest(traj: dict) -> str:
    """sha256 of a run's ``extra["trajectory"]`` (epoch length, per-epoch
    hits and quotas as JSON lists); 16 hex chars."""
    body = [int(traj["epoch_len"]), traj["epoch_hits"], traj["quota"]]
    return hashlib.sha256(json.dumps(body).encode()).hexdigest()[:16]


# The step kernel's adaptive instances (kernel mode 1c): chip_smoke.py phase
# 23 and tests/test_torch_kernel_gpu.py hold them to step_ref on the card,
# tests/test_torch_adaptive.py holds step_ref to the JAX step_ref on the
# CPU, with rebalance (and merge_halve when sharded) between epochs; every
# state leaf and hit flag.  Each case is (name, StepSpec kwargs without
# adaptive, the make_step_params args of every lane (one row: shared; LANES
# rows: per lane, with lane_n_valid's counts), window_cap, main_cap, hazard
# trace kind, accesses per lane, epoch, the quotas of the rebalances in turn
# (an int, or one per lane)).  The quotas go up and down, cross the window
# set count (uniform against load-aware window ways) and run into both
# clamps.
_AFLAT = dict(width=256, rows=4, dk_bits=1024, window_slots=30,
              main_slots=60)
_A8 = dict(width=512, rows=3, dk_bits=2048, window_slots=64, main_slots=64,
           assoc=8)
_A16 = dict(width=256, rows=4, dk_bits=0, window_slots=64, main_slots=64,
            assoc=16, counter_bits=8)
# DeviceWTinyLFU(65_536, assoc=8, adaptive=True).spec(): run FA's geometry
_FA_SPEC = dict(width=131_072, rows=4, dk_bits=2_097_152,
                window_slots=32_768, main_slots=65_536, assoc=16)
ADAPT_CASES = [
    ("flat cb4 dk", _AFLAT, [(3, 57, 45, 300, 7, 0)], 3, 57, "skewed", 900,
     128, [10, 2, 25, 1, 29, 40]),
    ("flat cb8 no-dk", dict(_AFLAT, dk_bits=0, counter_bits=8),
     [(6, 54, 43, 200, 30, 0)], 6, 54, "runs", 900, 150, [20, 3, 1, 12, 6]),
    ("ways 8 cb4 dk", _A8, [(20, 44, 35, 200, 7, 0)], 20, 44, "skewed",
     900, 128, [30, 3, 60, 1, 12, 5]),
    ("ways 16 cb8 no-dk", _A16, [(5, 59, 47, 300, 30, 0)], 5, 59,
     "alternating", 900, 128, [2, 9, 40, 3, 63, 1]),
    ("hazard runs, ways 8", _A8, [(8, 56, 44, 64, 7, 0)], 8, 56, "runs", 800,
     100, [1, 5, 30, 2, 16, 60, 4]),
    ("ways 8 lanes, per-lane params and quotas", _A8,
     [(20, 44, 35, 200, 7, 0), (6, 58, 40, 64, 7, 0),
      (30, 34, 27, 250, 7, 100), (2, 62, 10, 50, 7, 0)], 20, 44, "skewed",
     400, 100, [[3, 30, 1, 60], [12, 2, 40, 7], [60, 5, 9, 2]]),
    ("flat lanes, per-lane params and quotas", _AFLAT,
     [(3, 57, 45, 300, 7, 0), (10, 50, 30, 200, 7, 50),
      (3, 57, 45, 500, 3, 0), (20, 40, 10, 100, 7, 10)], 3, 57, "skewed",
     400, 100, [[10, 2, 25, 1], [1, 29, 5, 40], [7, 7, 7, 7]]),
    ("ways 8 cb4 dk, shards 4", dict(_A8, shards=SHARDS),
     [(20, 44, 35, 64, 7, 0)], 20, 44, "skewed", 800, 128,
     [30, 3, 60, 1, 12, 5]),
    ("FA geometry", _FA_SPEC, [(655, 64_881, 51_904, 524_288, 7, 0)], 655,
     64_881, "wide", ADAPT_EPOCH, ADAPT_EPOCH // 2, [1_000, 3_000]),
]


# Run P1-host: P1's admitting policies through default-constructed caches
# (PrefixCache(cap, policy=...): the host sketch, as bench_serving.py builds
# them; no kernel launch).  The pins are every PrefixCacheStats field of the
# default JAX PrefixCache (``python tests/test_torch_host_sketch.py``
# prints them).
P1_HOST_PINS = {
    ("tinylfu", 1000): (6779, 45981, 170922, 120826, 3162, 116664, 3162),
    ("tinylfu", 2000): (6779, 55143, 161760, 103569, 2582, 98987, 2582),
    ("tinylfu", 4000): (6779, 63040, 153863, 87382, 1863, 81519, 1863),
    ("wtinylfu", 1000): (6779, 47727, 169176, 116729, 4959, 110770, 4959),
    ("wtinylfu", 2000): (6779, 55621, 161282, 103320, 2336, 98984, 2336),
    ("wtinylfu", 4000): (6779, 63231, 153672, 87280, 2473, 80807, 2473),
}

# Runs PF: the paper's trace families at the full sizes of the reference's
# benchmark scripts (bench_youtube.py:25, bench_wiki.py:14,
# bench_traces.py:23-24), each at one capacity of its script with the
# script's sample factor and warmup share.  cell -> (generator of
# repro_torch.traces.synthetic, its kwargs, capacity, sample_factor, warmup
# share).  On the card: simulate_trace(trace, C, sample_factor=sf,
# warmup=w) at assoc=PF_ASSOC and on the exact flat tables; on the host:
# WTinyLFU(C, sample_factor=sf) and WTinyLFU(..., assoc=PF_ASSOC) through
# run_trace, and on PF_CAST_CELL bench_traces.py's cast (pf_cast).  The
# device pins are the JAX engine's (backend="jit", bit-equal to its Pallas
# kernel): hits, registers and state digest; the host pins the reference
# host engine's hits; PF_TRACE_SHA256 the sha256 of the reference
# generators' int64 keys (``PYTHONPATH=src python
# tests/test_torch_paper_traces.py`` prints them all, ~5 min).
PF_CELLS = {
    "PF-yt": ("youtube_dynamic_trace",
              dict(length=800_000, weeks=21, items_per_week=8000,
                   churn=0.4, seed=22), 1_000, 9, 0.1),
    "PF-wiki": ("wiki_drift_trace",
                dict(length=1_000_000, n_items=400_000, alpha=0.9,
                     drift_every=20_000, drift_frac=0.02, seed=31),
                1_000, 8, 0.2),
    "PF-spc1": ("spc1_like_trace", dict(length=900_000, seed=42), 4_096, 8,
                0.1),
    "PF-oltp": ("oltp_like_trace", dict(length=900_000, seed=43), 1_024, 8,
                0.1),
}
PF_ASSOC = 8
# the reference's host-vs-device bands (tests/test_device_simulate.py:20,
# 148): the flat tables against the host engine, the set tables against it
PF_TOL = {None: 0.005, PF_ASSOC: 0.01}
PF_CAST_CELL = "PF-spc1"
PF_CAST = ("LRU", "ARC", "LIRS", "2Q", "TLRU", "W-TinyLFU", "W-TinyLFU(20%)")
PF_TRACE_SHA256 = {
    "PF-yt":
        "108de65bb0a82393c87ad3b3aee49006cf2ecdfaf1c7518b073cbdfa82e3579b",
    "PF-wiki":
        "4f3e14f6900e5c422e5afd50c3d3563b7ad6ea9af997fec1627a658a6054d285",
    "PF-spc1":
        "8282cc1bc47f47f9cac81907837ed15e0ad7fca532c05795f3260542a302e364",
    "PF-oltp":
        "3bfdaca956e1431c16314d9ac53a89f55e3870a5ec854f69d6b6616772a501b7",
}
# (cell, assoc) -> (hits, regs, digest)
PF_PINS = {
    ("PF-yt", None):
        (433686, [7995, 792, 799995, 433686, 0, 0, 0, 0], "90d11af745f2ac02"),
    ("PF-yt", 8):
        (437073, [7995, 0, 799995, 437073, 0, 0, 0, 0], "a7ea4e6c8b73785c"),
    ("PF-wiki", None):
        (289700, [4000, 792, 1000000, 289700, 0, 0, 0, 0], "1507a060d141d167"),
    ("PF-wiki", 8):
        (285085, [4000, 0, 1000000, 285085, 0, 0, 0, 0], "a9539104f5e25bc9"),
    ("PF-spc1", None): (164190, [31648, 2532, 900000, 164190, 0, 0, 0, 0],
                        "ef68fb31089f4490"),
    ("PF-spc1", 8):
        (163656, [31648, 0, 900000, 163656, 0, 0, 0, 0], "fb4ae256e4ecba01"),
    ("PF-oltp", None):
        (443814, [7072, 811, 900000, 443814, 0, 0, 0, 0], "31cdfd7ebecb7387"),
    ("PF-oltp", 8):
        (446349, [7072, 0, 900000, 446349, 0, 0, 0, 0], "0156512d3a221462"),
}
# (cell, assoc) -> hits of the host engine; cast name -> hits on PF_CAST_CELL
PF_HOST_PINS = {
    ("PF-yt", None): 433564,
    ("PF-yt", 8): 436991,
    ("PF-wiki", None): 289833,
    ("PF-wiki", 8): 285310,
    ("PF-spc1", None): 163889,
    ("PF-spc1", 8): 163613,
    ("PF-oltp", None): 444177,
    ("PF-oltp", 8): 446689,
}
PF_CAST_PINS = {
    "LRU": 123544,
    "ARC": 165901,
    "LIRS": 174034,
    "2Q": 156688,
    "TLRU": 144170,
    "W-TinyLFU": 163889,
    "W-TinyLFU(20%)": 162774,
}
# (cell, twin name) -> sha256 (16 hex) of the reference's per-access flags
# of tests/test_torch_host_engine.py's set-associative twins on the cell's
# first 6,000 accesses
PF_TWIN_FLAGS_SHA256 = {
    ("PF-yt", "slru-assoc"): "274d597506da55bb",
    ("PF-yt", "w-tinylfu assoc 8"): "57ab5a6c79e9caa3",
    ("PF-yt", "w-tinylfu assoc 4 shards 2"): "b2dc0364f1592c44",
    ("PF-yt", "s3fifo-assoc"): "e10edf2f37e96359",
    ("PF-yt", "arc-assoc"): "385152d203d217bb",
    ("PF-yt", "lfu-assoc"): "5616961be2db3af7",
    ("PF-wiki", "slru-assoc"): "32c3fcd5db693e99",
    ("PF-wiki", "w-tinylfu assoc 8"): "c455bb67de174892",
    ("PF-wiki", "w-tinylfu assoc 4 shards 2"): "1d76dd9517ab74b3",
    ("PF-wiki", "s3fifo-assoc"): "6c6de7cf402e089a",
    ("PF-wiki", "arc-assoc"): "5b45e55c7a3275b8",
    ("PF-wiki", "lfu-assoc"): "85b9b58c8395f5d0",
    ("PF-spc1", "slru-assoc"): "c29faeb0f5417777",
    ("PF-spc1", "w-tinylfu assoc 8"): "800d5af7548169b6",
    ("PF-spc1", "w-tinylfu assoc 4 shards 2"): "26ed3ba597221413",
    ("PF-spc1", "s3fifo-assoc"): "6b98e8e6bba594d4",
    ("PF-spc1", "arc-assoc"): "b089b75dec76fda7",
    ("PF-spc1", "lfu-assoc"): "d2bb9a356b19c3c0",
    ("PF-oltp", "slru-assoc"): "7470b618aec98dff",
    ("PF-oltp", "w-tinylfu assoc 8"): "dc75711758df70d7",
    ("PF-oltp", "w-tinylfu assoc 4 shards 2"): "15ccf9a80701b63a",
    ("PF-oltp", "s3fifo-assoc"): "fa41d4a85088f38e",
    ("PF-oltp", "arc-assoc"): "92d9792eafda9826",
    ("PF-oltp", "lfu-assoc"): "c916c761d37fa699",
}


def pf_trace(cell: str) -> np.ndarray:
    """The int64 keys of PF cell ``cell`` (the port's generator)."""
    from repro_torch.traces import synthetic
    gen, kw, *_ = PF_CELLS[cell]
    return getattr(synthetic, gen)(**kw)


def pf_warmup(cell: str, trace: np.ndarray) -> int:
    """The cell's warmup over ``trace`` (its script's int(len * share))."""
    return int(len(trace) * PF_CELLS[cell][4])


def trace_sha256(trace: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        trace, dtype="<i8").tobytes()).hexdigest()


def pf_cast(core, sample_factor: int) -> dict:
    """bench_traces.py's cast (benchmarks/common.py policy_factories, the
    PF_CAST names) over the host-engine package ``core``: name ->
    factory(capacity)."""
    sf = sample_factor
    return {
        "LRU": lambda C: core.Cache(core.LRUEviction(C)),
        "ARC": lambda C: core.ARC(C),
        "LIRS": lambda C: core.LIRS(C),
        "2Q": lambda C: core.TwoQ(C),
        "TLRU": lambda C: core.tinylfu_cache(C, "lru", sample_factor=sf),
        "W-TinyLFU": lambda C: core.WTinyLFU(C, sample_factor=sf),
        "W-TinyLFU(20%)": lambda C: core.WTinyLFU(C, window_frac=0.20,
                                                  sample_factor=sf),
    }


def pf_host_run(cell: str, policy, core=None):
    """One host-engine run of PF cell ``cell``: ``policy`` an assoc (None
    or PF_ASSOC: W-TinyLFU) or a PF_CAST name, through ``core`` (default
    the port's) and ``run_trace`` with the cell's warmup.  Returns (hits,
    counted accesses, seconds)."""
    import time
    if core is None:
        from repro_torch import core
    trace = pf_trace(cell)
    _, _, cap, sf, _ = PF_CELLS[cell]
    if isinstance(policy, str):
        cache = pf_cast(core, sf)[policy](cap)
    else:
        cache = core.WTinyLFU(cap, sample_factor=sf, assoc=policy)
    t0 = time.perf_counter()
    r = core.run_trace(cache, trace, warmup=pf_warmup(cell, trace),
                       trace_name=cell)
    return r.hits, r.accesses, time.perf_counter() - t0


# Runs FD: the reference's fault drills at their own sizes
# (tests/test_faults.py:83-145), through DeviceWTinyLFU.run(...,
# fault_hook=fd_hook(name, faults, cfg.spec()), checkpoint_every=...).
# "flip" flips a window and a main cache-table word at 4,096 (the main word
# is a record's stored doorkeeper bit, which the victim's estimate then
# reads far out of range: the reference's gathers clamp such an index, and
# so does the port); "probes" flips bit 30 or 31 of every stored probe of
# both tables at 4,096 (not a reference drill: the clamp everywhere);
# "quarantine"
# flips a bit of shard 1's global sketch slice at 12,800 (integrity=True:
# caught at the next fold, the shard quarantined once); "loss" zeroes shard
# 0's global slice at 19,200 and 38,400.  Each is (zipf_trace kwargs,
# capacity, DeviceWTinyLFU kwargs, warmup, checkpoint_every).  The pins are
# the JAX engine's runs under the same hook (repro.core.faults; backend
# "jit", bit-equal to its Pallas kernel): hits and state digest
# (``PYTHONPATH=src python tests/test_torch_faults.py`` prints them).  The
# reference's own bounds hold too: the flips' hit ratios within
# FD_FLIP_TOL of the run without them, the golden drills' within GP_TOL of FD_GOLDEN,
# and the quarantine's last 20,000 accesses within GP_TOL of the run
# without the flip.
_FD_GOLDEN_TRACE = dict(length=60_000, n_items=50_000, alpha=0.9, seed=7)
FD_DRILLS = {
    "flip": (dict(length=10_000, n_items=1_500, alpha=0.9, seed=6), 300,
             dict(assoc=8), 1_000, 2_048),
    "probes": (dict(length=10_000, n_items=1_500, alpha=0.9, seed=6), 300,
               dict(assoc=8), 1_000, 2_048),
    "quarantine": (_FD_GOLDEN_TRACE, 200,
                   dict(shards=2, merge_every=1_600, integrity=True), 10_000,
                   3_200),
    "loss": (_FD_GOLDEN_TRACE, 200, dict(shards=2, merge_every=1_600),
             10_000, 3_200),
    # table addresses out of range: every window record's stored main
    # sets, or every main record's ARC ghost positions (table_flips)
    "sets": (dict(length=10_000, n_items=1_500, alpha=0.9, seed=6), 300,
             dict(assoc=8), 1_000, 2_048),
    "sets-adaptive": (dict(length=10_000, n_items=1_500, alpha=0.9, seed=6),
                      300, dict(assoc=8, adaptive=True), 1_000, 4_096),
    "sets-s3fifo": (dict(length=10_000, n_items=1_500, alpha=0.9, seed=6),
                    300, dict(assoc=8, policy="s3fifo", window_frac=0.1),
                    1_000, 2_048),
    "ghost-arc": (dict(length=10_000, n_items=1_500, alpha=0.9, seed=6), 300,
                  dict(assoc=8, policy="arc"), 1_000, 2_048),
}
FD_GOLDEN = 0.3498
FD_FLIP_TOL = 0.02
# the table drills held within FD_FLIP_TOL of the run without the fault (ARC
# with every ghost position out of range loses its ghost lists' memory and
# falls 0.024 below, in the JAX engine as in the port: no bound)
FD_FLIP_BOUNDED = ("flip", "probes", "sets", "sets-adaptive", "sets-s3fifo")
FD_TAIL = 20_000
FD_PINS = {"flip": (6105, "b15ce7193ba01595"),
           "probes": (6106, "bb23e1ba5135a613"),
           "quarantine": (17729, "ca22b61a610bd4c0"),
           "loss": (17705, "15c871b27f957b68"),
           "sets": (6107, "fbaa7ef359cbdefe"),
           "sets-adaptive": (6138, "eecbf17b728568dd"),
           "sets-s3fifo": (6092, "8183a4265f2520e3"),
           "ghost-arc": (5824, "bcfd5a888601ca73")}


def stored_probe_flips(spec, key: str) -> list:
    """(flat index, bit) flips of bits 30 and 31, by turns, in every
    stored probe of table ``key`` (the counter probes and doorkeeper bits a
    record keeps: ``wtab``/``mtab`` columns, or the flat ``widx``, ``wdkb``,
    ``midx``, ``mdkb`` leaves)."""
    if spec.assoc is None:
        n = spec.window_slots if key[0] == "w" else spec.main_slots
        per = spec.rows if key.endswith("idx") else spec.dkp
        return [(i, 30 + i % 2) for i in range(n * per)]
    n, cols, c0 = ((spec.window_slots, spec.wcols, 5) if key == "wtab"
                   else (spec.main_slots, spec.mcols, 3))
    return [(r * cols + c, 30 + (r + c) % 2) for r in range(n)
            for c in range(c0, c0 + spec.rows + spec.dkp)]


def corrupt_stored_probes(faults, spec, state: dict) -> dict:
    """``state`` with every stored probe of both tables flipped
    (:func:`stored_probe_flips`), through ``faults.flip_words``."""
    keys = (("widx", "wdkb", "midx", "mdkb") if spec.assoc is None
            else ("wtab", "mtab"))
    for k in keys:
        state = faults.flip_words(state, k, stored_probe_flips(spec, k))
    return state


def fd_hook(name: str, faults, spec):
    """The fault hook of drill ``name``, built on ``faults`` (the port's
    ``repro_torch.core.faults`` or the reference's, for its pins) and the
    run's StepSpec ``spec``."""
    def hook(cursor, state):
        if name == "flip" and cursor == 4_096:
            state = faults.flip_words(state, "wtab", [(1, 4)])
            return faults.flip_words(state, "mtab", [(7, 30)])
        if name == "probes" and cursor == 4_096:
            return corrupt_stored_probes(faults, spec, state)
        if name == "quarantine" and cursor == 12_800:
            return faults.flip_words(state, "counters",
                                     [(spec.wps_shard, 2)])
        if name == "loss" and cursor in (19_200, 38_400):
            return faults.drop_shard_delta(spec, state, 0, half="global")
        if name in ("sets", "sets-adaptive", "sets-s3fifo",
                    "ghost-arc") and cursor == 4_096:
            return faults.flip_words(state, *table_flips(
                spec, "ghost" if name == "ghost-arc" else "sets"))
        return None
    return hook


def digest(state: dict) -> str:
    """sha256 over the state leaves in sorted key order: the key's UTF-8
    bytes, then the leaf (a tensor on any device) as contiguous
    little-endian int32; 16 hex chars."""
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k].cpu().numpy(),
                                      dtype="<i4").tobytes())
    return h.hexdigest()[:16]


def mixed_keys(seed: int, n: int) -> np.ndarray:
    """Half from 40 keys (repeats pass the doorkeeper and bump counters),
    half from 2^63."""
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 40, size=n, dtype=np.uint64)
    big = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
    return np.where(rng.random(n) < 0.5, small, big)


# The add kernel's batch update (csrc/sketch_update.cu) runs a batch as
# tiles of ADD_TILE keys.  ADD_HAZARD_CASES are the batches on which its
# schedule could go wrong: tests/test_torch_add_schedule.py holds
# add_schedule (a numpy model of that schedule) to the JAX add_ref on the
# CPU, and chip_smoke.py phase 7 and tests/test_torch_kernel_gpu.py hold the
# kernel to the port's add_ref on the card.  Each case is (name,
# DeviceSketchConfig kwargs, key kind, batch sizes); the batches are added
# one after another to one sketch, so every batch after the first lands on
# a sketch an earlier batch filled.  Key kinds: ``mixed`` (mixed_keys),
# ``one`` (one key, every time).
ADD_TILE = 1024
ADD_HAZARD_CASES = [
    ("width 8, every key collides", dict(width=8, rows=4, cap=15,
                                         dk_bits=1024), "mixed", (300, 300)),
    ("width 8, no doorkeeper", dict(width=8, rows=4, cap=15, dk_bits=0),
     "mixed", (300, 300)),
    ("dk_bits 32, shared doorkeeper words", dict(width=256, rows=4, cap=15,
                                                 dk_bits=32),
     "mixed", (300, 300)),
    ("one key x200, cap 7", dict(width=256, cap=7, dk_bits=1024), "one",
     (200, 200)),
    ("one key x200, cap 15", dict(width=256, cap=15, dk_bits=1024), "one",
     (200, 200)),
    ("one key x200, cap 7, no doorkeeper", dict(width=256, cap=7, dk_bits=0),
     "one", (200, 200)),
    ("one key x200, cap 15, no doorkeeper", dict(width=256, cap=15,
                                                 dk_bits=0), "one",
     (200, 200)),
    ("10,000 keys across tiles", dict(width=1024, rows=4, cap=7,
                                      dk_bits=4096), "mixed", (10_000,)),
    ("tile - 1", dict(width=1024, rows=4, cap=7, dk_bits=4096), "mixed",
     (ADD_TILE - 1, ADD_TILE - 1)),
    ("tile + 1", dict(width=1024, rows=4, cap=7, dk_bits=4096), "mixed",
     (ADD_TILE + 1, ADD_TILE + 1)),
    ("a batch of 1", dict(width=1024, rows=4, cap=7, dk_bits=4096), "mixed",
     (300, 1, 1)),
    ("mixed keys at S's geometry", dict(width=262_144, rows=4, cap=7,
                                        dk_bits=2_097_152), "mixed",
     (4096, 4096)),
]


# Batch sizes at which chip_smoke.py phase 7 and tests/test_torch_kernel_gpu.py
# hold both paths of the admit kernel (a warp per pair, a thread per pair)
# to admission_ref on the card: the serving path's one pair, a warp's worth
# either side of 32, and run S's 50,000.
ADMIT_SIZES = (1, 2, 31, 32, 33, 50_000)


def add_hazard_batches(case: int) -> list:
    """The uint64 key batches of ADD_HAZARD_CASES[case]."""
    _, _, kind, sizes = ADD_HAZARD_CASES[case]
    if kind == "one":
        return [np.full(n, 123_456_789, np.uint64) for n in sizes]
    return [mixed_keys(1000 * case + j, n) for j, n in enumerate(sizes)]


def add_schedule(counters: np.ndarray, dk: np.ndarray, idx: np.ndarray,
                 dkb: np.ndarray, *, width: int, cap: int, dk_bits: int,
                 tile: int = ADD_TILE) -> list:
    """numpy model of the schedule of the add kernel's batch update: the
    batch in tiles of ``tile`` keys, each applied in full before the next.
    Per tile: a key's doorkeeper gate from each probe's bit before the
    tile, the first key of the tile to probe it, and the key's own earlier
    probes (then every touched bit set); components of the gated keys
    joined by shared counter nibbles (min-label propagation); a walk per
    component in batch order on the nibbles' values before the tile; and
    each nibble's change added to its word once.

    ``counters`` (rows, width // 8) and ``dk`` (1, dk_words) int32 are
    updated in place; ``idx`` (B, rows) and ``dkb`` (B, dk_probes) hold the
    keys' counter probes and doorkeeper bits (``key_probes``).  Returns,
    per tile, (gated keys, components, the largest component's keys, the
    largest several-key component's keys), counting repeats of a key."""
    cw = counters.reshape(-1).view(np.uint32)
    dw = dk.reshape(-1).view(np.uint32)
    rows = idx.shape[1]
    stats = []
    for base in range(0, len(idx), tile):
        ki = idx[base:base + tile].astype(np.int64)
        n = len(ki)
        gate = np.ones(n, bool)
        if dk_bits:
            bits = dkb[base:base + tile].astype(np.int64)
            uniq, first, inv = np.unique(bits.reshape(-1), return_index=True,
                                         return_inverse=True)
            first = (first // bits.shape[1])[inv.reshape(-1)].reshape(
                bits.shape)
            pre = (dw[bits >> 5] >> (bits & 31)) & 1
            earlier = np.zeros(bits.shape, bool)
            for p in range(1, bits.shape[1]):
                earlier[:, p] = (bits[:, :p] == bits[:, p:p + 1]).any(1)
            gate = ((pre == 1) | (first < np.arange(n)[:, None])
                    | earlier).all(1)
            np.bitwise_or.at(dw, uniq >> 5,
                             (np.uint64(1) << (uniq & 31).astype(np.uint64)
                              ).astype(np.uint32))
        nib = np.arange(rows) * width + ki[gate]          # (gated, rows)
        m = len(nib)
        uniq, inv = np.unique(nib.reshape(-1), return_inverse=True)
        inv = inv.reshape(nib.shape)
        lab = np.arange(m)
        while True:                        # components: min-label propagation
            tv = np.full(len(uniq), m)
            np.minimum.at(tv, inv.reshape(-1), np.repeat(lab, rows))
            new = tv[inv].min(1) if m else lab
            if np.array_equal(new, lab):
                break
            lab = new
        word = (uniq // width) * (width // 8) + (uniq % width) // 8
        shift = (uniq % 8) * 4
        vals = (cw[word].astype(np.int64) >> shift) & 15
        before = vals.copy()
        for j in np.lexsort((np.arange(m), lab)):   # by component, in order
            s = inv[j]
            v = vals[s]
            low = v.min()
            if low < cap:
                vals[s[v == low]] += 1
        np.add.at(cw, word, ((vals - before) << shift).astype(np.uint32))
        size = np.bincount(lab, minlength=1)
        # distinct keys (nibble tuples) per component
        pairs = np.unique(np.column_stack([lab, inv]), axis=0) if m else inv
        keys = np.bincount(pairs[:, 0], minlength=len(size))
        stats.append((m, int((size > 0).sum()), int(size.max()),
                      int(size[keys > 1].max(initial=0))))
    return stats


def replay(pc, stream, block: int = 32):
    """benchmarks/bench_serving.py's replay: the stream cut into 32-block
    pseudo-requests; each looks up its chain, then offers every block past
    the cached prefix that the cache does not hold.  Works on the
    PrefixCache of either package; returns its stats."""
    slot = 0
    for i in range(0, len(stream), block):
        chunk = [int(x) for x in stream[i:i + block]]
        hits = pc.lookup(chunk)
        for h in chunk[len(hits):]:
            if h not in pc:
                pc.insert(h, slot)
                slot += 1
    return pc.stats


# Hazard cases of the step kernel's set-associative path: traces whose
# consecutive accesses read the words the access before them wrote.
# chip_smoke.py phase 2 and tests/test_torch_kernel_gpu.py hold the kernel to
# the plain step_ref on the card; tests/test_torch_hazards.py holds step_ref
# to the JAX step_ref bitwise on the CPU.  Each case is (name, StepSpec
# kwargs, make_step_params args (window_cap, main_cap, prot_cap, W, cap,
# warmup), window_cap, main_cap, trace kind, accesses, chunk).
_TINY4 = dict(width=256, rows=4, dk_bits=1024, window_slots=4, main_slots=8,
              assoc=4)
_TINY8 = dict(width=512, rows=3, dk_bits=2048, window_slots=8, main_slots=16,
              assoc=8, counter_bits=8)
_TINY16 = dict(width=256, rows=4, dk_bits=1024, window_slots=16,
               main_slots=32, assoc=16)
# DeviceWTinyLFU(65_536, assoc=8).spec() and its params: run F's geometry
_F_SPEC = dict(width=131_072, rows=4, dk_bits=2_097_152, window_slots=1024,
               main_slots=65_536, assoc=16)
HAZARD_CASES = [
    ("runs of one key, ways 4", _TINY4, (3, 8, 6, 300, 7, 0), 3, 8,
     "runs", 600, 128),
    ("tiny tables, ways 8", _TINY8, (6, 16, 12, 400, 30, 0), 6, 16,
     "skewed", 600, 256),
    ("alternating keys, ways 16", _TINY16, (12, 32, 25, 500, 15, 0), 12, 32,
     "alternating", 600, 256),
    ("reset at every chunk boundary, ways 8", _TINY8, (8, 16, 12, 64, 30, 0),
     8, 16, "skewed", 512, 64),
    ("resets mid-chunk, ways 4", _TINY4, (4, 8, 6, 50, 7, 0), 4, 8,
     "alternating", 500, 64),
    ("F geometry", _F_SPEC, (655, 64_881, 51_904, 524_288, 7, 0), 655,
     64_881, "wide", 1200, 512),
]


# The step kernel's lane grid (streams=LANES): chip_smoke.py phase 2 and
# tests/test_torch_kernel_gpu.py hold it to step_ref with lanes on the card,
# every state leaf and hit flag.  Each case is (name, StepSpec kwargs without
# streams, the make_step_params args of every lane (one row: shared params,
# a (LANES, NPARAMS) tensor otherwise), window_cap, main_cap, hazard trace
# kind, accesses per lane, chunk).  Lane b replays hazard_keys(kind, n,
# seed=b); the chunks take lane_n_valid's per-lane counts.
LANES = 4
_F_LANE = (655, 64_881, 51_904, 524_288, 7, 0)
LANE_CASES = [
    ("flat, shared params", dict(width=256, rows=4, dk_bits=1024,
                                 window_slots=3, main_slots=60),
     [(3, 60, 48, 300, 7, 0)], 3, 60, "skewed", 400, 128),
    ("flat, per-lane params", dict(width=256, rows=4, dk_bits=1024,
                                   window_slots=3, main_slots=60),
     [(3, 60, 48, 300, 7, 0), (3, 60, 30, 200, 7, 50),
      (3, 60, 48, 500, 3, 0), (3, 60, 10, 100, 7, 10)], 3, 60, "skewed",
     400, 128),
    ("ways 8, shared params", _TINY8, [(6, 16, 12, 400, 30, 0)], 6, 16,
     "skewed", 400, 128),
    ("ways 8, per-lane params", _TINY8,
     [(6, 16, 12, 400, 30, 0), (6, 16, 4, 64, 30, 0),
      (6, 16, 12, 250, 200, 100), (6, 16, 8, 50, 15, 0)], 6, 16, "runs",
     400, 128),
    ("F geometry, per-lane params", _F_SPEC,
     [_F_LANE, (655, 64_881, 20_000, 524_288, 7, 100),
      (655, 64_881, 51_904, 1_000, 7, 0), _F_LANE], 655, 64_881, "wide",
     1024, 256),
]


def lane_keys(kind: str, n: int) -> np.ndarray:
    """(LANES, n) uint64 keys: lane b is hazard_keys(kind, n, seed=b)."""
    return np.stack([hazard_keys(kind, n, seed=b) for b in range(LANES)])


def lane_n_valid(chunk: int, c: int, left: int) -> list:
    """Per-lane n_valid of chunk c of a lane case with ``left`` accesses
    left: every lane up to a full chunk, but lane 1 half a chunk from the
    second chunk on and lane 3 none in every third chunk."""
    n = [min(chunk, left)] * LANES
    if c >= 1:
        n[1] = min(n[1], chunk // 2)
    if c % 3 == 2:
        n[3] = 0
    return n


def hazard_keys(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """n uint64 keys: ``runs``, runs of 1-12 repeats of one of 24 keys;
    ``skewed``, 60% from 6 hot keys and the rest from 200; ``wide``, 30%
    from 6 hot keys and the rest from 3,000 (enough to push window records
    out at F's 64 window sets); ``alternating``,
    a hot key between fresh keys, with every fourth fresh key a repeat
    (its set was just written by the candidate the hot key pushed)."""
    rng = np.random.default_rng(seed)
    if kind == "runs":
        keys = np.repeat(rng.integers(0, 24, n), rng.integers(1, 13, n))
    elif kind == "skewed":
        keys = np.where(rng.random(n) < 0.6, rng.integers(0, 6, n),
                        rng.integers(6, 206, n))
    elif kind == "wide":
        keys = np.where(rng.random(n) < 0.3, rng.integers(0, 6, n),
                        rng.integers(6, 3006, n))
    elif kind == "alternating":
        fresh = 1000 + np.arange(n)
        fresh[3::4] = fresh[1::4][:len(fresh[3::4])]
        keys = np.stack([np.full(n, 7), fresh], axis=1).reshape(-1)
    else:
        raise ValueError(f"unknown hazard trace {kind!r}")
    return keys[:n].astype(np.uint64)


# The step kernel's competitor bodies (kernel mode 1d: S3-FIFO, ARC, LFU):
# chip_smoke.py phase 28 and tests/test_torch_kernel_gpu.py hold them to
# step_ref on the card, tests/test_torch_panel_hazards.py holds step_ref to
# the JAX step_ref on the CPU; every state leaf (ARC's ghost Blooms too) and
# hit flag.  Each case is (name, StepSpec kwargs, the make_step_params args
# of every lane (one row: one stream; LANES rows: streams=LANES with per-lane
# params and lane_n_valid's counts), window_cap, main_cap, hazard trace
# kind, accesses per lane, chunk).  ARC's P_MAIN_CAP is p's cap and the
# count of evictions after which a ghost half is cleared: a small one clears
# both halves inside a chunk.  One-set tables alias both main choices (and
# an S3-FIFO candidate's) on every access; two-set tables on half of them.
# At 32 ways each lane holds two records of a pair of main sets.
_P1 = dict(width=256, rows=4, dk_bits=1024, window_slots=2, main_slots=2,
           assoc=1)
_PONE8 = dict(width=512, rows=3, dk_bits=2048, window_slots=8, main_slots=8,
              assoc=8, counter_bits=8)
_P32 = dict(width=256, rows=4, dk_bits=1024, window_slots=32, main_slots=64,
            assoc=32)
# DeviceWTinyLFU(65_536, assoc=8, policy=p).spec() and params: run FP's
# geometry (S3-FIFO at window_frac 0.1)
_FP_S3 = dict(width=131_072, rows=4, dk_bits=2_097_152, window_slots=7_680,
              main_slots=61_440, assoc=15, policy="s3fifo")
_FP_ONE = dict(width=131_072, rows=4, dk_bits=2_097_152, window_slots=8,
               main_slots=65_536, assoc=8)
PANEL_CASES = [
    ("s3fifo ways 4 cb4 dk, resets mid-chunk", dict(_TINY4, policy="s3fifo"),
     [(3, 8, 6, 50, 7, 0)], 3, 8, "skewed", 600, 128),
    ("s3fifo ways 1 cb4 dk", dict(_P1, policy="s3fifo"),
     [(1, 2, 1, 64, 7, 0)], 1, 2, "runs", 500, 128),
    ("s3fifo ways 8 cb8 no-dk, one main set, reset at chunk boundaries",
     dict(_PONE8, dk_bits=0, policy="s3fifo"), [(6, 8, 6, 64, 30, 0)], 6, 8,
     "skewed", 512, 64),
    ("s3fifo ways 16 cb4 dk", dict(_TINY16, policy="s3fifo"),
     [(12, 32, 25, 300, 15, 0)], 12, 32, "alternating", 600, 256),
    ("s3fifo ways 4, zero-way window sets",
     dict(_TINY4, window_slots=16, policy="s3fifo"), [(2, 8, 6, 200, 7, 0)],
     2, 8, "skewed", 600, 128),
    ("arc ways 4 dk 256, both halves clear in a chunk",
     dict(_TINY4, dk_bits=256, policy="arc"), [(1, 8, 6, 64, 7, 0)], 1, 8,
     "skewed", 600, 128),
    ("arc ways 1", dict(_P1, policy="arc"), [(1, 2, 1, 64, 7, 0)], 1, 2,
     "runs", 500, 128),
    ("arc ways 8 cb8, one main set", dict(_PONE8, policy="arc"),
     [(1, 8, 6, 64, 30, 0)], 1, 8, "alternating", 600, 256),
    ("arc ways 16 dk 256", dict(_TINY16, dk_bits=256, policy="arc"),
     [(1, 32, 25, 500, 15, 0)], 1, 32, "skewed", 600, 200),
    ("lfu ways 4 cb4 dk, resets mid-chunk", dict(_TINY4, policy="lfu"),
     [(1, 8, 6, 50, 7, 0)], 1, 8, "skewed", 600, 128),
    ("lfu ways 1 cb8 no-dk", dict(_P1, dk_bits=0, counter_bits=8,
                                  policy="lfu"),
     [(1, 2, 1, 64, 30, 0)], 1, 2, "runs", 500, 128),
    ("lfu ways 8 cb8 dk, one main set, reset at chunk boundaries",
     dict(_PONE8, policy="lfu"), [(1, 8, 6, 64, 30, 0)], 1, 8, "skewed", 512,
     64),
    ("lfu ways 16 cb4 no-dk", dict(_TINY16, dk_bits=0, policy="lfu"),
     [(1, 32, 25, 300, 15, 0)], 1, 32, "alternating", 600, 200),
    ("s3fifo ways 32, two records a lane", dict(_P32, policy="s3fifo"),
     [(32, 64, 51, 200, 7, 0)], 32, 64, "skewed", 400, 128),
    ("arc ways 32, two records a lane", dict(_P32, dk_bits=256, policy="arc"),
     [(1, 12, 51, 200, 7, 0)], 1, 64, "skewed", 400, 128),
    ("lfu ways 32, two records a lane", dict(_P32, policy="lfu"),
     [(1, 64, 51, 100, 7, 0)], 1, 64, "skewed", 400, 128),
    ("s3fifo lanes, per-lane params", dict(_TINY8, policy="s3fifo"),
     [(6, 16, 12, 400, 30, 0), (6, 16, 4, 64, 30, 0),
      (6, 16, 12, 250, 200, 100), (6, 16, 8, 50, 15, 0)], 6, 16, "runs",
     400, 128),
    ("arc lanes, per-lane params", dict(_TINY8, dk_bits=256, policy="arc"),
     [(1, 16, 12, 400, 30, 0), (1, 6, 4, 64, 30, 0),
      (1, 16, 12, 250, 200, 100), (1, 3, 8, 50, 15, 0)], 1, 16, "skewed",
     400, 128),
    ("lfu lanes, per-lane params", dict(_TINY8, policy="lfu"),
     [(1, 16, 12, 400, 30, 0), (1, 16, 4, 64, 30, 0),
      (1, 16, 12, 250, 200, 100), (1, 16, 8, 50, 15, 0)], 1, 16, "skewed",
     400, 128),
    ("s3fifo FP geometry", _FP_S3, [(6_554, 58_982, 47_185, 524_288, 7, 0)],
     6_554, 58_982, "wide", 512, 512),
    ("arc FP geometry", dict(_FP_ONE, policy="arc"),
     [(1, 65_536, 52_428, 524_288, 7, 0)], 1, 65_536, "wide", 512, 512),
    ("lfu FP geometry", dict(_FP_ONE, policy="lfu"),
     [(1, 65_536, 52_428, 524_288, 7, 0)], 1, 65_536, "wide", 512, 512),
]


# The step kernel's sharded instances (kernel mode 1b): chip_smoke.py phase
# 19 holds them to step_ref on the card, with merge_halve after every epoch,
# every state leaf and hit flag.  Each case is (name, StepSpec kwargs, the
# make_step_params args of every lane (one row: shared params, LANES rows:
# per lane, with streams=LANES and lane_n_valid's counts), window_cap,
# main_cap, hazard trace kind, accesses per lane, merge epoch).  W below the
# epoch makes a fold owe several halvings.
_S4 = dict(shards=SHARDS)
_FLAT = dict(width=256, rows=4, dk_bits=1024, window_slots=3, main_slots=60)
SHARD_CASES = [
    ("flat cb4 dk", dict(_FLAT, **_S4), [(3, 60, 48, 300, 7, 0)], 3, 60,
     "skewed", 600, 128),
    ("flat cb8 no-dk", dict(width=512, rows=3, dk_bits=0, window_slots=3,
                            main_slots=40, counter_bits=8, **_S4),
     [(3, 40, 30, 100, 30, 0)], 3, 40, "runs", 600, 256),
    ("ways 4 cb4 dk, integrity", dict(_TINY4, integrity=True, **_S4),
     [(3, 8, 6, 50, 7, 0)], 3, 8, "runs", 600, 128),
    ("ways 8 cb8 dk, W below the epoch", dict(_TINY8, **_S4),
     [(6, 16, 12, 64, 30, 0)], 6, 16, "skewed", 600, 256),
    ("ways 16 cb4 no-dk", dict(_TINY16, dk_bits=0, **_S4),
     [(12, 32, 25, 500, 15, 0)], 12, 32, "alternating", 600, 200),
    ("flat lanes, per-lane params", dict(_FLAT, **_S4),
     [(3, 60, 48, 300, 7, 0), (3, 60, 30, 200, 7, 50),
      (3, 60, 48, 500, 3, 0), (3, 60, 10, 100, 7, 10)], 3, 60, "skewed",
     400, 128),
    ("ways 8 lanes, per-lane params, integrity",
     dict(_TINY8, integrity=True, **_S4),
     [(6, 16, 12, 400, 30, 0), (6, 16, 4, 64, 30, 0),
      (6, 16, 12, 250, 200, 100), (6, 16, 8, 50, 15, 0)], 6, 16, "runs",
     400, 128),
    ("F4 geometry, one epoch, integrity",
     dict(_F_SPEC, integrity=True, **_S4), [_F_LANE], 655, 64_881, "wide",
     F4_EPOCH, F4_EPOCH),
]


# The flash kernel's cases on the card (chip_smoke.py phase 11 and
# tests/test_torch_kernel_gpu.py): tests/test_flash_kernel.py's shapes
# causal and not, ragged lengths, extends, per-row kv_len, GQA groups 1,
# 2, 4, 8 and 16 (the kernel puts up to 16 query heads of one KV group in a
# CTA), head dims 16 to 128, softcap 30, and run L's three shapes (the
# extends read a 2,048-slot cache up to kv_len 1,280).
# (name, B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len, softcap)
FLASH_CASES = [
    ("2x256x4x64 causal", 2, 256, 256, 4, 4, 64, True, 0, None, 0.0),
    ("2x256x4x64 full", 2, 256, 256, 4, 4, 64, False, 0, None, 0.0),
    ("1x512x2x128 causal", 1, 512, 512, 2, 2, 128, True, 0, None, 0.0),
    ("1x512x2x128 full", 1, 512, 512, 2, 2, 128, False, 0, None, 0.0),
    ("2x128x8x32 causal", 2, 128, 128, 8, 8, 32, True, 0, None, 0.0),
    ("2x128x8x32 full", 2, 128, 128, 8, 8, 32, False, 0, None, 0.0),
    ("ragged S=100 GQA 2", 1, 100, 100, 4, 2, 64, True, 0, None, 0.0),
    ("ragged extend Sq=77 q_offset=123", 2, 77, 300, 8, 2, 128, True, 123,
     200, 0.0),
    ("kv_len per row, full", 2, 40, 130, 4, 2, 64, False, 0, [77, 130],
     0.0),
    ("GQA 1 softcap 30", 1, 200, 200, 8, 8, 128, True, 0, None, 30.0),
    ("GQA 16", 1, 150, 150, 16, 1, 128, True, 0, None, 0.0),
    ("smoke heads D=16", 2, 37, 37, 4, 2, 16, True, 0, None, 0.0),
    ("L prefill", 1, 1280, 1280, 32, 8, 128, True, 0, None, 0.0),
    ("L prefill softcap 30", 1, 1280, 1280, 32, 8, 128, True, 0, None, 30.0),
    ("L extend q_offset 1024", 1, 256, 2048, 32, 8, 128, True, 1024, 1280,
     0.0),
    ("L extend q_offset 512", 1, 768, 2048, 32, 8, 128, True, 512, 1280,
     0.0),
    ("kv_len per row, extend GQA 4", 2, 64, 512, 8, 2, 128, True, 300,
     [310, 364], 0.0),
    ("GQA 8 D=32 extend", 1, 100, 400, 16, 2, 32, True, 250, 350, 0.0),
    ("GQA 4 D=64 softcap 30", 2, 90, 90, 8, 2, 64, True, 0, None, 30.0),
]

# The flash kernel's cache-tail case: a causal extend at q_offset 123 over
# (B, Skv, Hkv, D) = (2, 300, 2, 128) slices with 8 query heads, kv_len one
# value or one per row.  Slots at or past kv_len hold NaN and +-3e38 in one
# copy and zeros in the other; the kernel must give bit-equal outputs.
FLASH_TAIL = dict(B=2, Sq=77, Skv=300, Hq=8, Hkv=2, D=128, q_offset=123)
FLASH_TAIL_LENS = (200, [130, 250])


def cache_tails(k, v, lens):
    """(zeroed, poisoned): two copies of the cache slices k, v (tensors),
    their slots at or past each row's length set to 0 in one and to NaN,
    with every third slot +3e38 in k and -3e38 in v, in the other."""
    zeroed, poisoned = (k.clone(), v.clone()), (k.clone(), v.clone())
    for b, n in enumerate(lens):
        for x in zeroed:
            x[b, n:] = 0
        for x, big in zip(poisoned, (3e38, -3e38)):
            x[b, n:] = float("nan")
            x[b, n + 1::3] = big
    return zeroed, poisoned


# Run L: the LLM serving path at full width.  ServeEngine(Model(qwen3-4b),
# **L_ENGINE, prefix_policy="wtinylfu", device_sketch=True) replays
# make_workload(cfg,
# **L_WORKLOAD) with L_NEW_TOKENS new tokens each: 24 prompts of a shared
# 1,024-token tenant prefix (6 Zipf tenants) and a 256-token user suffix.
# The engine's stats depend only on the prompts' token ids, the schedule
# and the cache, not on the model's numbers, so the pins come from the JAX
# ServeEngine on the qwen3 smoke config with the published vocabulary and
# its admission on DeviceAdmission(use_pallas=False)
# (``python tests/test_torch_serving.py`` prints them).  The pool fills and
# then takes no payload, so no candidate reaches admission.
L_ENGINE = dict(max_batch=4, max_len=2048, block_size=16, pool_slots=512)
L_WORKLOAD = dict(n_requests=24, n_tenants=6, prefix_len=1024,
                  suffix_len=256, seed=0)
L_NEW_TOKENS = 8
L_PINS = {"prefix_hit_ratio": 0.4666666666666667, "block_hits": 896,
          "block_misses": 1024, "admitted": 0, "rejected": 0,
          "tokens_prefilled": 16384, "tokens_reused": 14336,
          "reuse_frac": 0.4666666666666667, "pool_used": 512}

# The depth-2 pin: qwen3-4b at full width with n_layers=2 and the weights
# numpy_params(cfg, D2_SEED) prefills D2_PROMPT_LEN tokens drawn by
# d2_prompt(), then decodes D2_STEPS tokens, each the JAX model's greedy
# token of the step before.  Per step (the prefill's last token, then each
# decode) the JAX package's top-8 token ids and their fp32 logits
# (``python tests/test_torch_models.py`` prints them).
D2_SEED, D2_PROMPT_LEN, D2_STEPS, D2_MAX_LEN = 0, 1280, 4, 2048
D2_PINS = [
    ((69720, 3637, 88408, 120032, 99561, 84631, 142015, 12029),
     (4.34375, 4.1875, 3.984375, 3.984375, 3.875, 3.84375, 3.796875, 3.78125)),
    ((41621, 114060, 121561, 109247, 69169, 110847, 26450, 100668),
     (4.125, 3.875, 3.875, 3.78125, 3.703125, 3.703125, 3.6875, 3.671875)),
    ((9696, 7365, 14065, 99982, 38500, 142829, 48752, 148353),
     (4.15625, 4.03125, 3.9375, 3.828125, 3.8125, 3.75, 3.734375, 3.734375)),
    ((112189, 135893, 85057, 111349, 67115, 81801, 110753, 30512),
     (4.03125, 4.0, 3.890625, 3.890625, 3.703125, 3.703125, 3.6875, 3.671875)),
    ((113232, 94596, 49353, 116508, 150924, 38728, 131563, 105765),
     (4.4375, 4.34375, 3.921875, 3.84375,
      3.84375, 3.703125, 3.6875, 3.671875)),
]


def d2_prompt(vocab_size: int) -> np.ndarray:
    return np.random.default_rng(D2_SEED + 1).integers(
        0, vocab_size, D2_PROMPT_LEN)


def numpy_params(cfg, seed: int) -> dict:
    """Weights for ``cfg`` in the JAX package's tree layout
    (``init_params``: leaves of the layer stack on a leading axis), made
    with numpy alone, fp32: embeddings N(0, 0.02), matrices N(0, 1/fan-in)
    clipped at 2 sigma, norm weights 1 + N(0, 0.1) clipped at ±0.2.
    Either package loads them (the port through
    ``models.convert.params_from_numpy``)."""
    rng = np.random.default_rng(seed)
    M, hd, F, L = cfg.d_model, cfg.hd, cfg.d_ff, cfg.n_layers
    Hq, Hkv = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def normal(shape, std):
        a = rng.standard_normal(shape, dtype=np.float32)
        np.clip(a, -2.0, 2.0, out=a)
        a *= np.float32(std)
        return a

    def dense(*shape):
        return normal(shape, 1.0 / np.sqrt(shape[-2]))

    def norm(*shape):
        return 1.0 + normal(shape, 0.1)

    tree = {"embed": normal((cfg.padded_vocab, M), 0.02),
            "final_norm": norm(M)}
    if not cfg.tie_embeddings:
        tree["out_head"] = dense(M, cfg.padded_vocab)
    attn = {"norm": norm(L, M), "wq": dense(L, M, Hq), "wk": dense(L, M, Hkv),
            "wv": dense(L, M, Hkv), "wo": dense(L, Hq, M)}
    if cfg.qk_norm:
        attn["q_norm"] = norm(L, hd)
        attn["k_norm"] = norm(L, hd)
    mlp = {"norm": norm(L, M), "w_gate": dense(L, M, F),
           "w_up": dense(L, M, F), "w_down": dense(L, F, M)}
    tree["layers"] = {"attn0": attn, "mlp0": mlp}
    return tree


# ---------------------------------------------------------------------------
# The step kernel's stale mesh instances (kernel mode 1e), its wide
# instances (more than 8 doorkeeper probes or 128 ways) and its exact path
# for out-of-range table addresses (stored main sets, ARC ghost positions):
# chip_smoke.py phases 36-38 and tests/test_torch_kernel_gpu.py hold the
# kernel to step_ref on the card with run_step_case, every state leaf and
# hit flag; tests/test_torch_mesh.py, test_torch_sketch_edges.py and
# test_torch_faults.py hold step_ref to the JAX step on the CPU.  Each case
# is (name, StepSpec kwargs, make_step_params args, window_cap, main_cap,
# hazard trace kind, accesses, chunk, options): ``rank`` (a meshed case runs
# that rank's step, no fold), ``flip`` ("sets": every window record's
# stored main sets, "ghost": every main record's stored doorkeeper bits,
# flipped by table_flips after the first chunk) and ``quotas`` (adaptive:
# the rebalance quotas between chunks, in turn).
# ---------------------------------------------------------------------------
_M4 = dict(width=512, rows=4, dk_bits=2048, shards=4)
_W256 = dict(width=1024, rows=4, dk_bits=4096, window_slots=256,
             main_slots=512, assoc=256)
STEP12_CASES = [
    ("mesh 2, rank 0, flat", dict(_M4, mesh_devices=2, window_slots=4,
                                  main_slots=60), (4, 60, 48, 500, 7, 0),
     4, 60, "skewed", 600, 200, dict(rank=0)),
    ("mesh 2, rank 1, flat", dict(_M4, mesh_devices=2, window_slots=4,
                                  main_slots=60), (4, 60, 48, 500, 7, 0),
     4, 60, "skewed", 600, 200, dict(rank=1)),
    ("mesh 2, rank 1, ways 8", dict(_M4, mesh_devices=2, window_slots=16,
                                    main_slots=64, assoc=8),
     (6, 58, 46, 500, 7, 0), 6, 58, "wide", 600, 200, dict(rank=1)),
    ("mesh 4, rank 2, ways 8 adaptive",
     dict(_M4, mesh_devices=4, window_slots=32, main_slots=64, assoc=8,
          adaptive=True), (8, 56, 44, 500, 7, 0), 8, 56, "skewed", 600, 150,
     dict(rank=2, quotas=[20, 3, 30])),
    ("mesh 1, ways 16 cb8 no-dk", dict(_M4, dk_bits=0, counter_bits=8,
                                       mesh_devices=1, window_slots=32,
                                       main_slots=64, assoc=16),
     (5, 59, 47, 500, 30, 0), 5, 59, "runs", 600, 200, dict(rank=0)),
    ("ways 256", _W256, (200, 500, 400, 600, 7, 0), 200, 500, "wide", 800,
     300, {}),
    ("ways 256 adaptive", dict(_W256, adaptive=True),
     (100, 400, 320, 600, 7, 0), 100, 400, "wide", 800, 200,
     dict(quotas=[200, 20, 255])),
    ("ways 256 shards 2", dict(_W256, shards=2), (200, 500, 400, 600, 7, 0),
     200, 500, "wide", 800, 300, {}),
    ("ways 256 mesh 2 rank 1", dict(_W256, shards=2, mesh_devices=2),
     (200, 500, 400, 600, 7, 0), 200, 500, "wide", 800, 300, dict(rank=1)),
    ("dk_probes 11, flat", dict(width=256, rows=4, dk_bits=1024,
                                dk_probes=11, window_slots=4, main_slots=60),
     (4, 60, 48, 300, 7, 0), 4, 60, "skewed", 600, 200, {}),
    ("dk_probes 16, flat sharded", dict(width=512, rows=4, dk_bits=2048,
                                        dk_probes=16, shards=2,
                                        window_slots=4, main_slots=60),
     (4, 60, 48, 300, 7, 0), 4, 60, "skewed", 600, 200, {}),
    ("dk_probes 11, ways 8, resets mid-chunk",
     dict(width=512, rows=3, dk_bits=2048, dk_probes=11, window_slots=8,
          main_slots=16, assoc=8, counter_bits=8), (6, 16, 12, 64, 30, 0),
     6, 16, "skewed", 600, 256, {}),
    ("dk_probes 16, ways 8 adaptive",
     dict(width=512, rows=3, dk_bits=2048, dk_probes=16, window_slots=64,
          main_slots=64, assoc=8, adaptive=True), (20, 44, 35, 200, 7, 0),
     20, 44, "skewed", 600, 150, dict(quotas=[30, 3, 60])),
    ("dk_probes 11, ways 8 mesh 2 rank 0",
     dict(_M4, dk_probes=11, mesh_devices=2, window_slots=16, main_slots=64,
          assoc=8), (6, 58, 46, 500, 7, 0), 6, 58, "wide", 600, 200,
     dict(rank=0)),
    ("dk_probes 16 flat adaptive", dict(width=256, rows=4, dk_bits=1024,
                                         dk_probes=16, window_slots=30,
                                         main_slots=60, adaptive=True),
     (3, 57, 45, 300, 7, 0), 3, 57, "skewed", 600, 150,
     dict(quotas=[10, 2, 25])),
    ("s3fifo ways 256", dict(_W256, policy="s3fifo"),
     (100, 500, 400, 200, 7, 0), 100, 500, "wide", 800, 300, {}),
    ("arc ways 256 dk_probes 11", dict(_W256, dk_probes=11, dk_bits=512,
                                       policy="arc"),
     (1, 500, 400, 200, 7, 0), 1, 500, "wide", 800, 300, {}),
    ("lfu dk_probes 16", dict(_TINY16, dk_probes=16, policy="lfu"),
     (1, 32, 25, 300, 15, 0), 1, 32, "skewed", 600, 200, {}),
    ("sets out of range, ways 8", _TINY8, (6, 16, 12, 400, 30, 0), 6, 16,
     "skewed", 600, 200, dict(flip="sets")),
    ("sets out of range, ways 10 shards 2",
     dict(width=512, rows=4, dk_bits=2048, window_slots=40, main_slots=80,
          assoc=10, shards=2), (30, 80, 64, 400, 7, 0), 30, 80, "wide",
     600, 200, dict(flip="sets")),
    ("sets out of range, ways 8 adaptive", _A8, (20, 44, 35, 200, 7, 0), 20,
     44, "skewed", 600, 150, dict(flip="sets", quotas=[30, 3, 60])),
    ("sets out of range, s3fifo ways 4", dict(_TINY4, policy="s3fifo"),
     (3, 8, 6, 50, 7, 0), 3, 8, "skewed", 600, 128, dict(flip="sets")),
    ("ghost positions out of range, arc ways 4",
     dict(_TINY4, dk_bits=256, policy="arc"), (1, 8, 6, 64, 7, 0), 1, 8,
     "skewed", 600, 128, dict(flip="ghost")),
    ("sets out of range, ways 256", _W256, (200, 500, 400, 600, 7, 0), 200,
     500, "wide", 800, 300, dict(flip="sets")),
]
# the bits flipped into a stored set or ghost position, by turns: 30 and 31
# keep an int32 product c * A of a power-of-two A in the table (the block
# of the set itself, which no longer equals the key's sets), 20 and 4 push
# it past the end or into another set (ways 10: 30 makes it negative)
TABLE_FLIP_BITS = (30, 31, 20, 4)


def table_flips(spec, what: str) -> tuple[str, list]:
    """(leaf, (flat index, bit) flips) of drill ``what``: "sets", the two
    stored main sets (WT_MSET, WT_MSET2 = columns 3, 4) of every window
    record; "ghost", the stored doorkeeper bits of every main record (ARC's
    ghost positions).  Bits by turns from TABLE_FLIP_BITS."""
    b = TABLE_FLIP_BITS
    if what == "sets":
        return "wtab", [(r * spec.wcols + c, b[(r + c) % len(b)])
                        for r in range(spec.window_slots) for c in (3, 4)]
    c0 = 3 + spec.rows
    return "mtab", [(r * spec.mcols + c, b[(r + c) % len(b)])
                    for r in range(spec.main_slots)
                    for c in range(c0, c0 + spec.dkp)]


def run_step_case(case, fn, device: str):
    """One STEP12_CASES case through ``fn`` (the port's ``step`` or
    ``step_ref``) on ``device``: ((state leaves as numpy), hit flags).
    Sharded unmeshed cases fold with ``merge_halve`` after every chunk;
    adaptive ones rebalance to the case's quotas in turn; a flip is applied
    (``core.faults.flip_words``) after the first chunk (the step finds the
    addresses it leaves out of range by itself)."""
    import torch
    from repro_torch.core import faults
    from repro_torch.kernels import sketch_step as port
    from repro_torch.kernels.sketch_common import keys_to_lanes
    from repro_torch.kernels.sketch_merge import merge_halve
    _, kw, pargs, wcap, mcap, kind, n, chunk, opt = case
    spec = port.StepSpec(**kw)
    params = port.make_step_params(*pargs, counter_bits=spec.counter_bits,
                                   device=device)
    state = port.init_step_state(spec, wcap, mcap, device=device)
    lo, hi = (torch.from_numpy(x).to(device)
              for x in keys_to_lanes(hazard_keys(kind, n, seed=3)))
    rank = opt.get("rank", 0)
    quotas = list(opt.get("quotas", ()))
    hits = []
    for c in range(0, n, chunk):
        if c == chunk and opt.get("flip"):
            leaf, flips = table_flips(spec, opt["flip"])
            state = faults.flip_words(state, leaf, flips)
        lc, hc = lo[c:c + chunk], hi[c:c + chunk]
        state, h = fn(spec, params, state, lc, hc, len(lc), rank=rank)
        hits.append(h)
        if spec.shards > 1 and not spec.mesh_devices:
            merge_halve(spec, params, state)
        if spec.adaptive and quotas:
            port.rebalance(spec, params, state, quotas[(c // chunk)
                                                       % len(quotas)])
    return (port.state_to_numpy(state),
            torch.cat(hits).cpu().numpy())

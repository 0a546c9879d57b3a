"""The check runs of the serving paths, their pinned JAX results, and the
helpers that drive them in either package.

``chip_smoke.py`` runs S, P, P1-host and L at full size on the card and
holds them to the pins below; ``tests/test_torch_sketch_ops.py``,
``tests/test_torch_prefix_cache.py``, ``tests/test_torch_host_sketch.py``,
``tests/test_torch_serving.py`` and ``tests/test_torch_models.py`` run the
same procedures at a small size against the JAX package, and, run as
scripts, print the JAX results that are pinned here.  The tenant-lane and
sweep runs T and W, the hazard cases of the step and add kernels (the step
kernel's lane grid too) and a numpy model of the add kernel's schedule live
here as well.  Imports numpy only.
"""
from __future__ import annotations

import hashlib

import numpy as np

# DeviceSketchConfig kwargs: the configurations of tests/test_kernels.py
SKETCH_CFGS = [dict(width=256, rows=4, cap=15, dk_bits=1024),
               dict(width=1024, rows=4, cap=7, dk_bits=4096),
               dict(width=512, rows=2, cap=15, dk_bits=0),
               dict(width=2048, rows=1, cap=3, dk_bits=2048)]

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

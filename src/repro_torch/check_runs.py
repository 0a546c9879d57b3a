"""The serving-admission path's check runs, their pinned JAX results, and
the helpers that drive them in either package.

``chip_smoke.py`` runs S and P at full size on the card and holds them to
the pins below; ``tests/test_torch_sketch_ops.py`` and
``tests/test_torch_prefix_cache.py`` run the same procedures at a small
size against the JAX package, and, run as scripts, print the JAX results
that are pinned here.  Imports numpy only.
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

# Runs P: benchmarks/bench_serving.py's replay through PrefixCache.  P1 is
# its full grid (lru / tinylfu / wtinylfu x P1_CAPS); P2 the same generator
# scaled to S's capacity, wtinylfu.  The pins are every PrefixCacheStats
# field (lookups, block_hits, block_misses, inserts, admitted, rejected,
# evicted) of the JAX PrefixCache with DeviceAdmission(use_pallas=False)
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

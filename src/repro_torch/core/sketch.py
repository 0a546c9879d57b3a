"""Host-side TinyLFU frequency sketch (paper §3).

Copy of ``repro/core/sketch.py``'s frequency sketches, held equal to them by
``tests/test_torch_host_sketch.py``.  ``FrequencySketch`` is the paper's
architecture: a Minimal-Increment (conservative update) counting structure,
a Doorkeeper Bloom filter and the reset.  ``ShardedFrequencySketch`` is the
host twin of the device engine's ``shards=S`` mode.

* the counting layout is the paper's prototype (a Counting Bloom Filter:
  one table, k probes) or Caffeine's CM-sketch (d rows, one probe each);
  both use conservative update;
* counters saturate at ``cap`` = W/C (the paper's small counters, §3.4.1);
* after ``sample_size`` (W) additions every counter is halved and the
  doorkeeper cleared (§3.3 reset; §3.4.2 doorkeeper reset).

``ExactHistogram`` is accurate TinyLFU (exact per-key counters, the same
reset), the paper's Fig. 22 reference point.

Pure Python with memoized probe indices: no tensor and no device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .hashing import SHARD_SEED64

_MASK64 = (1 << 64) - 1
_SM64_GAMMA = 0x9E3779B97F4A7C15
_SM64_M1 = 0xBF58476D1CE4E5B9
_SM64_M2 = 0x94D049BB133111EB
_SEED_STEP = 0xC2B2AE3D27D4EB4F


def _splitmix64_py(x: int) -> int:
    x = (x + _SM64_GAMMA) & _MASK64
    x = ((x ^ (x >> 30)) * _SM64_M1) & _MASK64
    x = ((x ^ (x >> 27)) * _SM64_M2) & _MASK64
    return x ^ (x >> 31)


def _pow2ceil(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


@dataclass
class SketchConfig:
    sample_size: int                      # W: reset period
    counters: int                         # total number of counters (all rows)
    rows: int = 4                         # d rows (CM layout); 1 => CBF layout
    probes_per_row: int = 1               # CBF layout: rows=1, probes=k
    cap: int = 15                         # small-counter saturation (W/C)
    doorkeeper_bits: int = 0              # 0 disables the doorkeeper
    doorkeeper_probes: int = 3
    conservative: bool = True             # minimal-increment update
    seed: int = 0

    @property
    def width(self) -> int:               # counters per row
        return max(1, self.counters // self.rows)

    def meta_bits(self) -> int:
        """Total metadata footprint in bits (for Fig 4 style accounting)."""
        bits_per_counter = max(1, int(self.cap).bit_length())
        return self.rows * self.width * bits_per_counter + self.doorkeeper_bits


class FrequencySketch:
    """TinyLFU histogram: estimate()/add()/reset(), paper §3."""

    _MEMO_LIMIT = 2_000_000               # probe memo safety valve (scan traces)

    def __init__(self, cfg: SketchConfig):
        self.cfg = cfg
        n_probes = cfg.rows * cfg.probes_per_row
        # flat table, row-major; probes carry precomputed row offsets
        self.table = [0] * (cfg.rows * cfg.width)
        self.dk = bytearray(cfg.doorkeeper_bits) if cfg.doorkeeper_bits else None
        self.size = 0                      # additions since last reset
        self.resets = 0
        self._memo: dict = {}
        self._dk_memo: dict = {}
        w = cfg.width
        if cfg.rows == 1:
            self._row_off = [0] * n_probes
        else:
            self._row_off = [r * w for r in range(cfg.rows)
                             for _ in range(cfg.probes_per_row)]
        self._probe_seeds = [((i + 1) * _SEED_STEP + cfg.seed) & _MASK64
                             for i in range(n_probes)]
        self._dk_seeds = [((i + 1) * _SEED_STEP + (cfg.seed ^ 0x5A5A)) & _MASK64
                          for i in range(cfg.doorkeeper_probes)]

    # -- hashing (memoized pure python) ---------------------------------------
    def _probes(self, key: int):
        p = self._memo.get(key)
        if p is None:
            w = self.cfg.width
            p = tuple(off + _splitmix64_py((key + s) & _MASK64) % w
                      for off, s in zip(self._row_off, self._probe_seeds))
            if len(self._memo) >= self._MEMO_LIMIT:
                self._memo.clear()
            self._memo[key] = p
        return p

    def _dk_probes(self, key: int):
        p = self._dk_memo.get(key)
        if p is None:
            nb = self.cfg.doorkeeper_bits
            p = tuple(_splitmix64_py((key + s) & _MASK64) % nb
                      for s in self._dk_seeds)
            if len(self._dk_memo) >= self._MEMO_LIMIT:
                self._dk_memo.clear()
            self._dk_memo[key] = p
        return p

    # -- doorkeeper ------------------------------------------------------------
    def _dk_contains(self, key: int) -> bool:
        dk = self.dk
        for i in self._dk_probes(key):
            if not dk[i]:
                return False
        return True

    def _dk_put(self, key: int) -> bool:
        """Insert; returns True if the key was already present."""
        dk = self.dk
        present = True
        for i in self._dk_probes(key):
            if not dk[i]:
                present = False
                dk[i] = 1
        return present

    # -- main structure ---------------------------------------------------------
    def _table_estimate(self, key: int) -> int:
        t = self.table
        return min(t[i] for i in self._probes(key))

    def _table_add(self, key: int) -> None:
        t = self.table
        idx = self._probes(key)
        vals = [t[i] for i in idx]
        m = min(vals)
        if m >= self.cfg.cap:
            return
        if self.cfg.conservative:
            m1 = m + 1
            for i, v in zip(idx, vals):    # minimal increment: bump only minima
                if v == m:
                    t[i] = m1
        else:
            cap = self.cfg.cap
            for i, v in zip(idx, vals):
                if v < cap:
                    t[i] = v + 1

    # -- public api (paper semantics) --------------------------------------------
    def estimate(self, key: int) -> int:
        est = self._table_estimate(key)
        if self.dk is not None and self._dk_contains(key):
            est += 1
        return est

    def add(self, key: int) -> None:
        if self.dk is not None:
            if self._dk_put(key):
                self._table_add(key)       # repeat visitor: count in main
            # else: first timer absorbed by the doorkeeper (1-bit counter)
        else:
            self._table_add(key)
        self.size += 1
        if self.size >= self.cfg.sample_size:
            self.reset()

    def reset(self) -> None:
        """Paper §3.3: halve all counters (integer division), clear doorkeeper,
        halve the sample counter."""
        self.table = [v >> 1 for v in self.table]
        if self.dk is not None:
            for i in range(len(self.dk)):
                self.dk[i] = 0
        self.size //= 2
        self.resets += 1

    # numpy view for tests / kernels parity checks
    def table_array(self) -> np.ndarray:
        return np.asarray(self.table, dtype=np.int64).reshape(
            self.cfg.rows, self.cfg.width)


class ShardedFrequencySketch:
    """Sharded TinyLFU histogram: the host twin of the device engine's
    ``shards=S`` mode (``kernels/sketch_step.py`` and ``sketch_merge.py``).

    A key owns one shard (a splitmix64 shard hash) and all its probes fall
    in that shard's ``width / shards`` counters (and ``doorkeeper_bits /
    shards`` bits).  :meth:`add` writes delta structures and reads global +
    delta; it never resets.  :meth:`merge_halve`, which the owning policy
    calls every merge epoch, adds the deltas into the global structures
    (saturating at ``cap``) and applies as many §3.3 halvings as the size
    owes.  ``stale_estimates=True`` makes :meth:`estimate` read the global
    structures only (stale by at most one epoch).
    """

    _MEMO_LIMIT = 2_000_000               # probe memo safety valve

    def __init__(self, cfg: SketchConfig, shards: int,
                 stale_estimates: bool = False):
        if shards < 2 or shards & (shards - 1):
            raise ValueError(f"shards {shards} must be a power of two >= 2")
        if cfg.width % shards:
            raise ValueError(f"width {cfg.width} must be a multiple of "
                             f"shards ({shards})")
        if cfg.doorkeeper_bits % shards:
            raise ValueError(f"doorkeeper_bits {cfg.doorkeeper_bits} must be "
                             f"a multiple of shards ({shards})")
        if not cfg.conservative:
            raise ValueError("sharded sketch is conservative-update only")
        self.cfg = cfg
        self.shards = shards
        self.stale_estimates = stale_estimates
        self.width_shard = cfg.width // shards
        self.dk_bits_shard = cfg.doorkeeper_bits // shards
        n_probes = cfg.rows * cfg.probes_per_row
        self.gtable = [0] * (cfg.rows * cfg.width)    # merged global
        self.dtable = [0] * (cfg.rows * cfg.width)    # shard-local deltas
        if cfg.doorkeeper_bits:
            self.gdk = bytearray(cfg.doorkeeper_bits)
            self.ddk = bytearray(cfg.doorkeeper_bits)
        else:
            self.gdk = self.ddk = None
        self.size = 0                      # additions since last §3.3 reset
        self.resets = 0
        self.merges = 0
        self._memo: dict = {}
        self._dk_memo: dict = {}
        w = cfg.width
        if cfg.rows == 1:
            self._row_off = [0] * n_probes
        else:
            self._row_off = [r * w for r in range(cfg.rows)
                             for _ in range(cfg.probes_per_row)]
        self._probe_seeds = [((i + 1) * _SEED_STEP + cfg.seed) & _MASK64
                             for i in range(n_probes)]
        self._dk_seeds = [((i + 1) * _SEED_STEP + (cfg.seed ^ 0x5A5A))
                          & _MASK64 for i in range(cfg.doorkeeper_probes)]

    # -- hashing (memoized; probes confined to the owning shard's slice) -----
    def _shard_of(self, key: int) -> int:
        return _splitmix64_py((key + SHARD_SEED64) & _MASK64) % self.shards

    def _probes(self, key: int):
        p = self._memo.get(key)
        if p is None:
            base = self._shard_of(key) * self.width_shard
            ws = self.width_shard
            p = tuple(off + base + _splitmix64_py((key + s) & _MASK64) % ws
                      for off, s in zip(self._row_off, self._probe_seeds))
            if len(self._memo) >= self._MEMO_LIMIT:
                self._memo.clear()
            self._memo[key] = p
        return p

    def _dk_probes(self, key: int):
        p = self._dk_memo.get(key)
        if p is None:
            base = self._shard_of(key) * self.dk_bits_shard
            nb = self.dk_bits_shard
            p = tuple(base + _splitmix64_py((key + s) & _MASK64) % nb
                      for s in self._dk_seeds)
            if len(self._dk_memo) >= self._MEMO_LIMIT:
                self._dk_memo.clear()
            self._dk_memo[key] = p
        return p

    # -- public api (FrequencySketch's, minus the automatic reset) -----------
    def add(self, key: int) -> None:
        if self.gdk is not None:
            present = True
            gdk, ddk = self.gdk, self.ddk
            for i in self._dk_probes(key):
                if not (gdk[i] or ddk[i]):
                    present = False
                    ddk[i] = 1
            if not present:                # first timer: doorkeeper absorbs
                self.size += 1
                return
        g, d = self.gtable, self.dtable
        idx = self._probes(key)
        vals = [g[i] + d[i] for i in idx]
        m = min(vals)
        if m < self.cfg.cap:               # the combined count caps; the
            for i, v in zip(idx, vals):    # bump goes to the delta
                if v == m:
                    d[i] += 1
        self.size += 1

    def estimate(self, key: int) -> int:
        g, d = self.gtable, self.dtable
        if self.stale_estimates:           # global only: <= one epoch stale
            est = min(g[i] for i in self._probes(key))
            if self.gdk is not None:
                gdk = self.gdk
                if all(gdk[i] for i in self._dk_probes(key)):
                    est += 1
            return est
        est = min(g[i] + d[i] for i in self._probes(key))
        if self.gdk is not None:
            gdk, ddk = self.gdk, self.ddk
            if all(gdk[i] or ddk[i] for i in self._dk_probes(key)):
                est += 1
        return est

    def merge_halve(self) -> None:
        """Fold the deltas into the global structures (saturating at cap)
        and apply the deferred §3.3 halvings: merge first, halve second, k
        halvings for an epoch that crossed the sample size k times."""
        cap = self.cfg.cap
        self.gtable = [min(g + d, cap)
                       for g, d in zip(self.gtable, self.dtable)]
        self.dtable = [0] * len(self.dtable)
        if self.gdk is not None:
            gdk, ddk = self.gdk, self.ddk
            for i in range(len(gdk)):
                if ddk[i]:
                    gdk[i] = 1
            self.ddk = bytearray(len(ddk))
        k = 0
        while self.cfg.sample_size > 0 and self.size >= self.cfg.sample_size:
            self.size //= 2
            k += 1
        if k:
            self.gtable = [v >> k for v in self.gtable]
            if self.gdk is not None:
                self.gdk = bytearray(len(self.gdk))
            self.resets += k
        self.merges += 1

    # numpy view (merged global + delta) for tests / parity checks
    def table_array(self) -> np.ndarray:
        merged = [g + d for g, d in zip(self.gtable, self.dtable)]
        return np.asarray(merged, dtype=np.int64).reshape(
            self.cfg.rows, self.cfg.width)


class ExactHistogram:
    """Accurate TinyLFU: per-key exact counters (hash table), same reset
    semantics.  ``integer_division=False`` gives the floating-point reset used
    to isolate the truncation error in Fig 22."""

    def __init__(self, sample_size: int, cap: float | None = None,
                 integer_division: bool = True):
        self.sample_size = sample_size
        self.cap = cap
        self.integer_division = integer_division
        self.counts: dict[int, float] = {}
        self.size = 0
        self.resets = 0

    def estimate(self, key: int) -> float:
        return self.counts.get(key, 0)

    def add(self, key: int) -> None:
        c = self.counts.get(key, 0) + 1
        if self.cap is None or c <= self.cap:
            self.counts[key] = c
        self.size += 1
        if self.size >= self.sample_size:
            self.reset()

    def reset(self) -> None:
        if self.integer_division:
            self.counts = {k: v // 2 for k, v in self.counts.items() if v >= 2}
        else:
            self.counts = {k: v / 2 for k, v in self.counts.items()}
        self.size //= 2
        self.resets += 1


def default_sketch(cache_size: int, sample_factor: int = 8,
                   counters_per_item: float = 2.0, rows: int = 4,
                   doorkeeper: bool = True, dk_bits_per_item: float = 4.0,
                   seed: int = 0, shards: int = 1,
                   stale_estimates: bool = False):
    """The reference's sizing rule: ~1.5 bytes of metadata per sample
    element (4-bit main counters x2/elem + 4 doorkeeper bits/elem), just
    above the paper's Fig 22 accuracy knee; cap = W/C with the doorkeeper
    absorbing one count.  ``shards > 1`` returns the sharded twin
    (:class:`ShardedFrequencySketch`, the same footprint), whose owner must
    call its ``merge_halve`` every merge epoch; ``stale_estimates`` (sharded
    only) selects its global-only reads."""
    sample = sample_factor * cache_size
    cap = max(1, sample_factor - (1 if doorkeeper else 0))
    counters = rows * _pow2ceil(max(1.0, counters_per_item * sample / rows))
    width = max(shards, counters // rows)
    dk_bits = 0
    if doorkeeper:
        dk_bits = max(32 * shards, _pow2ceil(sample * dk_bits_per_item))
    cfg = SketchConfig(sample_size=sample, counters=rows * width, rows=rows,
                       cap=cap, doorkeeper_bits=dk_bits, seed=seed)
    if shards > 1:
        return ShardedFrequencySketch(cfg, shards,
                                      stale_estimates=stale_estimates)
    if stale_estimates:
        raise ValueError("stale_estimates requires shards > 1 (an unsharded "
                         "sketch has no delta to be stale against)")
    return FrequencySketch(cfg)

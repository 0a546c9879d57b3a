"""Prefix cache with TinyLFU admission on the card.

Counterpart of ``repro/serve/prefix_cache.py``.  The cache maps chained block
hashes (content-defined keys over token blocks) to payload slots.  Retention
follows the paper's architecture (Fig. 1 / Fig. 5): an eviction policy over
the cached blocks (LRU, or an LRU window in front of an SLRU main for
W-TinyLFU) and TinyLFU admission, where a candidate block displaces the
eviction victim only if its recent access frequency is higher.  Every lookup
records all the requested hashes in the sketch in one batch.

Admission runs, as in the reference, through the host sketch by default
(``HostAdmission`` over ``core/sketch.py``'s ``FrequencySketch``: pure
Python, nothing on a device) or, with ``device_sketch=True``, through
``DeviceTinyLFU``, whose sketch and kernels live on the card
(``device=None``) or on the CPU with the plain versions (``device="cpu"``).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.policies import LRUEviction, SLRUEviction
from repro_torch.core.sketch import default_sketch
from repro_torch.kernels.ops import DeviceTinyLFU
from repro_torch.kernels.sketch_common import resolve_device

_MASK64 = (1 << 64) - 1
_GAMMA = 0x9E3779B97F4A7C15


def _mix(x: int) -> int:
    x = (x + _GAMMA) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def block_hashes(tokens, block_size: int) -> list[int]:
    """Chained content hashes: block i's key depends on blocks 0..i."""
    out = []
    h = 0x51CE_B00C
    n_full = len(tokens) // block_size
    for b in range(n_full):
        for t in tokens[b * block_size:(b + 1) * block_size]:
            h = _mix(h ^ _mix(int(t)))
        out.append(h)
    return out


# ---------------------------------------------------------------------------
# payload pool: device-tensor slots for KV blocks / state snapshots
# ---------------------------------------------------------------------------

def _tree_map(fn, tree, *rest):
    """Apply ``fn`` to the tensor leaves of a (nested) dict, in step with
    dicts of the same keys in ``rest``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"payload leaves must be tensors, not {type(tree)}")
    return fn(tree, *rest)


class PayloadPool:
    """Fixed-slot pool over a (nested) dict template of tensors, held on
    ``device`` (the card unless ``"cpu"``).  store/load/free."""

    def __init__(self, template, n_slots: int, device=None):
        self.device = resolve_device(device)
        self.n_slots = n_slots
        self.pool = _tree_map(
            lambda a: torch.zeros((n_slots,) + tuple(a.shape), dtype=a.dtype,
                                  device=self.device), template)
        self.free_list = list(range(n_slots))

    def store(self, tree) -> Optional[int]:
        if not self.free_list:
            return None
        slot = self.free_list.pop()
        _tree_map(lambda pool, a: pool[slot].copy_(a), self.pool, tree)
        return slot

    def load(self, slot: int):
        return _tree_map(lambda pool: pool[slot].clone(), self.pool)

    def load_many(self, slots: list[int]):
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        return _tree_map(lambda pool: pool[idx], self.pool)

    def free(self, slot: int) -> None:
        self.free_list.append(slot)

    @property
    def used(self) -> int:
        return self.n_slots - len(self.free_list)


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------

class HostAdmission:
    """Admission through the host sketch, one key at a time."""

    def __init__(self, capacity: int, sample_factor: int = 8, seed: int = 0):
        self.sketch = default_sketch(capacity, sample_factor=sample_factor,
                                     seed=seed)

    def record_batch(self, keys) -> None:
        for k in keys:
            self.sketch.add(int(k) & _MASK64)

    def admit(self, cand: int, victim: int) -> bool:
        return (self.sketch.estimate(int(cand) & _MASK64)
                > self.sketch.estimate(int(victim) & _MASK64))


class DeviceAdmission:
    """Admission through the batched sketch kernels: one add launch per
    recorded batch, one admit launch (and a read of its verdict) per
    decision."""

    def __init__(self, capacity: int, sample_factor: int = 8, device=None):
        self.t = DeviceTinyLFU(capacity, sample_factor=sample_factor,
                               device=device)

    def record_batch(self, keys) -> None:
        if len(keys):
            self.t.record(np.asarray(keys, np.uint64))

    def admit(self, cand: int, victim: int) -> bool:
        return bool(self.t.admit(np.asarray([cand], np.uint64),
                                 np.asarray([victim], np.uint64))[0])


# ---------------------------------------------------------------------------
# the cache itself
# ---------------------------------------------------------------------------

@dataclass
class PrefixCacheStats:
    lookups: int = 0
    block_hits: int = 0
    block_misses: int = 0
    inserts: int = 0
    admitted: int = 0
    rejected: int = 0
    evicted: int = 0

    @property
    def hit_ratio(self) -> float:
        n = self.block_hits + self.block_misses
        return self.block_hits / n if n else 0.0


class PrefixCache:
    """hash -> payload-slot cache with pluggable retention policy.

    policy: "lru" (no admission), "tinylfu" (LRU eviction + admission),
    "wtinylfu" (1% LRU window + SLRU main + admission).  Admission runs on
    the host sketch (seeded by ``seed``) unless ``device_sketch``; the
    device sketch lives on ``device`` (the card unless ``"cpu"``; without a
    card and without ``device="cpu"`` its construction raises).  ``device``
    is consulted for the device sketch only.
    """

    def __init__(self, capacity: int, policy: str = "wtinylfu",
                 sample_factor: int = 8, window_frac: float = 0.01,
                 device_sketch: bool = False, seed: int = 0, device=None):
        if policy not in ("lru", "tinylfu", "wtinylfu"):
            raise ValueError(f"policy {policy!r} must be 'lru', 'tinylfu' "
                             "or 'wtinylfu'")
        self.policy = policy
        self.capacity = capacity
        self.slots: dict[int, int] = {}           # hash -> payload slot
        self.stats = PrefixCacheStats()
        self.admission = None
        if policy != "lru":
            self.admission = (DeviceAdmission(capacity, sample_factor,
                                              resolve_device(device))
                              if device_sketch else
                              HostAdmission(capacity, sample_factor, seed))
        if policy == "wtinylfu":
            self.window_cap = max(1, int(round(capacity * window_frac)))
            self.main_cap = capacity - self.window_cap
            self.window: OrderedDict = OrderedDict()
            self.main = SLRUEviction(self.main_cap)
        else:
            self.main = LRUEviction(capacity)

    # -- helpers -------------------------------------------------------------
    def __contains__(self, h):
        if self.policy == "wtinylfu" and h in self.window:
            return True
        return h in self.main

    def __len__(self):
        n = len(self.main)
        if self.policy == "wtinylfu":
            n += len(self.window)
        return n

    def _touch(self, h):
        if self.policy == "wtinylfu" and h in self.window:
            self.window.move_to_end(h)
        else:
            self.main.on_hit(h)

    # -- api -----------------------------------------------------------------
    def lookup(self, hashes: list[int]) -> list[int]:
        """Longest cached prefix: returns payload slots for the leading run
        of hits.  Records ALL requested hashes in the sketch (they were
        accessed, whether or not they hit: the paper's frequency stream)."""
        self.stats.lookups += 1
        if self.admission is not None:
            self.admission.record_batch(hashes)
        out = []
        for h in hashes:
            if h in self:
                self._touch(h)
                out.append(self.slots[h])
            else:
                break
        self.stats.block_hits += len(out)
        self.stats.block_misses += len(hashes) - len(out)
        return out

    def lookup_snapshots(self, hashes: list[int],
                         every: int) -> tuple[int, Optional[int]]:
        """SSM-family lookup: snapshots exist only at block indices
        every-1, 2*every-1, ...  Returns (n_blocks_covered, payload_slot)
        for the DEEPEST cached snapshot (or (0, None)).  Records all
        hashes."""
        self.stats.lookups += 1
        if self.admission is not None:
            self.admission.record_batch(hashes)
        best = (0, None)
        boundaries = list(range(every - 1, len(hashes), every))
        for i in boundaries:
            h = hashes[i]
            if h in self:
                self._touch(h)
                best = (i + 1, self.slots[h])
        hits = best[0] // every
        self.stats.block_hits += hits
        self.stats.block_misses += len(boundaries) - hits
        return best

    def insert(self, h: int, slot: int) -> list[int]:
        """Offer one block.  Returns payload slots freed by eviction or
        rejection (the caller returns them to the pool).  The offered slot
        itself is freed (returned) if the block is rejected or already
        cached."""
        self.stats.inserts += 1
        if h in self:
            return [slot]
        freed: list[int] = []
        if self.policy == "wtinylfu":
            self.window[h] = None
            self.slots[h] = slot
            if len(self.window) <= self.window_cap:
                return freed
            cand, _ = self.window.popitem(last=False)
            freed += self._offer_main(cand)
            return freed
        return self._offer_main_direct(h, slot)

    def _offer_main(self, cand: int) -> list[int]:
        """W-TinyLFU window victim asks for main admission."""
        freed = []
        if len(self.main) < self.main.capacity:
            self.main.add(cand)
            return freed
        victim = self.main.peek_victim()
        if self.admission is None or self.admission.admit(cand, victim):
            self.stats.admitted += 1
            self.main.remove(victim)
            freed.append(self.slots.pop(victim))
            self.stats.evicted += 1
            self.main.add(cand)
        else:
            self.stats.rejected += 1
            freed.append(self.slots.pop(cand))
        return freed

    def _offer_main_direct(self, h: int, slot: int) -> list[int]:
        freed = []
        if len(self.main) < self.main.capacity:
            self.main.add(h)
            self.slots[h] = slot
            return freed
        victim = self.main.peek_victim()
        if self.admission is None or self.admission.admit(h, victim):
            self.stats.admitted += 1
            self.main.remove(victim)
            freed.append(self.slots.pop(victim))
            self.stats.evicted += 1
            self.main.add(h)
            self.slots[h] = slot
        else:
            self.stats.rejected += 1
            freed.append(slot)
        return freed

"""TinyLFU admission policy (paper §3): a host-side object that composes
with any ``Eviction`` through ``core.policies.Cache``.

Copy of ``repro/core/tinylfu.py`` (plain Python, no tensor and no device),
held equal to it by ``tests/test_torch_host_engine.py``.  The card's
counterpart is the batched admission path (``kernels/ops.py``)."""
from __future__ import annotations

from typing import Callable, Optional

from .sketch import FrequencySketch, default_sketch


class TinyLFUAdmission:
    """record() on every access; admit(candidate, victim) compares frequency
    estimates — the newcomer must be strictly more frequent to displace the
    victim (ties keep the incumbent, which resists one-hit-wonder pollution).

    ``on_reset`` supports §3.6: an LFU eviction synchronizes its internal
    counters with the sketch's halving.
    """

    def __init__(self, sketch: FrequencySketch,
                 on_reset: Optional[Callable[[], None]] = None):
        self.sketch = sketch
        self.on_reset = on_reset
        self._seen_resets = sketch.resets
        self.admitted = 0
        self.rejected = 0

    def record(self, key) -> None:
        self.sketch.add(key)
        if self.sketch.resets != self._seen_resets:
            self._seen_resets = self.sketch.resets
            if self.on_reset is not None:
                self.on_reset()

    def admit(self, candidate, victim) -> bool:
        ok = self.sketch.estimate(candidate) > self.sketch.estimate(victim)
        if ok: self.admitted += 1
        else: self.rejected += 1
        return ok


class SketchLFUEviction:
    """LFU eviction ordered by the TinyLFU sketch's estimates (§3.6: the LFU
    cache is synchronized with the sketch — counters age via the same reset).
    Items are (re)prioritized with the sketch estimate on insert and on hit,
    so the victim is the cached item the *sketch* believes least frequent."""
    name = "lfu"

    def __init__(self, capacity: int, sketch: FrequencySketch):
        from .policies import LFUEviction
        self._lfu = LFUEviction(capacity)
        self.sketch = sketch
        self.capacity = capacity

    def __contains__(self, key): return key in self._lfu
    def __len__(self): return len(self._lfu)
    def keys(self): return self._lfu.keys()
    def remove(self, key): self._lfu.remove(key)
    def peek_victim(self): return self._lfu.peek_victim()

    def _estimate(self, key) -> int:
        return max(1, self.sketch.estimate(key))

    def on_hit(self, key): self._lfu._bump(key, self._estimate(key))
    def add(self, key): self._lfu._bump(key, self._estimate(key))

    def halve_all(self):
        self._lfu.halve_all()


def tinylfu_cache(capacity: int, eviction: str = "lru", sample_factor: int = 8,
                  seed: int = 0, counters_per_item: float = 2.0,
                  doorkeeper: bool = True):
    """Factory for the paper's augmented caches: T-LRU / T-Random / T-LFU /
    T-FIFO / T-SLRU."""
    from . import policies as P

    sketch = default_sketch(capacity, sample_factor=sample_factor, seed=seed,
                            counters_per_item=counters_per_item,
                            doorkeeper=doorkeeper)
    ev: P.Eviction
    if eviction == "lru":
        ev = P.LRUEviction(capacity)
    elif eviction == "random":
        ev = P.RandomEviction(capacity, seed=seed)
    elif eviction == "fifo":
        ev = P.FIFOEviction(capacity)
    elif eviction == "slru":
        ev = P.SLRUEviction(capacity)
    elif eviction == "lfu":
        ev = SketchLFUEviction(capacity, sketch)
    else:
        raise ValueError(f"unknown eviction {eviction!r}")
    adm = TinyLFUAdmission(
        sketch, on_reset=(ev.halve_all if eviction == "lfu" else None))
    return P.Cache(ev, adm)

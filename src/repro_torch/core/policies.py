"""Host-side eviction policies the prefix cache composes with admission.

Copies of ``Eviction``, ``LRUEviction`` and ``SLRUEviction`` from
``repro/core/policies.py`` (plain Python, so the port keeps its own copy and
imports nothing of the JAX package).  Eviction picks the victim; admission
decides the swap (paper Fig. 1).
"""
from __future__ import annotations

from collections import OrderedDict


class Eviction:
    name = "base"

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"capacity {capacity} must be > 0")
        self.capacity = capacity

    def __contains__(self, key) -> bool: raise NotImplementedError
    def __len__(self) -> int: raise NotImplementedError
    def on_hit(self, key) -> None: raise NotImplementedError
    def add(self, key) -> None: raise NotImplementedError
    def remove(self, key) -> None: raise NotImplementedError
    def peek_victim(self): raise NotImplementedError
    def keys(self): raise NotImplementedError


class LRUEviction(Eviction):
    name = "lru"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.od: OrderedDict = OrderedDict()

    def __contains__(self, key): return key in self.od
    def __len__(self): return len(self.od)

    def on_hit(self, key): self.od.move_to_end(key)
    def add(self, key): self.od[key] = None
    def remove(self, key): del self.od[key]
    def peek_victim(self): return next(iter(self.od))
    def keys(self): return self.od.keys()


class SLRUEviction(Eviction):
    """Segmented LRU (§2.1): probation (A1) + protected (A2).  New items ->
    probation; hit in probation -> promote to protected; protected overflow
    demotes its LRU victim back to probation.  Victim = probation LRU."""
    name = "slru"

    def __init__(self, capacity: int, protected_frac: float = 0.8):
        super().__init__(capacity)
        self.prot_cap = max(1, int(capacity * protected_frac))
        self.probation: OrderedDict = OrderedDict()
        self.protected: OrderedDict = OrderedDict()

    def __contains__(self, key):
        return key in self.probation or key in self.protected

    def __len__(self): return len(self.probation) + len(self.protected)

    def on_hit(self, key):
        if key in self.protected:
            self.protected.move_to_end(key)
            return
        del self.probation[key]
        self.protected[key] = None
        if len(self.protected) > self.prot_cap:      # demote protected LRU
            demoted, _ = self.protected.popitem(last=False)
            self.probation[demoted] = None

    def add(self, key): self.probation[key] = None

    def remove(self, key):
        if key in self.probation:
            del self.probation[key]
        else:
            del self.protected[key]

    def peek_victim(self):
        if self.probation:
            return next(iter(self.probation))
        return next(iter(self.protected))

    def keys(self):
        return list(self.probation.keys()) + list(self.protected.keys())

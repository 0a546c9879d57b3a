"""Host-side cache eviction and replacement policies (paper §2.1 and the
§5 baselines).

Copy of ``repro/core/policies.py`` (plain Python and numpy, no tensor and no
device; the port keeps its own copy and imports nothing of the JAX package),
held equal to it by ``tests/test_torch_host_engine.py``.  Two interfaces:

* ``Eviction``: a pluggable eviction primitive (contains/on_hit/add/remove/
  peek_victim) that ``Cache`` composes with an admission policy, as in the
  paper's Fig. 1 (eviction picks the victim, admission decides the swap):
  LRU, Random, FIFO, LFU, SLRU and the set-associative SLRU twin of the
  device tables.
* ``ReplacementPolicy``: self-contained ``access(key) -> hit`` policies that
  entangle admission and eviction and so cannot host TinyLFU: ARC, LIRS, 2Q,
  WLFU, PLFU, and the host twins of the device policy panel (S3-FIFO, ARC
  and LFU on set-associative tables).
"""
from __future__ import annotations

from collections import OrderedDict, deque, Counter
import random
from typing import Optional

import numpy as np

from .hashing import (assoc_geometry, dk_probe_index, set_ways,
                      set_index32, slots_for, MSET_SALT, MSET2_SALT,
                      WSET_SALT)
from .sketch import default_sketch


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


class FIFOEviction(Eviction):
    name = "fifo"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.od: OrderedDict = OrderedDict()

    def __contains__(self, key): return key in self.od
    def __len__(self): return len(self.od)
    def on_hit(self, key): pass
    def add(self, key): self.od[key] = None
    def remove(self, key): del self.od[key]
    def peek_victim(self): return next(iter(self.od))
    def keys(self): return self.od.keys()


class RandomEviction(Eviction):
    name = "random"

    def __init__(self, capacity: int, seed: int = 0):
        super().__init__(capacity)
        self.rng = random.Random(seed)
        self.items: list = []
        self.pos: dict = {}

    def __contains__(self, key): return key in self.pos
    def __len__(self): return len(self.items)
    def on_hit(self, key): pass

    def add(self, key):
        self.pos[key] = len(self.items)
        self.items.append(key)

    def remove(self, key):
        i = self.pos.pop(key)
        last = self.items.pop()
        if last != key:
            self.items[i] = last
            self.pos[last] = i

    def peek_victim(self):
        # fresh draw per access: a sticky victim with a maxed-out counter
        # would freeze the cache behind an unbeatable incumbent
        return self.items[self.rng.randrange(len(self.items))]

    def keys(self): return list(self.items)


class LFUEviction(Eviction):
    """In-memory LFU with O(1) ops (freq-bucket linked structure) + the §3.6
    synchronization hook: ``halve_all()`` is called by TinyLFU's reset so the
    cache's counters age together with the sketch."""
    name = "lfu"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.freq: dict = {}
        self.buckets: dict[int, OrderedDict] = {}
        self.minf = 0

    def __contains__(self, key): return key in self.freq
    def __len__(self): return len(self.freq)

    def _bump(self, key, newf):
        oldf = self.freq.get(key)
        if oldf is not None:
            b = self.buckets[oldf]
            del b[key]
            if not b:
                del self.buckets[oldf]
                if self.minf == oldf:
                    self.minf = newf if oldf != newf else self.minf
        self.freq[key] = newf
        self.buckets.setdefault(newf, OrderedDict())[key] = None
        if newf < self.minf or len(self.freq) == 1:
            self.minf = newf

    def on_hit(self, key): self._bump(key, self.freq[key] + 1)
    def add(self, key): self._bump(key, 1)

    def remove(self, key):
        f = self.freq.pop(key)
        b = self.buckets[f]
        del b[key]
        if not b:
            del self.buckets[f]
            if self.minf == f and self.freq:
                self.minf = min(self.buckets)   # rare; amortized fine
        if not self.freq:
            self.minf = 0

    def peek_victim(self):
        while self.minf not in self.buckets:
            self.minf = min(self.buckets)
        return next(iter(self.buckets[self.minf]))

    def keys(self): return self.freq.keys()

    def halve_all(self):
        items = [(k, f // 2) for k, f in self.freq.items()]
        self.freq.clear(); self.buckets.clear()
        for k, f in items:
            f = max(f, 1)
            self.freq[k] = f
            self.buckets.setdefault(f, OrderedDict())[k] = None
        self.minf = min(self.buckets) if self.buckets else 0


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


class SetAssociativeSLRU(Eviction):
    """Host twin of the device set-associative SLRU main table
    (kernels/sketch_step.py ``_one_access_set``).

    Layout and semantics mirror the device exactly: pow2 sets of ``ways``
    (>= ``assoc``) slots sized by ``core.hashing.assoc_geometry``/``set_ways``,
    power-of-two-choices placement (``MSET_SALT``/``MSET2_SALT`` 32-bit-lane
    set hashes — a key resides in exactly one of its two choice sets),
    per-set protected budget ``max(1, usable * prot_cap // capacity)``, and
    victim priority empty < probation LRU < protected LRU across the key's
    two sets with the first-choice set winning ties.  Stamps are
    caller-provided monotone access indices so ``WTinyLFU(assoc=...)``
    reproduces the device engine's per-access hit sequence bit-for-bit
    (tests pin this with collision-free sketches).
    """
    name = "slru-assoc"

    def __init__(self, capacity: int, assoc: int = 8,
                 protected_frac: float = 0.8):
        super().__init__(capacity)
        self.n_sets, self.ways = assoc_geometry(capacity, assoc)
        self.usable = set_ways(capacity, self.n_sets)
        self.prot_cap = max(1, int(capacity * protected_frac))
        # per set: key -> [protected: bool, stamp: int]
        self.slots: list[dict] = [dict() for _ in range(self.n_sets)]
        self.home: dict = {}              # key -> resident set index
        self._memo: dict = {}             # key -> (choice set 1, choice set 2)
        self.t = 0                        # auto-stamp for standalone use

    def _stamp(self, stamp: Optional[int]) -> int:
        if stamp is None:
            stamp = self.t
            self.t += 1
        return stamp

    _MEMO_LIMIT = 2_000_000           # hash memo safety valve (scan traces)

    def sets_of(self, key) -> tuple[int, int]:
        p = self._memo.get(key)
        if p is None:
            p = (set_index32(key, self.n_sets, MSET_SALT),
                 set_index32(key, self.n_sets, MSET2_SALT))
            if len(self._memo) >= self._MEMO_LIMIT:
                self._memo.clear()
            self._memo[key] = p
        return p

    def __contains__(self, key): return key in self.home
    def __len__(self): return len(self.home)
    def keys(self): return list(self.home)

    def _prot_budget(self, s: int) -> int:
        return max(1, self.usable[s] * self.prot_cap // max(1, self.capacity))

    def on_hit(self, key, stamp: Optional[int] = None) -> None:
        """Promote-or-refresh to protected MRU; overflow demotes the set's
        protected LRU back to probation MRU (device step 3b)."""
        stamp = self._stamp(stamp)
        s = self.home[key]
        st = self.slots[s]
        st[key] = [True, stamp]
        if sum(1 for p, _ in st.values() if p) > self._prot_budget(s):
            demote = min((k for k, (p, _) in st.items() if p),
                         key=lambda k: st[k][1])
            st[demote] = [False, stamp]

    def victim_for(self, key) -> tuple[int, object]:
        """Where an insert of ``key`` would land: ``(set, None)`` for a free
        way, else ``(set, victim_key)`` — the weakest of the two choice
        sets' records (device step 5's argmin over the 2*ways concat)."""
        s1, s2 = self.sets_of(key)
        for s in (s1, s2):
            if len(self.slots[s]) < self.usable[s]:
                return s, None
        best = None
        for s in (s1, s2):
            for k, (p, stmp) in self.slots[s].items():
                if best is None or (p, stmp) < best[:2]:
                    best = (p, stmp, s, k)
        return best[2], best[3]

    def insert(self, key, set_index: int, stamp: Optional[int] = None) -> None:
        """Place ``key`` in ``set_index`` as probation MRU (admitted or
        free-way insert; the set comes from :meth:`victim_for`)."""
        self.slots[set_index][key] = [False, self._stamp(stamp)]
        self.home[key] = set_index

    def remove(self, key) -> None:
        del self.slots[self.home.pop(key)][key]

    # -- Eviction-interface conveniences for standalone composition ----------
    def add(self, key) -> None:
        s, victim = self.victim_for(key)
        if victim is not None:
            self.remove(victim)
        self.insert(key, s)

    def peek_victim(self):
        """Globally weakest record (O(capacity) — diagnostics only; the
        device-faithful query is the per-key :meth:`victim_for`)."""
        best = None
        for st in self.slots:
            for k, (p, stmp) in st.items():
                if best is None or (p, stmp) < best[:2]:
                    best = (p, stmp, k)
        return best[2] if best else None


# ===========================================================================
# Cache driver: eviction ∘ admission   (paper Fig. 1)
# ===========================================================================

class Cache:
    """``access(key) -> hit`` driver wiring an Eviction to an optional
    admission policy object exposing record(key) and admit(cand, victim)."""

    def __init__(self, eviction: Eviction, admission=None):
        self.ev = eviction
        self.admission = admission
        self.hits = 0
        self.misses = 0

    @property
    def capacity(self): return self.ev.capacity

    def access(self, key) -> bool:
        adm = self.admission
        if adm is not None:
            adm.record(key)
        if key in self.ev:
            self.ev.on_hit(key)
            self.hits += 1
            return True
        self.misses += 1
        if len(self.ev) < self.ev.capacity:
            self.ev.add(key)
            return False
        victim = self.ev.peek_victim()
        if adm is None or adm.admit(key, victim):
            self.ev.remove(victim)
            self.ev.add(key)
        return False

    @property
    def hit_ratio(self):
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


# ===========================================================================
# Self-contained replacement policies
# ===========================================================================

class ReplacementPolicy:
    name = "base"

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.hits = 0
        self.misses = 0

    def access(self, key) -> bool:
        hit = self._access(key)
        if hit: self.hits += 1
        else: self.misses += 1
        return hit

    @property
    def hit_ratio(self):
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class PLFU(ReplacementPolicy):
    """Perfect LFU: unbounded global histogram; cache holds argmax-C keys.
    Implemented incrementally: on access, bump global count; admit iff count
    exceeds the cache's current minimum (classic PLFU behaviour)."""
    name = "plfu"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.counts: Counter = Counter()
        self.lfu = LFUEviction(capacity)    # reuse bucket structure, freq=global count

    def _access(self, key) -> bool:
        self.counts[key] += 1
        c = self.counts[key]
        if key in self.lfu:
            self.lfu._bump(key, c)
            return True
        if len(self.lfu) < self.capacity:
            self.lfu._bump(key, c)
            return False
        victim = self.lfu.peek_victim()
        if c > self.lfu.freq[victim]:
            self.lfu.remove(victim)
            self.lfu._bump(key, c)
        return False


class WLFU(ReplacementPolicy):
    """Window LFU [38]: exact frequency over the last W requests; both the
    eviction and the admission compare exact window counts."""
    name = "wlfu"

    def __init__(self, capacity: int, window: int):
        super().__init__(capacity)
        self.window = window
        self.win: deque = deque()
        self.wcount: Counter = Counter()
        self.lfu = LFUEviction(capacity)

    def _record(self, key):
        self.win.append(key)
        self.wcount[key] += 1
        if len(self.win) > self.window:
            old = self.win.popleft()
            self.wcount[old] -= 1
            if self.wcount[old] <= 0:
                del self.wcount[old]
            if old in self.lfu:
                self.lfu._bump(old, max(1, self.wcount[old]))

    def _access(self, key) -> bool:
        self._record(key)
        c = max(1, self.wcount[key])
        if key in self.lfu:
            self.lfu._bump(key, c)
            return True
        if len(self.lfu) < self.capacity:
            self.lfu._bump(key, c)
            return False
        victim = self.lfu.peek_victim()
        if c > self.lfu.freq[victim]:
            self.lfu.remove(victim)
            self.lfu._bump(key, c)
        return False


class TwoQ(ReplacementPolicy):
    """2Q [37]: A1in FIFO (25%), A1out ghost FIFO (50% of capacity, keys
    only), Am LRU (75%)."""
    name = "2q"

    def __init__(self, capacity: int, kin: float = 0.25, kout: float = 0.5):
        super().__init__(capacity)
        self.kin_cap = max(1, int(capacity * kin))
        self.am_cap = max(1, capacity - self.kin_cap)
        self.kout_cap = max(1, int(capacity * kout))
        self.a1in: OrderedDict = OrderedDict()
        self.a1out: OrderedDict = OrderedDict()
        self.am: OrderedDict = OrderedDict()

    def _access(self, key) -> bool:
        if key in self.am:
            self.am.move_to_end(key)
            return True
        if key in self.a1in:                 # stays in A1in until FIFO-evicted
            return True
        if key in self.a1out:                # ghost hit -> promote to Am
            del self.a1out[key]
            self.am[key] = None
            if len(self.am) > self.am_cap:
                self.am.popitem(last=False)
            return False
        self.a1in[key] = None
        if len(self.a1in) > self.kin_cap:
            old, _ = self.a1in.popitem(last=False)
            self.a1out[old] = None
            if len(self.a1out) > self.kout_cap:
                self.a1out.popitem(last=False)
        return False


class ARC(ReplacementPolicy):
    """ARC [44]: T1/T2 resident, B1/B2 ghosts, adaptive target p."""
    name = "arc"

    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.p = 0
        self.t1: OrderedDict = OrderedDict()
        self.t2: OrderedDict = OrderedDict()
        self.b1: OrderedDict = OrderedDict()
        self.b2: OrderedDict = OrderedDict()

    def _replace(self, in_b2: bool):
        if self.t1 and (len(self.t1) > self.p or (in_b2 and len(self.t1) == self.p)):
            old, _ = self.t1.popitem(last=False)
            self.b1[old] = None
        else:
            old, _ = self.t2.popitem(last=False)
            self.b2[old] = None

    def _access(self, key) -> bool:
        c = self.capacity
        if key in self.t1:
            del self.t1[key]
            self.t2[key] = None
            return True
        if key in self.t2:
            self.t2.move_to_end(key)
            return True
        if key in self.b1:
            self.p = min(c, self.p + max(1, len(self.b2) // max(1, len(self.b1))))
            self._replace(False)
            del self.b1[key]
            self.t2[key] = None
            return False
        if key in self.b2:
            self.p = max(0, self.p - max(1, len(self.b1) // max(1, len(self.b2))))
            self._replace(True)
            del self.b2[key]
            self.t2[key] = None
            return False
        # brand-new key
        if len(self.t1) + len(self.b1) == c:
            if len(self.t1) < c:
                self.b1.popitem(last=False)
                self._replace(False)
            else:
                self.t1.popitem(last=False)
        elif len(self.t1) + len(self.b1) < c:
            total = len(self.t1) + len(self.t2) + len(self.b1) + len(self.b2)
            if total >= c:
                if total == 2 * c:
                    self.b2.popitem(last=False)
                self._replace(False)
        self.t1[key] = None
        return False


class LIRS(ReplacementPolicy):
    """LIRS [36].  Stack S tracks recency of LIR + recently-seen HIR (resident
    and non-resident); queue Q holds resident HIR blocks.  ~1% HIR budget."""
    name = "lirs"

    LIR, HIR_RES, HIR_NONRES = 0, 1, 2

    def __init__(self, capacity: int, hir_frac: float = 0.01,
                 max_nonres_factor: float = 3.0):
        super().__init__(capacity)
        self.lhirs = max(1, int(capacity * hir_frac))
        self.llirs = max(1, capacity - self.lhirs)
        self.s: OrderedDict = OrderedDict()   # key -> state (front=LRU end=MRU)
        self.q: OrderedDict = OrderedDict()   # resident HIR
        self.lir_count = 0
        self.state: dict = {}                  # key -> state for residents+ghosts
        self.max_nonres = int(max_nonres_factor * capacity)
        self.nonres: OrderedDict = OrderedDict()  # ghost order (oldest first)

    def _prune(self):
        # Bottom of S must be LIR.
        while self.s:
            k = next(iter(self.s))
            if self.state.get(k) == self.LIR:
                break
            del self.s[k]
            if self.state.get(k) == self.HIR_NONRES:
                del self.state[k]              # fully forgotten
                self.nonres.pop(k, None)

    def _bound_nonres(self):
        while len(self.nonres) > self.max_nonres:
            k, _ = self.nonres.popitem(last=False)
            if self.state.get(k) == self.HIR_NONRES:
                del self.state[k]
                self.s.pop(k, None)
        self._prune()

    def _evict_hir_resident(self):
        k, _ = self.q.popitem(last=False)
        if k in self.s:
            self.state[k] = self.HIR_NONRES
            self.nonres[k] = None
        else:
            del self.state[k]

    def _demote_lir_bottom(self):
        k = next(iter(self.s))
        del self.s[k]
        self.state[k] = self.HIR_RES
        self.q[k] = None
        self.lir_count -= 1
        self._prune()

    def _access(self, key) -> bool:
        st = self.state.get(key)
        if st == self.LIR:
            was_bottom = next(iter(self.s)) == key
            self.s.move_to_end(key)
            if was_bottom:
                self._prune()
            return True
        if st == self.HIR_RES:
            in_s = key in self.s
            if in_s:
                self.s.move_to_end(key)
                self.state[key] = self.LIR
                self.lir_count += 1
                del self.q[key]
                if self.lir_count > self.llirs:
                    self._demote_lir_bottom()
            else:
                self.s[key] = None
                self.q.move_to_end(key)
            return True
        # miss (new or non-resident HIR ghost)
        if self.lir_count < self.llirs and st is None and not self.q:
            self.state[key] = self.LIR
            self.s[key] = None
            self.lir_count += 1
            return False
        if len(self.q) + self.lir_count >= self.capacity:
            if self.q:
                self._evict_hir_resident()
            else:
                self._demote_lir_bottom()
                self._evict_hir_resident()
        if st == self.HIR_NONRES and key in self.s:   # ghost hit -> LIR
            self.nonres.pop(key, None)
            self.s.move_to_end(key)
            self.state[key] = self.LIR
            self.lir_count += 1
            if self.lir_count > self.llirs:
                self._demote_lir_bottom()
        else:
            self.nonres.pop(key, None)
            self.state[key] = self.HIR_RES
            self.s[key] = None
            self.q[key] = None
        self._bound_nonres()
        return False


# ===========================================================================
# Device-policy host twins (kernels/sketch_step.py StepSpec.policy panel)
# ===========================================================================

class _SetAssocTable:
    """Shared set-associative main-table bookkeeping for the device-policy
    host twins: pow2 sets sized by ``assoc_geometry``/``set_ways``,
    power-of-two-choices placement (``MSET_SALT``/``MSET2_SALT``), per-set
    ``key -> [flag, stamp]`` records.  Free-way preference follows the
    device victim argmin exactly: an empty slot (-1 meta) beats every
    resident, and the first-choice set's empties order before the
    second's in the (2*ways,) concat."""

    _MEMO_LIMIT = 2_000_000           # hash memo safety valve (scan traces)

    def __init__(self, capacity: int, assoc: int):
        self.capacity = capacity
        self.n_sets, self.ways = assoc_geometry(capacity, assoc)
        self.usable = set_ways(capacity, self.n_sets)
        self.slots: list[dict] = [dict() for _ in range(self.n_sets)]
        self.home: dict = {}              # key -> resident set index
        self._memo: dict = {}

    def sets_of(self, key) -> tuple[int, int]:
        p = self._memo.get(key)
        if p is None:
            p = (set_index32(key, self.n_sets, MSET_SALT),
                 set_index32(key, self.n_sets, MSET2_SALT))
            if len(self._memo) >= self._MEMO_LIMIT:
                self._memo.clear()
            self._memo[key] = p
        return p

    def __contains__(self, key): return key in self.home
    def __len__(self): return len(self.home)

    def free_set(self, key):
        """First choice set with a free usable way, or None (device: the
        empty-slot -1 wins the victim argmin, first half first)."""
        s1, s2 = self.sets_of(key)
        for s in (s1, s2):
            if len(self.slots[s]) < self.usable[s]:
                return s
        return None

    def insert(self, key, s: int, flag: bool, stamp: int) -> None:
        self.slots[s][key] = [flag, stamp]
        self.home[key] = s

    def remove(self, key) -> None:
        del self.slots[self.home.pop(key)][key]

    def residents(self, key):
        """(set, key, flag, stamp) over the key's two choice sets, first
        choice first — deduplicated when the choices alias (device masks
        the duplicate second half out of the victim scan)."""
        s1, s2 = self.sets_of(key)
        out = [(s1, k, f, st) for k, (f, st) in self.slots[s1].items()]
        if s2 != s1:
            out += [(s2, k, f, st) for k, (f, st) in self.slots[s2].items()]
        return out


class _GhostBloom:
    """Bit-for-bit replay of one half of the device ``"ghost"`` buffer: a
    ``dk_bits``-bit Bloom filter addressed by the doorkeeper probe schedule
    (``core.hashing.dk_probe_index_np``), cleared wholesale when it has
    absorbed ``clear_at`` inserts (the device's saturation clear)."""

    def __init__(self, dk_bits: int, dk_probes: int, clear_at: int):
        self.dk_bits = dk_bits
        self.dk_probes = dk_probes
        self.clear_at = clear_at
        self.words = np.zeros(max(1, dk_bits // 32), np.int64)
        self.count = 0
        self._memo: dict = {}

    def _bits(self, key):
        b = self._memo.get(key)
        if b is None:
            lo, hi = key & 0xFFFFFFFF, (key >> 32) & 0xFFFFFFFF
            b = tuple(dk_probe_index(lo, hi, p, self.dk_bits)
                      for p in range(self.dk_probes))
            if len(self._memo) >= _SetAssocTable._MEMO_LIMIT:
                self._memo.clear()
            self._memo[key] = b
        return b

    def __contains__(self, key) -> bool:
        return all((int(self.words[b >> 5]) >> (b & 31)) & 1
                   for b in self._bits(key))

    def add(self, key) -> None:
        if self.count >= self.clear_at:
            self.words[:] = 0
            self.count = 0
        for b in self._bits(key):
            self.words[b >> 5] |= np.int64(1 << (b & 31))
        self.count += 1


class SetAssocS3FIFO(ReplacementPolicy):
    """Host twin of the device ``policy="s3fifo"`` step
    (kernels/sketch_step.py ``_one_access_set_s3fifo``).

    S3-FIFO on the shared set-associative machinery: a small per-set FIFO
    (the device window table — hits do NOT refresh, order is insert
    order), a CLOCK-marked main FIFO (a hit sets the accessed flag and
    keeps the insert stamp; the victim scan prefers empty < unmarked
    FIFO-oldest < marked FIFO-oldest across the key's two choice sets),
    and the frequency sketch as the one-hit-wonder filter: a candidate
    displaced from the small FIFO enters main only when its estimate is
    >= 2, with no free-slot override.  With collision-free sketches the
    per-access hit sequence equals the device program's bit-for-bit."""
    name = "s3fifo-assoc"

    def __init__(self, capacity: int, window_frac: float = 0.1,
                 assoc: int = 8, sample_factor: int = 8, seed: int = 0,
                 counters_per_item: float = 1.0, doorkeeper: bool = True):
        super().__init__(capacity)
        self.window_cap = max(1, int(round(capacity * window_frac)))
        self.main_cap = max(1, capacity - self.window_cap)
        self.main = _SetAssocTable(self.main_cap, assoc)
        ways = self.main.ways
        self._n_wsets = slots_for(self.window_cap, ways) // ways
        self._wusable = set_ways(self.window_cap, self._n_wsets)
        self._wsets = [OrderedDict() for _ in range(self._n_wsets)]
        self._wset_memo: dict = {}
        self._t = 0
        self.sketch = default_sketch(capacity, sample_factor=sample_factor,
                                     seed=seed,
                                     counters_per_item=counters_per_item,
                                     doorkeeper=doorkeeper)

    def _wset_of(self, key) -> int:
        s = self._wset_memo.get(key)
        if s is None:
            s = set_index32(key, self._n_wsets, WSET_SALT)
            if len(self._wset_memo) >= _SetAssocTable._MEMO_LIMIT:
                self._wset_memo.clear()
            self._wset_memo[key] = s
        return s

    def _access(self, key) -> bool:
        t = self._t
        self._t += 1
        self.sketch.add(key)
        ws = self._wset_of(key)
        wset = self._wsets[ws]
        if key in wset:                    # small-FIFO hit: NO refresh
            return True
        if key in self.main:               # main hit: set the CLOCK mark
            s = self.main.home[key]
            self.main.slots[s][key][0] = True
            return True
        # miss: small-FIFO insert; overflow displaces the oldest toward main
        wset[key] = None
        if len(wset) > self._wusable[ws]:
            cand, _ = wset.popitem(last=False)
            if self.sketch.estimate(cand) >= 2:     # one-hit-wonder filter
                s = self.main.free_set(cand)
                if s is not None:
                    self.main.insert(cand, s, False, t)
                else:
                    best = None
                    for s_, k, f, st in self.main.residents(cand):
                        if best is None or (f, st) < best[:2]:
                            best = (f, st, s_, k)
                    if best is not None:
                        self.main.remove(best[3])
                        self.main.insert(cand, best[2], False, t)
        return False


class SetAssocARC(ReplacementPolicy):
    """Host twin of the device ``policy="arc"`` step
    (kernels/sketch_step.py ``_one_access_set_arc``).

    The seed :class:`ARC` is the algorithmic reference; this twin replays
    the device's *approximations* of it exactly: T1/T2 share the
    set-associative main table (flag = "in T2"), the adaptive target ``p``
    moves by +-1 per ghost hit (clamped to [0, capacity]), and the B1/B2
    ghost lists are Bloom halves replayed bit-for-bit through the device
    doorkeeper probe schedule — membership is approximate, removal is the
    wholesale saturation clear.  Because the Bloom arithmetic is replayed
    exactly (``dk_probe_index_np``), the hit sequence matches the device
    program exact-by-construction at ANY ``dk_bits`` — no collision-free
    assumption needed (ARC never consults the frequency sketch)."""
    name = "arc-assoc"

    def __init__(self, capacity: int, assoc: int = 8,
                 dk_bits: int | None = None, dk_probes: int = 3):
        super().__init__(capacity)
        if dk_bits is None:
            dk_bits = max(32, 1 << max(0, (32 * capacity - 1).bit_length()))
        self.main = _SetAssocTable(capacity, assoc)
        self.p = 0
        self.t1count = 0
        self.b1 = _GhostBloom(dk_bits, dk_probes, capacity)
        self.b2 = _GhostBloom(dk_bits, dk_probes, capacity)
        self._t = 0

    def _access(self, key) -> bool:
        t = self._t
        self._t += 1
        main = self.main
        if key in main:                    # hit: promote to T2, refresh
            rec = main.slots[main.home[key]][key]
            if not rec[0]:
                self.t1count -= 1          # T1 hit leaves T1
            rec[0] = True
            rec[1] = t
            return True
        # miss: ghost-driven +-1 adaptation (B1 beats B2 when both match)
        gb1 = key in self.b1
        gb2 = key in self.b2
        if gb1:
            self.p = min(self.main.capacity, self.p + 1)
        elif gb2:
            self.p = max(0, self.p - 1)
        in_t2 = gb1 or gb2                 # ghost-remembered -> T2
        s = main.free_set(key)
        if s is None:
            prefer_t1 = (self.t1count > self.p
                         or ((gb2 and not gb1) and self.t1count == self.p))
            best = None
            for s_, k, f, st in main.residents(key):
                okey = (f if prefer_t1 else not f, st)
                if best is None or okey < best[0]:
                    best = (okey, s_, k, f)
            if best is None:               # degenerate zero-way sets
                return False
            _, s, vic, vic_t2 = best
            main.remove(vic)
            if vic_t2:
                self.b2.add(vic)
            else:
                self.b1.add(vic)
                self.t1count -= 1
        main.insert(key, s, in_t2, t)
        if not in_t2:
            self.t1count += 1
        return False


class SetAssocLFU(ReplacementPolicy):
    """Host twin of the device ``policy="lfu"`` step
    (kernels/sketch_step.py ``_one_access_set_lfu``).

    Heap-free sketch-LFU: no window, no admission filter; the victim is
    the resident with the smallest sketch estimate across the key's two
    choice sets (stamps break frequency ties toward the LRU record), and
    a hit refreshes the stamp only.  With collision-free sketches the
    per-access hit sequence equals the device program's bit-for-bit."""
    name = "lfu-assoc"

    def __init__(self, capacity: int, assoc: int = 8, sample_factor: int = 8,
                 seed: int = 0, counters_per_item: float = 1.0,
                 doorkeeper: bool = True):
        super().__init__(capacity)
        self.main = _SetAssocTable(capacity, assoc)
        self._t = 0
        self.sketch = default_sketch(capacity, sample_factor=sample_factor,
                                     seed=seed,
                                     counters_per_item=counters_per_item,
                                     doorkeeper=doorkeeper)

    def _access(self, key) -> bool:
        t = self._t
        self._t += 1
        self.sketch.add(key)
        main = self.main
        if key in main:
            main.slots[main.home[key]][key][1] = t      # stamp refresh only
            return True
        s = main.free_set(key)
        if s is None:
            best = None
            for s_, k, _f, st in main.residents(key):
                okey = (self.sketch.estimate(k), st)
                if best is None or okey < best[0]:
                    best = (okey, s_, k)
            if best is None:               # degenerate zero-way sets
                return False
            _, s, vic = best
            main.remove(vic)
        main.insert(key, s, False, t)
        return False

"""W-TinyLFU (paper §4, Fig 5): LRU window cache (no admission) in front of an
SLRU main cache guarded by TinyLFU admission.

Flow per access:
  * hit in window or main -> hit (window hit refreshes window LRU; main hit
    follows SLRU promotion).
  * miss -> insert into window.  If the window overflows, its LRU victim asks
    for admission into the main cache; on rejection the window victim is
    dropped (it *is* W-TinyLFU's victim), on admission the main cache's SLRU
    victim is dropped instead.

Caffeine 2.0 defaults: window = 1% of total capacity, main = 99% with an
80/20 protected/probation SLRU split.

``assoc=W`` switches both tables to the set-associative layout — a host twin
of the device engine's O(ways) tables (kernels/sketch_step.py): the window
becomes per-set LRU and the main cache a ``SetAssociativeSLRU``
(power-of-two-choices placement, per-set protected budgets).  With
collision-free sketches the assoc host and device engines produce identical
per-access hit sequences (tests/test_torch_paper_traces.py pins this).

``shards=S`` swaps the sketch for the sharded twin
(``core.sketch.ShardedFrequencySketch``): writes accumulate in shard-local
deltas, reads compose global+delta, and every ``merge_every`` accesses the
merge_halve fold runs — mirroring the device engine's ``StepSpec.shards``
mode, whose per-access hit sequence it reproduces bit-for-bit under
collision-free sketches (reset timing included: §3.3 aging is deferred to
the merge boundaries on both sides).

``stale_admission=True`` (sharded only) makes admission estimates read the
merged global sketch ONLY — stale by at most one merge epoch — the host
twin of the device mesh runner's speculative ``mesh_exchange="stale"``
mode, whose per-access path is collective-free.  Under collision-free
sketches its hit sequence matches the stale-mode mesh run bit-for-bit.

Copy of ``repro/core/wtinylfu.py`` (plain Python, no tensor and no
device), held equal to it by ``tests/test_torch_host_engine.py``.  Its
counterpart on the card is ``core.device_simulate.simulate_trace``.
"""
from __future__ import annotations

from collections import OrderedDict

from .adaptive import window_cap_max, resolve_climb, climb_update
from .hashing import slots_for, set_ways, set_index32, WSET_SALT
from .policies import SLRUEviction, SetAssociativeSLRU, ReplacementPolicy
from .sketch import default_sketch
from .tinylfu import TinyLFUAdmission


class WTinyLFU(ReplacementPolicy):
    name = "w-tinylfu"

    def __init__(self, capacity: int, window_frac: float = 0.01,
                 sample_factor: int = 8, protected_frac: float = 0.8,
                 seed: int = 0, counters_per_item: float = 1.0,
                 doorkeeper: bool = True, assoc: int | None = None,
                 shards: int = 1, merge_every: int = 0,
                 stale_admission: bool = False):
        super().__init__(capacity)
        self.window_cap = max(1, int(round(capacity * window_frac)))
        self.main_cap = max(1, capacity - self.window_cap)
        self.assoc = assoc
        # sharded sketch twin (device StepSpec.shards): writes accumulate in
        # shard deltas and every ``merge_every`` accesses the merge_halve
        # fold runs — mirroring the device's epoch-boundary fused op,
        # including the 0 = auto cadence (min(4096, sample_size), i.e.
        # DeviceWTinyLFU.merge_epoch — aging never defers past one reset
        # period)
        self.shards = shards
        self.merge_every = merge_every or max(
            1, min(4096, sample_factor * capacity))
        self._nacc = 0
        if assoc is None:
            self.window: OrderedDict = OrderedDict()
            self.main = SLRUEviction(self.main_cap,
                                     protected_frac=protected_frac)
        else:
            self.main = SetAssociativeSLRU(self.main_cap, assoc=assoc,
                                           protected_frac=protected_frac)
            # the window shares the main table's static ways (one block
            # shape on device); per-set LRU over pow2 window sets
            ways = self.main.ways
            self._n_wsets = slots_for(self.window_cap, ways) // ways
            self._wusable = set_ways(self.window_cap, self._n_wsets)
            self._wsets = [OrderedDict() for _ in range(self._n_wsets)]
            self._wset_memo: dict = {}
            self._t = 0                    # device-matching LRU stamp
        sketch = default_sketch(capacity, sample_factor=sample_factor,
                                seed=seed, counters_per_item=counters_per_item,
                                doorkeeper=doorkeeper, shards=shards,
                                stale_estimates=stale_admission)
        self.admission = TinyLFUAdmission(sketch)

    def __contains__(self, key):
        if self.assoc is None:
            return key in self.window or key in self.main
        return (key in self._wsets[self._wset_of(key)]
                or key in self.main)

    _WSET_MEMO_LIMIT = 2_000_000      # hash memo safety valve (scan traces)

    def _wset_of(self, key) -> int:
        s = self._wset_memo.get(key)
        if s is None:
            s = set_index32(key, self._n_wsets, WSET_SALT)
            if len(self._wset_memo) >= self._WSET_MEMO_LIMIT:
                self._wset_memo.clear()
            self._wset_memo[key] = s
        return s

    def _access(self, key) -> bool:
        hit = (self._access_assoc(key) if self.assoc is not None
               else self._access_flat(key))
        if self.shards > 1:
            # device parity: the merge_halve fold runs after every
            # merge_every-th access completes, never on a partial tail
            self._nacc += 1
            if self._nacc % self.merge_every == 0:
                self.admission.sketch.merge_halve()
        return hit

    def _access_flat(self, key) -> bool:
        self.admission.record(key)
        if key in self.window:
            self.window.move_to_end(key)
            return True
        if key in self.main:
            self.main.on_hit(key)
            return True
        # miss: admit to window unconditionally
        self.window[key] = None
        if len(self.window) > self.window_cap:
            cand, _ = self.window.popitem(last=False)
            if len(self.main) < self.main.capacity:
                self.main.add(cand)
            else:
                victim = self.main.peek_victim()
                if self.admission.admit(cand, victim):
                    self.main.remove(victim)
                    self.main.add(cand)
        return False

    def _access_assoc(self, key) -> bool:
        """Set-associative twin of the device `_one_access_set` step."""
        t = self._t
        self._t += 1
        self.admission.record(key)
        wset = self._wsets[self._wset_of(key)]
        if key in wset:
            wset.move_to_end(key)          # refresh = stamp t (order only)
            return True
        if key in self.main:
            self.main.on_hit(key, t)
            return True
        # miss: insert into the key's window set; per-set LRU overflow
        # displaces a candidate toward the main table
        wset[key] = None
        if len(wset) > self._wusable[self._wset_of(key)]:
            cand, _ = wset.popitem(last=False)
            vset, victim = self.main.victim_for(cand)
            if victim is None:             # free way in a choice set
                self.main.insert(cand, vset, t)
            elif self.admission.admit(cand, victim):
                self.main.remove(victim)
                self.main.insert(cand, vset, t)
        return False


class AdaptiveWTinyLFU(ReplacementPolicy):
    """Runtime-adaptive W-TinyLFU: the window/main split is mutable state
    driven by an epoch-based hill-climber — the host twin of the device
    engine's ``adaptive=True`` mode (kernels/sketch_step.py runtime quota +
    core/device_simulate.py climb), exact flat-table layout.

    Every decision mirrors the device step bit-for-bit: stamps derive from
    the global access index (window ``2t`` / main ``2t+1`` so migration can
    never collide two entries), SLRU priority is the packed-meta order
    (probation stamp < protected stamp), the runtime protected budget is
    ``max(1, mcap_rt * prot_cap // main_cap)``, misses insert into the
    window gated by the runtime quota, and every ``epoch_len`` accesses the
    shared integer climb rule (``core.adaptive.climb_update``) moves the
    quota and the rebalance migrates displaced window records into main's
    free room (stamps preserved) or evicts main's weakest beyond its new
    budget.  With collision-free sketches on both sides the per-access hit
    sequence equals the device climber's exactly (tests pin this).
    """
    name = "w-tinylfu-adaptive"

    def __init__(self, capacity: int, window_frac: float = 0.01,
                 sample_factor: int = 8, protected_frac: float = 0.8,
                 seed: int = 0, counters_per_item: float = 1.0,
                 doorkeeper: bool = True, window_max_frac: float = 0.5,
                 epoch_len: int = 4096, delta0: int = 0, wmin: int = 1,
                 wmax: int = 0, tol: int = 0, restart: int = 0,
                 warm_epochs: int = 3, shards: int = 1,
                 stale_admission: bool = False):
        super().__init__(capacity)
        self.shards = shards          # sharded sketch: merge rides the epochs
        self.window_cap0 = max(1, int(round(capacity * window_frac)))
        self.main_cap0 = max(1, capacity - self.window_cap0)
        self.total = self.window_cap0 + self.main_cap0
        self.prot_cap0 = max(1, int(self.main_cap0 * protected_frac))
        self.quota = self.window_cap0
        self.epoch_len = epoch_len
        self.climb = resolve_climb(
            epoch_len, delta0, wmin, wmax, tol, restart, warm_epochs,
            window_cap_max(capacity, self.window_cap0, window_max_frac))
        # window: key -> stamp; main: key -> [protected, stamp]
        self._window: dict = {}
        self._main: dict = {}
        self._pcount = 0
        self._t = 0
        # climber carry (mirrors the device scan carry)
        self._prev, self._dirn, self._delta = -1, 1, self.climb[0]
        self._ewma, self._trend, self._k = -1, 0, 0
        self._ehits = 0
        self._eacc = 0
        self.quota_trajectory: list[int] = []
        sketch = default_sketch(capacity, sample_factor=sample_factor,
                                seed=seed, counters_per_item=counters_per_item,
                                doorkeeper=doorkeeper, shards=shards,
                                stale_estimates=stale_admission)
        self.admission = TinyLFUAdmission(sketch)

    def __contains__(self, key):
        return key in self._window or key in self._main

    def _access(self, key) -> bool:
        t = self._t
        self._t += 1
        # stamps are globally unique across tables (window even, main odd)
        # so rebalance migration can never collide two entries on one stamp
        # — the device kernel uses the same mapping (see _one_access_flat)
        wst, mst = 2 * t, 2 * t + 1
        self.admission.record(key)
        mcap_rt = self.total - self.quota
        prot_rt = max(1, mcap_rt * self.prot_cap0 // max(1, self.main_cap0))
        hit = True
        if key in self._window:
            self._window[key] = wst
        elif key in self._main:
            e = self._main[key]
            if not e[0]:
                self._pcount += 1
            e[0], e[1] = True, mst
            if self._pcount > prot_rt:
                # demote the protected LRU back to probation MRU
                kd = min((k for k, v in self._main.items() if v[0]),
                         key=lambda k: self._main[k][1])
                self._main[kd] = [False, mst]
                self._pcount -= 1
        else:
            hit = False
            if len(self._window) >= self.quota:
                cand = min(self._window, key=self._window.get)
                del self._window[cand]
                self._window[key] = wst
                if len(self._main) < mcap_rt:
                    self._main[cand] = [False, mst]
                else:
                    victim = min(self._main, key=lambda k: tuple(self._main[k]))
                    if self.admission.admit(cand, victim):
                        self._pcount -= self._main.pop(victim)[0]
                        self._main[cand] = [False, mst]
            else:
                self._window[key] = wst
        self._ehits += hit
        self._eacc += 1
        if self._eacc == self.epoch_len:
            self._epoch_boundary()
        return hit

    def _epoch_boundary(self):
        # sharded: the merge_halve fold rides the climb epochs, before the
        # climb + rebalance — same order as the device scan body
        if self.shards > 1:
            self.admission.sketch.merge_halve()
        # record the quota that was IN EFFECT for the finished epoch (the
        # device scan emits the same pre-climb value next to epoch_hits)
        self.quota_trajectory.append(self.quota)
        nq, self._prev, self._dirn, self._delta, self._ewma, self._trend, \
            self._k = climb_update(self.climb, self._ehits, self._prev,
                                   self._dirn, self._delta, self._ewma,
                                   self._trend, self._k, self.quota)
        self._rebalance(nq)
        self._ehits = 0
        self._eacc = 0

    def _rebalance(self, nq: int):
        """Host mirror of the device epoch rebalance (_rebalance_flat)."""
        mcap_new = self.total - nq
        n_wev = max(0, len(self._window) - nq)
        if n_wev:
            victims = sorted(self._window, key=self._window.get)[:n_wev]
            room = max(0, mcap_new - len(self._main))
            for kx in sorted(victims, key=self._window.get,
                             reverse=True)[:room]:
                self._main[kx] = [False, self._window[kx]]
            for kx in victims:
                del self._window[kx]
        n_mev = max(0, len(self._main) - mcap_new)
        if n_mev:
            for kx in sorted(self._main,
                             key=lambda k: tuple(self._main[k]))[:n_mev]:
                self._pcount -= self._main.pop(kx)[0]
        self.quota = nq

"""W-TinyLFU trace replay on set-associative tables, in plain Python and
NumPy: the reference that decides ``correct`` in the replay cells.

One lane, one access at a time, from a fresh state.  Per access ``t``:

1. TinyLFU add (paper §3.3, §3.4.1): if every doorkeeper bit of the key was
   already set, each of its row counters that equals the row minimum gains
   one, while that minimum is below ``cap``; then its doorkeeper bits are
   set.  The sample counter grows by one; when it reaches W, every counter
   halves, the doorkeeper clears and the counter halves.
2. Lookup: a key lives in at most one slot, of its window set or of one of
   its two main sets.  A window hit restamps the slot with ``t``.  A main
   hit stamps it protected (``2^30 | t``); if its set then holds more
   protected entries than its share of the protected budget, the oldest
   protected entry of the set goes back to probation, stamped ``t``.
3. Miss: the window set's smallest stamp (an empty slot first, ``-1``) takes
   the key, stamped ``t``; the record it held is the candidate.  Of the
   candidate's two main sets the smallest stamp (the first set on a tie) is
   the victim slot: an empty slot takes the candidate, an occupied one only
   if the candidate's estimate beats the victim's (minimum over rows, plus
   one if every doorkeeper bit is set), and the candidate goes in on
   probation, stamped ``t``.

Sizes follow the configuration's rules: window ``round(C * window_frac)``,
main the rest, protected ``int(0.8 * main)``, W ``= sample_factor * C``,
counters ``pow2ceil(W / rows)`` a row, doorkeeper ``pow2ceil(4 W)`` bits, set
count ``pow2floor(main // assoc)`` at ``ceil(main / sets)`` ways, each table
rounded up to a power-of-two number of sets of those ways, the capacity
spread over the sets (the first ``cap % sets`` sets one way more) and the
rest padding.  The final state is laid out as the program keeps it: packed
counter and doorkeeper words, records ``[lo, hi, meta, set1, set2,
probes..., bits...]`` in the window and ``[lo, hi, meta, probes...,
bits...]`` in main, and eight registers (sample counter, 0, accesses,
counted hits, 0, 0, 0, 0).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import hashing as H

PROT = 1 << 30
PAD = 2**31 - 1
EMPTY = -1


def pow2ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def pow2floor(x: int) -> int:
    return 1 << (max(1, int(x)).bit_length() - 1)


def spread(capacity: int, n_sets: int) -> list[int]:
    base, rem = divmod(capacity, n_sets)
    return [base + (1 if s < rem else 0) for s in range(n_sets)]


@dataclass(frozen=True)
class Geometry:
    capacity: int
    assoc: int = 8
    window_frac: float = 0.01
    sample_factor: int = 8
    rows: int = 4
    counter_bits: int = 4
    doorkeeper: bool = True
    protected_frac: float = 0.8
    counters_per_item: float = 1.0
    dk_bits_per_item: float = 4.0
    dk_probes: int = 3

    def __post_init__(self):
        if (self.counter_bits, self.doorkeeper, self.rows,
                self.dk_probes) != (4, True, 4, 3):
            raise ValueError("the reference replays 4 rows of 4-bit "
                             "counters and a 3-probe doorkeeper")

    @property
    def window_cap(self) -> int:
        return max(1, int(round(self.capacity * self.window_frac)))

    @property
    def main_cap(self) -> int:
        return max(1, self.capacity - self.window_cap)

    @property
    def prot_cap(self) -> int:
        return max(1, int(self.main_cap * self.protected_frac))

    @property
    def sample(self) -> int:
        return self.sample_factor * self.capacity

    @property
    def cap(self) -> int:
        return min(15, max(1, self.sample_factor - 1))

    @property
    def width(self) -> int:
        return max(8, pow2ceil(int(max(1.0, self.counters_per_item
                                           * self.sample / self.rows))))

    @property
    def dk_bits(self) -> int:
        return max(32, pow2ceil(int(self.sample * self.dk_bits_per_item)))

    @property
    def ways(self) -> int:
        if self.main_cap <= self.assoc:
            return self.main_cap
        sets = max(1, pow2floor(self.main_cap // self.assoc))
        return -(-self.main_cap // sets)

    def sets_for(self, cap: int) -> int:
        return pow2ceil(-(-cap // self.ways))

    @property
    def window_sets(self) -> int:
        return self.sets_for(self.window_cap)

    @property
    def main_sets(self) -> int:
        return self.sets_for(self.main_cap)


@dataclass
class Replay:
    """What a replay produced: the per-access hit flags (uint8) and the
    final state in the program's layout (int32 arrays by leaf name)."""
    hits: np.ndarray
    state: dict
    counted_hits: int


def probes_of(geo: Geometry, keys: np.ndarray) -> dict:
    """Everything the replay derives from a key, by hashing it."""
    lo, hi = H.lanes(keys)
    return {"lo": lo.view(np.int32), "hi": hi.view(np.int32),
            "idx": H.counter_probes(lo, hi, geo.rows, geo.width),
            "dkb": H.doorkeeper_probes(lo, hi, geo.dk_probes, geo.dk_bits),
            "wset": H.set_index(lo, hi, geo.window_sets, H.WINDOW_SET_SALT),
            "m1": H.set_index(lo, hi, geo.main_sets, H.MAIN_SET_SALT),
            "m2": H.set_index(lo, hi, geo.main_sets, H.MAIN_SET2_SALT)}


def replay(geo: Geometry, trace: np.ndarray, warmup: int = 0,
           drop_every: int = 0) -> Replay:
    """Replay the 1-D key ``trace`` from a fresh state.  Hits at accesses
    ``t >= warmup`` are counted.  ``drop_every > 0`` is the control: the
    last access of every ``drop_every`` is skipped (its flag 0), which
    breaks the guarantee that no access is dropped."""
    uniq, seq = np.unique(np.asarray(trace).astype(np.uint64),
                          return_inverse=True)
    pr = probes_of(geo, uniq)
    rows, width, A = geo.rows, geo.width, geo.ways
    flat = pr["idx"] + np.arange(rows, dtype=np.int64) * width
    # one tuple a key: 4 counter indices, 3 doorkeeper bits, its window
    # set's first slot and its two main sets' first slots
    K = [tuple(r) for r in np.concatenate(
        [flat, pr["dkb"], A * np.stack([pr["wset"], pr["m1"], pr["m2"]], 1)],
        axis=1).tolist()]

    cnt = bytearray(rows * width)
    cntv = np.frombuffer(cnt, np.uint8)
    dk = bytearray(geo.dk_bits)
    dkv = np.frombuffer(dk, np.uint8)
    cap, sample, prot_cap = geo.cap, geo.sample, geo.prot_cap
    main_cap = max(1, geo.main_cap)

    nws, nms = geo.window_sets, geo.main_sets
    wmeta = [EMPTY] * (nws * A)
    mmeta = [EMPTY] * (nms * A)
    for metas, n_sets, c in ((wmeta, nws, geo.window_cap),
                             (mmeta, nms, geo.main_cap)):
        for s, u in enumerate(spread(c, n_sets)):
            for j in range(u, A):
                metas[s * A + j] = PAD
    musable = spread(geo.main_cap, nms)
    pcap = [max(1, u * prot_cap // main_cap) for u in musable]
    nprot = [0] * nms
    wkey = [-1] * (nws * A)
    mkey = [-1] * (nms * A)
    wpos: dict = {}
    mpos: dict = {}

    def est(u):
        c0, c1, c2, c3, b0, b1, b2 = K[u][:7]
        return (min(cnt[c0], cnt[c1], cnt[c2], cnt[c3])
                + (1 if dk[b0] and dk[b1] and dk[b2] else 0))

    seq = seq.tolist()
    hits = bytearray(len(seq))
    order = range(len(seq))
    if drop_every:
        order = [p for p in order if p % drop_every != drop_every - 1]
    size = 0
    counted = 0
    t = 0                               # accesses replayed: the LRU clock
    for pos in order:
        u = seq[pos]
        c0, c1, c2, c3, b0, b1, b2, wbase, mb1, mb2 = K[u]
        # 1. TinyLFU add
        gate = dk[b0] and dk[b1] and dk[b2]
        dk[b0] = dk[b1] = dk[b2] = 1
        if gate:
            v0, v1, v2, v3 = cnt[c0], cnt[c1], cnt[c2], cnt[c3]
            m = min(v0, v1, v2, v3)
            if m < cap:
                m1 = m + 1
                if v0 == m:
                    cnt[c0] = m1
                if v1 == m:
                    cnt[c1] = m1
                if v2 == m:
                    cnt[c2] = m1
                if v3 == m:
                    cnt[c3] = m1
        size += 1
        if size >= sample:
            cntv >>= 1
            dkv[:] = 0
            size //= 2
        # 2. lookup
        slot = wpos.get(u)
        if slot is not None:
            wmeta[slot] = t
        else:
            slot = mpos.get(u)
            if slot is not None:
                s = slot // A
                if mmeta[slot] < PROT:
                    nprot[s] += 1
                mmeta[slot] = PROT | t
                if nprot[s] > pcap[s]:
                    best, bj = PAD, -1
                    for j in range(s * A, s * A + A):
                        m = mmeta[j]
                        if PROT <= m < best:
                            best, bj = m, j
                    mmeta[bj] = t
                    nprot[s] -= 1
        if slot is not None:
            hits[pos] = 1
            if t >= warmup:
                counted += 1
            t += 1
            continue
        # 3. miss: into the window, the evicted record to main
        seg = wmeta[wbase:wbase + A]
        m = min(seg)
        if m == PAD:                    # a set without ways: bypass
            cand = u
        else:
            slot = wbase + seg.index(m)
            cand = wkey[slot] if m >= 0 else -1
            if cand >= 0:
                del wpos[cand]
            wkey[slot] = u
            wmeta[slot] = t
            wpos[u] = slot
        if cand >= 0:
            b1, b2 = K[cand][8:]
            seg1 = mmeta[b1:b1 + A]
            m1 = min(seg1)
            vslot, vm = b1 + seg1.index(m1), m1
            if b2 != b1:
                seg2 = mmeta[b2:b2 + A]
                m2 = min(seg2)
                if m2 < m1:
                    vslot, vm = b2 + seg2.index(m2), m2
            admit = vm != PAD
            if admit and vm >= 0:
                vic = mkey[vslot]
                admit = est(cand) > est(vic)
                if admit:
                    del mpos[vic]
                    if vm >= PROT:
                        nprot[vslot // A] -= 1
            if admit:
                mkey[vslot] = cand
                mmeta[vslot] = t
                mpos[cand] = vslot
        t += 1

    regs = np.array([size, 0, t, counted, 0, 0, 0, 0], np.int32)
    state = {
        "counters": H.pack_counters(cntv, rows, width),
        "doorkeeper": H.pack_bits(dkv),
        "wtab": _table(pr, np.array(wkey), np.array(wmeta), window=True),
        "mtab": _table(pr, np.array(mkey), np.array(mmeta), window=False),
        "regs": regs}
    return Replay(np.frombuffer(bytes(hits), np.uint8).copy(), state,
                  counted)


def _table(pr: dict, keys: np.ndarray, meta: np.ndarray,
           window: bool) -> np.ndarray:
    """Slots -> packed records; a slot without a key keeps ``lo = hi =
    -1`` and zero probes."""
    held = keys >= 0
    k = np.where(held, keys, 0)
    cols = [np.where(held, pr["lo"][k], -1), np.where(held, pr["hi"][k], -1),
            meta]
    if window:
        cols += [np.where(held, pr["m1"][k], 0),
                 np.where(held, pr["m2"][k], 0)]
    tab = np.stack(cols, axis=1).astype(np.int64)
    extra = np.concatenate([pr["idx"][k], pr["dkb"][k]], axis=1)
    extra[~held] = 0
    return np.concatenate([tab, extra], axis=1).astype(np.int32)

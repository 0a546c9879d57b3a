"""The TinyLFU admission filter (paper Fig. 1), in plain Python and NumPy:
the reference that decides ``correct`` in the admission cells.

``record`` adds a batch of keys in order.  Per key: if every doorkeeper
bit was already set, each row counter equal to the row minimum gains one
while that minimum is below ``cap`` (the conservative update, §3.4.1); then
its doorkeeper bits are set.  After the batch the sample counter has grown
by the batch length; if it has reached W, every counter halves, the
doorkeeper clears and the sample counter halves (§3.3; at most once a
batch).  ``admit`` says, for each pair, whether the candidate's estimate
(minimum over rows, plus one if every doorkeeper bit is set) is strictly
greater than the victim's.

Sizes follow the filter's rules for ``num_blocks`` cache entries: W ``=
sample_factor * num_blocks``, ``pow2ceil(2 W / rows)`` counters a row,
``pow2ceil(4 W)`` doorkeeper bits, ``cap = min(15, sample_factor - 1)``.
The state is laid out as the program keeps it: ``counters`` (rows,
width / 8) packed int32 words, ``doorkeeper`` (1, bits / 32) and ``size``.
"""
from __future__ import annotations

import numpy as np

from . import hashing as H
from .wtinylfu import pow2ceil


class TinyLFU:
    def __init__(self, num_blocks: int, sample_factor: int = 8,
                 rows: int = 4, dk_probes: int = 3,
                 conservative: bool = True):
        """``conservative=False`` is the control: every row counter below
        ``cap`` gains one, which breaks the conservative update."""
        self.sample = sample_factor * num_blocks
        self.rows = rows
        self.width = pow2ceil(max(8, 2.0 * self.sample / rows))
        self.cap = min(15, max(1, sample_factor - 1))
        self.dk_bits = max(32, pow2ceil(self.sample * 4.0))
        self.dk_probes = dk_probes
        self.conservative = conservative
        self.cnt = bytearray(rows * self.width)
        self.dk = bytearray(self.dk_bits)
        self.size = 0
        self.resets = 0

    def probes(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(N,) keys -> ((N, rows) flat counter indices, (N, dk_probes)
        doorkeeper bits)."""
        lo, hi = H.lanes(keys)
        idx = H.counter_probes(lo, hi, self.rows, self.width)
        idx += np.arange(self.rows, dtype=np.int64) * self.width
        return idx, H.doorkeeper_probes(lo, hi, self.dk_probes, self.dk_bits)

    def record(self, keys: np.ndarray) -> None:
        if len(keys) == 0:
            return
        idx, dkb = self.probes(keys)
        cnt, dk, cap = self.cnt, self.dk, self.cap
        for ci, bits in zip(idx.tolist(), dkb.tolist()):
            gate = True
            for b in bits:
                if not dk[b]:
                    gate = False
            for b in bits:
                dk[b] = 1
            if not gate:
                continue
            m = min(cnt[i] for i in ci)
            if m >= cap:
                continue
            for i in ci:
                if cnt[i] == m or (not self.conservative and cnt[i] < cap):
                    cnt[i] += 1
        self.size += len(keys)
        if self.size >= self.sample:
            v = np.frombuffer(self.cnt, np.uint8)
            v >>= 1
            np.frombuffer(self.dk, np.uint8)[:] = 0
            self.size //= 2
            self.resets += 1

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        idx, dkb = self.probes(keys)
        cnt = np.frombuffer(self.cnt, np.uint8)
        dk = np.frombuffer(self.dk, np.uint8)
        est = np.minimum(cnt[idx].min(axis=1).astype(np.int32), 15)
        return est + dk[dkb].all(axis=1).astype(np.int32)

    def admit(self, cands: np.ndarray, victims: np.ndarray) -> np.ndarray:
        b = len(cands)
        est = self.estimate(np.concatenate([cands, victims]))
        return est[:b] > est[b:]

    def state(self) -> dict:
        """The state in the program's layout (int32 arrays)."""
        counters = H.pack_counters(np.frombuffer(self.cnt, np.uint8),
                                   self.rows, self.width)
        return {"counters": counters.reshape(self.rows, self.width // 8),
                "doorkeeper": H.pack_bits(np.frombuffer(self.dk, np.uint8))
                .reshape(1, -1),
                "size": np.array(self.size, np.int32)}

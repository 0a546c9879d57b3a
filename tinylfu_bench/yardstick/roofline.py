"""The work a kernel launch has to do, counted from the trace and the
geometry alone, and the least time the card could take for it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM bandwidth and 67 T 32-bit operations a second outside the
tensor cores.  A launch's least time is the larger of its bytes over the
bandwidth and its operations over the rate.  Bytes count each distinct
word a launch addresses once: its inputs (key lanes, precomputed probes),
its outputs (hit flags, verdicts) and the state words its accesses read,
each a 32-bit word.  What only the replay itself decides (which records a
miss evicts, which words it writes back) is left out, so the bytes are a
lower bound and a share of the roofline can only read low.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
WORD = 4


def least_s(nbytes, ops):
    """Least time of launches with ``nbytes`` and ``ops`` (scalars or
    arrays, one entry a launch), summed over the launches."""
    return float(np.sum(np.maximum(np.asarray(nbytes) / HBM_BYTES_PER_S,
                                   np.asarray(ops) / INT32_OPS_PER_S)))


def distinct_per_row(x: np.ndarray) -> np.ndarray:
    """(G, n) integers -> (G,) number of distinct values in each row."""
    if x.shape[1] == 0:
        return np.zeros(x.shape[0], np.int64)
    s = np.sort(x, axis=1)
    return 1 + (np.diff(s, axis=1) != 0).sum(axis=1)


def _chunks(x: np.ndarray, chunk: int):
    """(n, ...) -> [(k, chunk, ...) of the whole chunks, (m, ...) tail]."""
    n = x.shape[0] - x.shape[0] % chunk
    return x[:n].reshape((n // chunk, chunk) + x.shape[1:]), x[n:]


def step_launch_work(probes: dict, words_per_row: int, ways: int,
                     wcols: int, mcols: int, chunk: int):
    """Bytes and 32-bit operations of each step launch over one lane.

    ``probes`` holds per access ``idx`` (n, rows) counter indices, ``dkb``
    (n, dkp) doorkeeper bits, ``wset`` (n,) and ``m1``/``m2`` (n,) set
    indices.  A launch of ``chunk`` accesses reads per access its two key
    lanes and its rows + dkp + 3 probe words, writes one hit flag, and reads
    each distinct counter word, doorkeeper word, window set and main set its
    accesses address once (a set: ``ways`` records of ``wcols`` or
    ``mcols`` words).  Operations: per access three compares per way of the
    three sets it searches, and three per counter and doorkeeper probe."""
    idx, dkb = probes["idx"], probes["dkb"]
    rows, dkp = idx.shape[1], dkb.shape[1]
    cword = (idx >> 3) + np.arange(rows) * words_per_row
    dword = dkb >> 5
    parts = {"c": cword, "d": dword, "w": probes["wset"][:, None],
             "m": np.stack([probes["m1"], probes["m2"]], axis=1)}
    sizes = {"c": 1, "d": 1, "w": ways * wcols, "m": ways * mcols}
    nbytes, ops = [], []
    for block in _chunks_all(parts, chunk):
        launches, n = block["c"].shape[:2]
        words = n * (2 + rows + dkp + 3 + 1)
        for k, v in block.items():
            words = words + sizes[k] * distinct_per_row(
                v.reshape(launches, -1))
        nbytes.append(WORD * words)
        ops.append(np.full(launches, n * (9 * ways + 3 * (rows + dkp))))
    return np.concatenate(nbytes), np.concatenate(ops)


def _chunks_all(parts: dict, chunk: int):
    """The whole chunks of every part at once, then the tail."""
    whole, tail = {}, {}
    for k, v in parts.items():
        whole[k], tail[k] = _chunks(v, chunk)
    yield whole
    if tail["c"].shape[0]:
        yield {k: v[None] for k, v in tail.items()}


def add_launch_work(idx: np.ndarray, dkb: np.ndarray, words_per_row: int):
    """Bytes and operations of one batched add of the keys whose (B, rows)
    counter indices and (B, dkp) doorkeeper bits are given: two key lanes a
    key and each distinct counter and doorkeeper word once; per key its
    salted hashes (15 operations each) and three a probe."""
    rows, dkp = idx.shape[1], dkb.shape[1]
    cword = ((idx >> 3) + np.arange(rows) * words_per_row).reshape(1, -1)
    words = (2 * idx.shape[0] + distinct_per_row(cword)[0]
             + distinct_per_row((dkb >> 5).reshape(1, -1))[0])
    ops = idx.shape[0] * (15 * (rows + dkp) + 3 * (rows + dkp))
    return WORD * int(words), int(ops)


def reset_launch_work(counter_words: int, dk_words: int):
    """A reset reads and writes every counter word (a shift and a mask
    each) and writes every doorkeeper word."""
    return (WORD * (2 * counter_words + dk_words), 2 * counter_words)

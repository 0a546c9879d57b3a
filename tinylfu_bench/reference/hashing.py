"""The 32-bit-lane hash family of the device engine, in NumPy.

A uint64 key is two uint32 lanes (``lo``, ``hi``).  A salted hash is
``mix32((lo + salt) mod 2^32) ^ mix32(hi ^ 0x85EBCA6B ^ salt)`` with the
Prospector-style finalizer ``mix32``.  Counter probe ``p`` of a row uses the
salt ``PROBE_SALTS[p % 8] + 0x9E3779B9 * (p // 8)`` and doorkeeper probe
``p`` the salt ``(PROBE_SALTS[p % 8] ^ 0xDEADBEEF) + 0x9E3779B9 * (p // 8)``
(both modulo 2^32); a set index takes the table's own salt.  Every index is
the hash masked to a power-of-two size.
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
PROBE_SALTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F,
               0x165667B1, 0xD3A2646C, 0xFD7046C5, 0xB55A4F09)
DK_XOR = 0xDEADBEEF
HI_XOR = 0x85EBCA6B
STEP = 0x9E3779B9
WINDOW_SET_SALT = 0x1B873593
MAIN_SET_SALT = 0xCC9E2D51
MAIN_SET2_SALT = 0x38495AB5


def lanes(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 keys -> (lo, hi) uint32 lanes."""
    k = np.asarray(keys).astype(np.uint64)
    return ((k & np.uint64(M32)).astype(np.uint32),
            (k >> np.uint64(32)).astype(np.uint32))


def mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def salted(lo: np.ndarray, hi: np.ndarray, salt: int) -> np.ndarray:
    s = np.uint32(salt & M32)
    return mix32(lo + s) ^ mix32(hi ^ np.uint32(HI_XOR) ^ s)


def counter_probes(lo, hi, rows: int, width: int) -> np.ndarray:
    """(N,) lanes -> (N, rows) int64 counter indices in [0, width)."""
    out = np.empty(lo.shape + (rows,), np.int64)
    for p in range(rows):
        salt = PROBE_SALTS[p % 8] + STEP * (p // 8)
        out[..., p] = salted(lo, hi, salt) & np.uint32(width - 1)
    return out


def doorkeeper_probes(lo, hi, probes: int, bits: int) -> np.ndarray:
    """(N,) lanes -> (N, probes) int64 doorkeeper bit positions."""
    out = np.empty(lo.shape + (probes,), np.int64)
    for p in range(probes):
        salt = (PROBE_SALTS[p % 8] ^ DK_XOR) + STEP * (p // 8)
        out[..., p] = salted(lo, hi, salt) & np.uint32(bits - 1)
    return out


def set_index(lo, hi, n_sets: int, salt: int) -> np.ndarray:
    return (salted(lo, hi, salt) & np.uint32(n_sets - 1)).astype(np.int64)


def pack_counters(values: np.ndarray, rows: int, width: int) -> np.ndarray:
    """(rows * width,) 4-bit counter values -> the packed int32 words, eight
    to a word, counter ``i`` of a row in bits ``4 (i % 8)`` of word
    ``i // 8``."""
    v = values.astype(np.uint32).reshape(rows, width // 8, 8)
    w = (v << (np.uint32(4) * np.arange(8, dtype=np.uint32))).sum(
        axis=-1, dtype=np.uint32)
    return w.reshape(-1).view(np.int32)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """(n,) 0/1 bytes -> int32 words, bit ``b`` in bit ``b % 32`` of word
    ``b // 32``."""
    return np.packbits(bits.astype(np.uint8), bitorder="little").view(
        "<u4").astype(np.uint32).view(np.int32)

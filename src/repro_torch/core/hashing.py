"""Hash mixers, salts and table geometry shared by the host and device
engines.

Copy of ``repro/core/hashing.py`` plus ``_pow2ceil`` from
``repro/core/sketch.py``: the 64-bit splitmix family of the host sketches,
the numpy twins of the device's 32-bit-lane mixers (bit for bit the torch
lanes of ``kernels/sketch_common.py``; the host policy twins place keys in
sets and ghost bits with them), the salts and the set-associative geometry.
Plain Python/numpy: the port keeps its own copy so that it imports nothing
of the JAX package.  Every value here must stay equal to the reference's,
since keys hash to the same probes and sets on both sides.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# 64-bit splitmix (host side)
# ---------------------------------------------------------------------------

_SM64_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM64_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM64_M2 = np.uint64(0x94D049BB133111EB)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer. x: uint64 ndarray -> uint64 ndarray."""
    x = (x + _SM64_GAMMA).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * _SM64_M1
    x = (x ^ (x >> np.uint64(27))) * _SM64_M2
    x = x ^ (x >> np.uint64(31))
    return x


def probe_indices(keys: np.ndarray, num_probes: int, width: int,
                  seed: int = 0) -> np.ndarray:
    """(N,) uint64 keys -> (N, num_probes) int64 indices in [0, width): one
    seed offset per probe, full 64-bit mixing, then a modulo (``width``
    need not be a power of two)."""
    keys = np.asarray(keys, dtype=np.uint64)
    seeds = (np.arange(1, num_probes + 1, dtype=np.uint64)
             * np.uint64(0xC2B2AE3D27D4EB4F)) + np.uint64(seed)
    mixed = splitmix64(keys[:, None] + seeds[None, :])
    return (mixed % np.uint64(width)).astype(np.int64)

MIX32_M1 = 0x7FEB352D
MIX32_M2 = 0x846CA68B
PROBE_SALTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F,
               0x165667B1, 0xD3A2646C, 0xFD7046C5, 0xB55A4F09)

# set-index salts for the set-associative cache tables
WSET_SALT = 0x1B873593          # window table set hash
MSET_SALT = 0xCC9E2D51          # main (SLRU) table: first-choice set hash
MSET2_SALT = 0x38495AB5         # main table: second-choice set hash
SHARD_SALT = 0x52DCE729         # sketch shard hash
SHARD_SEED64 = 0xA24BAED4963EE407   # host splitmix64 shard hash seed

_M32 = 0xFFFFFFFF


def mix32_np(x: np.ndarray) -> np.ndarray:
    """numpy twin of the 32-bit mixer the device uses."""
    x = np.asarray(x, dtype=np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(MIX32_M1)).astype(np.uint32)
    x ^= x >> np.uint32(15)
    x = (x * np.uint32(MIX32_M2)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def _salted32_np(lo: np.ndarray, hi: np.ndarray, salt: int) -> np.ndarray:
    s = np.uint32(salt & _M32)
    return mix32_np(lo + s) ^ mix32_np(hi ^ np.uint32(0x85EBCA6B) ^ s)


def probe_indices32_np(lo: np.ndarray, hi: np.ndarray, num_probes: int,
                       width: int) -> np.ndarray:
    """numpy twin of the device's counter-probe schedule (width pow2).  A
    probe's salt is taken modulo 2^32, as on the device."""
    assert width & (width - 1) == 0, "device sketch width must be a power of 2"
    lo = np.asarray(lo, dtype=np.uint32)
    hi = np.asarray(hi, dtype=np.uint32)
    out = np.empty(lo.shape + (num_probes,), dtype=np.int64)
    for p in range(num_probes):
        salt = (PROBE_SALTS[p % len(PROBE_SALTS)]
                + 0x9E3779B9 * (p // len(PROBE_SALTS)))
        h = _salted32_np(lo, hi, salt)
        out[..., p] = (h & np.uint32(width - 1)).astype(np.int64)
    return out


def dk_probe_index_np(lo: np.ndarray, hi: np.ndarray, p: int,
                      dk_bits: int) -> np.ndarray:
    """numpy twin of the device's doorkeeper-probe schedule, bit for bit
    (the salt modulo 2^32).  The host ``SetAssocARC`` twin replays the
    device's ghost-Bloom arithmetic with these bit positions."""
    assert dk_bits & (dk_bits - 1) == 0, "dk_bits must be a power of 2"
    lo = np.asarray(lo, dtype=np.uint32)
    hi = np.asarray(hi, dtype=np.uint32)
    salt = ((PROBE_SALTS[p % len(PROBE_SALTS)] ^ 0xDEADBEEF)
            + 0x9E3779B9 * (p // len(PROBE_SALTS)))
    h = _salted32_np(lo, hi, salt)
    return (h & np.uint32(dk_bits - 1)).astype(np.int64)


def key_to_lanes(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 keys -> (lo, hi) uint32 lane pair."""
    keys = np.asarray(keys, dtype=np.uint64)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def set_index32_np(keys: np.ndarray, n_sets: int, salt: int) -> np.ndarray:
    """Set index of each key in an ``n_sets``-set table (pow2), bit for bit
    the device's set hash: the host twins and the device tables place every
    key in the same set."""
    assert n_sets & (n_sets - 1) == 0, "set count must be a power of 2"
    lo, hi = key_to_lanes(keys)
    h = _salted32_np(lo, hi, salt)
    return (h & np.uint32(n_sets - 1)).astype(np.int64)


def _mix32(x: int) -> int:
    x ^= x >> 16
    x = (x * MIX32_M1) & _M32
    x ^= x >> 15
    x = (x * MIX32_M2) & _M32
    return x ^ (x >> 16)


def _salted32(lo: int, hi: int, salt: int) -> int:
    s = salt & _M32
    return _mix32((lo + s) & _M32) ^ _mix32(hi ^ 0x85EBCA6B ^ s)


def set_index32(key: int, n_sets: int, salt: int) -> int:
    """:func:`set_index32_np` of one key, in Python ints (the host twins
    hash one key at a time; a numpy call per key costs ~50x more)."""
    assert n_sets & (n_sets - 1) == 0, "set count must be a power of 2"
    key = int(key)
    if not 0 <= key < 1 << 64:
        raise OverflowError(f"key {key} out of bounds for uint64")
    return _salted32(key & _M32, key >> 32, salt) & (n_sets - 1)


def dk_probe_index(lo: int, hi: int, p: int, dk_bits: int) -> int:
    """:func:`dk_probe_index_np` of one (lo, hi) lane pair, in Python ints."""
    assert dk_bits & (dk_bits - 1) == 0, "dk_bits must be a power of 2"
    salt = ((PROBE_SALTS[p % len(PROBE_SALTS)] ^ 0xDEADBEEF)
            + 0x9E3779B9 * (p // len(PROBE_SALTS)))
    return _salted32(lo & _M32, hi & _M32, salt) & (dk_bits - 1)


def shard_index32_np(keys: np.ndarray, shards: int) -> np.ndarray:
    """Owning sketch shard of each key (``shards`` pow2), bit for bit the
    device's shard hash.  (``ShardedFrequencySketch`` uses its own splitmix64
    shard hash.)"""
    return set_index32_np(keys, shards, SHARD_SALT)


def shard_geometry(width: int, dk_bits: int, shards: int) -> tuple[int, int]:
    """(width_shard, dk_bits_shard) of a sketch split into ``shards``."""
    if shards < 1 or shards & (shards - 1):
        raise ValueError(f"shards {shards} must be a power of two")
    if width % (shards * 8):
        raise ValueError(f"width {width} must be a multiple of 8*shards "
                         f"({shards * 8})")
    if dk_bits and dk_bits % (shards * 32):
        raise ValueError(f"dk_bits {dk_bits} must be a multiple of "
                         f"32*shards ({shards * 32})")
    return width // shards, dk_bits // shards


def _pow2floor(x: int) -> int:
    return 1 << (max(1, int(x)).bit_length() - 1)


def _pow2ceil(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


def assoc_geometry(capacity: int, assoc: int) -> tuple[int, int]:
    """(n_sets, ways) hosting ``capacity`` entries at >= ``assoc`` ways/set.

    The set count rounds down to a power of two, so the ways per set land in
    [assoc, 2*assoc); tiny capacities collapse to one set.
    """
    assert capacity >= 1 and assoc >= 1
    if capacity <= assoc:
        return 1, capacity
    n = max(1, _pow2floor(capacity // assoc))
    return n, -(-capacity // n)                      # ways = ceil(cap/sets)


def slots_for(capacity: int, ways: int) -> int:
    """Table slots for ``capacity`` entries at a fixed ``ways``: the smallest
    power-of-two set count with sets*ways >= capacity, times ways."""
    need = -(-capacity // ways)
    return (1 << max(0, need - 1).bit_length()) * ways


def set_ways(capacity: int, n_sets: int) -> list[int]:
    """Usable ways per set expressing ``capacity`` exactly over ``n_sets``:
    the first ``capacity % n_sets`` sets get one extra way."""
    assert capacity >= 1
    base, rem = divmod(capacity, n_sets)
    return [base + (1 if s < rem else 0) for s in range(n_sets)]

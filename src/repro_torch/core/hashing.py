"""Hash constants and table geometry shared by the device engine.

Counterpart of ``repro/core/hashing.py`` (the 32-bit-lane salts and the
set-associative geometry helpers) plus ``_pow2ceil`` from
``repro/core/sketch.py``.  Plain Python/numpy: the port keeps its own copy so
that it imports nothing of the JAX package.  Every value here must stay equal
to the reference's, since keys hash to the same probes and sets on both sides.
"""
from __future__ import annotations

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

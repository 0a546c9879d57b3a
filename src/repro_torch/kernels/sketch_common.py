"""32-bit-lane hashing and packed-counter helpers on torch tensors.

Counterpart of ``repro/kernels/sketch_common.py``.  Keys arrive as (lo, hi)
lanes: int32 tensors holding the bit patterns of the two uint32 halves of a
uint64 key.  torch has no usable uint32 arithmetic (``>>`` and ``+`` on
``torch.uint32`` are not implemented on the CPU, and ``>>`` on int32 is
arithmetic), so the mixers compute on int64 masked to 32 bits; results are
returned as int32, exactly the reference's values.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import (MIX32_M1, MIX32_M2, PROBE_SALTS,
                                      SHARD_SALT)

DK_SALT_XOR = 0xDEADBEEF        # doorkeeper probes use salted variants
HI_MIX_XOR = 0x85EBCA6B
_M32 = 0xFFFFFFFF

# device-resident policies (StepSpec.policy); this port runs "wtinylfu" only
POLICIES = ("wtinylfu", "s3fifo", "arc", "lfu")


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any integer tensor) -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Prospector-style 32-bit finalizer; int64 in [0, 2^32) in and out."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = (x * MIX32_M1) & _M32
    x = x ^ (x >> 15)
    x = (x * MIX32_M2) & _M32
    x = x ^ (x >> 16)
    return x


def _salted_hash(lo: torch.Tensor, hi: torch.Tensor,
                 salt: int) -> torch.Tensor:
    s = salt & _M32
    return mix32((_u32(lo) + s) & _M32) ^ mix32(_u32(hi) ^ HI_MIX_XOR ^ s)


def probe_index(lo: torch.Tensor, hi: torch.Tensor, p: int,
                width: int) -> torch.Tensor:
    """Index of probe ``p`` into a row of ``width`` (pow2) counters."""
    salt = (PROBE_SALTS[p % len(PROBE_SALTS)]
            + 0x9E3779B9 * (p // len(PROBE_SALTS)))
    return (_salted_hash(lo, hi, salt) & (width - 1)).to(torch.int32)


def dk_probe_index(lo: torch.Tensor, hi: torch.Tensor, p: int,
                   dk_bits: int) -> torch.Tensor:
    """Bit position of doorkeeper probe ``p`` in a ``dk_bits`` (pow2)
    filter."""
    salt = ((PROBE_SALTS[p % len(PROBE_SALTS)] ^ DK_SALT_XOR)
            + 0x9E3779B9 * (p // len(PROBE_SALTS)))
    return (_salted_hash(lo, hi, salt) & (dk_bits - 1)).to(torch.int32)


def set_index(lo: torch.Tensor, hi: torch.Tensor, n_sets: int,
              salt: int) -> torch.Tensor:
    """Set index for the set-associative cache tables (n_sets pow2)."""
    return (_salted_hash(lo, hi, salt) & (n_sets - 1)).to(torch.int32)


def shard_index(lo: torch.Tensor, hi: torch.Tensor,
                shards: int) -> torch.Tensor:
    """Owning sketch shard of a key (``shards`` pow2)."""
    return (_salted_hash(lo, hi, SHARD_SALT) & (shards - 1)).to(torch.int32)


def halve_words(words: torch.Tensor, counter_bits: int = 4) -> torch.Tensor:
    """Per-field halving of packed counters (the paper's §3.3 reset).  The
    mask clears both the cross-field borrow bits and the sign extension of
    the arithmetic shift."""
    mask = 0x77777777 if counter_bits == 4 else 0x7F7F7F7F
    return (words >> 1) & mask


def keys_to_lanes(keys) -> tuple[np.ndarray, np.ndarray]:
    """uint64 keys -> (lo, hi) int32 bit-pattern numpy lanes."""
    keys = np.asarray(keys).astype(np.uint64)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi

"""Device-sketch configuration and state, 32-bit-lane hashing and
packed-counter helpers on torch tensors.

Counterpart of ``repro/kernels/sketch_common.py``.  Keys arrive as (lo, hi)
lanes: int32 tensors holding the bit patterns of the two uint32 halves of a
uint64 key.  torch has no usable uint32 arithmetic (``>>`` and ``+`` on
``torch.uint32`` are not implemented on the CPU, and ``>>`` on int32 is
arithmetic), so the mixers compute on int64 masked to 32 bits; results are
returned as int32, exactly the reference's values.

The batched sketch state (``init_state``) has the reference's leaves:
``counters`` (rows, width//8) and ``doorkeeper`` (1, dk_words) on the device,
and ``size``, a 0-d int32 tensor that always lives on the host.  No kernel
reads ``size``: it moves only by the number of keys added and halves at a
reset, never by the data, so keeping it on the host lets ``ops.add`` decide
the §3.3 reset after a batch without waiting for the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.hashing import (MIX32_M1, MIX32_M2, PROBE_SALTS,
                                      SHARD_SALT)

DK_SALT_XOR = 0xDEADBEEF        # doorkeeper probes use salted variants
HI_MIX_XOR = 0x85EBCA6B
_M32 = 0xFFFFFFFF

# device-resident policies (StepSpec.policy); this port runs "wtinylfu" only
POLICIES = ("wtinylfu", "s3fifo", "arc", "lfu")


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for the CPU; no silent fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass "
                "device='cpu' to run the plain version on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r} must be 'cuda' or 'cpu'")
    return dev


@dataclass(frozen=True)
class DeviceSketchConfig:
    """Geometry of one batched device sketch: 4-bit counters packed eight
    to an int32 word, a doorkeeper bitset packed 32 to a word, and the §3.3
    sample size W.  Same fields, properties and checks as the reference's
    (which asserts; the port raises ValueError)."""
    width: int                    # counters per row (power of two)
    rows: int = 4
    cap: int = 15                 # <= 15 (4-bit nibbles)
    dk_bits: int = 0              # doorkeeper bits (power of two); 0 = off
    dk_probes: int = 3
    sample_size: int = 0          # W; 0 = never reset automatically

    def __post_init__(self):
        _check(_pow2(self.width) and self.width % 8 == 0,
               f"width {self.width} must be a power of two >= 8")
        _check(1 <= self.cap <= 15, f"cap {self.cap} must be in 1..15")
        _check(self.dk_bits == 0 or (_pow2(self.dk_bits)
                                     and self.dk_bits >= 32),
               f"dk_bits {self.dk_bits} must be 0 or a power of two >= 32")
        _check(self.rows <= len(PROBE_SALTS),
               f"rows {self.rows} must be <= {len(PROBE_SALTS)}")

    @property
    def words_per_row(self) -> int:
        return self.width // 8

    @property
    def dk_words(self) -> int:
        return max(1, self.dk_bits // 32)


def _sketch_shapes(cfg: DeviceSketchConfig) -> dict:
    return {"counters": (cfg.rows, cfg.words_per_row),
            "doorkeeper": (1, cfg.dk_words), "size": ()}


def sketch_state_from_numpy(cfg: DeviceSketchConfig, arrays: dict,
                            device=None) -> dict:
    """Reference-layout numpy leaves (``{k: np.asarray(v)}`` of a JAX sketch
    state) -> the port's state: ``counters`` and ``doorkeeper`` on
    ``device`` (the card unless ``"cpu"``), ``size`` on the host."""
    dev = resolve_device(device)
    shapes = _sketch_shapes(cfg)
    _check(set(arrays) == set(shapes),
           f"sketch state keys {sorted(arrays)} != {sorted(shapes)}")
    out = {}
    for k, shape in shapes.items():
        a = np.array(arrays[k], dtype=np.int32, order="C")   # 0-d stays 0-d
        _check(a.shape == shape,
               f"sketch state[{k!r}] shape {a.shape} != {shape}")
        t = torch.from_numpy(a)
        out[k] = t if k == "size" else t.to(dev)
    return out


def sketch_state_to_numpy(state: dict) -> dict:
    """The port's sketch state -> numpy int32 leaves (reference layout)."""
    return {k: v.detach().cpu().numpy().astype(np.int32)
            for k, v in state.items()}


def init_state(cfg: DeviceSketchConfig, device=None) -> dict:
    """Zeroed sketch state on ``device`` (the card unless ``"cpu"``)."""
    return sketch_state_from_numpy(
        cfg, {k: np.zeros(s, np.int32)
              for k, s in _sketch_shapes(cfg).items()}, device)


def check_sketch_inputs(cfg: DeviceSketchConfig, state: dict,
                        *lanes: torch.Tensor) -> torch.device:
    """Validate a sketch state and (B,) key lanes; returns their device."""
    shapes = _sketch_shapes(cfg)
    _check(set(state) == set(shapes),
           f"sketch state keys {sorted(state)} != {sorted(shapes)}")
    dev = state["counters"].device
    for k, shape in shapes.items():
        v = state[k]
        where = torch.device("cpu") if k == "size" else dev
        _check(v.dtype == torch.int32 and tuple(v.shape) == shape
               and v.device == where and v.is_contiguous(),
               f"sketch state[{k!r}] must be a contiguous int32 {shape} "
               f"tensor on {where}")
    for x in lanes:
        _check(x.dim() == 1 and x.shape == lanes[0].shape
               and x.dtype == torch.int32 and x.device == dev,
               f"key lanes must be (B,) int32 tensors on {dev}, like the "
               "sketch state")
    return dev


def key_probes(lo: torch.Tensor, hi: torch.Tensor, rows: int, width: int,
               dk_bits: int, dk_probes: int):
    """(B,) key lanes -> ((B, rows) counter probes, (B, dk_probes)
    doorkeeper bit positions; (B, 1) zeros without a doorkeeper)."""
    idx = probe_matrix(lo, hi, probe_salts(rows), width - 1)
    if dk_bits:
        dkb = probe_matrix(lo, hi, dk_probe_salts(dk_probes), dk_bits - 1)
    else:
        dkb = torch.zeros(lo.shape + (1,), dtype=torch.int32,
                          device=lo.device)
    return idx, dkb


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


def _salted_hash(lo: torch.Tensor, hi: torch.Tensor, salt) -> torch.Tensor:
    """mix32(lo + salt) ^ mix32(hi ^ HI_MIX_XOR ^ salt), both mixers in one
    pass; ``salt`` is an int in [0, 2^32) or an int64 tensor of them that
    broadcasts against the lanes."""
    m = mix32(torch.stack([(_u32(lo) + salt) & _M32,
                           _u32(hi) ^ HI_MIX_XOR ^ salt]))
    return m[0] ^ m[1]


def probe_salts(n: int) -> list[int]:
    """Salts of counter probes 0..n-1."""
    return [(PROBE_SALTS[p % len(PROBE_SALTS)]
             + 0x9E3779B9 * (p // len(PROBE_SALTS))) & _M32
            for p in range(n)]


def dk_probe_salts(n: int) -> list[int]:
    """Salts of doorkeeper probes 0..n-1."""
    return [((PROBE_SALTS[p % len(PROBE_SALTS)] ^ DK_SALT_XOR)
             + 0x9E3779B9 * (p // len(PROBE_SALTS))) & _M32
            for p in range(n)]


def probe_matrix(lo: torch.Tensor, hi: torch.Tensor, salts: list[int],
                 mask: int) -> torch.Tensor:
    """(B,) key lanes -> (B, len(salts)) int32: every key's salted hash
    under every salt, masked, in one vectorised pass."""
    s = torch.tensor(salts, dtype=torch.int64, device=lo.device)
    return (_salted_hash(lo[..., None], hi[..., None], s)
            & mask).to(torch.int32).contiguous()


def set_index(lo: torch.Tensor, hi: torch.Tensor, n_sets: int,
              salt: int) -> torch.Tensor:
    """Set index for the set-associative cache tables (n_sets pow2)."""
    return (_salted_hash(lo, hi, salt) & (n_sets - 1)).to(torch.int32)


def shard_index(lo: torch.Tensor, hi: torch.Tensor,
                shards: int) -> torch.Tensor:
    """Owning sketch shard of a key (``shards`` pow2)."""
    return (_salted_hash(lo, hi, SHARD_SALT) & (shards - 1)).to(torch.int32)


def nibble_get(word: torch.Tensor, nib: torch.Tensor) -> torch.Tensor:
    """Extract 4-bit counter ``nib`` (0..7) from an int32 word."""
    return (word >> (nib * 4)) & 0xF


def nibble_inc(word: torch.Tensor, nib: torch.Tensor) -> torch.Tensor:
    """Increment 4-bit counter ``nib`` (caller guarantees value < 15)."""
    return word + (torch.ones_like(nib) << (nib * 4))


def halve_words(words: torch.Tensor, counter_bits: int = 4) -> torch.Tensor:
    """Per-field halving of packed counters (the paper's §3.3 reset).  The
    mask clears both the cross-field borrow bits and the sign extension of
    the arithmetic shift."""
    mask = 0x77777777 if counter_bits == 4 else 0x7F7F7F7F
    return (words >> 1) & mask


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def merge_words(a: torch.Tensor, b: torch.Tensor,
                counter_bits: int = 4) -> torch.Tensor:
    """Per-field saturating add of packed counter words (the CM-sketch
    merge).  A word-wise ``a + b`` would carry an overflowing field into its
    neighbour, so even and odd fields are summed apart, each in a lane with
    a spare high bit, and a field that overflowed is pinned at the counter
    maximum.  The reference's int32 arithmetic, op for op."""
    _check(counter_bits in (4, 8), f"counter_bits {counter_bits} must be 4 "
           "or 8")
    if counter_bits == 4:
        lane_mask, flag_shift, flag_mask, fmax = 0x0F0F0F0F, 4, 0x01010101, 0xF
    else:
        lane_mask, flag_shift, flag_mask, fmax = 0x00FF00FF, 8, 0x00010001, 0xFF

    def lane_sum(x, y):
        s = (x & lane_mask) + (y & lane_mask)
        over = (s >> flag_shift) & flag_mask        # 1 per overflowed field
        return (s | over * fmax) & lane_mask

    even = lane_sum(a, b)
    odd = lane_sum(a >> counter_bits, b >> counter_bits)
    return even | (odd << counter_bits)


def checksum_words(words: torch.Tensor) -> torch.Tensor:
    """Position-weighted wrap-around checksum over the last axis:
    ``sum(x[i] * w[i]) mod 2^32`` with odd weights ``w[i] = (i *
    2654435761) | 1``, as int32.  A flipped bit or two swapped unequal words
    change it.  Computed on int64 masked to 32 bits: the product is split at
    the weight's 16-bit halves so that nothing overflows."""
    i = torch.arange(words.shape[-1], dtype=torch.int64, device=words.device)
    w = ((i * 2654435761) & _M32) | 1
    x = _u32(words)
    prod = (x * (w & 0xFFFF) + (((x * (w >> 16)) & 0xFFFF) << 16)) & _M32
    return _i32(prod.sum(dim=-1) & _M32)


def bit_get(words: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    """Bit ``bit`` of a packed int32 bitset (flat indexing)."""
    word = words.reshape(-1)[(bit >> 5).long()]
    return (word >> (bit & 31)) & 1


def keys_to_lanes(keys) -> tuple[np.ndarray, np.ndarray]:
    """uint64 keys -> (lo, hi) int32 bit-pattern numpy lanes."""
    keys = np.asarray(keys).astype(np.uint64)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi

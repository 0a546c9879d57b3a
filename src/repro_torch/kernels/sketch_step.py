"""Fused per-access W-TinyLFU step: plain PyTorch version and CUDA wrapper.

Counterpart of ``repro/kernels/sketch_step.py`` for ``policy="wtinylfu"``,
``adaptive=False`` and ``shards=1``, in both table layouts:

* flat (``assoc=None``): exact global LRU window and SLRU main, one packed
  int32 ``meta`` per slot (-1 empty, ``t`` probation, ``2^30|t`` protected,
  ``2^31-1`` padding), O(capacity) lookups;
* set-associative (``assoc=A``): packed records ``[lo, hi, meta, (mset1,
  mset2,) idx[rows], dkb[dkp]]`` in sets of A ways, two-choice main
  placement, O(A) per access.

``streams=B`` batches B independent tenant lanes (the reference's
``_step_lanes``): every state leaf carries a leading lane axis, keys come as
``(B, T)`` lanes, ``params`` is shared ``(NPARAMS,)`` or per-lane ``(B,
NPARAMS)`` and ``n_valid`` an int or per-lane ``(B,)``.

The state is a dict of int32 tensors with the reference's keys and shapes
(``_state_keys``), so ``state_from_numpy``/``state_to_numpy`` carry state
between the JAX package and the port leaf for leaf.

``step_ref`` is the plain version: a Python loop over the accesses of one
chunk (and over the lanes), written with tensor ops that run on any device.
``step`` is the wrapper that replaces ``step_pallas``: on CUDA tensors it
launches the hand-written kernel in ``csrc/sketch_step.cu`` (updating the
state in place; one CTA per lane); on CPU tensors it runs ``step_ref``.
There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core.hashing import (WSET_SALT, MSET_SALT, MSET2_SALT,
                                      set_ways, shard_geometry)
from .sketch_common import (POLICIES, _check, _pow2, halve_words, key_probes,
                            resolve_device, set_index)
from .sketch_update import add_one

_I32_MAX = 2**31 - 1          # padding-slot meta: never free, never a victim
_PROT = 1 << 30               # meta bit 30: protected segment
_EMPTY = -1                   # meta of an empty (usable) slot

# params vector layout
P_WINDOW_CAP = 0
P_MAIN_CAP = 1
P_PROT_CAP = 2
P_SAMPLE = 3                  # W; 0 disables the automatic reset
P_CAP = 4                     # counter saturation (< 2**counter_bits)
P_WARMUP = 5                  # accesses before hits start counting
NPARAMS = 8

# regs vector layout
R_SIZE = 0                    # sketch additions since last reset
R_PCOUNT = 1                  # protected entries within main (flat only)
R_T = 2                       # global access index == LRU stamp
R_HITS = 3                    # counted hits (post warmup)
R_WQUOTA = 4
R_WCOUNT = 5
R_MCOUNT = 6
R_EHITS = 7
NREGS = 8

# packed set-associative record columns
WT_LO, WT_HI, WT_META, WT_MSET, WT_MSET2 = 0, 1, 2, 3, 4
MT_LO, MT_HI, MT_META = 0, 1, 2

# the kernel keeps one access's probes and its sets' records in registers
_MAX_ROWS = 8
_MAX_DKP = 8
_MAX_WAYS = 128


@dataclass(frozen=True)
class StepSpec:
    """Static geometry of one simulated W-TinyLFU instance.

    Same fields, properties and validation as the reference ``StepSpec``
    (see its docstring for each field).  The port runs the fields at their
    defaults except ``width``, ``rows``, ``dk_bits``, ``dk_probes``, the
    slot counts, ``assoc`` and ``counter_bits``; the others are accepted
    here and refused by the entry points that do not port them yet.
    """
    width: int
    rows: int = 4
    dk_bits: int = 0
    dk_probes: int = 3
    window_slots: int = 1
    main_slots: int = 1
    assoc: int | None = None
    counter_bits: int = 4
    adaptive: bool = False
    shards: int = 1
    mesh_devices: int = 0
    mesh_exchange: str = "chunk"
    integrity: bool = False
    streams: int = 1
    policy: str = "wtinylfu"

    def __post_init__(self):
        _check(self.policy in POLICIES,
               f"policy {self.policy!r} must be one of {POLICIES}")
        if self.policy != "wtinylfu":
            _check(self.assoc is not None,
                   f"policy {self.policy!r} runs on the set-associative "
                   "machinery only (assoc=W)")
            _check(self.shards == 1 and self.mesh_devices == 0,
                   f"policy {self.policy!r} does not support sketch "
                   "sharding or mesh execution")
            _check(not self.adaptive and not self.integrity,
                   f"policy {self.policy!r} cannot combine with adaptive/"
                   "integrity")
        if self.policy == "arc":
            _check(self.dk_bits > 0, "policy='arc' needs dk_bits > 0")
        _check(self.streams >= 1, "streams must be >= 1")
        if self.streams > 1:
            _check(self.mesh_devices == 0,
                   "streams cannot combine with mesh_devices")
        if self.integrity:
            _check(self.shards > 1, "integrity requires shards > 1")
        _check(self.mesh_exchange in ("chunk", "stale"),
               f"mesh_exchange {self.mesh_exchange!r} must be 'chunk' or "
               "'stale'")
        if self.mesh_devices:
            _check(self.shards > 1, "mesh execution requires shards > 1")
            _check(self.shards % self.mesh_devices == 0,
                   f"shards {self.shards} must be a multiple of "
                   f"mesh_devices {self.mesh_devices}")
        _check(_pow2(self.width) and self.width % 8 == 0,
               f"width {self.width} must be a power of two >= 8")
        _check(self.counter_bits in (4, 8),
               f"counter_bits {self.counter_bits} must be 4 or 8")
        _check(self.dk_bits == 0 or (_pow2(self.dk_bits)
                                     and self.dk_bits >= 32),
               f"dk_bits {self.dk_bits} must be 0 or a power of two >= 32")
        _check(self.window_slots >= 1 and self.main_slots >= 1,
               "window_slots and main_slots must be >= 1")
        shard_geometry(self.width, self.dk_bits, self.shards)
        if self.assoc is not None:
            _check(self.assoc >= 1, "assoc must be >= 1")
            _check(self.window_slots % self.assoc == 0
                   and _pow2(self.window_slots // self.assoc),
                   "window_slots must be assoc * pow2-sets")
            _check(self.main_slots % self.assoc == 0
                   and _pow2(self.main_slots // self.assoc),
                   "main_slots must be assoc * pow2-sets")

    @property
    def counters_per_word(self) -> int:
        return 32 // self.counter_bits

    @property
    def words_per_row(self) -> int:
        return self.width // self.counters_per_word

    @property
    def counter_cap_max(self) -> int:
        return (1 << self.counter_bits) - 1

    @property
    def dk_words(self) -> int:
        return max(1, self.dk_bits // 32)

    @property
    def width_shard(self) -> int:
        return self.width // self.shards

    @property
    def dk_bits_shard(self) -> int:
        return self.dk_bits // self.shards

    @property
    def counter_words(self) -> int:
        return self.rows * self.words_per_row

    @property
    def sketch_halves(self) -> int:
        return 2 if self.shards > 1 else 1

    @property
    def local_shards(self) -> int:
        return self.shards // max(1, self.mesh_devices)

    @property
    def wps_shard(self) -> int:
        return self.words_per_row // self.shards

    @property
    def dkw_shard(self) -> int:
        return max(1, self.dk_words // self.shards)

    @property
    def dkp(self) -> int:         # stored doorkeeper probes per table entry
        return self.dk_probes if self.dk_bits else 1

    @property
    def window_sets(self) -> int:
        return self.window_slots // self.assoc

    @property
    def main_sets(self) -> int:
        return self.main_slots // self.assoc

    @property
    def wcols(self) -> int:       # packed window record width (set mode)
        return 5 + self.rows + self.dkp

    @property
    def mcols(self) -> int:       # packed main record width (set mode)
        return 3 + self.rows + self.dkp


def _require_ported(spec: StepSpec):
    """Refuse the StepSpec modes this slice of the port does not run."""
    if spec.adaptive:
        raise NotImplementedError(
            "adaptive window is ROADMAP queue 1 item 7")
    if spec.mesh_devices:
        raise NotImplementedError("mesh execution is ROADMAP queue 1 item 12")
    if spec.shards > 1 or spec.integrity:
        raise NotImplementedError(
            "sharded sketches / integrity are ROADMAP queue 1 item 6")
    if spec.policy != "wtinylfu":
        raise NotImplementedError(
            f"policy {spec.policy!r} is ROADMAP queue 1 item 9")


def make_step_params(window_cap: int, main_cap: int, prot_cap: int,
                     sample_size: int, cap: int, warmup: int = 0,
                     counter_bits: int = 4, device=None) -> torch.Tensor:
    """Pack per-config scalars into the (NPARAMS,) int32 params vector on
    ``device`` (the card unless ``"cpu"``; see :func:`resolve_device`)."""
    _check(1 <= cap <= (1 << counter_bits) - 1,
           f"cap {cap} does not fit {counter_bits}-bit counters")
    p = [int(window_cap), int(main_cap), int(prot_cap), int(sample_size),
         int(cap), int(warmup)] + [0] * (NPARAMS - 6)
    return torch.tensor(p, dtype=torch.int32, device=resolve_device(device))


def _state_keys(spec: StepSpec) -> tuple[str, ...]:
    if spec.assoc is None:
        return ("counters", "doorkeeper", "wlo", "whi", "wmeta", "widx",
                "wdkb", "mlo", "mhi", "mmeta", "midx", "mdkb", "regs")
    return ("counters", "doorkeeper", "wtab", "mtab", "regs")


def _state_shapes(spec: StepSpec) -> dict:
    if spec.assoc is None:
        w, m = spec.window_slots, spec.main_slots
        tables = {"wlo": (w,), "whi": (w,), "wmeta": (w,),
                  "widx": (w, spec.rows), "wdkb": (w, spec.dkp),
                  "mlo": (m,), "mhi": (m,), "mmeta": (m,),
                  "midx": (m, spec.rows), "mdkb": (m, spec.dkp)}
    else:
        tables = {"wtab": (spec.window_slots, spec.wcols),
                  "mtab": (spec.main_slots, spec.mcols)}
    shapes = {"counters": (spec.counter_words,),
              "doorkeeper": (spec.dk_words,), **tables, "regs": (NREGS,)}
    if spec.streams > 1:
        return {k: (spec.streams,) + v for k, v in shapes.items()}
    return shapes


def init_step_state(spec: StepSpec, window_cap: int | None = None,
                    main_cap: int | None = None, device=None) -> dict:
    """Zeroed simulation state: a dict of int32 tensors on ``device`` (the
    card unless ``"cpu"``).

    ``window_cap``/``main_cap`` below the static slot counts mark the excess
    slots as permanent padding (set mode: spread over the sets by
    ``set_ways``), exactly as the reference's init does.  With
    ``spec.streams = B > 1`` every leaf gains a leading lane axis and each
    lane is the same zeroed instance.
    """
    _require_ported(spec)
    if spec.streams > 1:
        base = init_step_state(replace(spec, streams=1), window_cap,
                               main_cap, device)
        return {k: v.unsqueeze(0).repeat((spec.streams,) + (1,) * v.dim())
                for k, v in base.items()}
    wcap = spec.window_slots if window_cap is None else int(window_cap)
    mcap = spec.main_slots if main_cap is None else int(main_cap)
    _check(1 <= wcap <= spec.window_slots and 1 <= mcap <= spec.main_slots,
           f"capacities ({wcap}, {mcap}) must fit the static slots "
           f"({spec.window_slots}, {spec.main_slots})")
    arrays = {"counters": np.zeros((spec.counter_words,), np.int32),
              "doorkeeper": np.zeros((spec.dk_words,), np.int32),
              "regs": np.zeros((NREGS,), np.int32)}
    if spec.assoc is None:
        for p, slots, cap in (("w", spec.window_slots, wcap),
                              ("m", spec.main_slots, mcap)):
            arrays[p + "lo"] = np.full((slots,), -1, np.int32)
            arrays[p + "hi"] = np.full((slots,), -1, np.int32)
            arrays[p + "meta"] = np.where(np.arange(slots) >= cap, _I32_MAX,
                                          _EMPTY).astype(np.int32)
            arrays[p + "idx"] = np.zeros((slots, spec.rows), np.int32)
            arrays[p + "dkb"] = np.zeros((slots, spec.dkp), np.int32)
    else:
        def set_table(slots, cap, ncols, meta_col):
            ways = np.asarray(set_ways(cap, slots // spec.assoc))
            way_of = np.arange(slots) % spec.assoc
            pad = way_of >= ways[np.arange(slots) // spec.assoc]
            tab = np.zeros((slots, ncols), np.int32)
            tab[:, 0] = -1
            tab[:, 1] = -1
            tab[:, meta_col] = np.where(pad, _I32_MAX, _EMPTY)
            return tab

        arrays["wtab"] = set_table(spec.window_slots, wcap, spec.wcols,
                                   WT_META)
        arrays["mtab"] = set_table(spec.main_slots, mcap, spec.mcols, MT_META)
    return state_from_numpy(spec, arrays, device)


def state_from_numpy(spec: StepSpec, arrays: dict, device=None) -> dict:
    """Reference-layout numpy leaves -> the port's state dict on ``device``
    (the card unless ``"cpu"``).

    Checks every key and shape against ``spec``, so a state written by the
    JAX package (``{k: np.asarray(v)}``) carries across leaf for leaf.
    """
    dev = resolve_device(device)
    shapes = _state_shapes(spec)
    _check(set(arrays) == set(shapes),
           f"state keys {sorted(arrays)} != {sorted(shapes)}")
    out = {}
    for k in _state_keys(spec):
        a = np.ascontiguousarray(np.asarray(arrays[k]).astype(np.int32))
        _check(a.shape == shapes[k],
               f"state[{k!r}] shape {a.shape} != {shapes[k]}")
        out[k] = torch.from_numpy(a.copy()).to(dev)
    return out


def state_to_numpy(state: dict) -> dict:
    """The port's state dict -> numpy int32 leaves (reference layout)."""
    return {k: v.detach().cpu().numpy().astype(np.int32)
            for k, v in state.items()}


# ---------------------------------------------------------------------------
# probe precomputation: vectorized over the chunk, outside the access loop
# ---------------------------------------------------------------------------

def precompute_probes(spec: StepSpec, lo: torch.Tensor, hi: torch.Tensor):
    """Key lanes of any shape S ((b,) or (B, T)) -> (S + (rows,) probes,
    S + (dkp,) doorkeeper bits, S window set, S + (2,) main set choices),
    all int32 on lo's device.  Set indices are zeros in flat mode."""
    idx, dkb = key_probes(lo, hi, spec.rows, spec.width, spec.dk_bits,
                          spec.dk_probes)
    if spec.assoc is not None:
        wset = set_index(lo, hi, spec.window_sets, WSET_SALT)
        mset = torch.stack([set_index(lo, hi, spec.main_sets, MSET_SALT),
                            set_index(lo, hi, spec.main_sets, MSET2_SALT)],
                           dim=-1)
    else:
        wset = torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)
        mset = torch.zeros(lo.shape + (2,), dtype=torch.int32,
                           device=lo.device)
    return idx, dkb, wset.contiguous(), mset.contiguous()


# ---------------------------------------------------------------------------
# plain per-access bodies (tensor ops; 0-d tensors for scalars, no host sync)
# ---------------------------------------------------------------------------

def _get(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] along dim 0 as a copy (i a 0-d index tensor)."""
    return x.index_select(0, i.reshape(1).long())[0]


def _put(x: torch.Tensor, i: torch.Tensor, v, pred=None):
    """x[i] = where(pred, v, x[i]) along dim 0, in place."""
    j = i.reshape(1).long()
    if pred is not None:
        v = torch.where(pred, v, x.index_select(0, j)[0])
    x.index_put_((j,), torch.as_tensor(v, dtype=x.dtype,
                                       device=x.device).unsqueeze(0))


def _argmax_mask(m: torch.Tensor) -> torch.Tensor:
    """First True index; 0 for an all-False mask (jnp.argmax semantics)."""
    return torch.argmax(m.to(torch.int32))


def _counter_vals(spec: StepSpec, words, idx):
    sub = idx & (spec.counters_per_word - 1)
    return (words >> (sub * spec.counter_bits)) & spec.counter_cap_max


def _word_of(spec: StepSpec, idx):
    return idx >> (3 if spec.counter_bits == 4 else 2)


def _sketch_add(spec: StepSpec, params, counters, dk, size, kidx, kdkb):
    """Doorkeeper gate -> conservative increment (``add_one``, shared with
    the batched add) -> §3.3 reset, in place on ``counters``/``dk``; returns
    the new size (0-d tensor)."""
    add_one(counters, dk, kidx, kdkb, words_per_row=spec.words_per_row,
            counter_bits=spec.counter_bits, cap=params[P_CAP],
            dk_bits=spec.dk_bits)
    size = size + 1
    do_reset = (params[P_SAMPLE] > 0) & (size >= params[P_SAMPLE])
    counters.copy_(torch.where(do_reset,
                               halve_words(counters, spec.counter_bits),
                               counters))
    dk.copy_(torch.where(do_reset, torch.zeros_like(dk), dk))
    return torch.where(do_reset, size // 2, size)


def _estimate_pair(spec: StepSpec, counters, dk, idx2, dkb2):
    """TinyLFU estimates of two entries from their stored probes:
    (2, rows) probes, (2, dkp) doorkeeper bits -> (2,) int32."""
    rows = torch.arange(spec.rows, device=counters.device)
    flat2 = (rows[None, :] * spec.words_per_row
             + _word_of(spec, idx2)).long()
    est = _counter_vals(spec, counters[flat2], idx2).min(dim=-1).values
    if spec.dk_bits:
        w2 = dk[(dkb2 >> 5).long()]
        ok = (((w2 >> (dkb2 & 31)) & 1) == 1).all(dim=-1)
        est = est + ok.to(torch.int32)
    return est


def _one_access_flat(spec: StepSpec, params, st: dict, klo, khi, kidx, kdkb):
    """One access against the exact flat tables, in place; returns hit."""
    regs = st["regs"]
    t = regs[R_T].clone()
    size = _sketch_add(spec, params, st["counters"], st["doorkeeper"],
                       regs[R_SIZE].clone(), kidx, kdkb)
    wlo, whi, wmeta = st["wlo"], st["whi"], st["wmeta"]
    widx, wdkb = st["widx"], st["wdkb"]
    mlo, mhi, mmeta = st["mlo"], st["mhi"], st["mmeta"]
    midx, mdkb = st["midx"], st["mdkb"]

    # lookups: argmax of an all-False mask is 0, whose slot the test reads
    jw = _argmax_mask((wlo == klo) & (whi == khi))
    jm = _argmax_mask((mlo == klo) & (mhi == khi))
    hit_w = ((_get(wlo, jw) == klo) & (_get(whi, jw) == khi)
             & (_get(wmeta, jw) >= 0))
    hit_m = ((_get(mlo, jm) == klo) & (_get(mhi, jm) == khi)
             & (_get(mmeta, jm) >= 0))
    promote = hit_m & (_get(mmeta, jm) < _PROT)
    hit = hit_w | hit_m

    _put(wmeta, jw, t, hit_w)                       # window hit: refresh
    _put(mmeta, jm, _PROT | t, hit_m)               # main hit: -> protected
    pcount = regs[R_PCOUNT] + promote.to(torch.int32)
    over = pcount > params[P_PROT_CAP]              # demote protected LRU
    kd = torch.argmin(torch.where(mmeta >= _PROT, mmeta, _I32_MAX))
    _put(mmeta, kd, t, over)
    pcount = pcount - over.to(torch.int32)

    miss = ~hit
    ws = torch.argmin(wmeta)                        # after the hit refresh
    wsmeta = _get(wmeta, ws)
    push = miss & (wsmeta >= 0)
    cand_lo, cand_hi = _get(wlo, ws), _get(whi, ws)
    cand_idx, cand_dkb = _get(widx, ws), _get(wdkb, ws)
    _put(wlo, ws, klo, miss)
    _put(whi, ws, khi, miss)
    _put(wmeta, ws, t, miss)
    _put(widx, ws, kidx, miss)
    _put(wdkb, ws, kdkb, miss)

    tslot = torch.argmin(mmeta)                     # after promote/demote
    vmeta = _get(mmeta, tslot)
    m_free = vmeta < 0
    est = _estimate_pair(spec, st["counters"], st["doorkeeper"],
                         torch.stack([cand_idx, _get(midx, tslot)]),
                         torch.stack([cand_dkb, _get(mdkb, tslot)]))
    do_ins = push & (m_free | (est[0] > est[1]))
    _put(mlo, tslot, cand_lo, do_ins)
    _put(mhi, tslot, cand_hi, do_ins)
    _put(mmeta, tslot, t, do_ins)
    _put(midx, tslot, cand_idx, do_ins)
    _put(mdkb, tslot, cand_dkb, do_ins)
    pcount = pcount - (do_ins & (vmeta >= _PROT)).to(torch.int32)

    counted = (hit & (t >= params[P_WARMUP])).to(torch.int32)
    regs[R_SIZE] = size
    regs[R_PCOUNT] = pcount
    regs[R_T] = t + 1
    regs[R_HITS] = regs[R_HITS] + counted
    return hit


def _one_access_set(spec: StepSpec, params, st: dict, klo, khi, kidx, kdkb,
                    kwset, kmset):
    """One access against the set-associative tables, in place; returns hit.

    All decisions read the pre-access blocks; where the candidate's sets
    alias the key's sets the hit updates are replayed onto them; the block
    writes go last in the order km1, km2, c1, c2, window (later writes win).
    """
    A = spec.assoc
    rows, dkp = spec.rows, spec.dkp
    regs = st["regs"]
    t = regs[R_T].clone()
    size = _sketch_add(spec, params, st["counters"], st["doorkeeper"],
                       regs[R_SIZE].clone(), kidx, kdkb)
    wtab, mtab = st["wtab"], st["mtab"]
    ways = torch.arange(A, device=wtab.device)

    def block(tab, s):
        return tab[(s.long() * A + ways)]            # (A, cols) copy

    km1, km2 = kmset[0], kmset[1]
    same_km = km2 == km1

    wblk = block(wtab, kwset)
    wmeta = wblk[:, WT_META].clone()
    match_w = (wblk[:, WT_LO] == klo) & (wblk[:, WT_HI] == khi) & (wmeta >= 0)
    hit_w = match_w.any()
    jw = _argmax_mask(match_w)
    mblk1, mblk2 = block(mtab, km1), block(mtab, km2)

    def match_in(blk):
        return ((blk[:, MT_LO] == klo) & (blk[:, MT_HI] == khi)
                & (blk[:, MT_META] >= 0))

    match1 = match_in(mblk1)
    match2 = match_in(mblk2) & ~same_km       # aliased choices: set1 only
    hit1, hit2 = match1.any(), match2.any()
    hit = hit_w | hit1 | hit2

    _put(wmeta, jw, t, hit_w)
    miss = ~hit
    ws = torch.argmin(wmeta)
    newrow = torch.cat([torch.stack([klo, khi, t, km1, km2]), kidx, kdkb])
    wsm = _get(wmeta, ws)
    w_ok = wsm != _I32_MAX                    # zero-way set: bypass window
    push = miss & ((wsm >= 0) | ~w_ok)
    cand = torch.where(w_ok, _get(wblk, ws), newrow)
    wblk[:, WT_META] = wmeta
    _put(wblk, ws, newrow, miss & w_ok)

    def hit_update(blk, match, hit_half):
        blk = blk.clone()
        meta = blk[:, MT_META].clone()
        _put(meta, _argmax_mask(match), _PROT | t, hit_half)
        usable = (meta != _I32_MAX).sum()
        nprot = ((meta >= _PROT) & (meta != _I32_MAX)).sum()
        cap = torch.clamp(usable * params[P_PROT_CAP]
                          // torch.clamp(params[P_MAIN_CAP], min=1), min=1)
        over = hit_half & (nprot > cap)
        kd = torch.argmin(torch.where(meta >= _PROT, meta, _I32_MAX))
        _put(meta, kd, t, over)
        blk[:, MT_META] = meta
        return blk

    mblk1u = hit_update(mblk1, match1, hit1)
    mblk2u = hit_update(mblk2, match2, hit2)
    m2eff = torch.where(same_km, mblk1u, mblk2u)

    c1, c2 = cand[WT_MSET], cand[WT_MSET2]
    same_c = c2 == c1

    def fixup(cb, c):
        return torch.where(c == km2, m2eff, torch.where(c == km1, mblk1u, cb))

    cb1 = fixup(block(mtab, c1), c1)
    cb2 = fixup(block(mtab, c2), c2)
    cblk = torch.cat([cb1, cb2], dim=0)
    tslot = torch.argmin(cblk[:, MT_META])        # ties pick the first half
    vic = _get(cblk, tslot)
    m_free = vic[MT_META] < 0
    est = _estimate_pair(
        spec, st["counters"], st["doorkeeper"],
        torch.stack([cand[5:5 + rows], vic[3:3 + rows]]),
        torch.stack([cand[5 + rows:5 + rows + dkp],
                     vic[3 + rows:3 + rows + dkp]]))
    do_ins = push & (vic[MT_META] != _I32_MAX) & (m_free | (est[0] > est[1]))
    candrow = torch.cat([torch.stack([cand[WT_LO], cand[WT_HI], t]),
                         cand[5:5 + rows], cand[5 + rows:5 + rows + dkp]])
    cb1u, cb2u = cb1.clone(), cb2.clone()
    _put(cb1u, torch.clamp(tslot, max=A - 1), candrow, do_ins & (tslot < A))
    _put(cb2u, torch.clamp(tslot - A, 0, A - 1), candrow,
         do_ins & (tslot >= A))
    cb2u = torch.where(same_c, cb1u, cb2u)

    for s, blk in ((km1, mblk1u), (km2, m2eff), (c1, cb1u), (c2, cb2u)):
        mtab[s.long() * A + ways] = blk
    wtab[kwset.long() * A + ways] = wblk

    counted = (hit & (t >= params[P_WARMUP])).to(torch.int32)
    regs[R_SIZE] = size
    regs[R_T] = t + 1
    regs[R_HITS] = regs[R_HITS] + counted
    return hit


def _lane_count(n_valid, b: int, lanes: int):
    """``n_valid`` (None, an int, or with lanes one int per lane) -> an int,
    or a list of ``lanes`` ints; each in [0, b]."""
    if n_valid is None:
        return b
    if isinstance(n_valid, (torch.Tensor, np.ndarray)):
        n_valid = n_valid.tolist()
    if isinstance(n_valid, (list, tuple)):
        _check(lanes > 1 and len(n_valid) == lanes,
               f"a per-lane n_valid needs streams > 1 and one entry per "
               f"lane; got {len(n_valid)} for streams={max(1, lanes)}")
        n = [int(x) for x in n_valid]
        _check(all(0 <= x <= b for x in n),
               f"n_valid {n} must be in [0, {b}]")
        return n
    n = int(n_valid)
    _check(0 <= n <= b, f"n_valid {n} must be in [0, {b}]")
    return n


def _check_inputs(spec: StepSpec, params, state: dict, lo, hi, n_valid,
                  probes=None):
    _require_ported(spec)
    shapes = _state_shapes(spec)
    _check(set(state) == set(shapes),
           f"state keys {sorted(state)} != {sorted(shapes)}")
    dev = lo.device
    for k, v in state.items():
        _check(v.dtype == torch.int32 and tuple(v.shape) == shapes[k]
               and v.device == dev and v.is_contiguous(),
               f"state[{k!r}] must be a contiguous int32 {shapes[k]} tensor "
               f"on {dev}")
    B = spec.streams
    if B > 1:
        _check(lo.dim() == 2 and lo.shape[0] == B,
               f"streams={B} expects (B, T) key lanes; got trace shape "
               f"{tuple(lo.shape)} — one row per tenant lane")
        _check(params.shape in ((NPARAMS,), (B, NPARAMS))
               and params.device == dev,
               f"params must be ({NPARAMS},) or ({B}, {NPARAMS}) on {dev}")
    else:
        _check(lo.dim() == 1, "lo/hi must be (B,) lanes on one device")
        _check(params.shape == (NPARAMS,) and params.device == dev,
               f"params must be ({NPARAMS},) on {dev}")
    _check(lo.shape == hi.shape and hi.device == dev,
           "lo/hi must be key lanes of one shape on one device")
    if probes is not None:
        _check(len(probes) == 4 and all(
            tuple(p.shape[:lo.dim()]) == tuple(lo.shape) and p.device == dev
            for p in probes),
            "probes must be precompute_probes' four tensors for lo/hi")
    return _lane_count(n_valid, lo.shape[-1], B)


def step_ref(spec: StepSpec, params: torch.Tensor, state: dict,
             lo: torch.Tensor, hi: torch.Tensor, n_valid: int | None = None,
             probes=None):
    """Plain version: advance ``state`` (in place) through the first
    ``n_valid`` accesses of ``lo/hi``; returns (state, hit flags).

    Accesses at positions >= n_valid leave the state untouched and report
    hit 0.  ``probes`` may carry ``precompute_probes(spec, lo, hi)`` when the
    caller hashed the keys already.  Runs on any device, one tensor op at a
    time.  With ``spec.streams > 1`` it runs each lane in turn through the
    single-lane body, on that lane's views of the state.
    """
    n = _check_inputs(spec, params, state, lo, hi, n_valid, probes)
    if spec.streams > 1:
        lspec = replace(spec, streams=1)
        hits = torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)
        for i in range(spec.streams):
            _, hits[i] = step_ref(
                lspec, params[i] if params.dim() == 2 else params,
                {k: v[i] for k, v in state.items()}, lo[i], hi[i],
                n[i] if isinstance(n, list) else n,
                None if probes is None else tuple(p[i] for p in probes))
        return state, hits
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    params = params.to(torch.int32)
    kidx, kdkb, kwset, kmset = (precompute_probes(spec, lo, hi)
                                if probes is None else probes)
    hits = torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)
    for i in range(n):
        if spec.assoc is None:
            hit = _one_access_flat(spec, params, state, lo[i], hi[i],
                                   kidx[i], kdkb[i])
        else:
            hit = _one_access_set(spec, params, state, lo[i], hi[i],
                                  kidx[i], kdkb[i], kwset[i], kmset[i])
        hits[i] = hit.to(torch.int32)
    return state, hits


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper (replaces step_pallas)
# ---------------------------------------------------------------------------

_THREADS = 256


class _Args(ctypes.Structure):
    """Mirror of ``StepArgs`` in csrc/sketch_step.cu (pointers first)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "lo", "hi", "kidx", "kdkb", "kwset", "kmset", "params", "counters",
        "dk", "wlo", "whi", "wmeta", "widx", "wdkb", "mlo", "mhi", "mmeta",
        "midx", "mdkb", "wtab", "mtab", "regs", "hits", "nvalid")] + [
        (name, ctypes.c_int) for name in (
            "n_valid", "b", "rows", "dkp", "dk_bits", "counter_bits",
            "words_per_row", "counter_words", "dk_words", "window_slots",
            "main_slots", "assoc", "wcols", "mcols", "lanes",
            "params_stride")]


def _launch(spec: StepSpec, params: torch.Tensor, state: dict, lo, hi,
            probes, n_valid, hits: torch.Tensor, lib=None,
            lane_grid: bool | None = None):
    """One kernel launch over one chunk: state updated in place, hit flags
    written to ``hits`` (zeros past n_valid).  No host sync.  ``lib`` is the
    loaded kernel library (default: the build of ``csrc/sketch_step.cu``).

    ``lane_grid`` (default: ``spec.streams > 1``) launches the lane kernel,
    one CTA per lane of ``(B, b)`` keys, lane-axis state, shared or per-lane
    params; ``n_valid`` is then an int or a (B,) int32 CUDA tensor.  With
    ``lane_grid=True`` and unbatched inputs it runs one lane, the same work
    as the single-stream launch."""
    from ._build import check_error, load_library
    _check(spec.rows <= _MAX_ROWS and spec.dkp <= _MAX_DKP,
           f"the kernel takes rows <= {_MAX_ROWS} and dk_probes <= "
           f"{_MAX_DKP}")
    _check((spec.assoc or 0) <= _MAX_WAYS,
           f"the kernel holds at most {_MAX_WAYS} ways per set in registers, "
           f"not {spec.assoc}")
    if lane_grid is None:
        lane_grid = spec.streams > 1
    kidx, kdkb, kwset, kmset = probes
    ptr = {"lo": lo, "hi": hi, "kidx": kidx, "kdkb": kdkb, "kwset": kwset,
           "kmset": kmset, "params": params, "counters": state["counters"],
           "dk": state["doorkeeper"], "regs": state["regs"], "hits": hits}
    for k in ("wlo", "whi", "wmeta", "widx", "wdkb", "mlo", "mhi", "mmeta",
              "midx", "mdkb", "wtab", "mtab"):
        if k in state:
            ptr[k] = state[k]
    per_lane = isinstance(n_valid, torch.Tensor)
    _check(lane_grid or not per_lane,
           "a per-lane n_valid needs the lane grid")
    if per_lane:
        ptr["nvalid"] = n_valid
    for k, v in ptr.items():
        _check(v.is_cuda and v.dtype == torch.int32 and v.is_contiguous(),
               f"kernel operand {k!r} must be a contiguous int32 CUDA tensor")
    lanes = lo.shape[0] if lo.dim() == 2 else 1
    args = _Args(**{k: v.data_ptr() for k, v in ptr.items()},
                 n_valid=0 if per_lane else int(n_valid), b=lo.shape[-1],
                 rows=spec.rows, dkp=spec.dkp, dk_bits=spec.dk_bits,
                 counter_bits=spec.counter_bits,
                 words_per_row=spec.words_per_row,
                 counter_words=spec.counter_words, dk_words=spec.dk_words,
                 window_slots=spec.window_slots, main_slots=spec.main_slots,
                 assoc=spec.assoc or 0,
                 wcols=spec.wcols if spec.assoc else 0,
                 mcols=spec.mcols if spec.assoc else 0,
                 lanes=lanes if lane_grid else 0,
                 params_stride=NPARAMS if params.dim() == 2 else 0)
    lib = lib or load_library()
    stream = torch.cuda.current_stream(lo.device).cuda_stream
    check_error("sketch_step", lib, lib.sketch_step_launch(
        ctypes.addressof(args), _THREADS, stream))
    step.launches += 1


def step(spec: StepSpec, params: torch.Tensor, state: dict,
         lo: torch.Tensor, hi: torch.Tensor, n_valid=None, probes=None):
    """Fused chunk step; same contract as :func:`step_ref`.

    CUDA tensors: one launch of the hand-written kernel for all lanes, state
    updated in place (the analogue of the reference's donated buffers); a
    failed build or launch raises.  CPU tensors: the plain version.
    """
    n = _check_inputs(spec, params, state, lo, hi, n_valid, probes)
    if lo.device.type == "cpu":
        return step_ref(spec, params, state, lo, hi, n, probes)
    if lo.device.type != "cuda":
        raise ValueError(f"step runs on CUDA or CPU tensors, not "
                         f"{lo.device.type}")
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    params = params.to(torch.int32).contiguous()
    hits = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
    if probes is None:
        probes = precompute_probes(spec, lo, hi)
    if isinstance(n, list):         # per-lane counts: one int per lane
        n = (n[0] if len(set(n)) == 1 else
             torch.tensor(n, dtype=torch.int32).to(lo.device))
    _launch(spec, params, state, lo, hi, probes, n, hits)
    return state, hits


step.launches = 0       # kernel launches since the last reset to 0

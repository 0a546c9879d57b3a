"""Fused per-access cache step: plain PyTorch version and CUDA wrapper.

Counterpart of ``repro/kernels/sketch_step.py``.  ``policy="wtinylfu"``
runs in both table layouts:

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

``shards=S > 1`` runs the sharded sketch: every probe is confined to the
key's owning shard, ``counters``/``doorkeeper`` hold ``[global || delta]``
halves, an access reads global plus delta (doorkeeper bits: global or delta)
and writes only the delta half, and there is no per-access reset: the §3.3
aging moves to the epoch fold (``kernels/sketch_merge.py``).  ``integrity``
adds a ``csum`` leaf of ``S + 1`` int32 words that only the fold touches.

``mesh_devices=D`` (with ``shards``) is one rank's step of the sharded sketch
split over a ``("shard",)`` mesh of D ranks (``distributed/mesh.py``): the
``counters``/``doorkeeper`` leaves hold only the replicated global halves,
and ``dcounters``/``ddoorkeeper`` this rank's delta blocks, ``(L, rows,
wps_shard)`` and ``(L, dkw_shard)`` for its ``L = shards / D`` shards
(placed by ``distributed.mesh.owned_shards``; ``rank=`` of :func:`step`
says which rank).  This is the ``mesh_exchange="stale"`` step (kernel
mode 1e): the owner of the key's shard composes its delta with the global
half and writes its delta, a non-owner writes nothing, and estimates read the
global halves only, so every rank takes the same decisions.

The policy panel's competitors run on the set-associative tables, one
stream or lanes, unsharded and static (``_SET_BODIES``): ``"s3fifo"`` (the
window is the small FIFO, main a CLOCK-marked FIFO, the sketch the
one-hit-wonder filter), ``"arc"`` (T1/T2 in the main table, the target p
and the list counts in registers, B1/B2 as the Bloom halves of a ``ghost``
leaf; no sketch) and ``"lfu"`` (no window, the victim the smallest estimate
of the key's two sets).

``adaptive=True`` moves the window/main split from init-time padding into
registers: ``regs[R_WQUOTA]`` is the window quota, the flat tables gate
inserts on the resident counts ``R_WCOUNT``/``R_MCOUNT``, and the set
tables read each set's usable ways (``wuw`` for the window, arithmetic for
main); ways past them read as padding and stay empty in storage.  Stamps
are ``2t`` in the window and ``2t + 1`` in main, ``R_EHITS`` counts the
epoch's hits and ``wsl`` each window set's accesses.  :func:`rebalance`
moves the split between epochs (tensor ops, no host read).

The state is a dict of int32 tensors with the reference's keys and shapes
(``_state_keys``), so ``state_from_numpy``/``state_to_numpy`` carry state
between the JAX package and the port leaf for leaf.

Table words that the step takes as addresses are clamped as the
reference's ``dynamic_slice``/``dynamic_update_slice`` clamp them: a stored
main set ``c`` (``WT_MSET``, ``WT_MSET2``) addresses the block that starts at
the int32 product ``c * A`` clamped into ``[0, main_slots - A]``, and ARC's
ghost positions clamp into the ghost leaf.  A fault may corrupt them
(``core/faults.py``); the step degrades as the reference does.

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

from repro_torch.analysis import program_trace
from repro_torch.core.hashing import (WSET_SALT, MSET_SALT, MSET2_SALT,
                                      set_ways, shard_geometry)
from .sketch_common import (POLICIES, _check, _pow2, dk_probe_salts,
                            halve_words, key_probes, probe_matrix,
                            probe_salts, resolve_device, set_index,
                            shard_index)
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

# the kernel keeps one access's counter probes one per lane of a warp half
_MAX_ROWS = 8


@dataclass(frozen=True)
class StepSpec:
    """Static geometry of one simulated W-TinyLFU instance.

    Same fields, properties and validation as the reference ``StepSpec``
    (see its docstring for each field).  ``mesh_devices`` selects the
    stale mesh step (the per-rank layout of the module docstring);
    ``mesh_exchange`` is read by the engine, not by the step.
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
    csum = ("csum",) if spec.integrity else ()
    mesh = ("dcounters", "ddoorkeeper") if spec.mesh_devices else ()
    if spec.assoc is None:
        return (("counters", "doorkeeper") + mesh
                + ("wlo", "whi", "wmeta", "widx", "wdkb", "mlo", "mhi",
                   "mmeta", "midx", "mdkb", "regs") + csum)
    load = ("wsl", "wuw") if spec.adaptive else ()
    ghost = ("ghost",) if spec.policy == "arc" else ()
    return (("counters", "doorkeeper") + mesh + ("wtab", "mtab") + ghost
            + ("regs",) + load + csum)


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
        if spec.adaptive:
            tables["wsl"] = tables["wuw"] = (spec.window_sets,)
        if spec.policy == "arc":      # B1 || B2 ghost Blooms
            tables["ghost"] = (2 * spec.dk_words,)
    if spec.mesh_devices:         # global halves + this rank's delta blocks
        L = spec.local_shards
        shapes = {"counters": (spec.counter_words,),
                  "doorkeeper": (spec.dk_words,),
                  "dcounters": (L, spec.rows, spec.wps_shard),
                  "ddoorkeeper": (L, spec.dkw_shard), **tables,
                  "regs": (NREGS,)}
    else:
        shapes = {"counters": (spec.sketch_halves * spec.counter_words,),
                  "doorkeeper": (spec.sketch_halves * spec.dk_words,),
                  **tables, "regs": (NREGS,)}
    if spec.integrity:
        shapes["csum"] = (spec.shards + 1,)
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
    ``spec.adaptive`` nothing is padded: ``window_cap`` seeds the quota
    register ``R_WQUOTA`` and (set mode) the window's usable ways ``wuw =
    set_ways(window_cap, window_sets)``, ``wsl`` starts at 0.  With
    ``spec.streams = B > 1`` every leaf gains a leading lane axis and each
    lane is the same zeroed instance.  With ``spec.mesh_devices`` it is one
    rank's state: the global halves and this rank's zeroed delta blocks.
    """
    if spec.streams > 1:
        base = init_step_state(replace(spec, streams=1), window_cap,
                               main_cap, device)
        state = {k: v.unsqueeze(0).repeat((spec.streams,) + (1,) * v.dim())
                 for k, v in base.items()}
        _mark_in_range(spec, state)
        return state
    wcap = spec.window_slots if window_cap is None else int(window_cap)
    mcap = spec.main_slots if main_cap is None else int(main_cap)
    _check(1 <= wcap <= spec.window_slots and 1 <= mcap <= spec.main_slots,
           f"capacities ({wcap}, {mcap}) must fit the static slots "
           f"({spec.window_slots}, {spec.main_slots})")
    arrays = {k: np.zeros(v, np.int32) for k, v in _state_shapes(spec).items()
              if k in ("counters", "doorkeeper", "dcounters", "ddoorkeeper",
                       "regs", "csum", "wsl", "ghost")}
    if spec.adaptive:
        arrays["regs"][R_WQUOTA] = wcap
        if spec.assoc is not None:
            arrays["wuw"] = np.asarray(set_ways(wcap, spec.window_sets),
                                       np.int32)
        wcap, mcap = spec.window_slots, spec.main_slots     # no padding
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
    if not tables_out_of_range(spec, arrays):
        _mark_in_range(spec, out)
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
    all int32 on lo's device.  Set indices are zeros in flat mode.  With
    ``shards > 1`` a probe is ``shard * width_shard + (hash & (width_shard -
    1))``, and likewise a doorkeeper bit, for the key's owning shard."""
    if spec.shards > 1:
        ks = shard_index(lo, hi, spec.shards)[..., None]
        idx = ks * spec.width_shard + probe_matrix(
            lo, hi, probe_salts(spec.rows), spec.width_shard - 1)
        if spec.dk_bits:
            dkb = ks * spec.dk_bits_shard + probe_matrix(
                lo, hi, dk_probe_salts(spec.dk_probes),
                spec.dk_bits_shard - 1)
        else:
            dkb = torch.zeros(lo.shape + (1,), dtype=torch.int32,
                              device=lo.device)
    else:
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


def _sketch_add_sharded(spec: StepSpec, params, counters, dk, size, kidx,
                        kdkb):
    """The sharded add on ``[global || delta]`` buffers, in place: the
    doorkeeper gate tests global | delta bits (a later probe of the access
    also sees an earlier probe's bit) and sets its bits in the delta half;
    the conservative minimum is over global + delta fields and the bump
    lands in the delta field.  No reset (the epoch fold ages the sketch);
    returns size + 1."""
    H, HD = spec.counter_words, spec.dk_words
    if spec.dk_bits:
        w_idx = (kdkb >> 5).long()
        bpos = kdkb & 31
        words = dk[HD + w_idx]
        pre = ((words | dk[w_idx]) >> bpos) & 1
        earlier = torch.tril(kdkb[:, None] == kdkb[None, :], diagonal=-1)
        gate = ((pre == 1) | earlier.any(dim=1)).all()
        bitm = torch.ones_like(bpos) << bpos
        same = w_idx[:, None] == w_idx[None, :]
        merged = words.clone()
        for j in range(kdkb.shape[0]):
            merged = merged | torch.where(same[:, j], bitm[j], 0)
        dk[HD + w_idx] = merged            # duplicate words carry one value
    else:
        gate = torch.ones((), dtype=torch.bool, device=counters.device)
    rows = torch.arange(spec.rows, device=counters.device)
    flat = (rows * spec.words_per_row + _word_of(spec, kidx)).long()
    words = counters[H + flat]
    vals = (_counter_vals(spec, words, kidx)
            + _counter_vals(spec, counters[flat], kidx))
    m = vals.min()
    bump = gate & (m < params[P_CAP])
    sub = (kidx & (spec.counters_per_word - 1)) * spec.counter_bits
    inc = torch.ones_like(sub) << sub
    counters[H + flat] = torch.where(bump & (vals == m), words + inc, words)
    return size + 1


def _sketch_add_mesh(spec: StepSpec, params, st: dict, size, kidx, kdkb):
    """One rank's add of the stale mesh step (the reference's
    ``_sketch_add_mesh``), in place on its delta blocks: the rank that owns
    the key's shard (``st["_base"] <= shard < base + L``) composes its delta
    with the global half exactly as the sharded add does (gate on delta |
    global bits, minimum over delta + global fields) and writes its delta
    blocks; another rank computes the same arithmetic on don't-care words
    and writes back what it read.  No reset; returns size + 1."""
    L, rows = spec.local_shards, spec.rows
    base = st["_base"]
    cg, dkg = st["counters"], st["doorkeeper"]
    cdf = st["dcounters"].view(-1)
    ddf = st["ddoorkeeper"].view(-1)
    ks = kidx[0] // spec.width_shard            # owning shard (rows agree)
    local = (ks >= base) & (ks < base + L)
    lks = torch.clamp(ks - base, 0, L - 1)
    if spec.dk_bits:
        w_idx = (kdkb >> 5).long()
        bpos = kdkb & 31
        ldw = (lks * spec.dkw_shard
               + ((kdkb - ks * spec.dk_bits_shard) >> 5)).long()
        words, gwords = ddf[ldw], dkg[w_idx]
        pre = ((torch.where(local, words, 0) | gwords) >> bpos) & 1
        earlier = torch.tril(kdkb[:, None] == kdkb[None, :], diagonal=-1)
        gate = ((pre == 1) | earlier.any(dim=1)).all()
        bitm = torch.ones_like(bpos) << bpos
        same = w_idx[:, None] == w_idx[None, :]
        merged = words.clone()
        for j in range(kdkb.shape[0]):
            merged = merged | torch.where(same[:, j], bitm[j], 0)
        ddf[ldw] = torch.where(local, merged, words)    # duplicates agree
    else:
        gate = torch.ones((), dtype=torch.bool, device=cg.device)
    r = torch.arange(rows, device=cg.device)
    flat = (r * spec.words_per_row + _word_of(spec, kidx)).long()
    h = kidx - ks * spec.width_shard            # per-shard probe offsets
    dflat = ((lks * rows + r) * spec.wps_shard + _word_of(spec, h)).long()
    words, gw = cdf[dflat], cg[flat]
    vals = (torch.where(local, _counter_vals(spec, words, kidx), 0)
            + _counter_vals(spec, gw, kidx))
    m = vals.min()
    bump = gate & (m < params[P_CAP])
    sub = (kidx & (spec.counters_per_word - 1)) * spec.counter_bits
    new = torch.where(bump & (vals == m), words + (torch.ones_like(sub)
                                                   << sub), words)
    cdf[dflat] = torch.where(local, new, words)
    return size + 1


def _add(spec: StepSpec, params, st: dict, kidx, kdkb):
    """The access's sketch add (sharded, meshed or not); returns the new
    size."""
    size = st["regs"][R_SIZE].clone()
    if spec.mesh_devices:
        return _sketch_add_mesh(spec, params, st, size, kidx, kdkb)
    fn = _sketch_add_sharded if spec.shards > 1 else _sketch_add
    return fn(spec, params, st["counters"], st["doorkeeper"], size, kidx,
              kdkb)


def _clip_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Word indices as the reference's gathers take them: a negative one
    counts from the end once, then each clamps into [0, n)."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1).long()


def _block_start(s: torch.Tensor, A: int, n: int) -> torch.Tensor:
    """Row offset of the A-row block of set ``s`` in an n-row table as the
    reference's dynamic slices take it: the int32 product ``s * A`` (it
    wraps), clamped into ``[0, n - A]``.  A set index read from the tables
    (a stored main set) may be out of range after a fault."""
    p = (s.long() * A) & 0xFFFFFFFF
    p = torch.where(p >= 2**31, p - 2**32, p)
    return torch.clamp(p, 0, n - A)


def _estimate_block(spec: StepSpec, counters, dk, idx2, dkb2):
    """TinyLFU estimates of K entries from their stored probes: (K, rows)
    probes, (K, dkp) doorkeeper bits -> (K,) int32 (the reference's
    ``_estimate_pair`` at K = 2, its ``_estimate_block`` at any K).
    Sharded: counters are global + delta fields, doorkeeper bits global |
    delta.  Meshed (the stale step): the global halves only, so every rank
    takes the same verdict.  A stored probe is table state, which a fault
    may corrupt: its word index clamps as the reference's gathers clamp
    it."""
    rows = torch.arange(spec.rows, device=counters.device)
    flat2 = rows[None, :] * spec.words_per_row + _word_of(spec, idx2)
    n = counters.shape[-1]
    halves = spec.shards > 1 and not spec.mesh_devices
    vals = _counter_vals(spec, counters[_clip_index(flat2, n)], idx2)
    if halves:
        vals = vals + _counter_vals(spec, counters[_clip_index(
            spec.counter_words + flat2, n)], idx2)
    est = vals.min(dim=-1).values
    if spec.dk_bits:
        b2, nd = dkb2 >> 5, dk.shape[-1]
        w2 = dk[_clip_index(b2, nd)]
        if halves:
            w2 = w2 | dk[_clip_index(spec.dk_words + b2, nd)]
        ok = (((w2 >> (dkb2 & 31)) & 1) == 1).all(dim=-1)
        est = est + ok.to(torch.int32)
    return est


def _floordiv(a, b):
    """``a // b`` with floor rounding, as ``jnp.int32 //`` (a or b may be
    negative; int32 products wrap before it, as in the reference)."""
    return torch.div(a, b, rounding_mode="floor")


def _runtime_caps(params, wquota):
    """Adaptive: main's runtime capacity (what the quota leaves of the
    total) and the protected budget at the static fraction of it."""
    mcap_rt = params[P_WINDOW_CAP] + params[P_MAIN_CAP] - wquota
    prot_rt = torch.clamp(_floordiv(
        mcap_rt * params[P_PROT_CAP],
        torch.clamp(params[P_MAIN_CAP], min=1)), min=1)
    return mcap_rt, prot_rt


def _one_access_flat(spec: StepSpec, params, st: dict, klo, khi, kidx, kdkb):
    """One access against the exact flat tables, in place; returns hit.

    Adaptive: the protected budget follows main's runtime capacity, the
    drain is gated on a main hit, and at quota the argmins hide EMPTY slots
    (the runtime equivalent of padding)."""
    regs = st["regs"]
    t = regs[R_T].clone()
    size = _add(spec, params, st, kidx, kdkb)
    wlo, whi, wmeta = st["wlo"], st["whi"], st["wmeta"]
    widx, wdkb = st["widx"], st["wdkb"]
    mlo, mhi, mmeta = st["mlo"], st["mhi"], st["mmeta"]
    midx, mdkb = st["midx"], st["mdkb"]
    if spec.adaptive:
        wquota, wcount, mcount = (regs[R_WQUOTA].clone(),
                                  regs[R_WCOUNT].clone(),
                                  regs[R_MCOUNT].clone())
        mcap_rt, prot_rt = _runtime_caps(params, wquota)
        wst, mst = t + t, t + t + 1
    else:
        prot_rt, wst, mst = params[P_PROT_CAP], t, t

    # lookups: argmax of an all-False mask is 0, whose slot the test reads
    jw = _argmax_mask((wlo == klo) & (whi == khi))
    jm = _argmax_mask((mlo == klo) & (mhi == khi))
    hit_w = ((_get(wlo, jw) == klo) & (_get(whi, jw) == khi)
             & (_get(wmeta, jw) >= 0))
    hit_m = ((_get(mlo, jm) == klo) & (_get(mhi, jm) == khi)
             & (_get(mmeta, jm) >= 0))
    promote = hit_m & (_get(mmeta, jm) < _PROT)
    hit = hit_w | hit_m

    _put(wmeta, jw, wst, hit_w)                     # window hit: refresh
    _put(mmeta, jm, _PROT | mst, hit_m)             # main hit: -> protected
    pcount = regs[R_PCOUNT] + promote.to(torch.int32)
    over = pcount > prot_rt                         # demote protected LRU
    if spec.adaptive:
        over = over & hit_m
    kd = torch.argmin(torch.where(mmeta >= _PROT, mmeta, _I32_MAX))
    _put(mmeta, kd, mst, over)
    pcount = pcount - over.to(torch.int32)

    miss = ~hit
    if spec.adaptive:                               # after the hit refresh
        ws = torch.argmin(torch.where((wcount >= wquota) & (wmeta == _EMPTY),
                                      _I32_MAX, wmeta))
    else:
        ws = torch.argmin(wmeta)
    wsmeta = _get(wmeta, ws)
    push = miss & (wsmeta >= 0)
    cand_lo, cand_hi = _get(wlo, ws), _get(whi, ws)
    cand_idx, cand_dkb = _get(widx, ws), _get(wdkb, ws)
    _put(wlo, ws, klo, miss)
    _put(whi, ws, khi, miss)
    _put(wmeta, ws, wst, miss)
    _put(widx, ws, kidx, miss)
    _put(wdkb, ws, kdkb, miss)

    if spec.adaptive:                               # after promote/demote
        tslot = torch.argmin(torch.where(
            (mcount >= mcap_rt) & (mmeta == _EMPTY), _I32_MAX, mmeta))
    else:
        tslot = torch.argmin(mmeta)
    vmeta = _get(mmeta, tslot)
    m_free = vmeta < 0
    est = _estimate_block(spec, st["counters"], st["doorkeeper"],
                         torch.stack([cand_idx, _get(midx, tslot)]),
                         torch.stack([cand_dkb, _get(mdkb, tslot)]))
    do_ins = push & (m_free | (est[0] > est[1]))
    _put(mlo, tslot, cand_lo, do_ins)
    _put(mhi, tslot, cand_hi, do_ins)
    _put(mmeta, tslot, mst, do_ins)
    _put(midx, tslot, cand_idx, do_ins)
    _put(mdkb, tslot, cand_dkb, do_ins)
    pcount = pcount - (do_ins & (vmeta >= _PROT)).to(torch.int32)

    counted = (hit & (t >= params[P_WARMUP])).to(torch.int32)
    regs[R_SIZE] = size
    regs[R_PCOUNT] = pcount
    regs[R_T] = t + 1
    regs[R_HITS] = regs[R_HITS] + counted
    if spec.adaptive:
        regs[R_WCOUNT] = wcount + (miss & (wsmeta == _EMPTY)).to(torch.int32)
        regs[R_MCOUNT] = mcount + (do_ins & m_free).to(torch.int32)
        regs[R_EHITS] = regs[R_EHITS] + hit.to(torch.int32)
    return hit


def _insert(b1, b2, tslot, row, do_ins, same):
    """Write ``row`` at ``tslot`` of the (2A,) pair of set blocks ``b1``,
    ``b2`` (copies) where ``do_ins``; aliased sets (``same``) take the first
    block's result.  Returns the updated (b1, b2)."""
    A = b1.shape[0]
    b1u, b2u = b1.clone(), b2.clone()
    _put(b1u, torch.clamp(tslot, max=A - 1), row, do_ins & (tslot < A))
    _put(b2u, torch.clamp(tslot - A, 0, A - 1), row, do_ins & (tslot >= A))
    return b1u, torch.where(same, b1u, b2u)


def _main_lookup(spec: StepSpec, mtab, klo, khi, kmset):
    """The key's two main set blocks (copies) and their match masks; the
    second is masked when the choices alias (a hit counts in set 1 only).
    Returns (blk1, blk2, match1, match2, same_km)."""
    A = spec.assoc
    ways = torch.arange(A, device=mtab.device)
    km1, km2 = kmset[0], kmset[1]
    same_km = km2 == km1
    blk1 = mtab[km1.long() * A + ways]
    blk2 = mtab[km2.long() * A + ways]

    def match_in(blk):
        return ((blk[:, MT_LO] == klo) & (blk[:, MT_HI] == khi)
                & (blk[:, MT_META] >= 0))
    return blk1, blk2, match_in(blk1), match_in(blk2) & ~same_km, same_km


def _with_meta(blk, match, meta):
    """A copy of ``blk`` whose matching records take ``meta``."""
    out = blk.clone()
    out[:, MT_META] = torch.where(match, meta, blk[:, MT_META])
    return out


def _one_access_set(spec: StepSpec, params, st: dict, klo, khi, kidx, kdkb,
                    kwset, kmset):
    """One access against the set-associative tables, in place; returns hit.

    All decisions read the pre-access blocks; where the candidate's sets
    alias the key's sets the hit updates are replayed onto them; the block
    writes go last in the order km1, km2, c1, c2, window (later writes win).
    Adaptive: a set's ways at or past its usable count (``wuw[set]`` in the
    window; main's runtime capacity spread over its sets) read as padding
    for every decision and are written back EMPTY; ``wsl`` counts the
    access in its window set.
    """
    A = spec.assoc
    rows, dkp = spec.rows, spec.dkp
    regs = st["regs"]
    t = regs[R_T].clone()
    size = _add(spec, params, st, kidx, kdkb)
    wtab, mtab = st["wtab"], st["mtab"]
    ways = torch.arange(A, device=wtab.device)

    if spec.adaptive:
        mcap_rt, _ = _runtime_caps(params, regs[R_WQUOTA])
        nms = spec.main_sets

        def w_usable(s):
            return _get(st["wuw"], s)

        def m_usable(s):
            return (_floordiv(mcap_rt, nms)
                    + (s < torch.remainder(mcap_rt, nms)).to(torch.int32))

        def masked(blk, u, col, fill):
            blk[:, col] = torch.where(ways >= u, fill, blk[:, col])
            return blk
        wst, mst = t + t, t + t + 1
    else:
        def w_usable(s):
            return None

        m_usable = w_usable

        def masked(blk, u, col, fill):
            return blk
        wst, mst = t, t

    def block(tab, s, u, col):
        return masked(tab[(s.long() * A + ways)], u, col,   # (A, cols) copy
                      _I32_MAX)

    km1, km2 = kmset[0], kmset[1]
    same_km = km2 == km1

    wblk = block(wtab, kwset, w_usable(kwset), WT_META)
    wmeta = wblk[:, WT_META].clone()
    match_w = (wblk[:, WT_LO] == klo) & (wblk[:, WT_HI] == khi) & (wmeta >= 0)
    hit_w = match_w.any()
    jw = _argmax_mask(match_w)
    mblk1 = block(mtab, km1, m_usable(km1), MT_META)
    mblk2 = block(mtab, km2, m_usable(km2), MT_META)

    def match_in(blk):
        return ((blk[:, MT_LO] == klo) & (blk[:, MT_HI] == khi)
                & (blk[:, MT_META] >= 0))

    match1 = match_in(mblk1)
    match2 = match_in(mblk2) & ~same_km       # aliased choices: set1 only
    hit1, hit2 = match1.any(), match2.any()
    hit = hit_w | hit1 | hit2

    _put(wmeta, jw, wst, hit_w)
    miss = ~hit
    ws = torch.argmin(wmeta)
    newrow = torch.cat([torch.stack([klo, khi, wst, km1, km2]), kidx, kdkb])
    wsm = _get(wmeta, ws)
    w_ok = wsm != _I32_MAX                    # zero-way set: bypass window
    push = miss & ((wsm >= 0) | ~w_ok)
    cand = torch.where(w_ok, _get(wblk, ws), newrow)
    wblk[:, WT_META] = wmeta
    _put(wblk, ws, newrow, miss & w_ok)

    def hit_update(blk, match, hit_half):
        blk = blk.clone()
        meta = blk[:, MT_META].clone()
        _put(meta, _argmax_mask(match), _PROT | mst, hit_half)
        usable = (meta != _I32_MAX).sum()
        nprot = ((meta >= _PROT) & (meta != _I32_MAX)).sum()
        cap = torch.clamp(usable * params[P_PROT_CAP]
                          // torch.clamp(params[P_MAIN_CAP], min=1), min=1)
        over = hit_half & (nprot > cap)
        kd = torch.argmin(torch.where(meta >= _PROT, meta, _I32_MAX))
        _put(meta, kd, mst, over)
        blk[:, MT_META] = meta
        return blk

    mblk1u = hit_update(mblk1, match1, hit1)
    mblk2u = hit_update(mblk2, match2, hit2)
    m2eff = torch.where(same_km, mblk1u, mblk2u)

    c1, c2 = cand[WT_MSET], cand[WT_MSET2]
    same_c = c2 == c1

    def fixup(cb, c):
        return torch.where(c == km2, m2eff, torch.where(c == km1, mblk1u, cb))

    ms = mtab.shape[0]
    cs1, cs2 = _block_start(c1, A, ms), _block_start(c2, A, ms)
    cb1 = fixup(masked(mtab[cs1 + ways], m_usable(c1), MT_META, _I32_MAX), c1)
    cb2 = fixup(masked(mtab[cs2 + ways], m_usable(c2), MT_META, _I32_MAX), c2)
    cblk = torch.cat([cb1, cb2], dim=0)
    tslot = torch.argmin(cblk[:, MT_META])        # ties pick the first half
    vic = _get(cblk, tslot)
    m_free = vic[MT_META] < 0
    est = _estimate_block(
        spec, st["counters"], st["doorkeeper"],
        torch.stack([cand[5:5 + rows], vic[3:3 + rows]]),
        torch.stack([cand[5 + rows:5 + rows + dkp],
                     vic[3 + rows:3 + rows + dkp]]))
    do_ins = push & (vic[MT_META] != _I32_MAX) & (m_free | (est[0] > est[1]))
    candrow = torch.cat([torch.stack([cand[WT_LO], cand[WT_HI], mst]),
                         cand[5:5 + rows], cand[5 + rows:5 + rows + dkp]])
    cb1u, cb2u = _insert(cb1, cb2, tslot, candrow, do_ins, same_c)

    for s, st0, blk in ((km1, km1.long() * A, mblk1u),
                        (km2, km2.long() * A, m2eff), (c1, cs1, cb1u),
                        (c2, cs2, cb2u)):
        mtab[st0 + ways] = masked(blk, m_usable(s), MT_META, _EMPTY)
    wtab[kwset.long() * A + ways] = masked(wblk, w_usable(kwset), WT_META,
                                           _EMPTY)

    counted = (hit & (t >= params[P_WARMUP])).to(torch.int32)
    regs[R_SIZE] = size
    regs[R_T] = t + 1
    regs[R_HITS] = regs[R_HITS] + counted
    if spec.adaptive:
        _put(st["wsl"], kwset, _get(st["wsl"], kwset) + 1)
        regs[R_EHITS] = regs[R_EHITS] + hit.to(torch.int32)
    return hit


def _one_access_set_s3fifo(spec: StepSpec, params, st: dict, klo, khi,
                           kidx, kdkb, kwset, kmset):
    """One access under S3-FIFO, in place; returns hit.

    The window table is the small FIFO (insert order: a window hit writes
    nothing), the main table the CLOCK-marked main FIFO (a hit ORs
    ``_PROT`` into the meta and keeps the stamp, so the victim argmin orders
    empty < unmarked oldest < marked oldest), and the sketch is the
    one-hit-wonder filter: the candidate pushed out of the small FIFO enters
    main only with an estimate (after this access's add) of at least 2, with
    no free-slot override."""
    A, rows, dkp = spec.assoc, spec.rows, spec.dkp
    regs = st["regs"]
    t = regs[R_T].clone()
    size = _add(spec, params, st, kidx, kdkb)
    wtab, mtab = st["wtab"], st["mtab"]
    ways = torch.arange(A, device=wtab.device)
    km1, km2 = kmset[0], kmset[1]

    wblk = wtab[kwset.long() * A + ways]
    wmeta = wblk[:, WT_META].clone()
    hit_w = ((wblk[:, WT_LO] == klo) & (wblk[:, WT_HI] == khi)
             & (wmeta >= 0)).any()
    mblk1, mblk2, match1, match2, same_km = _main_lookup(spec, mtab, klo,
                                                         khi, kmset)
    hit = hit_w | match1.any() | match2.any()

    miss = ~hit
    ws = torch.argmin(wmeta)                  # oldest insert (or empty)
    newrow = torch.cat([torch.stack([klo, khi, t, km1, km2]), kidx, kdkb])
    wsm = _get(wmeta, ws)
    w_ok = wsm != _I32_MAX                    # zero-way set: bypass window
    push = miss & ((wsm >= 0) | ~w_ok)
    cand = torch.where(w_ok, _get(wblk, ws), newrow)
    _put(wblk, ws, newrow, miss & w_ok)

    mblk1u = _with_meta(mblk1, match1, mblk1[:, MT_META] | _PROT)
    mblk2u = _with_meta(mblk2, match2, mblk2[:, MT_META] | _PROT)
    m2eff = torch.where(same_km, mblk1u, mblk2u)

    c1, c2 = cand[WT_MSET], cand[WT_MSET2]

    cs1 = _block_start(c1, A, mtab.shape[0])
    cs2 = _block_start(c2, A, mtab.shape[0])

    def fixup(c, cs):
        cb = mtab[cs + ways]
        return torch.where(c == km2, m2eff, torch.where(c == km1, mblk1u, cb))

    cb1, cb2 = fixup(c1, cs1), fixup(c2, cs2)
    cblk = torch.cat([cb1, cb2], dim=0)
    tslot = torch.argmin(cblk[:, MT_META])    # empty < unmarked < marked
    vic = _get(cblk, tslot)
    est = _estimate_block(spec, st["counters"], st["doorkeeper"],
                          cand[5:5 + rows][None], cand[5 + rows:][None])
    do_ins = push & (vic[MT_META] != _I32_MAX) & (est[0] >= 2)
    candrow = torch.cat([torch.stack([cand[WT_LO], cand[WT_HI], t]),
                         cand[5:5 + rows], cand[5 + rows:5 + rows + dkp]])
    cb1u, cb2u = _insert(cb1, cb2, tslot, candrow, do_ins, c2 == c1)

    for st0, blk in ((km1.long() * A, mblk1u), (km2.long() * A, m2eff),
                     (cs1, cb1u), (cs2, cb2u)):
        mtab[st0 + ways] = blk
    wtab[kwset.long() * A + ways] = wblk

    regs[R_SIZE] = size
    regs[R_T] = t + 1
    regs[R_HITS] = regs[R_HITS] + (hit & (t >= params[P_WARMUP])).to(
        torch.int32)
    return hit


def _one_access_set_arc(spec: StepSpec, params, st: dict, klo, khi, kidx,
                        kdkb, kwset, kmset):
    """One access under ARC, in place; returns hit.

    T1 (probation meta) and T2 (``_PROT`` meta) share the main table; the
    target p is ``regs[R_WQUOTA]``, |T1| ``R_WCOUNT``, and the B1/B2 ghost
    lists are the Bloom halves of the ``ghost`` leaf (``[0, dk_words)`` and
    ``[dk_words, 2 dk_words)``), addressed by the stored doorkeeper probes,
    with their insert counts in ``R_MCOUNT``/``R_EHITS``; a half is cleared
    when its count has reached ``P_MAIN_CAP``.  No sketch add and no reset;
    the window table is never read or written; every miss is admitted."""
    A, rows, dkp, dkw = spec.assoc, spec.rows, spec.dkp, spec.dk_words
    regs = st["regs"]
    t = regs[R_T].clone()
    p, t1count = regs[R_WQUOTA].clone(), regs[R_WCOUNT].clone()
    gb1count, gb2count = regs[R_MCOUNT].clone(), regs[R_EHITS].clone()
    ghost, mtab = st["ghost"], st["mtab"]
    ways = torch.arange(A, device=mtab.device)
    km1, km2 = kmset[0], kmset[1]

    mblk1, mblk2, match1, match2, same_km = _main_lookup(spec, mtab, klo,
                                                         khi, kmset)
    hit = match1.any() | match2.any()
    hit_t1 = ((match1 & (mblk1[:, MT_META] < _PROT)).any()
              | (match2 & (mblk2[:, MT_META] < _PROT)).any())
    gpos, gbit = (kdkb >> 5).long(), kdkb & 31
    gb1 = (((ghost[gpos] >> gbit) & 1) == 1).all()
    gb2 = (((ghost[dkw + gpos] >> gbit) & 1) == 1).all()

    mblk1u = _with_meta(mblk1, match1, _PROT | t)   # hit: -> T2 MRU
    mblk2u = _with_meta(mblk2, match2, _PROT | t)
    m2eff = torch.where(same_km, mblk1u, mblk2u)

    miss = ~hit
    in_b1 = miss & gb1
    in_b2 = miss & gb2 & ~gb1
    p_new = torch.where(in_b1, torch.minimum(params[P_MAIN_CAP], p + 1),
                        torch.where(in_b2, torch.clamp(p - 1, min=0), p))

    # REPLACE: the T1 LRU while |T1| exceeds p (at |T1| == p on a B2 ghost
    # hit), else the T2 LRU; flipping _PROT in the order key swaps which
    # list the argmin prefers
    cblk = torch.cat([mblk1u, m2eff], dim=0)
    meta_c = cblk[:, MT_META]
    prefer_t1 = (t1count > p_new) | (in_b2 & (t1count == p_new))
    flip = torch.where(prefer_t1, 0, _PROT)
    okey = torch.where(meta_c == _I32_MAX, _I32_MAX,
                       torch.where(meta_c < 0, -1, meta_c ^ flip))
    tslot = torch.argmin(okey)
    vic = _get(cblk, tslot)
    do_ins = miss & (_get(okey, tslot) != _I32_MAX)
    evict = do_ins & (vic[MT_META] >= 0)
    vic_was_t1 = evict & (vic[MT_META] < _PROT)

    # the victim's stored probes enter B1 (from T1) or B2; a half whose
    # count reached P_MAIN_CAP is cleared first; probes sharing a word merge
    # onto the word as read before the clear (zero when cleared).  A stored
    # probe is table state: its word clamps into the leaf, as the
    # reference's dynamic slices clamp it, and the words are written in
    # probe order (a later probe's write wins where two clamp together)
    goff = torch.where(vic_was_t1, 0, dkw)
    vdkb = vic[3 + rows:3 + rows + dkp]
    vpos = goff + (vdkb >> 5)
    cpos = torch.clamp(vpos, 0, 2 * dkw - 1).long()
    vbit = torch.ones_like(vdkb) << (vdkb & 31)
    gw = ghost[cpos]
    clr1 = vic_was_t1 & (gb1count >= params[P_MAIN_CAP])
    clr2 = evict & ~vic_was_t1 & (gb2count >= params[P_MAIN_CAP])
    clr = clr1 | clr2
    half = torch.arange(2 * dkw, device=ghost.device) // dkw == goff // dkw
    ghost.copy_(torch.where(clr & half, 0, ghost))
    merged = torch.where(clr, 0, gw)
    same = vpos[:, None] == vpos[None, :]
    for j in range(dkp):
        merged = merged | torch.where(same[:, j], vbit[j], 0)
    vals = torch.where(evict, merged, gw)
    for j in range(dkp):
        _put(ghost, cpos[j], vals[j])

    meta0 = torch.where(gb1 | gb2, _PROT | t, t)   # remembered keys -> T2
    candrow = torch.cat([torch.stack([klo, khi, meta0]), kidx, kdkb])
    mb1f, mb2f = _insert(mblk1u, m2eff, tslot, candrow, do_ins, same_km)
    mtab[km1.long() * A + ways] = mb1f
    mtab[km2.long() * A + ways] = mb2f

    i32 = torch.int32
    regs[R_T] = t + 1
    regs[R_HITS] = regs[R_HITS] + (hit & (t >= params[P_WARMUP])).to(i32)
    regs[R_WQUOTA] = p_new
    regs[R_WCOUNT] = (t1count - hit_t1.to(i32) - vic_was_t1.to(i32)
                      + (do_ins & (meta0 < _PROT)).to(i32))
    regs[R_MCOUNT] = torch.where(clr1, 0, gb1count) + vic_was_t1.to(i32)
    regs[R_EHITS] = (torch.where(clr2, 0, gb2count)
                     + (evict & ~vic_was_t1).to(i32))
    return hit


def _one_access_set_lfu(spec: StepSpec, params, st: dict, klo, khi, kidx,
                        kdkb, kwset, kmset):
    """One access under the heap-free sketch LFU, in place; returns hit.

    No window; a hit refreshes the stamp (probation meta, no ``_PROT``); a
    miss always enters the key's own two sets, in place of the record with
    the smallest estimate (after this access's add; empty as -1, padding
    never), the oldest stamp among ties, set 1 before set 2 (its duplicate
    masked when the choices alias)."""
    A, rows = spec.assoc, spec.rows
    regs = st["regs"]
    t = regs[R_T].clone()
    size = _add(spec, params, st, kidx, kdkb)
    mtab = st["mtab"]
    ways = torch.arange(A, device=mtab.device)
    km1, km2 = kmset[0], kmset[1]

    mblk1, mblk2, match1, match2, same_km = _main_lookup(spec, mtab, klo,
                                                         khi, kmset)
    hit = match1.any() | match2.any()
    mblk1u = _with_meta(mblk1, match1, t)
    mblk2u = _with_meta(mblk2, match2, t)
    m2eff = torch.where(same_km, mblk1u, mblk2u)

    cblk = torch.cat([mblk1u, m2eff], dim=0)
    meta_c = cblk[:, MT_META]
    est = _estimate_block(spec, st["counters"], st["doorkeeper"],
                          cblk[:, 3:3 + rows], cblk[:, 3 + rows:])
    pad = (meta_c == _I32_MAX) | (same_km & (torch.arange(
        2 * A, device=mtab.device) >= A))
    okey1 = torch.where(pad, _I32_MAX, torch.where(meta_c < 0, -1, est))
    okey2 = torch.where(okey1 == okey1.min(), meta_c, _I32_MAX)
    tslot = torch.argmin(okey2)               # LRU among frequency ties
    do_ins = ~hit & (_get(okey1, tslot) != _I32_MAX)
    candrow = torch.cat([torch.stack([klo, khi, t]), kidx, kdkb])
    mb1f, mb2f = _insert(mblk1u, m2eff, tslot, candrow, do_ins, same_km)
    mtab[km1.long() * A + ways] = mb1f
    mtab[km2.long() * A + ways] = mb2f

    regs[R_SIZE] = size
    regs[R_T] = t + 1
    regs[R_HITS] = regs[R_HITS] + (hit & (t >= params[P_WARMUP])).to(
        torch.int32)
    return hit


# the set path's per-access body of each policy (the reference's
# _one_access dispatch)
_SET_BODIES = {"wtinylfu": _one_access_set, "s3fifo": _one_access_set_s3fifo,
               "arc": _one_access_set_arc, "lfu": _one_access_set_lfu}


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
                  probes=None, rank: int = 0):
    _check(0 <= rank < max(1, spec.mesh_devices),
           f"rank {rank} must be in [0, {max(1, spec.mesh_devices)})")
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
             probes=None, rank: int = 0):
    """Plain version: advance ``state`` (in place) through the first
    ``n_valid`` accesses of ``lo/hi``; returns (state, hit flags).

    Accesses at positions >= n_valid leave the state untouched and report
    hit 0.  ``probes`` may carry ``precompute_probes(spec, lo, hi)`` when the
    caller hashed the keys already.  Runs on any device, one tensor op at a
    time.  With ``spec.streams > 1`` it runs each lane in turn through the
    single-lane body, on that lane's views of the state.  With
    ``spec.mesh_devices`` the state is rank ``rank``'s (its delta blocks
    hold the shards ``distributed.mesh.owned_shards`` gives it).  Every
    address it reads from the tables is clamped, as the reference's are.
    """
    n = _check_inputs(spec, params, state, lo, hi, n_valid, probes, rank)
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
    st = state
    if spec.mesh_devices:           # the rank's first shard, for the add
        st = {**state, "_base": torch.tensor(
            _mesh_base(spec, rank), dtype=torch.int32, device=lo.device)}
    for i in range(n):
        if spec.assoc is None:
            hit = _one_access_flat(spec, params, st, lo[i], hi[i],
                                   kidx[i], kdkb[i])
        else:
            hit = _SET_BODIES[spec.policy](spec, params, st, lo[i],
                                           hi[i], kidx[i], kdkb[i], kwset[i],
                                           kmset[i])
        hits[i] = hit.to(torch.int32)
    return state, hits


# ---------------------------------------------------------------------------
# epoch-boundary rebalance: move the runtime window/main boundary
# ---------------------------------------------------------------------------
# Tensor ops on a leading lane axis (one lane when streams == 1), in place on
# the state's device; nothing is read back to the host.  Every sort is
# stable, as jnp.argsort is.

def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.argsort(x, dim=-1, stable=True)


def _ranks(x: torch.Tensor) -> torch.Tensor:
    """Rank of each entry along the last axis (stable: ties by index)."""
    return _argsort(_argsort(x))


def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor):
    """``dst[b, idx[b, i]] = src[b, i]`` along axis 1, in place, where an
    index equal to ``dst.shape[1]`` is dropped (jnp's ``mode="drop"``): the
    writes go to one spare slot that is then cut off.  Kept indices must be
    distinct."""
    n = dst.shape[1]
    ext = torch.cat([dst, dst[:, :1]], dim=1)
    ix = idx.long().reshape(idx.shape + (1,) * (src.dim() - 2)).expand(
        src.shape)
    ext.scatter_(1, ix, src)
    dst.copy_(ext[:, :n])


def _rebalance_flat(spec: StepSpec, total, state: dict, nq):
    regs = state["regs"]
    wlo, whi, wmeta = state["wlo"], state["whi"], state["wmeta"]
    mlo, mhi, mmeta = state["mlo"], state["mhi"], state["mmeta"]
    wcount, mcount = regs[:, R_WCOUNT], regs[:, R_MCOUNT]
    pcount = regs[:, R_PCOUNT]
    mcap_new = total - nq

    # window shrink: the LRU residents past the new quota leave; the most
    # recent of them move into main's free room (empty slots first, stamps
    # kept), the rest are dropped
    res_w = (wmeta >= 0) & (wmeta < _I32_MAX)
    n_wev = torch.clamp(wcount - nq, min=0)
    evict = res_w & (_ranks(torch.where(res_w, wmeta, _I32_MAX))
                     < n_wev[:, None])
    room = torch.clamp(mcap_new - mcount, min=0)
    dranks = _ranks(torch.where(evict, -wmeta, _I32_MAX))
    mig = evict & (dranks < room[:, None])
    free_order = _argsort((mmeta != _EMPTY).to(torch.int32))
    tgt = torch.where(mig, torch.gather(
        free_order, 1, dranks.clamp(max=spec.main_slots - 1)),
        spec.main_slots)
    for m, w in ((mlo, wlo), (mhi, whi), (mmeta, wmeta),
                 (state["midx"], state["widx"]),
                 (state["mdkb"], state["wdkb"])):
        _scatter_drop(m, tgt, w)
    wlo.copy_(torch.where(evict, -1, wlo))
    whi.copy_(torch.where(evict, -1, whi))
    wmeta.copy_(torch.where(evict, _EMPTY, wmeta))
    wcount = wcount - n_wev
    mcount = mcount + mig.sum(dim=1).to(torch.int32)

    # window grow: main's weakest past the new budget leave (only one side
    # shrinks, so this and the migration above never both act)
    res_m = (mmeta >= 0) & (mmeta < _I32_MAX)
    n_mev = torch.clamp(mcount - mcap_new, min=0)
    evict_m = res_m & (_ranks(torch.where(res_m, mmeta, _I32_MAX))
                       < n_mev[:, None])
    pcount = pcount - (evict_m & (mmeta >= _PROT)).sum(dim=1).to(torch.int32)
    mlo.copy_(torch.where(evict_m, -1, mlo))
    mhi.copy_(torch.where(evict_m, -1, mhi))
    mmeta.copy_(torch.where(evict_m, _EMPTY, mmeta))
    regs[:, R_PCOUNT] = pcount
    regs[:, R_WCOUNT] = wcount
    regs[:, R_MCOUNT] = mcount - n_mev


def _compact(tab, n_sets: int, A: int, meta_col: int, usable):
    """Per set: records strongest first (stable sort on -meta), the first
    ``usable`` kept and the rest blanked.  Returns (new (B, sets, A, cols),
    sorted (B, sets, A, cols), the evicted residents (B, sets, A))."""
    B, _, ncols = tab.shape
    t3 = tab.reshape(B, n_sets, A, ncols)
    order = _argsort(-t3[..., meta_col])
    t3s = torch.gather(t3, 2, order[..., None].expand(t3.shape))
    keep = torch.arange(A, device=tab.device) < usable[..., None]
    metas = t3s[..., meta_col]
    evict = (metas >= 0) & (metas < _I32_MAX) & ~keep
    # an empty record: lo = hi = -1, meta _EMPTY, the rest 0 (made by tensor
    # ops: a Python scalar stored into one element waits for the card)
    cols = torch.arange(ncols, device=tab.device)
    blank = torch.where(cols == meta_col, _EMPTY,
                        torch.where(cols < 2, -1, 0)).to(tab.dtype)
    return torch.where(keep[..., None], t3s, blank), t3s, evict


def _spread(cap, n: int):
    """(B, n) ways per set of ``cap`` (B,) over n sets: the first cap % n
    sets one more (``core.hashing.set_ways``)."""
    s = torch.arange(n, device=cap.device, dtype=torch.int32)
    return (_floordiv(cap, n)[:, None]
            + (s < torch.remainder(cap, n)[:, None]).to(torch.int32))


def _rebalance_set(spec: StepSpec, total, state: dict, nq, exact: bool):
    A, nws, nms = spec.assoc, spec.window_sets, spec.main_sets
    wtab, mtab = state["wtab"], state["mtab"]
    B = wtab.shape[0]
    mcap_new = total - nq

    # window ways (core.adaptive.window_set_ways): uniform while nq >= nws,
    # else one way to each of the nq sets with the most traffic (wsl)
    load = state["wsl"]
    rank = torch.empty_like(load).scatter_(
        1, _argsort(-load), torch.arange(nws, dtype=load.dtype,
                                         device=load.device).expand(B, nws))
    uw = torch.where((nq < nws)[:, None], (rank < nq[:, None]).to(
        torch.int32), _spread(nq, nws))
    um = _spread(mcap_new, nms)
    w3n, w3s, w_evict = _compact(wtab, nws, A, WT_META, uw)
    m3n, _, _ = _compact(mtab, nms, A, MT_META, um)

    # the evicted window records move, in set-then-way order, into the
    # first free way below u(s) of the block of their stored first-choice
    # main set s: the block at s * A clamped into the table (_block_start;
    # a stored set is table state, which a fault may put out of range), u
    # the usable ways of s itself, base + (s < rem).  After compaction a
    # set's free ways are [r, A) (r its kept residents) and u takes one of
    # two values, base or base + 1, so with V = base - r the migrants of
    # one block that land are its first V and then the first later one
    # whose u is base + 1; the i-th of them lands in way r + i.  A stable
    # sort by block, ranks within each run of one block, one scatter.  That
    # needs every block to be one set's; with ``exact`` (a stored set out of
    # range, whose block may start inside a set) the migrants go one at a
    # time instead (_migrate_exact).
    recs = w3s.reshape(B, -1, spec.wcols)
    mnew = m3n.reshape(B, -1, spec.mcols)
    migrate = _migrate_exact if exact else _migrate_ranked
    migrate(spec, mcap_new, recs, w_evict.reshape(B, -1), mnew)
    wtab.copy_(w3n.reshape(wtab.shape))
    mtab.copy_(mnew)
    state["wsl"].zero_()
    state["wuw"].copy_(uw)


def _migrate_ranked(spec: StepSpec, mcap_new, recs, evicted, mnew):
    """The closed-form migration (see :func:`_rebalance_set`) of the
    evicted window records ``recs`` (B, window_slots, wcols) into the
    compacted main table ``mnew`` (B, main_slots, mcols), in place."""
    A, nms = spec.assoc, spec.main_sets
    meta = mnew[..., MT_META].reshape(mnew.shape[0], nms, A)
    kept = ((meta >= 0) & (meta < _I32_MAX)).sum(dim=2).to(torch.int32)
    raw = recs[..., WT_MSET]
    tset = torch.where(evicted, _block_start(raw, A, spec.main_slots) // A,
                       nms)
    order = _argsort(tset)
    st_ = torch.gather(tset, 1, order)
    s_raw = torch.gather(raw, 1, order)
    pos = torch.arange(st_.shape[1], device=st_.device).expand_as(st_)
    start = torch.ones_like(st_, dtype=torch.bool)
    start[:, 1:] = st_[:, 1:] != st_[:, :-1]
    k = pos - torch.cummax(torch.where(start, pos, 0), dim=1).values
    sc = st_.clamp(max=nms - 1).long()
    r = torch.gather(kept, 1, sc)
    base = _floordiv(mcap_new, nms)[:, None]
    u = base + (s_raw < torch.remainder(mcap_new, nms)[:, None]).to(
        torch.int32)
    V = base - r
    first = k < V
    late = (st_ < nms) & (V >= 0) & (k >= V) & (u - r == V + 1)
    cs = torch.cumsum(late.to(torch.int32), dim=1)
    before = torch.cummax(torch.where(start, cs - late.to(torch.int32), 0),
                          dim=1).values
    ok = (st_ < nms) & (first | (late & (cs - before == 1)))
    dest = torch.where(ok, st_ * A + r + torch.where(first, k, V), nms * A)
    src = torch.gather(recs, 1, order[..., None].expand_as(recs))
    mainrow = torch.cat([src[..., :WT_META + 1], src[..., WT_MSET2 + 1:]],
                        dim=-1)
    _scatter_drop(mnew, dest, mainrow)


def _migrate_exact(spec: StepSpec, mcap_new, recs, evicted, mnew):
    """The reference's migration loop, for tables that hold a stored main
    set out of range: the evicted window records ``recs`` move one at a
    time, in set-then-way order, each into the first free way below u(s)
    of the A-row block at ``_block_start(s)`` (s its stored set as it is,
    u = base + (s < rem)), and each block is written back whole, so a
    later block overwrites an earlier one where two overlap.  It reads the
    tables back to the host and writes ``mnew`` once."""
    A, nms = spec.assoc, spec.main_sets
    way = np.arange(A)
    caps = mcap_new.cpu().tolist()
    recs_h, ev_h = recs.cpu().numpy(), evicted.cpu().numpy()
    out = mnew.cpu().numpy().copy()
    starts = _block_start(recs[..., WT_MSET], A, spec.main_slots).cpu()
    for b, cap in enumerate(caps):
        base, rem = cap // nms, cap % nms
        for i in np.flatnonzero(ev_h[b]):
            rec, start = recs_h[b, i], int(starts[b, i])
            blk = out[b, start:start + A]
            free = ((blk[:, MT_META] == _EMPTY)
                    & (way < base + (int(rec[WT_MSET]) < rem)))
            if free.any():
                blk[int(np.argmax(free))] = np.concatenate(
                    [rec[:WT_META + 1], rec[WT_MSET2 + 1:]])
    mnew.copy_(torch.from_numpy(out))


def rebalance(spec: StepSpec, params: torch.Tensor, state: dict,
              new_quota) -> dict:
    """Move the runtime window/main boundary to ``new_quota`` (adaptive
    mode), in place; returns ``state``.

    The quota is clamped to ``[max(1, total - main_slots), min(window_slots,
    total - 1)]`` (total = window_cap + main_cap).  Flat tables: the
    window's LRU residents past the quota leave, the most recent of them
    moving into main's free room (probation, stamps kept); on a grow main's
    weakest past its new capacity leave.  Set tables: each set is compacted
    strongest-first to its new usable ways (the window's by
    ``window_set_ways`` over last epoch's ``wsl``), the window's evicted
    records move into free usable ways of their first-choice main set, and
    ``wsl`` restarts at 0.  ``R_WQUOTA`` takes the quota and ``R_EHITS``
    restarts at 0.  With lanes (``streams > 1``) every lane rebalances to
    its own quota (``new_quota`` of shape (B,)) with its own params row.
    Tensor ops on the state's device; nothing is read back to the host
    while the tables are marked in range (:func:`_needs_exact`).  A state
    whose tables hold a stored main set out of range (a fault's) migrates
    its window records one at a time on the host, as the reference's loop
    does, and is written back.
    """
    _check(spec.adaptive, "rebalance requires StepSpec.adaptive")
    exact = _needs_exact(spec, state)
    lanes = spec.streams > 1
    st = state if lanes else {k: v.unsqueeze(0) for k, v in state.items()}
    dev = st["regs"].device
    p = params.reshape(-1, NPARAMS)
    total = p[:, P_WINDOW_CAP] + p[:, P_MAIN_CAP]
    nq = torch.as_tensor(new_quota, dtype=torch.int32, device=dev)
    nq = nq.reshape(-1).expand(st["regs"].shape[0])
    nq = torch.minimum(torch.maximum(nq, torch.clamp(
        total - spec.main_slots, min=1)), torch.clamp(total - 1,
                                                      max=spec.window_slots))
    if spec.assoc is None:
        _rebalance_flat(spec, total, st, nq)
    else:
        _rebalance_set(spec, total, st, nq, exact)
    st["regs"][:, R_WQUOTA] = nq
    st["regs"][:, R_EHITS] = 0
    if not exact:                   # it moves records only
        _mark_in_range(spec, state)
    return state


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper (replaces step_pallas)
# ---------------------------------------------------------------------------

_THREADS = 256


class _Args(ctypes.Structure):
    """Mirror of ``StepArgs`` in csrc/sketch_step.cu (pointers, then ints,
    then the policy panel's two fields, then the stale mesh step's)."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "lo", "hi", "kidx", "kdkb", "kwset", "kmset", "params", "counters",
        "dk", "wlo", "whi", "wmeta", "widx", "wdkb", "mlo", "mhi", "mmeta",
        "midx", "mdkb", "wtab", "mtab", "regs", "hits", "nvalid", "wsl",
        "wuw")] + [
        (name, ctypes.c_int) for name in (
            "n_valid", "b", "rows", "dkp", "dk_bits", "counter_bits",
            "words_per_row", "counter_words", "dk_words", "window_slots",
            "main_slots", "assoc", "wcols", "mcols", "lanes",
            "params_stride", "halves", "adaptive", "policy")] + [
        ("ghost", ctypes.c_void_p), ("dcounters", ctypes.c_void_p),
        ("ddk", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in (
            "mesh", "mesh_base", "local_shards", "width_shard",
            "dk_bits_shard", "wps_shard", "dkw_shard", "exact")]

# the adaptive instances (kernel mode 1c) and the competitor policies'
# (mode 1d) are a second and a third build of the same source, compiled in
# parallel with the first
ADAPTIVE_DEFINES = ("SKETCH_STEP_ADAPTIVE",)
PANEL_DEFINES = ("SKETCH_STEP_PANEL",)


def _defines(spec: StepSpec) -> tuple[str, ...]:
    """The ``-D`` defines of the build that holds ``spec``'s instances."""
    if spec.policy != "wtinylfu":
        return PANEL_DEFINES
    return ADAPTIVE_DEFINES if spec.adaptive else ()


def _launch(spec: StepSpec, params: torch.Tensor, state: dict, lo, hi,
            probes, n_valid, hits: torch.Tensor, lib=None,
            lane_grid: bool | None = None, rank: int = 0,
            exact: bool = False):
    """One kernel launch over one chunk: state updated in place, hit flags
    written to ``hits`` (zeros past n_valid).  No host sync.  ``lib`` is the
    loaded kernel library (default: the build of ``csrc/sketch_step.cu``).

    ``lane_grid`` (default: ``spec.streams > 1``) launches the lane kernel,
    one CTA per lane of ``(B, b)`` keys, lane-axis state, shared or per-lane
    params; ``n_valid`` is then an int or a (B,) int32 CUDA tensor.  With
    ``lane_grid=True`` and unbatched inputs it runs one lane, the same work
    as the single-stream launch.  ``spec.shards > 1`` launches the sharded
    instances (``[global || delta]`` sketch, no per-access reset);
    ``spec.adaptive`` the adaptive ones (runtime quota registers, per-set
    usable ways, ``wsl``), from the ``ADAPTIVE_DEFINES`` build; a
    competitor ``spec.policy`` the panel's (ARC's ``ghost`` Blooms too),
    from the ``PANEL_DEFINES`` build.  ``spec.mesh_devices`` launches the
    stale mesh instances (mode 1e) for mesh rank ``rank``.  More than 8
    doorkeeper probes or 128 ways launch the wide instances of the build
    (records read from memory, the set path's accesses by one thread), and
    so does ``exact``: the tables hold addresses out of range (see
    :func:`_needs_exact`), which only those instances take as the
    reference does."""
    from ._build import check_error, load_library
    ptr = _arg_ptrs(spec, params, state, lo, hi, probes, n_valid, hits)
    for k, v in ptr.items():
        _check(v.is_cuda and v.dtype == torch.int32 and v.is_contiguous(),
               f"kernel operand {k!r} must be a contiguous int32 CUDA tensor")
    args = _Args(**{k: v.data_ptr() for k, v in ptr.items()},
                 **_arg_ints(spec, params, lo, n_valid, lane_grid, rank,
                             exact))
    lib = lib or load_library("sketch_step", _defines(spec))
    stream = torch.cuda.current_stream(lo.device).cuda_stream
    check_error("sketch_step", lib, lib.sketch_step_launch(
        ctypes.addressof(args), _THREADS, stream))
    step.launches += 1


def _arg_ptrs(spec: StepSpec, params: torch.Tensor, state: dict, lo, hi,
              probes, n_valid, hits: torch.Tensor) -> dict:
    """The tensors whose addresses fill the pointer fields of ``StepArgs``
    for one launch, by field name."""
    kidx, kdkb, kwset, kmset = probes
    ptr = {"lo": lo, "hi": hi, "kidx": kidx, "kdkb": kdkb, "kwset": kwset,
           "kmset": kmset, "params": params, "counters": state["counters"],
           "dk": state["doorkeeper"], "regs": state["regs"], "hits": hits}
    for k in ("wlo", "whi", "wmeta", "widx", "wdkb", "mlo", "mhi", "mmeta",
              "midx", "mdkb", "wtab", "mtab", "wsl", "wuw", "ghost",
              "dcounters"):
        if k in state:
            ptr[k] = state[k]
    if spec.mesh_devices:
        ptr["ddk"] = state["ddoorkeeper"]
    if isinstance(n_valid, torch.Tensor):
        ptr["nvalid"] = n_valid
    return ptr


def _arg_ints(spec: StepSpec, params: torch.Tensor, lo, n_valid,
              lane_grid: bool | None = None, rank: int = 0,
              exact: bool = False) -> dict:
    """The non-pointer fields of ``StepArgs`` for one launch: the instance
    the kernel runs.  Plain values, from shapes and ``spec``, so they come
    out the same for tensors on any device.  ``n_valid`` is an int, or per
    lane a tensor or list (the kernel then reads its ``nvalid`` operand)."""
    _check(spec.rows <= _MAX_ROWS,
           f"the kernel takes rows <= {_MAX_ROWS}, not {spec.rows}")
    if lane_grid is None:
        lane_grid = spec.streams > 1
    per_lane = isinstance(n_valid, (torch.Tensor, list, tuple))
    _check(lane_grid or not per_lane,
           "a per-lane n_valid needs the lane grid")
    lanes = lo.shape[0] if lo.dim() == 2 else 1
    return dict(n_valid=0 if per_lane else int(n_valid), b=lo.shape[-1],
                rows=spec.rows, dkp=spec.dkp, dk_bits=spec.dk_bits,
                counter_bits=spec.counter_bits,
                words_per_row=spec.words_per_row,
                counter_words=spec.counter_words, dk_words=spec.dk_words,
                window_slots=spec.window_slots, main_slots=spec.main_slots,
                assoc=spec.assoc or 0,
                wcols=spec.wcols if spec.assoc else 0,
                mcols=spec.mcols if spec.assoc else 0,
                lanes=lanes if lane_grid else 0,
                params_stride=NPARAMS if params.dim() == 2 else 0,
                halves=1 if spec.mesh_devices else spec.sketch_halves,
                adaptive=int(spec.adaptive),
                policy=POLICIES.index(spec.policy),
                mesh=int(spec.mesh_devices > 0),
                mesh_base=_mesh_base(spec, rank) if spec.mesh_devices
                else 0,
                local_shards=spec.local_shards,
                width_shard=spec.width_shard,
                dk_bits_shard=spec.dk_bits_shard,
                wps_shard=spec.wps_shard, dkw_shard=spec.dkw_shard,
                exact=int(exact))


def step(spec: StepSpec, params: torch.Tensor, state: dict,
         lo: torch.Tensor, hi: torch.Tensor, n_valid=None, probes=None,
         rank: int = 0):
    """Fused chunk step; same contract as :func:`step_ref`.

    CUDA tensors: one launch of the hand-written kernel for all lanes, state
    updated in place (the analogue of the reference's donated buffers); a
    failed build or launch raises.  Tables that hold addresses out of range
    (only a fault's state does: the kernel writes none) take the exact
    instances, which clamp them as the reference does; :func:`_needs_exact`
    finds them.  CPU tensors: the plain version, which clamps every
    address.  While a program is recorded (``analysis.program_trace``) the
    call is one ``launch`` event carrying the instance (:func:`_arg_ints`),
    on either device.
    """
    n = _check_inputs(spec, params, state, lo, hi, n_valid, probes, rank)
    if lo.device.type not in ("cpu", "cuda"):
        raise ValueError(f"step runs on CUDA or CPU tensors, not "
                         f"{lo.device.type}")
    exact = _needs_exact(spec, state)
    if isinstance(n, list) and len(set(n)) == 1:
        n = n[0]                    # per-lane counts that agree: one int
    rec = program_trace.active
    if rec is None:
        return _step_on_device(spec, params, state, lo, hi, n, probes, rank,
                               exact)
    instance = {"defines": _defines(spec),
                **_arg_ints(spec, params, lo, n, rank=rank, exact=exact)}
    with rec.launch("sketch_step", instance):
        return _step_on_device(spec, params, state, lo, hi, n, probes, rank,
                               exact)


def _step_on_device(spec: StepSpec, params, state: dict, lo, hi, n, probes,
                    rank: int, exact: bool):
    """:func:`step`'s launch on CUDA tensors, its plain version on CPU
    tensors.  The plain version, like the kernel, writes only addresses in
    range, so a state marked in range stays marked (see
    :func:`_needs_exact`)."""
    if lo.device.type == "cpu":
        state, hits = step_ref(spec, params, state, lo, hi, n, probes, rank)
        if not exact:
            _mark_in_range(spec, state)
        return state, hits
    lo = lo.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    params = params.to(torch.int32).contiguous()
    hits = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
    if probes is None:
        probes = precompute_probes(spec, lo, hi)
    if isinstance(n, list):         # per-lane counts: one int per lane
        n = torch.tensor(n, dtype=torch.int32).to(lo.device)
    _launch(spec, params, state, lo, hi, probes, n, hits, rank=rank,
            exact=exact)
    return state, hits


def _mesh_base(spec: StepSpec, rank: int) -> int:
    """The first shard whose delta blocks mesh rank ``rank`` holds."""
    from repro_torch.distributed.mesh import owned_shards
    return owned_shards(spec.shards, spec.mesh_devices, rank).start


def _address_table(spec: StepSpec):
    """(leaf, columns, limit) of the table words the step takes as
    addresses: a window record's stored main sets, ``[0, main_sets)``
    (W-TinyLFU, S3-FIFO), or under ARC a main record's stored doorkeeper
    bits, ``[0, 32 dk_words)`` (its ghost positions); None where the tables
    hold no address (the flat tables, LFU)."""
    if spec.assoc is None:
        return None
    if spec.policy in ("wtinylfu", "s3fifo"):
        return "wtab", slice(WT_MSET, WT_MSET2 + 1), spec.main_sets
    if spec.policy == "arc":
        c0 = 3 + spec.rows
        return "mtab", slice(c0, c0 + spec.dkp), 32 * spec.dk_words
    return None


def tables_out_of_range(spec: StepSpec, state: dict) -> bool:
    """Whether ``state`` (tensors or numpy) holds table words that the step
    takes as addresses out of range (see :func:`_address_table`).  The
    kernel writes none, so only a fault's state (a hook's, a restored
    checkpoint's) can.  A device tensor's answer is read to the host."""
    at = _address_table(spec)
    if at is None:
        return False
    key, cols, lim = at
    w = state[key][..., cols]
    if not isinstance(w, torch.Tensor):
        w = np.asarray(w)
    return bool(((w < 0) | (w >= lim)).any())


def _version(t: torch.Tensor):
    """``t``'s version counter (torch's in-place writes advance it, the
    kernel's do not); None for an inference tensor, which keeps none."""
    return None if t.is_inference() else t._version


def _in_range_marked(spec: StepSpec, state: dict) -> bool:
    """Whether ``state``'s address table was found in range at its current
    version (see :func:`_needs_exact`)."""
    at = _address_table(spec)
    if at is None:
        return True
    t = state[at[0]]
    v = _version(t)
    return v is not None and getattr(t, "_in_range_at", None) == v


def _mark_in_range(spec: StepSpec, state: dict):
    """Record that ``state``'s address table is in range at its current
    version."""
    at = _address_table(spec)
    if at is not None:
        t = state[at[0]]
        t._in_range_at = _version(t)


def _needs_exact(spec: StepSpec, state: dict) -> bool:
    """Whether a launch on ``state`` must take the exact instances: its
    tables hold an address out of range (:func:`tables_out_of_range`).  A
    table found in range is marked with its version counter; the kernel
    writes only addresses in range and does not advance the counter, and
    the engine's own in-place writes (``rebalance``) keep the mark, so a
    run reads the table once, or not at all when its state came from
    :func:`init_step_state` or :func:`state_from_numpy`.  A torch write
    into the table, a fault's, makes the next launch read it again, and
    while it holds an address out of range every launch does."""
    if _in_range_marked(spec, state):
        return False
    if tables_out_of_range(spec, state):
        return True
    _mark_in_range(spec, state)
    return False


step.launches = 0       # kernel launches since the last reset to 0

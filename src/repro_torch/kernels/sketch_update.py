"""Sequential conservative-update adds: plain PyTorch version and CUDA
wrapper.

Counterpart of ``repro/kernels/sketch_update.py`` (``add_pallas``) and of
``add_ref`` in ``repro/kernels/ref.py``.  The paper's Add is
order-dependent: later keys of a batch see the increments of earlier ones.
Per key, in order: the doorkeeper test-and-set (each probe reads its word
after the key's earlier probes set their bits), then, iff the key was
present (or there is no doorkeeper), +1 on every row whose counter equals
the minimum, when that minimum is below ``cap``.  ``size`` grows by the
number of keys added.  No reset here: ``ops.add`` composes it.

``add_ref`` is the plain version, a Python loop over the keys written with
tensor ops that run on any device.  ``add`` is the wrapper replacing
``add_pallas``: on CUDA tensors it launches the hand-written kernel in
``csrc/sketch_update.cu`` (an exact parallel batch update: doorkeeper gates
from first touches, components of keys sharing a counter nibble, a walk per
component); on CPU tensors it runs ``add_ref``.  Both update the state
in place (the analogue of the reference's aliased buffers) and return it.
There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from .sketch_common import (DeviceSketchConfig, _check, check_sketch_inputs,
                            key_probes)


def add_one(counters: torch.Tensor, dk: torch.Tensor, kidx: torch.Tensor,
            kdkb: torch.Tensor, *, words_per_row: int, counter_bits: int,
            cap, dk_bits: int) -> None:
    """One key's doorkeeper gate and conservative increment, in place on
    the flat ``counters`` and ``dk`` words, from its (rows,) counter probes
    and (dk_probes,) doorkeeper bits.

    Every read uses the words gathered before any write: a later doorkeeper
    probe of the key sees an earlier probe's bit through the pairwise
    comparison, and probes sharing a word write one merged value.  Rows are
    distinct words, so the counter reads need no such care.
    """
    if dk_bits:
        w_idx = (kdkb >> 5).long()
        bpos = kdkb & 31
        words = dk[w_idx]                              # (dkp,) one gather
        pre = (words >> bpos) & 1
        earlier = torch.tril(kdkb[:, None] == kdkb[None, :], diagonal=-1)
        gate = ((pre == 1) | earlier.any(dim=1)).all()
        bitm = torch.ones_like(bpos) << bpos
        same = w_idx[:, None] == w_idx[None, :]
        merged = words.clone()
        for j in range(kdkb.shape[0]):
            merged = merged | torch.where(same[:, j], bitm[j], 0)
        dk[w_idx] = merged                 # duplicate words carry one value
    else:
        gate = torch.ones((), dtype=torch.bool, device=counters.device)

    rows = torch.arange(kidx.shape[0], device=counters.device)
    flat = (rows * words_per_row
            + (kidx >> (3 if counter_bits == 4 else 2))).long()
    words = counters[flat]
    sub = (kidx & (32 // counter_bits - 1)) * counter_bits
    vals = (words >> sub) & ((1 << counter_bits) - 1)
    m = vals.min()
    bump = gate & (m < cap)
    inc = torch.ones_like(sub) << sub
    counters[flat] = torch.where(bump & (vals == m), words + inc, words)


def add_ref(cfg: DeviceSketchConfig, state: dict, lo: torch.Tensor,
            hi: torch.Tensor) -> dict:
    """Plain version: add the keys of ``lo/hi`` in order, in place;
    ``size += B``.  Runs on any device, one tensor op at a time."""
    check_sketch_inputs(cfg, state, lo, hi)
    idx, dkb = key_probes(lo, hi, cfg.rows, cfg.width, cfg.dk_bits,
                          cfg.dk_probes)
    counters = state["counters"].view(-1)
    dk = state["doorkeeper"].view(-1)
    for i in range(lo.shape[0]):
        add_one(counters, dk, idx[i], dkb[i], words_per_row=cfg.words_per_row,
                counter_bits=4, cap=cfg.cap, dk_bits=cfg.dk_bits)
    state["size"] = state["size"] + lo.shape[0]
    return state


# Doorkeeper probes a key that the kernel takes: 0-8 in registers, more in
# its loop instance, whose tile shrinks with the probe count (896 keys at 9
# probes, 384 at 20, 32 at 256; csrc/sketch_update.cu).
MAX_DK_PROBES = 256


def _launch(cfg: DeviceSketchConfig, state: dict, lo: torch.Tensor,
            hi: torch.Tensor, lib=None) -> None:
    """One launch of ``csrc/sketch_update.cu`` on the current stream: the
    batch added in place by the parallel batch update.  No host sync.
    ``lib`` is the loaded kernel library (default: the build of
    ``csrc/sketch_update.cu``)."""
    from ._build import launch
    _check(not cfg.dk_bits or cfg.dk_probes <= MAX_DK_PROBES,
           f"the add kernel takes dk_probes <= {MAX_DK_PROBES}, not "
           f"{cfg.dk_probes}: past that not even a 32-key tile's doorkeeper "
           "table fits in shared memory")
    _check(1 <= cfg.rows <= 8 and cfg.rows * cfg.width < 2 ** 32,
           "the kernel takes 1 <= rows <= 8 and rows * width < 2^32")
    launch("sketch_update", "sketch_update_launch",
           state["counters"], state["doorkeeper"], lo, hi, lo.shape[0],
           cfg.rows, cfg.width, cfg.cap, cfg.dk_bits, cfg.dk_probes, lib=lib)
    add.launches += 1


def add(cfg: DeviceSketchConfig, state: dict, lo: torch.Tensor,
        hi: torch.Tensor) -> dict:
    """Sequential batch add; same contract as :func:`add_ref`.  CUDA
    tensors: one kernel launch (a failed build or launch raises); CPU
    tensors: the plain version."""
    dev = check_sketch_inputs(cfg, state, lo, hi)
    if dev.type == "cpu":
        return add_ref(cfg, state, lo, hi)
    if lo.shape[0]:
        _launch(cfg, state, lo, hi)
    state["size"] = state["size"] + lo.shape[0]
    return state


add.launches = 0        # kernel launches since the last reset to 0

"""Epoch-boundary fold of the sharded frequency sketch (``StepSpec.shards``).

Counterpart of ``repro/kernels/sketch_merge.py`` (``shard_checksums`` and
``merge_halve``).  With ``shards > 1`` the ``counters`` and ``doorkeeper``
leaves hold ``[global || delta]`` halves: the step writes only the delta
half and reads global plus delta.  Between merge epochs :func:`merge_halve`

1. (with ``integrity``) verifies each shard's global slices against the
   checksums stored at the previous fold, and zeroes the global and delta
   slices of a shard that does not match;
2. merges the delta into the global half (a per-field saturating add) and
   ORs the doorkeeper halves;
3. applies the §3.3 halvings the epoch owes, ``k`` of them: the reference
   halves ``size`` in a loop while ``size >= W``, which is ``k = (size //
   W).bit_length()`` (0 when W = 0) and leaves ``size >> k``; k halvings of
   a packed field shift it right by k.  The doorkeeper is cleared when k > 0;
4. zeroes the delta halves and (with ``integrity``) refreshes the checksums
   and counts the shards it zeroed in ``csum[S]``.

The fold is tensor ops on the state's device, in place: ``k`` is computed on
the card, so nothing is read back to the host.  With ``streams=B`` every
leaf has a lane axis and each lane folds with its own ``size`` and params
row.  ``merge_halve.folds`` counts the folds.

:func:`merge_halve_mesh` is the fold of the stale mesh run
(``StepSpec.mesh_devices``): every rank gathers the others' delta blocks over
the mesh's process group (the one collective of that mode, on the card under
NCCL), reorders them into the delta-half layout and applies the same fold, so
each rank ends the epoch with the same global halves and zeroed deltas.
"""
from __future__ import annotations

import torch

from .sketch_common import _check, _i32, _u32, checksum_words, merge_words
from dataclasses import replace

from .sketch_step import P_SAMPLE, R_SIZE, StepSpec


def shard_checksums(spec: StepSpec, counters_global: torch.Tensor,
                    dk_global: torch.Tensor) -> torch.Tensor:
    """(..., shards) int32 checksums over each shard's global slices: its
    words ``r * words_per_row + s * wps_shard + w`` of the counters, then
    (with a doorkeeper) its ``dkw_shard`` doorkeeper words."""
    S = spec.shards
    lead = counters_global.shape[:-1]
    c = counters_global.reshape(lead + (spec.rows, S, spec.wps_shard))
    per_shard = c.movedim(-2, -3).reshape(lead + (S, -1))
    if spec.dk_bits:
        d = dk_global.reshape(lead + (S, spec.dkw_shard))
        per_shard = torch.cat([per_shard, d], dim=-1)
    return checksum_words(per_shard)


def _halvings(size: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """Number of §3.3 halvings owed: ``(size // W).bit_length()`` for W > 0,
    else 0 (int64, size's shape)."""
    q = torch.where(sample > 0,
                    torch.div(size, sample.clamp(min=1),
                              rounding_mode="floor"), 0).long()
    pow2 = torch.ones(31, dtype=torch.int64, device=q.device) << torch.arange(
        31, device=q.device)
    return (q.unsqueeze(-1) >= pow2).sum(dim=-1)


def _shift_fields(words: torch.Tensor, k: torch.Tensor,
                  counter_bits: int) -> torch.Tensor:
    """Every packed field shifted right by k (k passes of ``halve_words``;
    0 once k reaches the field width)."""
    rep = 0x11111111 if counter_bits == 4 else 0x01010101
    k = k.clamp(max=counter_bits)
    mask = (((1 << counter_bits) - 1) >> k) * rep
    return _i32((_u32(words) >> k) & mask)


def merge_halve(spec: StepSpec, params: torch.Tensor, state: dict) -> dict:
    """Fold the deltas into the global halves and apply the deferred §3.3
    aging, in place; returns ``state``.  ``params`` is ``(NPARAMS,)`` or,
    with lanes, ``(B, NPARAMS)``."""
    _check(spec.shards > 1, "merge_halve requires StepSpec.shards > 1")
    H, HD = spec.counter_words, spec.dk_words
    counters, dk, regs = state["counters"], state["doorkeeper"], state["regs"]
    lead = counters.shape[:-1]
    gc, dc = counters[..., :H], counters[..., H:]
    gdk, ddk = dk[..., :HD], dk[..., HD:]
    if spec.integrity:
        S = spec.shards
        ok = shard_checksums(spec, gc, gdk) == state["csum"][..., :S]

        def keep(x, shape, mask):
            return torch.where(mask, x.reshape(lead + shape), 0).reshape(
                x.shape)

        okc = ok[..., None, :, None]
        rsw = (spec.rows, S, spec.wps_shard)
        gc, dc = keep(gc, rsw, okc), keep(dc, rsw, okc)
        if spec.dk_bits:
            okd = ok[..., :, None]
            sw = (S, spec.dkw_shard)
            gdk, ddk = keep(gdk, sw, okd), keep(ddk, sw, okd)

    g = merge_words(gc, dc, spec.counter_bits)
    d = gdk | ddk
    size = regs[..., R_SIZE]
    k = _halvings(size, params[..., P_SAMPLE])
    g = _shift_fields(g, k.unsqueeze(-1), spec.counter_bits)
    d = torch.where(k.unsqueeze(-1) > 0, 0, d)
    regs[..., R_SIZE] = (size.long() >> k).to(torch.int32)
    counters[..., :H] = g
    counters[..., H:] = 0
    dk[..., :HD] = d
    dk[..., HD:] = 0
    if spec.integrity:
        csum = state["csum"]
        csum[..., S] += (~ok).sum(dim=-1).to(torch.int32)
        csum[..., :S] = shard_checksums(spec, g, d)
    merge_halve.folds += 1
    return state


merge_halve.folds = 0   # folds since the last reset to 0 (no kernel of its own)


def merge_halve_mesh(spec: StepSpec, params: torch.Tensor, state: dict,
                     mesh) -> dict:
    """The stale mesh run's epoch fold, in place on this rank's state;
    returns ``state``.

    ``mesh`` is this rank's ``distributed.mesh.ShardMesh``.  The delta
    blocks ``(L, rows, wps_shard)`` and ``(L, dkw_shard)`` of every rank are
    gathered in rank order into ``(S, ...)`` (shard-major), reordered into
    the delta half's layout (word ``r * words_per_row + s * wps_shard +
    w``), and :func:`merge_halve` folds ``[global || delta]``; the global
    halves take the result and the delta blocks are zeroed."""
    _check(spec.mesh_devices > 0,
           "merge_halve_mesh requires StepSpec.mesh_devices")
    H, HD = spec.counter_words, spec.dk_words
    cd = mesh.all_gather(state["dcounters"])            # (S, rows, wps)
    delta = cd.transpose(0, 1).reshape(H)
    if spec.dk_bits:
        ddk = mesh.all_gather(state["ddoorkeeper"]).reshape(HD)
    else:
        ddk = torch.zeros_like(state["doorkeeper"])
    flat = {**{k: v for k, v in state.items()
               if k not in ("dcounters", "ddoorkeeper")},
            "counters": torch.cat([state["counters"], delta]),
            "doorkeeper": torch.cat([state["doorkeeper"], ddk])}
    merge_halve(replace(spec, mesh_devices=0), params, flat)
    state["counters"].copy_(flat["counters"][:H])
    state["doorkeeper"].copy_(flat["doorkeeper"][:HD])
    state["dcounters"].zero_()
    state["ddoorkeeper"].zero_()
    return state

"""Fused batched admission verdicts (paper Fig. 1): plain PyTorch version
and CUDA wrapper.

Counterpart of ``repro/kernels/admission.py`` (``admit_pallas``) and of
``admission_ref`` in ``repro/kernels/ref.py``: for each pair ``i``, admit
candidate ``i`` over victim ``i`` iff its estimate is strictly greater.

``admission_ref`` is the plain version (two plain estimates, any device);
``admit`` launches ``csrc/admission.cu`` on CUDA tensors (a warp per pair,
one probe per lane, up to ``WARP_MAX_PAIRS`` pairs; a thread per pair above;
any number of doorkeeper probes) and runs ``admission_ref`` on CPU tensors,
with no fallback between them.
"""
from __future__ import annotations

import torch

from .sketch_common import DeviceSketchConfig, check_sketch_inputs
from .sketch_estimate import estimate_ref


def admission_ref(cfg: DeviceSketchConfig, state: dict, cand_lo, cand_hi,
                  victim_lo, victim_hi) -> torch.Tensor:
    """(B,) bool: admit candidate i over victim i (strictly greater).  The
    candidates and victims are estimated in one plain pass."""
    b = cand_lo.shape[0]
    est = estimate_ref(cfg, state, torch.cat([cand_lo, victim_lo]),
                       torch.cat([cand_hi, victim_hi]))
    return est[:b] > est[b:]


# Batches of at most this many pairs take the kernel's warp-per-pair path,
# larger ones its thread-per-pair path (the crossover measured on the card:
# chip_smoke.py phase 10, PERF.md).
WARP_MAX_PAIRS = 8192


def _launch(cfg: DeviceSketchConfig, state: dict, cand_lo, cand_hi,
            victim_lo, victim_hi, out: torch.Tensor,
            per_thread: bool | None = None) -> None:
    """One launch of ``csrc/admission.cu``: ``out`` (B,) bool gets the
    verdicts, a thread per pair if ``per_thread`` (default: more than
    ``WARP_MAX_PAIRS`` pairs), else a warp per pair.  No host sync."""
    from ._build import launch
    if per_thread is None:
        per_thread = cand_lo.shape[0] > WARP_MAX_PAIRS
    launch("admission", "admission_launch", state["counters"],
           state["doorkeeper"], cand_lo, cand_hi, victim_lo, victim_hi, out,
           cand_lo.shape[0], cfg.rows, cfg.width, cfg.dk_bits, cfg.dk_probes,
           int(per_thread))
    admit.launches += 1


def admit(cfg: DeviceSketchConfig, state: dict, cand_lo, cand_hi, victim_lo,
          victim_hi) -> torch.Tensor:
    """Batched admission; same contract as :func:`admission_ref`.  CUDA
    tensors: one kernel launch; CPU tensors: the plain version."""
    dev = check_sketch_inputs(cfg, state, cand_lo, cand_hi, victim_lo,
                              victim_hi)
    if dev.type == "cpu":
        return admission_ref(cfg, state, cand_lo, cand_hi, victim_lo,
                             victim_hi)
    out = torch.empty(cand_lo.shape, dtype=torch.bool, device=dev)
    if cand_lo.shape[0]:
        _launch(cfg, state, cand_lo, cand_hi, victim_lo, victim_hi, out)
    return out


admit.launches = 0      # kernel launches since the last reset to 0

"""Fused batched admission verdicts (paper Fig. 1): plain PyTorch version
and CUDA wrapper.

Counterpart of ``repro/kernels/admission.py`` (``admit_pallas``) and of
``admission_ref`` in ``repro/kernels/ref.py``: for each pair ``i``, admit
candidate ``i`` over victim ``i`` iff its estimate is strictly greater.

``admission_ref`` is the plain version (two plain estimates, any device);
``admit`` launches ``csrc/admission.cu`` on CUDA tensors, both estimates of a
pair in one thread, and runs ``admission_ref`` on CPU tensors, with no
fallback between them.
"""
from __future__ import annotations

import torch

from .sketch_common import DeviceSketchConfig, _check, check_sketch_inputs
from .sketch_estimate import estimate_ref


def admission_ref(cfg: DeviceSketchConfig, state: dict, cand_lo, cand_hi,
                  victim_lo, victim_hi) -> torch.Tensor:
    """(B,) bool: admit candidate i over victim i (strictly greater).  The
    candidates and victims are estimated in one plain pass."""
    b = cand_lo.shape[0]
    est = estimate_ref(cfg, state, torch.cat([cand_lo, victim_lo]),
                       torch.cat([cand_hi, victim_hi]))
    return est[:b] > est[b:]


def _launch(cfg: DeviceSketchConfig, state: dict, cand_lo, cand_hi,
            victim_lo, victim_hi, out: torch.Tensor) -> None:
    """One launch of ``csrc/admission.cu``: ``out`` (B,) bool gets the
    verdicts.  No host sync."""
    from ._build import launch
    _check(cfg.dk_probes <= 8, "the kernel takes dk_probes <= 8")
    launch("admission", "admission_launch", state["counters"],
           state["doorkeeper"], cand_lo, cand_hi, victim_lo, victim_hi, out,
           cand_lo.shape[0], cfg.rows, cfg.width, cfg.dk_bits, cfg.dk_probes)
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

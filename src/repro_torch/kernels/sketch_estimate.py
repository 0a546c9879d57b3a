"""Batched TinyLFU frequency estimates: plain PyTorch version and CUDA
wrapper.

Counterpart of ``repro/kernels/sketch_estimate.py`` (``estimate_pallas``)
and of ``estimate_ref`` in ``repro/kernels/ref.py``: per key, the minimum
over rows of its 4-bit counters, plus 1 iff every doorkeeper probe bit is
set (only with a doorkeeper), so an estimate lies in 0..cap+1.  The TPU
kernel gathers the counter words through one-hot fp32 matmuls on the MXU;
on Hopper a gather is a plain indexed load, so nothing of that is ported.

``estimate_ref`` is the plain version (vectorised tensor ops, any device);
``estimate`` launches ``csrc/sketch_estimate.cu`` on CUDA tensors and runs
``estimate_ref`` on CPU tensors, with no fallback between them.
"""
from __future__ import annotations

import torch

from .sketch_common import (DeviceSketchConfig, _check, check_sketch_inputs,
                            dk_probe_salts, nibble_get, probe_matrix,
                            probe_salts)


def _dk_contains(cfg: DeviceSketchConfig, dk: torch.Tensor, lo, hi):
    """(B,) bool: all doorkeeper probe bits set."""
    bits = probe_matrix(lo, hi, dk_probe_salts(cfg.dk_probes),
                        cfg.dk_bits - 1)                  # (B, dk_probes)
    words = dk.reshape(-1)[(bits >> 5).long()]
    return (((words >> (bits & 31)) & 1) == 1).all(dim=-1)


def _table_estimate(cfg: DeviceSketchConfig, counters: torch.Tensor, lo, hi):
    """(B,) int32 min over rows of the 4-bit counters (from 15)."""
    idx = probe_matrix(lo, hi, probe_salts(cfg.rows), cfg.width - 1)
    rows = torch.arange(cfg.rows, device=lo.device)
    vals = nibble_get(counters[rows, (idx >> 3).long()], idx & 7)
    est = torch.full(lo.shape, 15, dtype=torch.int32, device=lo.device)
    return torch.minimum(est, vals.amin(dim=-1)) if cfg.rows else est


def estimate_ref(cfg: DeviceSketchConfig, state: dict, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """Plain version of the paper's §3.4.2 estimate: (B,) int32."""
    check_sketch_inputs(cfg, state, lo, hi)
    est = _table_estimate(cfg, state["counters"], lo, hi)
    if cfg.dk_bits:
        est = est + _dk_contains(cfg, state["doorkeeper"], lo,
                                 hi).to(torch.int32)
    return est


def _launch(cfg: DeviceSketchConfig, state: dict, lo: torch.Tensor,
            hi: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of ``csrc/sketch_estimate.cu``: ``out`` (B,) int32 gets
    the estimates.  No host sync."""
    from ._build import launch
    _check(cfg.dk_probes <= 8, "the kernel takes dk_probes <= 8")
    launch("sketch_estimate", "sketch_estimate_launch",
           state["counters"], state["doorkeeper"], lo, hi, out, lo.shape[0],
           cfg.rows, cfg.width, cfg.dk_bits, cfg.dk_probes)
    estimate.launches += 1


def estimate(cfg: DeviceSketchConfig, state: dict, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """Batched estimate; same contract as :func:`estimate_ref`.  CUDA
    tensors: one kernel launch; CPU tensors: the plain version."""
    dev = check_sketch_inputs(cfg, state, lo, hi)
    if dev.type == "cpu":
        return estimate_ref(cfg, state, lo, hi)
    out = torch.empty(lo.shape, dtype=torch.int32, device=dev)
    if lo.shape[0]:
        _launch(cfg, state, lo, hi, out)
    return out


estimate.launches = 0   # kernel launches since the last reset to 0

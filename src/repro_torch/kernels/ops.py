"""Public batched sketch ops and the stateful ``DeviceTinyLFU`` facade.

Counterpart of ``repro/kernels/ops.py``.  ``estimate``, ``admit`` and
``reset`` are the kernel wrappers of their modules; ``add`` composes the
sequential batch add with the automatic reset (paper §3.3): at most one
reset, after the whole batch, iff ``size >= W``.  Each op picks the
hand-written kernel or the plain version by the device of its tensors; the
reference's ``use_pallas=False`` switch has no counterpart on the card.
The ops update the state in place and return it.

``size`` lives on the host and moves only by the batch length, so the reset
decision reads no device memory: recording a batch on the card queues one
add launch (and, when W is reached, one reset launch) and never waits for
the card.

While a ``torch.profiler`` records, each ``DeviceTinyLFU`` call is a span
of ``analysis.program_trace`` (``facade.record``, ``facade.estimate``,
``facade.admit``), its key split and stack ``facade.lanes``, its copy in
``facade.copy_in`` (whose bytes are its ``bytes_in``) and, where it
returns an answer, the read that waits for the card ``facade.verdict_read``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis import program_trace
from repro_torch.core.hashing import _pow2ceil
from .admission import admit
from .sketch_common import (DeviceSketchConfig, init_state, keys_to_lanes,
                            resolve_device)
from .sketch_estimate import estimate
from .sketch_reset import reset
from .sketch_update import add as _add_batch

__all__ = ["estimate", "add", "reset", "admit", "make_config",
           "DeviceTinyLFU"]


def add(cfg: DeviceSketchConfig, state: dict, lo: torch.Tensor,
        hi: torch.Tensor) -> dict:
    """Batch add + automatic reset once the sample counter reaches W."""
    _add_batch(cfg, state, lo, hi)
    if cfg.sample_size and int(state["size"]) >= cfg.sample_size:
        reset(cfg, state)
    return state


def make_config(num_blocks: int, sample_factor: int = 8,
                counters_per_item: float = 2.0, rows: int = 4,
                dk_bits_per_item: float = 4.0) -> DeviceSketchConfig:
    """The reference's sizing rule: W = sample_factor * num_blocks, width =
    pow2ceil(counters_per_item * W / rows), cap = sample_factor - 1 (at
    most 15), doorkeeper pow2ceil(dk_bits_per_item * W) bits."""
    sample = sample_factor * num_blocks
    width = _pow2ceil(max(8, counters_per_item * sample / rows))
    width = max(width, 8)
    return DeviceSketchConfig(
        width=width, rows=rows, cap=min(15, max(1, sample_factor - 1)),
        dk_bits=max(32, _pow2ceil(sample * dk_bits_per_item)),
        sample_size=sample)


def _lanes_on(device: torch.device, *keys: np.ndarray) -> list:
    """uint64 key arrays -> their (lo, hi) int32 lanes on ``device``, all
    in one host-to-device copy."""
    with program_trace.span("facade.lanes"):
        rows = np.stack([lane for k in keys for lane in keys_to_lanes(k)])
    with program_trace.span("facade.copy_in"):
        program_trace.count("bytes_in", rows.nbytes)
        t = torch.from_numpy(rows).to(device, non_blocking=True)
        return list(t.unbind(0))


def _read(t: torch.Tensor) -> np.ndarray:
    """A verdict on the host: waits for the card."""
    with program_trace.span("facade.verdict_read"):
        return t.cpu().numpy()


class DeviceTinyLFU:
    """Stateful TinyLFU over a sketch on the card (serving-side admission).

    Keys are uint64 (block hashes); each batch becomes 32-bit lanes on the
    way in.  Lives on the card unless ``device="cpu"``; without a card and
    without ``device="cpu"`` construction raises.
    """

    def __init__(self, num_blocks: int, sample_factor: int = 8, device=None,
                 **kw):
        self.cfg = make_config(num_blocks, sample_factor=sample_factor, **kw)
        self.device = resolve_device(device)
        self.state = init_state(self.cfg, self.device)

    def record(self, keys: np.ndarray) -> None:
        if len(keys) == 0:
            return
        with program_trace.span("facade.record"):
            lo, hi = _lanes_on(self.device, keys)
            add(self.cfg, self.state, lo, hi)

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        if len(keys) == 0:
            return np.zeros(0, np.int32)
        with program_trace.span("facade.estimate"):
            lo, hi = _lanes_on(self.device, keys)
            return _read(estimate(self.cfg, self.state, lo, hi))

    def admit(self, cands: np.ndarray, victims: np.ndarray) -> np.ndarray:
        if len(cands) == 0:
            return np.zeros(0, bool)
        with program_trace.span("facade.admit"):
            lanes = _lanes_on(self.device, cands, victims)
            return _read(admit(self.cfg, self.state, *lanes))

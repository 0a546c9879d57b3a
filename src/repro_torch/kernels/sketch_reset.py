"""The paper's §3.3 reset: plain PyTorch version and CUDA wrapper.

Counterpart of ``repro/kernels/sketch_reset.py`` (``reset_pallas``) and of
``reset_ref`` in ``repro/kernels/ref.py``: every packed 4-bit counter halved
(``(x >> 1) & 0x77777777`` per word), the doorkeeper zeroed, ``size //= 2``.

``reset_ref`` is the plain version (any device); ``reset`` launches
``csrc/sketch_reset.cu`` on CUDA tensors and runs ``reset_ref`` on CPU
tensors, with no fallback between them.  Both work in place and return the
state.  ``size`` lives on the host (see ``sketch_common``), so the kernel
never reads or writes it: the wrapper halves it exactly once per reset.
"""
from __future__ import annotations

from .sketch_common import DeviceSketchConfig, check_sketch_inputs, halve_words


def reset_ref(cfg: DeviceSketchConfig, state: dict) -> dict:
    """Plain version: halve every counter, clear the doorkeeper, halve
    ``size``; in place."""
    check_sketch_inputs(cfg, state)
    state["counters"].copy_(halve_words(state["counters"]))
    state["doorkeeper"].zero_()
    state["size"] = state["size"] // 2
    return state


def _launch(cfg: DeviceSketchConfig, state: dict) -> None:
    """One launch of ``csrc/sketch_reset.cu`` over the counter and
    doorkeeper words, in place.  No host sync."""
    from ._build import launch
    launch("sketch_reset", "sketch_reset_launch", state["counters"],
           state["counters"].numel(), state["doorkeeper"],
           state["doorkeeper"].numel())
    reset.launches += 1


def reset(cfg: DeviceSketchConfig, state: dict) -> dict:
    """§3.3 reset; same contract as :func:`reset_ref`.  CUDA tensors: one
    kernel launch; CPU tensors: the plain version."""
    dev = check_sketch_inputs(cfg, state)
    if dev.type == "cpu":
        return reset_ref(cfg, state)
    _launch(cfg, state)
    state["size"] = state["size"] // 2
    return state


reset.launches = 0      # kernel launches since the last reset to 0

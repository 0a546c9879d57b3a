"""Fault injection for the device engine.

Counterpart of ``repro/core/faults.py``, on the port's state: three fault
families, each matched to the mechanism that recovers from it.

* Process death: :func:`run_to_kill` runs a checkpointing run as a
  subprocess and SIGKILLs it after it reports k checkpoints; the caller
  then resumes with ``core.device_simulate.resume_trace``.  Saves are
  atomic (``checkpoint.store``), so a kill at any instant leaves at most a
  torn ``.tmp`` that ``latest_step`` ignores.
* Lost shard state: :func:`drop_shard_delta` zeroes one shard's slices of
  the sharded sketch.  The estimate degrades; it is not corrupted.
* Corrupted words: :func:`flip_words` XOR-flips bits of a state leaf.  A
  flip in a shard's global sketch slice is caught by the checksums
  (``integrity=True``) and the shard is quarantined at the next fold; a
  flip in the cache tables exercises degradation without a crash.

The mutators take the state that ``DeviceWTinyLFU.run(..., fault_hook=)``
passes (tensors on any device, or numpy arrays) and return a new dict whose
mutated leaf is a new tensor on the same device (a new array for numpy);
they never write into their input.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.sketch_common import _check
from repro_torch.kernels.sketch_step import StepSpec


def run_to_kill(script: str, *, marker: str = "CKPT", kills: int = 2,
                timeout: float = 600.0, env: Optional[dict] = None,
                python: Optional[str] = None):
    """Run ``script`` (python source) as a subprocess and SIGKILL it after
    it has printed ``marker`` ``kills`` times on stdout.

    The script is expected to print one marker line per completed
    checkpoint (``on_checkpoint=lambda c: print("CKPT", c, flush=True)``),
    so the kill lands mid-run with at least one durable checkpoint behind
    it.  Returns ``(markers_seen, returncode)``; a SIGKILLed child reports
    ``-signal.SIGKILL``.  If the script finishes before ``kills`` markers
    appear the (successful) return code is surfaced so the caller can fail
    with the real exit status instead of hanging.
    """
    proc = subprocess.Popen(
        [python or sys.executable, "-c", script],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, **(env or {})})
    seen = 0
    deadline = time.monotonic() + timeout
    try:
        for line in proc.stdout:
            if time.monotonic() > deadline:
                raise TimeoutError(f"run_to_kill: no {kills} markers within "
                                   f"{timeout}s; output so far: {line!r}")
            if line.startswith(marker):
                seen += 1
                if seen >= kills:
                    proc.kill()
                    break
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return seen, proc.returncode


def _copy(x):
    """A new tensor on ``x``'s device, or a new numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone(memory_format=torch.contiguous_format)
    return np.array(x, copy=True)


def flip_words(state: dict, key: str, flips) -> dict:
    """XOR single bits into ``state[key]``.

    ``flips``: iterable of ``(flat_index, bit)`` pairs, bit in [0, 32).
    Returns a new state dict; the mutated leaf is a copy.
    """
    out = _copy(state[key])
    flat = out.reshape(-1)
    if isinstance(out, torch.Tensor):
        for idx, bit in flips:      # bit 31 is the int32 -2^31, no overflow
            flat[idx] ^= (1 << bit) - (1 << 32 if bit == 31 else 0)
    else:
        view = flat.view(np.uint32)
        for idx, bit in flips:
            view[idx] ^= np.uint32(1) << np.uint32(bit)
    return {**state, key: out}


def drop_shard_delta(spec: StepSpec, state: dict, shard: int,
                     half: str = "delta") -> dict:
    """Zero shard ``shard``'s counter and doorkeeper slices in a sharded
    state.

    ``half="delta"`` models one device's epoch of increments lost before
    the merge fold (meaningful only on mid-epoch state: at boundaries the
    fold has just cleared the deltas).  ``half="global"`` models the loss
    of the shard's whole accumulated estimate, which is what the
    boundary-time ``fault_hook`` injects for the stale-exchange drills.
    ``half="both"`` combines them.
    """
    _check(spec.shards > 1 and 0 <= shard < spec.shards,
           f"shard {shard} of a sketch with {spec.shards} shards")
    _check(half in ("delta", "global", "both"),
           f"half {half!r} must be 'delta', 'global' or 'both'")
    H, wps = spec.counter_words, spec.wps_shard
    halves = (0, 1) if half == "both" else ((1,) if half == "delta" else (0,))
    c = _copy(state["counters"])
    for h in halves:
        c[h * H:(h + 1) * H].reshape(spec.rows, spec.shards, wps)[:, shard] = 0
    out = {**state, "counters": c}
    if spec.dk_bits:
        HD = spec.dk_words
        dk = _copy(state["doorkeeper"])
        for h in halves:
            dk[h * HD:(h + 1) * HD].reshape(spec.shards,
                                            spec.dkw_shard)[shard] = 0
        out["doorkeeper"] = dk
    return out

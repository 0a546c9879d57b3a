"""The schedule of the add kernel's batch update, modelled in numpy, against
the JAX package's sequential add, bitwise.

``csrc/sketch_update.cu`` does not walk a batch key by key: per tile of
``ADD_TILE`` keys it takes every doorkeeper gate from first touches, joins
the gated keys that share a counter nibble into components, walks each
component in batch order, and adds each nibble's change once.  The kernel
cannot run here; ``check_runs.add_schedule`` models that schedule in numpy
and is held here to the JAX ``add_ref`` (through ``ops.add`` with
``use_pallas=False``) on every case of ``check_runs.ADD_HAZARD_CASES`` and
on run S's first two batches.  On the card, ``chip_smoke.py`` phase 7 and
``tests/test_torch_kernel_gpu.py`` hold the kernel to the port's plain
``add_ref`` on the same cases.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import sketch_common as jsc
from repro_torch.check_runs import (ADD_HAZARD_CASES, ADD_TILE, S_BATCH,
                                    S_BLOCKS, add_hazard_batches,
                                    add_schedule)
from repro_torch.kernels.sketch_common import key_probes, keys_to_lanes
from repro_torch.traces.synthetic import zipf_trace

CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc"


def schedule_and_jax(jcfg, batches):
    """Add the batches one after another through the model and through the
    JAX ops.add; assert equal counters and doorkeeper after each.  Returns
    the model's per-tile statistics of the last batch."""
    jstate = jsc.init_state(jcfg)
    counters = np.zeros((jcfg.rows, jcfg.width // 8), np.int32)
    dk = np.zeros((1, max(1, jcfg.dk_bits // 32)), np.int32)
    for keys in batches:
        lo, hi = keys_to_lanes(keys)
        jstate = jops.add(jcfg, jstate, lo, hi, False)
        idx, dkb = key_probes(torch.from_numpy(lo), torch.from_numpy(hi),
                              jcfg.rows, jcfg.width, jcfg.dk_bits,
                              jcfg.dk_probes)
        stats = add_schedule(counters, dk, idx.numpy(), dkb.numpy(),
                             width=jcfg.width, cap=jcfg.cap,
                             dk_bits=jcfg.dk_bits)
        np.testing.assert_array_equal(counters,
                                      np.asarray(jstate["counters"]))
        np.testing.assert_array_equal(dk, np.asarray(jstate["doorkeeper"]))
        assert len(stats) == -(-len(keys) // ADD_TILE)
    return stats


@pytest.mark.parametrize("case", range(len(ADD_HAZARD_CASES)),
                         ids=[c[0] for c in ADD_HAZARD_CASES])
def test_schedule_matches_jax_add(case):
    """Counters and doorkeeper bit-equal to the JAX add after every batch."""
    name, kw, _, _ = ADD_HAZARD_CASES[case]
    stats = schedule_and_jax(jsc.DeviceSketchConfig(**kw),
                             add_hazard_batches(case))
    gated, components, largest, _ = stats[-1]
    if name.startswith("width 8"):     # every key collides: one component
        assert gated > 1 and components == 1 and largest == gated
    if name.startswith("one key"):
        assert components == 1 and largest == gated


def test_schedule_matches_jax_add_on_run_s():
    """Run S's first two batches at its geometry; the second batch has
    components of several keys."""
    keys = zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9, seed=11)
    jcfg = jops.make_config(S_BLOCKS)
    stats = schedule_and_jax(jcfg, [keys[:S_BATCH], keys[S_BATCH:2 * S_BATCH]])
    assert all(several <= largest for _, _, largest, several in stats)
    assert any(several for *_, several in stats)


def test_model_tile_is_the_kernels():
    """The model's tile is the one the kernel runs."""
    src = (CSRC / "sketch_update.cu").read_text()
    assert re.search(rf"constexpr int kTile = {ADD_TILE};", src)

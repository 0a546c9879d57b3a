"""The port's plain competitor bodies (S3-FIFO, ARC, LFU) against the JAX
step_ref on the panel kernel's check cases
(``repro_torch.check_runs.PANEL_CASES``), on the CPU: bitwise, on every
state leaf (ARC's ``ghost`` Blooms too) and every hit flag.

These are the cases ``chip_smoke.py`` phase 28 and
``tests/test_torch_kernel_gpu.py`` run through the CUDA kernel's panel
instances on the card: 1, 4, 8, 16 and 32 ways, tables of one and two
main sets (aliased choices), 4- and 8-bit counters, the doorkeeper on and
off, resets inside and across chunk boundaries, zero-way window sets, ARC
at 256 ghost bits with both halves cleared inside a chunk, four lanes with
per-lane params and shorter lanes, and one chunk at run FP's geometry.  The
JAX side runs each lane on its own, chunk by chunk with the lane's
``n_valid``; the port runs the lane axis at once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sketch_step as jks
from repro_torch.check_runs import (LANES, PANEL_CASES, hazard_keys,
                                    lane_keys, lane_n_valid)
from repro_torch.kernels import sketch_step as pks
from repro_torch.kernels.sketch_common import keys_to_lanes

torch.set_num_threads(1)

_jstep = jax.jit(jks.step_ref, static_argnums=(0,))


def jax_lane(kw, pargs, wcap, mcap, lo, hi, chunk, counts):
    """One lane through the JAX package: (numpy state, hit flags)."""
    spec = jks.StepSpec(**kw)
    params = jks.make_step_params(*pargs, counter_bits=spec.counter_bits)
    state = jks.init_step_state(spec, wcap, mcap)
    hits = []
    for s, nv in zip(range(0, len(lo), chunk), counts):
        state, h = _jstep(spec, params, state, jnp.asarray(lo[s:s + chunk]),
                          jnp.asarray(hi[s:s + chunk]), jnp.int32(nv))
        hits.append(np.asarray(h))
    return ({k: np.asarray(v) for k, v in state.items()},
            np.concatenate(hits))


@pytest.mark.parametrize("case", range(len(PANEL_CASES)),
                         ids=[c[0] for c in PANEL_CASES])
def test_panel_step_ref_bitwise_on_cases(case):
    _, kw, prows, wcap, mcap, kind, n, chunk = PANEL_CASES[case]
    lanes = LANES if len(prows) > 1 else 1
    keys = lane_keys(kind, n) if lanes > 1 else hazard_keys(kind, n,
                                                            seed=case)
    lo, hi = keys_to_lanes(keys)
    starts = range(0, n, chunk)
    counts = [lane_n_valid(chunk, c, n - s) if lanes > 1
              else min(chunk, n - s) for c, s in enumerate(starts)]

    spec = pks.StepSpec(**kw, streams=lanes)
    params = torch.stack([pks.make_step_params(
        *p, counter_bits=spec.counter_bits, device="cpu") for p in prows])
    params = params[0] if lanes == 1 else params
    state = pks.init_step_state(spec, wcap, mcap, device="cpu")
    hits = [pks.step_ref(spec, params, state,
                         torch.from_numpy(lo[..., s:s + chunk]),
                         torch.from_numpy(hi[..., s:s + chunk]), nv)[1]
            for s, nv in zip(starts, counts)]
    got = pks.state_to_numpy(state), torch.cat(hits, dim=-1).numpy()
    assert ("ghost" in got[0]) == (spec.policy == "arc")

    for b in range(lanes):
        want = jax_lane(kw, prows[b] if lanes > 1 else prows[0], wcap, mcap,
                        lo[b] if lanes > 1 else lo,
                        hi[b] if lanes > 1 else hi, chunk,
                        [c[b] for c in counts] if lanes > 1 else counts)
        lane = ({k: v[b] for k, v in got[0].items()} if lanes > 1
                else got[0], got[1][b] if lanes > 1 else got[1])
        assert sorted(lane[0]) == sorted(want[0])
        for k in want[0]:
            np.testing.assert_array_equal(lane[0][k], want[0][k],
                                          err_msg=f"lane {b} state[{k}]")
        # a lane's accesses past its n_valid report no hit on either side
        mask = np.concatenate([np.arange(min(chunk, n - s)) < (
            c[b] if lanes > 1 else c) for s, c in zip(starts, counts)])
        np.testing.assert_array_equal(lane[1][mask], want[1][mask],
                                      err_msg=f"lane {b} hit flags")
        assert not lane[1][~mask].any()
        assert lane[1].any()

"""The port's plain adaptive step against the JAX step_ref on the adaptive
kernel's check cases (``repro_torch.check_runs.ADAPT_CASES``), on the CPU:
bitwise, on every state leaf and every hit flag.

These are the cases ``chip_smoke.py`` phase 23 and
``tests/test_torch_kernel_gpu.py`` run through the CUDA kernel's adaptive
instances on the card: flat and 8 and 16 ways, 4- and 8-bit counters,
doorkeeper on and off, runs of one key, ``shards=4`` and four lanes with
per-lane params, quotas and shorter lanes, one epoch at a time with
``rebalance`` (after ``merge_halve`` when sharded) between epochs to quotas
that go up and down and cross the window set count.  The JAX side runs each
lane on its own (``step_ref`` with the lane's ``n_valid``, then the
reference's ``rebalance`` to the lane's quota); the port runs the lane axis
at once.  The case at FA's geometry runs on the card only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sketch_merge as jkm
from repro.kernels import sketch_step as jks
from repro_torch.check_runs import (ADAPT_CASES, LANES, hazard_keys,
                                    lane_keys, lane_n_valid)
from repro_torch.kernels import sketch_step as pks
from repro_torch.kernels.sketch_common import keys_to_lanes
from repro_torch.kernels.sketch_merge import merge_halve

torch.set_num_threads(1)

_jstep = jax.jit(jks.step_ref, static_argnums=(0,))
CASES = ADAPT_CASES[:-1]            # all but FA's geometry


def jax_lane(kw, pargs, wcap, mcap, lo, hi, epoch, counts, quotas):
    """One lane through the JAX package: (numpy state, hit flags)."""
    spec = jks.StepSpec(**kw, adaptive=True)
    params = jks.make_step_params(*pargs, counter_bits=spec.counter_bits)
    state = jks.init_step_state(spec, wcap, mcap)
    hits = []
    for c, (s, nv) in enumerate(zip(range(0, len(lo), epoch), counts)):
        state, h = _jstep(spec, params, state, jnp.asarray(lo[s:s + epoch]),
                          jnp.asarray(hi[s:s + epoch]), jnp.int32(nv))
        hits.append(np.asarray(h))
        if spec.shards > 1:
            state = jkm.merge_halve(spec, params, state)
        state = jks.rebalance(spec, params, state, quotas[c])
    return ({k: np.asarray(v) for k, v in state.items()},
            np.concatenate(hits))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_adaptive_step_ref_bitwise_on_cases(case):
    _, kw, prows, wcap, mcap, kind, n, epoch, quotas = CASES[case]
    lanes = LANES if len(prows) > 1 else 1
    keys = lane_keys(kind, n) if lanes > 1 else hazard_keys(kind, n,
                                                            seed=case)
    lo, hi = keys_to_lanes(keys)
    starts = range(0, n, epoch)
    counts = [lane_n_valid(epoch, c, n - s) if lanes > 1
              else min(epoch, n - s) for c, s in enumerate(starts)]
    qs = [quotas[c % len(quotas)] for c in range(len(counts))]

    spec = pks.StepSpec(**kw, adaptive=True, streams=lanes)
    params = torch.stack([pks.make_step_params(
        *p, counter_bits=spec.counter_bits, device="cpu") for p in prows])
    params = params[0] if lanes == 1 else params
    state = pks.init_step_state(spec, wcap, mcap, device="cpu")
    hits = []
    for c, (s, nv) in enumerate(zip(starts, counts)):
        hits.append(pks.step_ref(spec, params, state,
                                 torch.from_numpy(lo[..., s:s + epoch]),
                                 torch.from_numpy(hi[..., s:s + epoch]),
                                 nv)[1])
        if spec.shards > 1:
            merge_halve(spec, params, state)
        pks.rebalance(spec, params, state, torch.tensor(qs[c]))
    got = pks.state_to_numpy(state), torch.cat(hits, dim=-1).numpy()

    for b in range(lanes):
        want = jax_lane(kw, prows[b] if lanes > 1 else prows[0], wcap, mcap,
                        lo[b] if lanes > 1 else lo,
                        hi[b] if lanes > 1 else hi, epoch,
                        [c[b] for c in counts] if lanes > 1 else counts,
                        [q[b] for q in qs] if lanes > 1 else qs)
        lane = ({k: v[b] for k, v in got[0].items()} if lanes > 1
                else got[0], got[1][b] if lanes > 1 else got[1])
        assert sorted(lane[0]) == sorted(want[0])
        for k in want[0]:
            np.testing.assert_array_equal(lane[0][k], want[0][k],
                                          err_msg=f"lane {b} state[{k}]")
        # a lane's accesses past its n_valid report no hit on either side
        mask = np.concatenate([np.arange(min(epoch, n - s)) < (
            c[b] if lanes > 1 else c) for s, c in zip(starts, counts)])
        np.testing.assert_array_equal(lane[1][mask], want[1][mask],
                                      err_msg=f"lane {b} hit flags")
        assert not lane[1][~mask].any()

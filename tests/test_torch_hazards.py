"""The port's plain step against the JAX step_ref on the step kernel's
hazard traces (``repro_torch.check_runs.HAZARD_CASES``): bitwise, on every
state leaf and every hit flag.

The traces are those ``chip_smoke.py`` phase 2 and
``tests/test_torch_kernel_gpu.py`` replay through the CUDA kernel on the
card: runs of one repeated key, tables of one or two sets, a hot key
alternating with fresh keys, sketch resets at every chunk boundary and in
mid-chunk, at 4, 8 and 16 ways and at run F's geometry.  JAX runs the whole
trace in one call; the port runs it through the engine's chunk runner, so
the state also carries across chunk boundaries.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import sketch_step as jref
from repro_torch.check_runs import HAZARD_CASES, hazard_keys
from repro_torch.core.device_simulate import run_chunks
from repro_torch.kernels import sketch_step as port
from repro_torch.kernels.sketch_common import keys_to_lanes

torch.set_num_threads(1)


@pytest.mark.parametrize("case", range(len(HAZARD_CASES)),
                         ids=[c[0] for c in HAZARD_CASES])
def test_step_ref_bitwise_on_hazards(case):
    _, kw, pargs, wcap, mcap, kind, n, chunk = HAZARD_CASES[case]
    keys = hazard_keys(kind, n, seed=case)
    lo, hi = keys_to_lanes(keys)

    spec = jref.StepSpec(**kw)
    state, hits = jref.step_ref(
        spec, jref.make_step_params(*pargs, counter_bits=spec.counter_bits),
        jref.init_step_state(spec, wcap, mcap), jnp.asarray(lo),
        jnp.asarray(hi))
    want = {k: np.asarray(v) for k, v in state.items()}, np.asarray(hits)

    spec = port.StepSpec(**kw)
    params = port.make_step_params(*pargs, counter_bits=spec.counter_bits,
                                   device="cpu")
    state = port.init_step_state(spec, wcap, mcap, device="cpu")
    state, hits = run_chunks(spec, params, state, torch.from_numpy(lo),
                             torch.from_numpy(hi), chunk)
    got = port.state_to_numpy(state), hits.numpy()

    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k],
                                      err_msg=f"state[{k}]")
    np.testing.assert_array_equal(got[1], want[1], err_msg="hit flags")
    assert int(got[0]["regs"][port.R_T]) == n

"""The CUDA step kernel against the port's plain version, on the card.

Imports nothing of JAX, so it runs on the machine with the card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernel_gpu.py``.
Without a card the kernel test skips; the wrapper checks below run anywhere.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.device_simulate import run_chunks
from repro_torch.kernels import sketch_step as port
from repro_torch.kernels.sketch_common import keys_to_lanes

# (StepSpec kwargs, make_step_params args, window_cap, main_cap)
CASES = [
    (dict(width=256, rows=4, dk_bits=1024, window_slots=2, main_slots=60),
     (2, 60, 48, 500, 7, 0), None, None),
    (dict(width=1024, rows=2, dk_bits=0, window_slots=5, main_slots=45),
     (5, 45, 36, 400, 15, 100), None, None),
    (dict(width=2048, rows=5, dk_bits=4096, window_slots=10, main_slots=90,
          counter_bits=8), (10, 90, 72, 300, 200, 0), None, None),
    (dict(width=256, rows=4, dk_bits=1024, window_slots=8, main_slots=16,
          assoc=4), (6, 14, 11, 300, 7, 0), 6, 14),
    (dict(width=512, rows=3, dk_bits=2048, window_slots=8, main_slots=64,
          assoc=8, counter_bits=8), (3, 60, 48, 400, 30, 0), 3, 60),
    (dict(width=256, rows=4, dk_bits=0, window_slots=16, main_slots=32,
          assoc=4), (2, 30, 24, 250, 15, 0), 2, 30),
]


def run(fn, spec, params, wcap, mcap, lo, hi, chunk):
    state = port.init_step_state(spec, wcap, mcap, device=lo.device)
    state, hits = run_chunks(spec, params, state, lo, hi, chunk, fn=fn)
    return port.state_to_numpy(state), hits.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_matches_plain_on_card(case):
    """Kernel == plain on every state leaf and hit flag, chunked with a
    reset inside a chunk and a padded tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw, pargs, wcap, mcap = CASES[case]
    spec = port.StepSpec(**kw)
    params = port.make_step_params(*pargs, counter_bits=spec.counter_bits,
                                   device="cuda")
    keys = np.random.default_rng(case).integers(0, 300, size=700,
                                                dtype=np.uint64)
    lo, hi = (torch.from_numpy(x).cuda() for x in keys_to_lanes(keys))
    got = run(port.step, spec, params, wcap, mcap, lo, hi, 256)
    ref = run(port.step_ref, spec, params, wcap, mcap, lo, hi, 256)
    for k in ref[0]:
        np.testing.assert_array_equal(got[0][k], ref[0][k],
                                      err_msg=f"state[{k}]")
    np.testing.assert_array_equal(got[1], ref[1], err_msg="hit flags")


def test_launch_refuses_cpu_tensors():
    """The kernel path never takes CPU tensors: only ``step`` may route a
    CPU tensor to the plain version."""
    kw, pargs, wcap, mcap = CASES[0]
    spec = port.StepSpec(**kw)
    state = port.init_step_state(spec, device="cpu")
    lo = torch.zeros(4, dtype=torch.int32)
    probes = port.precompute_probes(spec, lo, lo)
    with pytest.raises(ValueError, match="CUDA"):
        port._launch(spec, port.make_step_params(*pargs, device="cpu"), state,
                     lo, lo, probes, 4, torch.zeros(4, dtype=torch.int32))

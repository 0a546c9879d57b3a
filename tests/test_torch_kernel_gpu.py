"""The CUDA kernels against the port's plain versions, on the card: the step
kernel and the four batched sketch kernels (add, estimate, admit, reset).

Imports nothing of JAX, so it runs on the machine with the card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernel_gpu.py``.
Without a card the kernel tests skip; the wrapper checks below run anywhere.
"""
import numpy as np
import pytest
import torch

from repro_torch.check_runs import SKETCH_CFGS as CFGS, mixed_keys
from repro_torch.core.device_simulate import run_chunks
from repro_torch.kernels import (admission, sketch_estimate, sketch_reset,
                                 sketch_update)
from repro_torch.kernels import sketch_common as sc
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


# DeviceSketchConfig kwargs: the tests/test_kernels.py CFGS and one with W
SKETCH_CFGS = CFGS + [dict(width=256, rows=4, cap=15, dk_bits=1024,
                           sample_size=256)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(SKETCH_CFGS)))
@pytest.mark.parametrize("batch", [1, 7, 128, 300, 1024])
def test_sketch_kernels_match_plain_on_card(case, batch):
    """add (with the automatic reset), estimate, admit and a standalone
    reset: kernel == plain on every leaf and output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = sc.DeviceSketchConfig(**SKETCH_CFGS[case])
    keys = mixed_keys(case * 7919 + batch, batch)
    lo, hi = (torch.from_numpy(x).cuda() for x in keys_to_lanes(keys))
    q = np.concatenate([keys[:64], np.arange(64, dtype=np.uint64)])
    qlo, qhi = (torch.from_numpy(x).cuda() for x in keys_to_lanes(q))
    vlo, vhi = qlo.roll(1), qhi.roll(1)
    states = []
    for add, reset, est, adm in (
            (sketch_update.add, sketch_reset.reset, sketch_estimate.estimate,
             admission.admit),
            (sketch_update.add_ref, sketch_reset.reset_ref,
             sketch_estimate.estimate_ref, admission.admission_ref)):
        state = sc.init_state(cfg, device="cuda")
        add(cfg, state, lo, hi)
        if cfg.sample_size and int(state["size"]) >= cfg.sample_size:
            reset(cfg, state)
        outs = [est(cfg, state, qlo, qhi).cpu(),
                adm(cfg, state, qlo, qhi, vlo, vhi).cpu()]
        reset(cfg, state)
        states.append((sc.sketch_state_to_numpy(state), outs))
    (got, got_out), (ref, ref_out) = states
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"state[{k}]")
    for g, r in zip(got_out, ref_out):
        assert torch.equal(g, r)


@pytest.mark.parametrize("module,wrapper,args", [
    (sketch_update, "add", lambda c, s, x: (c, s, x, x)),
    (sketch_estimate, "estimate", lambda c, s, x: (c, s, x, x, x)),
    (admission, "admit", lambda c, s, x: (
        c, s, x, x, x, x, torch.zeros(4, dtype=torch.bool))),
    (sketch_reset, "reset", lambda c, s, x: (c, s)),
])
def test_sketch_launch_refuses_cpu_tensors(module, wrapper, args):
    """The sketch kernels' launch paths never take CPU tensors (only the
    wrappers may route a CPU tensor to the plain version), and a refused
    launch is not counted."""
    cfg = sc.DeviceSketchConfig(width=256, dk_bits=1024)
    state = sc.init_state(cfg, device="cpu")
    x = torch.zeros(4, dtype=torch.int32)
    before = getattr(module, wrapper).launches
    with pytest.raises(ValueError, match="CUDA"):
        module._launch(*args(cfg, state, x))
    assert getattr(module, wrapper).launches == before

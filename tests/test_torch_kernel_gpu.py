"""The CUDA kernels against the port's plain versions, on the card: the step
kernel (one stream and its lane grid), the four batched sketch kernels (add, estimate, admit, reset; both
paths of the add on its hazard cases and of the admit at small and large
batches) and the flash-attention kernel.

Imports nothing of JAX, so it runs on the machine with the card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernel_gpu.py``.
Without a card the kernel tests skip; the wrapper checks below run anywhere.
"""
import numpy as np
import pytest
import torch

from repro_torch.check_runs import (ADD_HAZARD_CASES, ADMIT_SIZES,
                                    FLASH_CASES, FLASH_TAIL,
                                    FLASH_TAIL_LENS, HAZARD_CASES, LANE_CASES,
                                    LANES, lane_keys, lane_n_valid,
                                    SKETCH_CFGS as CFGS, add_hazard_batches,
                                    cache_tails, hazard_keys, mixed_keys)
from repro_torch.core.device_simulate import run_chunks
from repro_torch.kernels import (admission, flash_attention, sketch_estimate,
                                 sketch_reset, sketch_update)
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(HAZARD_CASES)),
                         ids=[c[0] for c in HAZARD_CASES])
def test_kernel_matches_plain_on_hazards(case):
    """Kernel == plain on every state leaf and hit flag over the traces
    whose accesses read what the access before them wrote."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, kw, pargs, wcap, mcap, kind, n, chunk = HAZARD_CASES[case]
    spec = port.StepSpec(**kw)
    params = port.make_step_params(*pargs, counter_bits=spec.counter_bits,
                                   device="cuda")
    keys = hazard_keys(kind, n, seed=case)
    lo, hi = (torch.from_numpy(x).cuda() for x in keys_to_lanes(keys))
    got = run(port.step, spec, params, wcap, mcap, lo, hi, chunk)
    ref = run(port.step_ref, spec, params, wcap, mcap, lo, hi, chunk)
    for k in ref[0]:
        np.testing.assert_array_equal(got[0][k], ref[0][k],
                                      err_msg=f"state[{k}]")
    np.testing.assert_array_equal(got[1], ref[1], err_msg="hit flags")


def run_lane_case(case, fn, device):
    """LANE_CASES[case] through ``fn`` (step or step_ref) chunk by chunk
    with lane_n_valid's per-lane counts; returns (numpy state, hit
    flags)."""
    _, kw, prows, wcap, mcap, kind, n, chunk = LANE_CASES[case]
    spec = port.StepSpec(**kw, streams=LANES)
    params = torch.stack([port.make_step_params(
        *p, counter_bits=spec.counter_bits, device=device) for p in prows])
    params = params[0] if len(prows) == 1 else params
    state = port.init_step_state(spec, wcap, mcap, device=device)
    lo, hi = (torch.from_numpy(x).to(device)
              for x in keys_to_lanes(lane_keys(kind, n)))
    hits = []
    for c, s in enumerate(range(0, n, chunk)):
        _, h = fn(spec, params, state, lo[:, s:s + chunk], hi[:, s:s + chunk],
                  lane_n_valid(chunk, c, n - s))
        hits.append(h.cpu())
    return port.state_to_numpy(state), torch.cat(hits, dim=1).numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(LANE_CASES)),
                         ids=[c[0] for c in LANE_CASES])
def test_lane_kernel_matches_plain_on_card(case):
    """The lane grid (one CTA per lane, one launch per chunk) == step_ref
    with lanes on every state leaf and hit flag: flat and set, shared and
    per-lane params, a lane with a shorter n_valid and one with none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = port.step.launches
    got = run_lane_case(case, port.step, "cuda")
    _, _, _, _, _, _, n, chunk = LANE_CASES[case]
    assert port.step.launches - before == -(-n // chunk)
    ref = run_lane_case(case, port.step_ref, "cuda")
    for k in ref[0]:
        np.testing.assert_array_equal(got[0][k], ref[0][k],
                                      err_msg=f"state[{k}]")
    np.testing.assert_array_equal(got[1], ref[1], err_msg="hit flags")


@pytest.mark.gpu
@pytest.mark.parametrize("case", [0, 3, 5],
                         ids=["flat", "ways 4", "ways 4, no doorkeeper"])
def test_lane_grid_at_one_lane_equals_single_launch(case):
    """streams=1 through the lane kernel (one CTA at lane 0) == the
    single-stream launch, leaf for leaf and flag for flag."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw, pargs, wcap, mcap = CASES[case]
    spec = port.StepSpec(**kw)
    params = port.make_step_params(*pargs, counter_bits=spec.counter_bits,
                                   device="cuda")
    keys = np.random.default_rng(case).integers(0, 300, size=700,
                                                dtype=np.uint64)
    lo, hi = (torch.from_numpy(x).cuda() for x in keys_to_lanes(keys))
    probes = port.precompute_probes(spec, lo, hi)
    outs = []
    for lane_grid in (False, True):
        state = port.init_step_state(spec, wcap, mcap, device="cuda")
        hits = torch.empty_like(lo)
        for s in range(0, 700, 256):
            e = min(s + 256, 700)
            port._launch(spec, params, state, lo[s:e], hi[s:e],
                         tuple(p[s:e] for p in probes), e - s, hits[s:e],
                         lane_grid=lane_grid)
        outs.append((port.state_to_numpy(state), hits.cpu().numpy()))
    (single, sh), (lane, lh) = outs
    for k in single:
        np.testing.assert_array_equal(lane[k], single[k],
                                      err_msg=f"state[{k}]")
    np.testing.assert_array_equal(lh, sh, err_msg="hit flags")


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


def test_launch_refuses_more_ways_than_registers_hold():
    """The set path holds a set's ways in registers, at most 128: more are
    refused before anything is built or launched."""
    spec = port.StepSpec(width=256, rows=4, dk_bits=1024, window_slots=129,
                         main_slots=129, assoc=129)
    state = port.init_step_state(spec, device="cpu")
    lo = torch.zeros(4, dtype=torch.int32)
    probes = port.precompute_probes(spec, lo, lo)
    before = port.step.launches
    with pytest.raises(ValueError, match="128 ways"):
        port._launch(spec, port.make_step_params(2, 120, 96, 500, 7,
                                                 device="cpu"),
                     state, lo, lo, probes, 4,
                     torch.zeros(4, dtype=torch.int32))
    assert port.step.launches == before


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


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(ADD_HAZARD_CASES)),
                         ids=[c[0] for c in ADD_HAZARD_CASES])
def test_add_kernel_matches_plain_on_hazards(case):
    """The add kernel == add_ref after every batch of the add's hazard
    cases (one component for a whole batch, shared doorkeeper words, one
    key repeated past cap, batches across and beside the tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = sc.DeviceSketchConfig(**ADD_HAZARD_CASES[case][1])
    kernel = sc.init_state(cfg, device="cuda")
    plain = sc.init_state(cfg, device="cuda")
    for keys in add_hazard_batches(case):
        lo, hi = (torch.from_numpy(x).cuda() for x in keys_to_lanes(keys))
        sketch_update._launch(cfg, kernel, lo, hi)
        sketch_update.add_ref(cfg, plain, lo, hi)
        for k in ("counters", "doorkeeper"):
            assert torch.equal(kernel[k], plain[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("per_thread", [False, True], ids=["warp", "thread"])
@pytest.mark.parametrize("n", ADMIT_SIZES)
def test_admit_kernel_matches_plain_at_batch_sizes(n, per_thread):
    """Each path of the admit kernel == admission_ref at S's geometry, on a
    sketch of random nibbles and doorkeeper words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = sc.DeviceSketchConfig(width=262_144, rows=4, cap=7,
                                dk_bits=2_097_152)
    rng = np.random.default_rng(n)
    words = lambda *shape: rng.integers(-2**31, 2**31, shape,  # noqa: E731
                                        dtype=np.int64).astype(np.int32)
    state = sc.sketch_state_from_numpy(cfg, {
        "counters": words(cfg.rows, cfg.words_per_row),
        "doorkeeper": words(1, cfg.dk_words),
        "size": np.array(0, np.int32)}, device="cuda")
    keys = rng.integers(0, 1 << 63, 2 * n, dtype=np.uint64)
    lanes = [torch.from_numpy(x).cuda() for k in (keys[:n], keys[n:])
             for x in keys_to_lanes(k)]
    out = torch.empty(n, dtype=torch.bool, device="cuda")
    admission._launch(cfg, state, *lanes, out, per_thread=per_thread)
    assert torch.equal(out, admission.admission_ref(cfg, state, *lanes))


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


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(FLASH_CASES)))
def test_flash_kernel_matches_plain_on_card(case):
    """Kernel vs plain within max-abs 2e-2 in bf16 (the reference's bf16
    bound) on chip_smoke.py's cases; K/V as a slice of a larger tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, B, Sq, Skv, Hq, Hkv, D, causal, off, kv_len, cap = FLASH_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(case)
    q = torch.randn((B, Sq, Hq, D), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B + 1, Skv, Hkv, D), generator=g,
                        device="cuda").bfloat16()[1:] for _ in range(2))
    if isinstance(kv_len, list):
        kv_len = torch.tensor(kv_len, device="cuda")
    kw = dict(causal=causal, q_offset=off, kv_len=kv_len, softcap=cap)
    before = flash_attention.flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, **kw)
    want = flash_attention.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("kv_len", FLASH_TAIL_LENS)
def test_flash_kernel_ignores_the_cache_past_kv_len(kv_len):
    """Cache slots past kv_len filled with NaN and +-3e38 give an output
    bit-equal to the same launch on a zeroed tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = FLASH_TAIL
    g = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn((c["B"], c["Sq"], c["Hq"], c["D"]), generator=g,
                    device="cuda").bfloat16()
    k, v = (torch.randn((c["B"], c["Skv"], c["Hkv"], c["D"]), generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    lens = [kv_len] * c["B"] if isinstance(kv_len, int) else kv_len
    zeroed, poisoned = cache_tails(k, v, lens)
    if isinstance(kv_len, list):
        kv_len = torch.tensor(kv_len, device="cuda")
    kw = dict(causal=True, q_offset=c["q_offset"], kv_len=kv_len)
    want = flash_attention.flash_attention(q, *zeroed, **kw)
    got = flash_attention.flash_attention(q, *poisoned, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_flash_launch_refuses_cpu_tensors():
    """The flash kernel's launch path never takes CPU tensors (only the
    wrapper routes them to the plain version), and a refused launch is not
    counted."""
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    before = flash_attention.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention._launch(q, q, q, causal=True, q_offset=0,
                                kv_len=None, softcap=0.0)
    assert flash_attention.flash_attention.launches == before

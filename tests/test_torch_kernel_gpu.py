"""The CUDA kernels against the port's plain versions, on the card: the step
kernel (one stream, its lane grid, its sharded instances with the fold
between epochs and its adaptive instances with the rebalance between
epochs), the four batched sketch kernels (add, estimate, admit, reset; both
paths of the add on its hazard cases and of the admit at small and large
batches; all four at the edge geometries, past 8 doorkeeper probes too,
and one stream of programmatic dependent launches), the flash-attention
kernel (serving, and training: the LSE instance and the backward kernel),
checkpointed and resumed runs of the engine on the card, the
window-adaptation CLI, a prefix of one of the paper's trace families
through the engine, and each serving family's smoke engine.

Imports nothing of JAX, so it runs on the machine with the card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernel_gpu.py``.
Without a card the kernel tests skip; the wrapper checks below run anywhere.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.check_runs import (ADAPT_CASES, ADD_HAZARD_CASES,
                                    ADMIT_SIZES, FB_CASES, FB_LSE_TOL,
                                    FB_TOL,
                                    FLASH_CASES, FLASH_TAIL,
                                    FLASH_TAIL_LENS, HAZARD_CASES, LANE_CASES,
                                    LANES, PANEL_CASES, PANEL_FRACS,
                                    PF_CELLS, pf_trace, pf_warmup,
                                    SHARD_CASES, SKETCH_EDGE_CFGS,
                                    STEP12_CASES, lane_keys, run_step_case,
                                    lane_n_valid,
                                    SKETCH_CFGS as CFGS, add_hazard_batches,
                                    cache_tails, hazard_keys, mixed_keys,
                                    random_sketch)
from repro_torch.core.device_simulate import (ClimbSpec, run_chunks,
                                              simulate_trace)
from repro_torch.kernels import (admission, flash_attention, sketch_estimate,
                                 sketch_reset, sketch_update)
from repro_torch.kernels import sketch_common as sc
from repro_torch.kernels import sketch_step as port
from repro_torch.kernels.sketch_common import keys_to_lanes
from repro_torch.kernels.sketch_merge import merge_halve

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


def run_shard_case(case, fn, device):
    """SHARD_CASES[case] through ``fn`` (step or step_ref) one epoch at a
    time, merge_halve after each (per-lane counts with lanes); returns
    (numpy state, hit flags)."""
    _, kw, prows, wcap, mcap, kind, n, epoch = SHARD_CASES[case]
    lanes = LANES if len(prows) > 1 else 1
    spec = port.StepSpec(**kw, streams=lanes)
    params = torch.stack([port.make_step_params(
        *p, counter_bits=spec.counter_bits, device=device) for p in prows])
    params = params[0] if lanes == 1 else params
    state = port.init_step_state(spec, wcap, mcap, device=device)
    keys = lane_keys(kind, n) if lanes > 1 else hazard_keys(kind, n,
                                                            seed=case)
    lo, hi = (torch.from_numpy(x).to(device) for x in keys_to_lanes(keys))
    hits = []
    for c, s in enumerate(range(0, n, epoch)):
        nv = lane_n_valid(epoch, c, n - s) if lanes > 1 else min(epoch,
                                                                 n - s)
        _, h = fn(spec, params, state, lo[..., s:s + epoch],
                  hi[..., s:s + epoch], nv)
        merge_halve(spec, params, state)
        hits.append(h.cpu())
    return port.state_to_numpy(state), torch.cat(hits, dim=-1).numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(SHARD_CASES) - 1),
                         ids=[c[0] for c in SHARD_CASES[:-1]])
def test_sharded_kernel_matches_plain_on_card(case):
    """The sharded instances (kernel mode 1b) == step_ref on every state
    leaf and hit flag, with the fold after every epoch: flat and set, 4- and
    8-bit counters, doorkeeper on and off, lanes, integrity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = port.step.launches
    got = run_shard_case(case, port.step, "cuda")
    n, epoch = SHARD_CASES[case][6:8]
    assert port.step.launches - before == -(-n // epoch)
    ref = run_shard_case(case, port.step_ref, "cuda")
    for k in ref[0]:
        np.testing.assert_array_equal(got[0][k], ref[0][k],
                                      err_msg=f"state[{k}]")
    np.testing.assert_array_equal(got[1], ref[1], err_msg="hit flags")


@pytest.mark.gpu
@pytest.mark.parametrize("assoc", [None, 8], ids=["flat", "ways 8"])
def test_sharded_engine_on_card_equals_cpu(assoc):
    """simulate_trace(shards=4, integrity=True) on the card launches the
    step kernel once per epoch and equals the CPU run leaf for leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys = hazard_keys("skewed", 900, seed=3)
    kw = dict(shards=4, integrity=True, merge_every=256, assoc=assoc,
              sample_factor=2, return_state=True)
    before = port.step.launches
    r, st, h = simulate_trace(keys, 40, device="cuda", **kw)
    assert port.step.launches - before == 4
    rc, sc_, hc = simulate_trace(keys, 40, device="cpu", **kw)
    assert r.hits == rc.hits and r.extra["backend"] == "cuda"
    np.testing.assert_array_equal(h.cpu().numpy(), hc.numpy())
    for k in sc_:
        np.testing.assert_array_equal(st[k].cpu().numpy(), sc_[k].numpy(),
                                      err_msg=f"state[{k}]")


def run_adapt_case(case, fn, device):
    """ADAPT_CASES[case] through ``fn`` (step or step_ref) one epoch at a
    time, then merge_halve when sharded and rebalance to the case's next
    quota; returns (numpy state, hit flags)."""
    _, kw, prows, wcap, mcap, kind, n, epoch, quotas = ADAPT_CASES[case]
    lanes = LANES if len(prows) > 1 else 1
    spec = port.StepSpec(**kw, adaptive=True, streams=lanes)
    params = torch.stack([port.make_step_params(
        *p, counter_bits=spec.counter_bits, device=device) for p in prows])
    params = params[0] if lanes == 1 else params
    state = port.init_step_state(spec, wcap, mcap, device=device)
    keys = lane_keys(kind, n) if lanes > 1 else hazard_keys(kind, n,
                                                            seed=case)
    lo, hi = (torch.from_numpy(x).to(device) for x in keys_to_lanes(keys))
    hits = []
    for c, s in enumerate(range(0, n, epoch)):
        nv = lane_n_valid(epoch, c, n - s) if lanes > 1 else min(epoch,
                                                                 n - s)
        _, h = fn(spec, params, state, lo[..., s:s + epoch],
                  hi[..., s:s + epoch], nv)
        if spec.shards > 1:
            merge_halve(spec, params, state)
        port.rebalance(spec, params, state, torch.tensor(
            quotas[c % len(quotas)], dtype=torch.int32, device=device))
        hits.append(h.cpu())
    return port.state_to_numpy(state), torch.cat(hits, dim=-1).numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(ADAPT_CASES) - 1),
                         ids=[c[0] for c in ADAPT_CASES[:-1]])
def test_adaptive_kernel_matches_plain_on_card(case):
    """The adaptive instances (kernel mode 1c) == step_ref on every state
    leaf and hit flag, with the rebalance between epochs: flat and 8 and 16
    ways, 4- and 8-bit counters, doorkeeper on and off, lanes with per-lane
    quotas, shards=4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = port.step.launches
    got = run_adapt_case(case, port.step, "cuda")
    n, epoch = ADAPT_CASES[case][6:8]
    assert port.step.launches - before == -(-n // epoch)
    ref = run_adapt_case(case, port.step_ref, "cuda")
    for k in ref[0]:
        np.testing.assert_array_equal(got[0][k], ref[0][k],
                                      err_msg=f"state[{k}]")
    np.testing.assert_array_equal(got[1], ref[1], err_msg="hit flags")


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(), dict(assoc=4),
                                dict(assoc=8, shards=4)],
                         ids=["flat", "ways 4", "ways 8 shards 4"])
def test_adaptive_engine_on_card_equals_cpu(kw):
    """simulate_trace(adaptive=True) on the card launches the adaptive
    instances once per climb epoch, climbs and rebalances there, and equals
    the CPU run leaf for leaf, with its trajectory and final quota."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys = hazard_keys("wide", 1100, seed=5)
    args = dict(adaptive=True, climb=ClimbSpec(epoch_len=256),
                return_state=True, **kw)
    before = port.step.launches
    r, st, h = simulate_trace(keys, 64, device="cuda", **args)
    assert port.step.launches - before == 5
    rc, sc_, hc = simulate_trace(keys, 64, device="cpu", **args)
    assert r.hits == rc.hits and r.extra["backend"] == "cuda"
    assert (r.extra["trajectory"], r.extra["final_quota"]) == (
        rc.extra["trajectory"], rc.extra["final_quota"])
    np.testing.assert_array_equal(h.cpu().numpy(), hc.numpy())
    for k in sc_:
        np.testing.assert_array_equal(st[k].cpu().numpy(), sc_[k].numpy(),
                                      err_msg=f"state[{k}]")


@pytest.mark.gpu
@pytest.mark.parametrize("assoc", ["8", "0"], ids=["8 ways", "flat"])
def test_hillclimb_cli_on_card_equals_cpu(assoc, tmp_path):
    """The window-adaptation CLI with --static-sweep on the card (no
    --device) writes the rows of its --device cpu run, bar the fields
    that say where and how long it ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import hillclimb
    flags = ["--trace", "phase", "--capacity", "100", "--length", "1024",
             "--epoch-len", "64", "--assoc", assoc, "--static-sweep"]
    before = port.step.launches
    card = hillclimb.main([*flags, "--out", str(tmp_path / "card.json")])
    assert port.step.launches - before == 16 + 5 * 2
    cpu = hillclimb.main([*flags, "--device", "cpu", "--out",
                          str(tmp_path / "cpu.json")])
    for a, b in zip(card, cpu, strict=True):
        assert a["extra"].pop("backend").startswith("cuda")
        assert b["extra"].pop("backend").startswith("plain")
        for row in (a, b):
            row.pop("wall_s")
            row["extra"].pop("grid_wall_s", None)
            row["extra"].pop("device")
        assert a == b


@pytest.mark.gpu
@pytest.mark.parametrize("assoc", [8, None], ids=["8 ways", "flat"])
def test_paper_family_prefix_on_card_equals_cpu(assoc):
    """PF-oltp's first 20,000 accesses (an OLTP-like log of sparse bursts
    over a Zipf page set, check_runs.PF_CELLS) through simulate_trace at
    the cell's capacity and sample factor: the card equals the plain
    version on the CPU leaf for leaf, with every hit flag."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, cap, sf, _ = PF_CELLS["PF-oltp"]
    tr = pf_trace("PF-oltp")[:20_000]
    args = dict(sample_factor=sf, warmup=pf_warmup("PF-oltp", tr),
                assoc=assoc, return_state=True)
    before = port.step.launches
    r, st, h = simulate_trace(tr, cap, device="cuda", **args)
    assert port.step.launches - before == -(-len(tr) // 512)
    rc, sc_, hc = simulate_trace(tr, cap, device="cpu", **args)
    assert r.hits == rc.hits > 0
    np.testing.assert_array_equal(h.cpu().numpy(), hc.numpy())
    for k in sc_:
        np.testing.assert_array_equal(st[k].cpu().numpy(), sc_[k].numpy(),
                                      err_msg=f"state[{k}]")


def run_panel_case(case, fn, device):
    """PANEL_CASES[case] through ``fn`` (step or step_ref) chunk by chunk
    (per-lane counts with lanes); returns (numpy state, hit flags)."""
    _, kw, prows, wcap, mcap, kind, n, chunk = PANEL_CASES[case]
    lanes = LANES if len(prows) > 1 else 1
    spec = port.StepSpec(**kw, streams=lanes)
    params = torch.stack([port.make_step_params(
        *p, counter_bits=spec.counter_bits, device=device) for p in prows])
    params = params[0] if lanes == 1 else params
    state = port.init_step_state(spec, wcap, mcap, device=device)
    keys = lane_keys(kind, n) if lanes > 1 else hazard_keys(kind, n,
                                                            seed=case)
    lo, hi = (torch.from_numpy(x).to(device) for x in keys_to_lanes(keys))
    hits = []
    for c, s in enumerate(range(0, n, chunk)):
        nv = lane_n_valid(chunk, c, n - s) if lanes > 1 else min(chunk,
                                                                 n - s)
        hits.append(fn(spec, params, state, lo[..., s:s + chunk],
                       hi[..., s:s + chunk], nv)[1].cpu())
    return port.state_to_numpy(state), torch.cat(hits, dim=-1).numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(PANEL_CASES)),
                         ids=[c[0] for c in PANEL_CASES])
def test_panel_kernel_matches_plain_on_card(case):
    """The panel instances (kernel mode 1d: S3-FIFO, ARC, LFU) == step_ref
    on every state leaf (ARC's ghost too) and hit flag: 1 to 32 ways, one
    and two main sets, 4- and 8-bit counters, doorkeeper on and off, resets,
    ARC's ghost halves cleared inside a chunk, lanes with per-lane params,
    FP's geometry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = port.step.launches
    got = run_panel_case(case, port.step, "cuda")
    n, chunk = PANEL_CASES[case][6:8]
    assert port.step.launches - before == -(-n // chunk)
    ref = run_panel_case(case, port.step_ref, "cuda")
    for k in ref[0]:
        np.testing.assert_array_equal(got[0][k], ref[0][k],
                                      err_msg=f"state[{k}]")
    np.testing.assert_array_equal(got[1], ref[1], err_msg="hit flags")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["s3fifo", "arc", "lfu"])
@pytest.mark.parametrize("streams", [1, 3])
def test_panel_engine_on_card_equals_cpu(policy, streams):
    """simulate_trace(policy=p) on the card launches the panel instances
    once per chunk (no fallback) and equals the CPU run leaf for leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys = hazard_keys("wide", 1100, seed=5)
    if streams > 1:
        keys = np.stack([hazard_keys("wide", 1100, seed=b)
                         for b in range(streams)])
    args = dict(assoc=8, policy=policy, window_frac=PANEL_FRACS[policy],
                streams=streams, chunk=256, return_state=True)
    before = port.step.launches
    r, st, h = simulate_trace(keys, 64, device="cuda", **args)
    assert port.step.launches - before == 5
    rc, sc_, hc = simulate_trace(keys, 64, device="cpu", **args)
    assert r.hits == rc.hits > 0 and r.extra["backend"] == "cuda"
    np.testing.assert_array_equal(h.cpu().numpy(), hc.numpy())
    for k in sc_:
        np.testing.assert_array_equal(st[k].cpu().numpy(), sc_[k].numpy(),
                                      err_msg=f"state[{k}]")


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
    """More ways than the register-held instances take (129) are no longer
    refused by a limit: the wrapper passes them to the wide instances, and
    only its CUDA-operand check refuses CPU tensors, before anything is
    built or launched."""
    spec = port.StepSpec(width=256, rows=4, dk_bits=1024, window_slots=129,
                         main_slots=129, assoc=129, dk_probes=11)
    state = port.init_step_state(spec, device="cpu")
    lo = torch.zeros(4, dtype=torch.int32)
    probes = port.precompute_probes(spec, lo, lo)
    before = port.step.launches
    with pytest.raises(ValueError, match="CUDA"):
        port._launch(spec, port.make_step_params(2, 120, 96, 500, 7,
                                                 device="cpu"),
                     state, lo, lo, probes, 4,
                     torch.zeros(4, dtype=torch.int32))
    assert port.step.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(STEP12_CASES)),
                         ids=[c[0] for c in STEP12_CASES])
def test_step12_kernel_matches_plain_on_card(case):
    """The stale mesh instances (any rank's), the wide instances and the
    exact path after out-of-range table addresses: the kernel equals the
    plain version, every leaf and hit flag."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = run_step_case(STEP12_CASES[case], port.step, "cuda")
    want = run_step_case(STEP12_CASES[case], port.step_ref, "cpu")
    np.testing.assert_array_equal(got[1], want[1])
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(shards=4, merge_every=256), dict(shards=4, assoc=8,
                                          merge_every=256),
    dict(shards=4, assoc=8, adaptive=True)],
    ids=["flat", "ways 8", "ways 8 adaptive"])
@pytest.mark.parametrize("exchange", ["chunk", "stale"])
def test_mesh_engine_on_card_equals_cpu(kw, exchange):
    """A one-rank mesh (no process group) on the card equals the same run
    on the CPU, every leaf of the canonical state and every hit flag; chunk
    mode also equals the unmeshed sharded run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.distributed.mesh import make_shard_mesh
    keys = hazard_keys("wide", 1_536, seed=5)
    kw = dict(kw, mesh_exchange=exchange, climb=ClimbSpec(epoch_len=256))
    out = [simulate_trace(keys, 150, warmup=200, mesh=make_shard_mesh(4),
                          return_state=True, device=dev, **kw)
           for dev in ("cuda", "cpu")]
    (r, st, h), (rc, stc, hc) = out
    assert r.hits == rc.hits and torch.equal(h.cpu(), hc)
    for k in stc:
        assert torch.equal(st[k].cpu(), stc[k]), k
    if exchange == "chunk":
        kw.pop("mesh_exchange")
        assert simulate_trace(keys, 150, warmup=200, device="cuda",
                              **kw).hits == r.hits


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


EDGE_BATCHES = [0, 1, 3, 8, 50_000]


def card_sketch(cfg, seed):
    """check_runs.random_sketch on the card."""
    return sc.sketch_state_from_numpy(cfg, random_sketch(cfg, seed),
                                      device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("batch", EDGE_BATCHES)
@pytest.mark.parametrize("case", range(len(SKETCH_EDGE_CFGS)))
def test_edge_estimate_admit_reset_match_plain_on_card(case, batch):
    """The estimate, both paths of the admit and the reset == their plain
    versions at the edge geometries (rows 1-8, one- and two-word rows,
    one-word doorkeepers, 0-20 doorkeeper probes), on a random sketch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = sc.DeviceSketchConfig(**SKETCH_EDGE_CFGS[case])
    state = card_sketch(cfg, case)
    keys = np.random.default_rng(batch).integers(0, 1 << 63, 2 * batch,
                                                 dtype=np.uint64)
    lanes = [torch.from_numpy(x).cuda() for k in (keys[:batch], keys[batch:])
             for x in keys_to_lanes(k)]
    assert torch.equal(sketch_estimate.estimate(cfg, state, *lanes[:2]),
                       sketch_estimate.estimate_ref(cfg, state, *lanes[:2]))
    want = admission.admission_ref(cfg, state, *lanes)
    assert torch.equal(admission.admit(cfg, state, *lanes), want)
    if batch:
        for per_thread in (False, True):
            out = torch.empty(batch, dtype=torch.bool, device="cuda")
            admission._launch(cfg, state, *lanes, out, per_thread=per_thread)
            assert torch.equal(out, want), per_thread
    plain = {k: v.clone() for k, v in state.items()}
    sketch_reset.reset(cfg, state)
    sketch_reset.reset_ref(cfg, plain)
    for k in state:
        assert torch.equal(state[k], plain[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(SKETCH_EDGE_CFGS)))
def test_edge_add_matches_plain_on_card(case):
    """The add kernel == add_ref at the edge geometries (0-20 doorkeeper
    probes, past 8 by its loop instance): two batches of mixed keys from a
    zeroed sketch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = sc.DeviceSketchConfig(**SKETCH_EDGE_CFGS[case])
    kernel = sc.init_state(cfg, device="cuda")
    plain = sc.init_state(cfg, device="cuda")
    for seed in (case, case + 100):
        keys = mixed_keys(seed, 200)
        lo, hi = (torch.from_numpy(x).cuda() for x in keys_to_lanes(keys))
        sketch_update.add(cfg, kernel, lo, hi)
        sketch_update.add_ref(cfg, plain, lo, hi)
        for k in kernel:
            assert torch.equal(kernel[k], plain[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("dk_probes", [9, 13, 20])
def test_add_loop_instance_matches_plain_on_card(dk_probes):
    """The add's loop instance (more than 8 doorkeeper probes) == add_ref
    over batches of several tiles (its tile is 896, 608 and 384 keys at 9,
    13 and 20 probes), repeated keys among them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = sc.DeviceSketchConfig(width=1024, rows=4, cap=15, dk_bits=4096,
                                dk_probes=dk_probes)
    kernel = sc.init_state(cfg, device="cuda")
    plain = sc.init_state(cfg, device="cuda")
    before = sketch_update.add.launches
    for seed in (dk_probes, dk_probes + 100):
        keys = mixed_keys(seed, 2_000)
        lo, hi = (torch.from_numpy(x).cuda() for x in keys_to_lanes(keys))
        sketch_update.add(cfg, kernel, lo, hi)
        sketch_update.add_ref(cfg, plain, lo, hi)
        for k in kernel:
            assert torch.equal(kernel[k], plain[k]), k
    assert sketch_update.add.launches - before == 2
    assert int(kernel["counters"].ne(0).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kw,every", [
    (dict(), 8_192), (dict(shards=4), 8_192),
    (dict(adaptive=True), 8_192)], ids=["static", "sharded", "adaptive"])
def test_checkpointed_engine_on_card_equals_plain_run(kw, every, tmp_path):
    """At F's geometry (C=65,536, assoc=8) on 40,000 accesses: the
    checkpointed run on the card and the resume from its earliest kept
    checkpoint equal the plain run on the card (hit flags, every state
    leaf, trajectory and final quota)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.device_simulate import DeviceWTinyLFU, resume_trace
    from repro_torch.traces.synthetic import zipf_trace
    tr = zipf_trace(40_000, n_items=200_000, alpha=0.9, seed=11)
    climb = ClimbSpec(epoch_len=4_096)
    cfg = DeviceWTinyLFU(65_536, assoc=8, **kw)
    want = cfg.run(tr, warmup=8_000, climb=climb, return_state=True)
    d = tmp_path / "ck"
    got = cfg.run(tr, warmup=8_000, climb=climb, checkpoint_dir=str(d),
                  checkpoint_every=every, return_state=True)
    kept = sorted(d.iterdir())
    first = int(kept[0].name[5:])
    for x in kept[1:]:
        shutil.rmtree(x)
    res = resume_trace(tr, cfg, checkpoint_dir=str(d), warmup=8_000,
                       climb=climb,
                       checkpoint_every=every, return_state=True)
    assert res[0].extra["resumed_at"] == first
    for r, st, h in (got, res):
        assert r.hits == want[0].hits and r.extra["backend"] == "cuda"
        assert torch.equal(h, want[2])
        for k in st:
            assert torch.equal(st[k], want[1][k]), k
        for k in ("trajectory", "final_quota"):
            assert r.extra.get(k) == want[0].extra.get(k), k


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(assoc=8), dict(), dict(assoc=8, shards=2, merge_every=128),
    dict(shards=2, merge_every=128), dict(assoc=8, adaptive=True)],
    ids=["set", "flat", "set-sharded", "flat-sharded", "set-adaptive"])
def test_corrupted_stored_probes_card_equals_cpu(kw):
    """Every stored probe of both tables flipped (bit 30 or 31) at 512
    accesses: the kernel clamps the far-out word indices as the plain
    version (and the reference) does, so the card's run equals the CPU's
    leaf for leaf, with no fault."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.check_runs import corrupt_stored_probes
    from repro_torch.core import faults
    from repro_torch.core.device_simulate import DeviceWTinyLFU
    keys = hazard_keys("wide", 1_536, seed=5)
    cfg = DeviceWTinyLFU(150, sample_factor=2, **kw)

    def hook(cursor, state):
        return (corrupt_stored_probes(faults, cfg.spec(), state)
                if cursor == 512 else None)
    out = [cfg.run(keys, warmup=200, climb=ClimbSpec(epoch_len=256),
                   checkpoint_every=512, fault_hook=hook, return_state=True,
                   device=dev) for dev in ("cuda", "cpu")]
    (r, st, h), (rc, stc, hc) = out
    assert r.hits == rc.hits and torch.equal(h.cpu(), hc)
    for k in stc:
        assert torch.equal(st[k].cpu(), stc[k]), k


@pytest.mark.gpu
def test_async_save_snapshots_card_tensors_in_page_locked_buffers(tmp_path):
    """AsyncCheckpointer.save copies a card tensor into its key's
    page-locked buffer before it returns: a write on the card right after
    it does not reach the checkpoint, and a buffer grown or reused by the
    next save leaves the first checkpoint as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.checkpoint import store
    d = str(tmp_path)
    ck = store.AsyncCheckpointer(d, keep=5)
    x = torch.arange(1_000, dtype=torch.int32, device="cuda")
    ck.save(1, {"x": x})
    x.add_(7)
    ck.save(2, {"x": torch.cat([x, x])})
    x.mul_(3)
    ck.save(3, {"x": x})
    ck.wait()
    want = {1: torch.arange(1_000, dtype=torch.int32),
            2: torch.cat([torch.arange(1_000, dtype=torch.int32) + 7] * 2),
            3: (torch.arange(1_000, dtype=torch.int32) + 7) * 3}
    for step, w in want.items():
        got = store.restore_checkpoint(d, step, {"x": w}, device="cpu")
        assert torch.equal(got["x"], w), step


@pytest.mark.gpu
def test_dependent_launches_in_one_stream_match_plain():
    """(add, reset, estimate, admit) rounds queued on one stream with no
    host sync between them (the reset and estimate are programmatic
    dependents of the kernel before each) == the plain sequence, at S's
    geometry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ops import make_config
    cfg = make_config(65_536)
    rng = np.random.default_rng(20)
    keys = rng.integers(0, 1 << 40, (3, 4096), dtype=np.uint64)
    queries = rng.integers(0, 1 << 40, 5000, dtype=np.uint64)
    q = [torch.from_numpy(x).cuda() for x in keys_to_lanes(queries)]
    v = [x.roll(1) for x in q]
    outs = []
    for add, reset, est, adm in (
            (sketch_update.add, sketch_reset.reset, sketch_estimate.estimate,
             admission.admit),
            (sketch_update.add_ref, sketch_reset.reset_ref,
             sketch_estimate.estimate_ref, admission.admission_ref)):
        state = sc.init_state(cfg, device="cuda")
        got = []
        for batch in keys:
            lo, hi = (torch.from_numpy(x).cuda() for x in keys_to_lanes(batch))
            add(cfg, state, lo, hi)
            got.append(est(cfg, state, *q))
            reset(cfg, state)
            got.append(est(cfg, state, *q))
            add(cfg, state, lo, hi)
            got.append(adm(cfg, state, *q, *v))
        torch.cuda.synchronize()
        outs.append((got, state))
    (got, k_state), (want, p_state) = outs
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k in k_state:
        assert torch.equal(k_state[k], p_state[k]), k


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


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(FB_CASES) - 1),
                         ids=[c[0] for c in FB_CASES[:-1]])
def test_flash_bwd_kernel_matches_plain_on_card(case):
    """The training forward (output and LSE) and the backward kernel
    against their plain versions on chip_smoke.py phase 42's cases (dq,
    dk, dv within FB_TOL of their largest), each launch counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, B, S, Hq, Hkv, D, cap = FB_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(case)
    q, do = (torch.randn((B, S, Hq, D), generator=g,
                         device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    n_fwd = flash_attention.flash_attention.launches
    n_bwd = flash_attention.flash_attention_bwd.launches
    out, lse = flash_attention._launch_train(q, k, v, cap)
    got = flash_attention.flash_attention_bwd(q, k, v, out, do, lse,
                                              softcap=cap)
    want_o, want_l = flash_attention.flash_attention_ref(
        q, k, v, softcap=cap, return_lse=True)
    want = flash_attention.flash_attention_bwd_ref(q, k, v, out, do, lse,
                                                   softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == n_fwd + 1
    assert flash_attention.flash_attention_bwd.launches == n_bwd + 1
    assert float((out.float() - want_o.float()).abs().max()) <= 2e-2
    assert float((lse - want_l).abs().max()) <= FB_LSE_TOL
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        err = float((a.float() - b.float()).abs().max())
        assert err <= FB_TOL * float(b.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["B3 G4 D128 ragged", "B3 G5 D64 cap",
                                  "TR"])
def test_flash_bwd_kernel_is_deterministic_on_card(name):
    """Two calls of the backward kernel on the same inputs give bit-equal
    dq, dk and dv (its dQ partials are added in a fixed order), at a
    ragged case of each wgmma head dim and at TR's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, B, S, Hq, Hkv, D, cap = next(c for c in FB_CASES if c[0] == name)
    g = torch.Generator(device="cuda").manual_seed(5)
    q, do = (torch.randn((B, S, Hq, D), generator=g,
                         device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g,
                        device="cuda").bfloat16() for _ in range(2))
    out, lse = flash_attention._launch_train(q, k, v, cap)
    first = flash_attention.flash_attention_bwd(q, k, v, out, do, lse,
                                                softcap=cap)
    second = flash_attention.flash_attention_bwd(q, k, v, out, do, lse,
                                                 softcap=cap)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(a).all()) for a in first)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_flash_kernels_launch_from_a_fresh_thread():
    """The flash kernels build their TMA maps in whatever thread launches
    them (autograd runs backward in a worker thread): a thread that has
    launched nothing before gets the same results as the main thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import threading
    g = torch.Generator(device="cuda").manual_seed(3)
    q, do = (torch.randn((2, 130, 8, 64), generator=g,
                         device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn((2, 130, 2, 64), generator=g,
                        device="cuda").bfloat16() for _ in range(2))

    def both():
        out, lse = flash_attention._launch_train(q, k, v, 0.0)
        return (out, lse) + flash_attention.flash_attention_bwd(
            q, k, v, out, do, lse)
    want = both()
    got = []
    th = threading.Thread(target=lambda: got.append(both()))
    th.start()
    th.join()
    torch.cuda.synchronize()
    assert len(got) == 1
    assert all(torch.equal(a, b) for a, b in zip(got[0], want))


def test_flash_train_launch_refuses_cpu_tensors():
    """The training instance's launch path never takes CPU tensors (the
    autograd Function routes them to the plain version), and a refused
    launch is not counted."""
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    before = flash_attention.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention._launch_train(q, q, q, 0.0)
    assert flash_attention.flash_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e",
                                  "llama4_maverick_400b_a17b",
                                  "llava_next_34b", "musicgen_medium",
                                  "zamba2_1p2b", "xlstm_1p3b"])
def test_serving_family_engine_on_card(arch):
    """Each serving family's smoke engine on the card (bf16): the stats of
    the JAX engine (they depend on the prompts and the schedule only),
    tokens in range, and the flash kernel launched for every attention
    layer of every extend (per segment of snapshot_every blocks for the
    SSM families; none for xLSTM)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.check_runs import FAMILY_SERVE_PINS, numpy_params
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.driver import make_workload
    cfg = get_config(arch, smoke=True)
    eng = ServeEngine(Model(cfg), params_from_numpy(cfg, numpy_params(cfg, 0)),
                      max_batch=4, max_len=128, block_size=8, pool_slots=48)
    for p in make_workload(cfg, 16, seed=1):
        eng.submit(p, 3)
    reqs = list(eng.queue)
    flash_attention.flash_attention.launches = 0
    out = eng.run()
    assert eng.stats == FAMILY_SERVE_PINS[arch][0]
    toks = [t for v in out.values() for s in v
            for t in (s if isinstance(s, list) else [s])]
    assert len(out) == 16 and all(0 <= t < cfg.vocab_size for t in toks)
    seg = eng.snapshot_every * eng.block_size
    extends = sum(
        -(-(len(r.prompt) - r.prefix_blocks_reused * eng.block_size)
          // (seg if cfg.family in ("hybrid_ssm", "xlstm") else 10 ** 9))
        for r in reqs)
    per = {"hybrid_ssm": cfg.n_layers // max(cfg.attn_every, 1),
           "xlstm": 0}.get(cfg.family, cfg.n_layers)
    assert flash_attention.flash_attention.launches == per * extends

"""The port's plain step (repro_torch.kernels.sketch_step.step_ref) against
the JAX package's step_ref: bitwise, on every state leaf and every hit flag.

Both sides get the same key lanes (numpy, from a seed), the same params and
the same initial state; JAX runs on the CPU.  Covers the flat specs of
tests/test_sketch_step.py, set-associative specs at assoc 4 and 8 (with set
counts small enough that a key's two main sets and the candidate's sets
alias), 8-bit counters, a reset that straddles a chunk boundary, an n_valid
tail and warmup counting.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import sketch_step as jref
from repro_torch.core.device_simulate import run_chunks
from repro_torch.kernels import sketch_step as port
from repro_torch.kernels.sketch_common import keys_to_lanes

# the plain step issues thousands of tiny ops: intra-op threads only spin,
# and under parallel test workers they contend for every core
torch.set_num_threads(1)

# (StepSpec kwargs, make_step_params args, window_cap, main_cap)
FLAT = [
    (dict(width=256, rows=4, dk_bits=1024, window_slots=2, main_slots=60),
     (2, 60, 48, 500, 7, 0), None, None),
    (dict(width=1024, rows=2, dk_bits=0, window_slots=5, main_slots=45),
     (5, 45, 36, 400, 15, 0), None, None),
    (dict(width=512, rows=1, dk_bits=2048, window_slots=1, main_slots=30),
     (1, 30, 24, 0, 3, 0), None, None),                 # never resets
    (dict(width=2048, rows=5, dk_bits=4096, window_slots=10, main_slots=90),
     (10, 90, 72, 1000, 1, 0), None, None),             # cap 1
]
SET = [
    # 2 window sets, 4 main sets: km1 == km2 and candidate/key aliasing
    (dict(width=256, rows=4, dk_bits=1024, window_slots=8, main_slots=16,
          assoc=4), (6, 14, 11, 300, 7, 0), 6, 14),
    # one window set with padding, 8 main sets of 8 ways, 8-bit counters
    (dict(width=512, rows=3, dk_bits=2048, window_slots=8, main_slots=64,
          assoc=8, counter_bits=8), (3, 60, 48, 400, 30, 0), 3, 60),
    # zero-way window sets (window_cap below the set count)
    (dict(width=256, rows=4, dk_bits=0, window_slots=16, main_slots=32,
          assoc=4), (2, 30, 24, 250, 15, 0), 2, 30),
]


def _keys(seed, n, universe):
    return np.random.default_rng(seed).integers(0, universe, size=n,
                                                dtype=np.uint64)


def run_jax(kw, pargs, wcap, mcap, keys, n_valid=None):
    spec = jref.StepSpec(**kw)
    params = jref.make_step_params(*pargs, counter_bits=spec.counter_bits)
    state = jref.init_step_state(spec, wcap, mcap)
    lo, hi = keys_to_lanes(keys)
    state, hits = jref.step_ref(spec, params, state, jnp.asarray(lo),
                                jnp.asarray(hi), n_valid)
    return {k: np.asarray(v) for k, v in state.items()}, np.asarray(hits)


def port_inputs(kw, pargs, wcap, mcap, keys):
    spec = port.StepSpec(**kw)
    params = port.make_step_params(*pargs, counter_bits=spec.counter_bits,
                                   device="cpu")
    state = port.init_step_state(spec, wcap, mcap, device="cpu")
    lo, hi = (torch.from_numpy(x) for x in keys_to_lanes(keys))
    return spec, params, state, lo, hi


def run_port(kw, pargs, wcap, mcap, keys, chunk=None):
    """The engine's chunk runner: the last chunk padded past its n_valid."""
    spec, params, state, lo, hi = port_inputs(kw, pargs, wcap, mcap, keys)
    state, hits = run_chunks(spec, params, state, lo, hi,
                             chunk or len(keys))
    return port.state_to_numpy(state), hits.numpy()


def assert_same(a, b):
    sa, ha = a
    sb, hb = b
    assert sorted(sa) == sorted(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=f"state[{k}]")
    np.testing.assert_array_equal(ha, hb, err_msg="hit flags")


@pytest.mark.parametrize("case", range(len(FLAT) + len(SET)))
def test_step_ref_bitwise(case):
    kw, pargs, wcap, mcap = (FLAT + SET)[case]
    keys = _keys(case, 500, 300)
    assert_same(run_jax(kw, pargs, wcap, mcap, keys),
                run_port(kw, pargs, wcap, mcap, keys))


@pytest.mark.parametrize("case", [0, len(FLAT)])
def test_reset_straddles_chunks(case):
    """W=500/300 with 256-access chunks: the reset lands mid-chunk and the
    chunked port run equals the unchunked JAX run."""
    kw, pargs, wcap, mcap = (FLAT + SET)[case]
    keys = _keys(100 + case, 700, 200)
    ref = run_jax(kw, pargs, wcap, mcap, keys)
    got = run_port(kw, pargs, wcap, mcap, keys, chunk=256)
    assert_same(ref, got)
    size = int(ref[0]["regs"][port.R_SIZE])
    assert size < 700 and int(ref[0]["regs"][port.R_T]) == 700


@pytest.mark.parametrize("case", [1, len(FLAT) + 1])
def test_n_valid_tail_and_warmup(case):
    """Accesses past n_valid leave the state untouched and report 0 (one
    step call with n_valid, and the runner's padded last chunk); hits count
    from the warmup access on."""
    kw, pargs, wcap, mcap = (FLAT + SET)[case]
    pargs = pargs[:5] + (250,)
    keys = _keys(200 + case, 600, 150)
    ref = run_jax(kw, pargs, wcap, mcap, keys, n_valid=450)
    spec, params, state, lo, hi = port_inputs(kw, pargs, wcap, mcap, keys)
    state, hits = port.step(spec, params, state, lo, hi, 450)
    got = port.state_to_numpy(state), hits.numpy()
    assert_same(ref, got)
    assert_same((ref[0], ref[1][:450]),
                run_port(kw, pargs, wcap, mcap, keys[:450], chunk=200))
    regs = got[0]["regs"]
    assert regs[port.R_T] == 450 and not got[1][450:].any()
    assert 0 < regs[port.R_HITS] == got[1][250:450].sum() < got[1].sum()


def test_state_carries_across_from_jax():
    """A JAX-written state, carried into the port mid-trace, continues to
    the same final state as the uninterrupted JAX run."""
    kw, pargs, wcap, mcap = SET[0]
    keys = _keys(7, 600, 250)
    ref = run_jax(kw, pargs, wcap, mcap, keys)
    head, _ = run_jax(kw, pargs, wcap, mcap, keys[:350])
    spec = port.StepSpec(**kw)
    state = port.state_from_numpy(spec, head, "cpu")
    lo, hi = (torch.from_numpy(x) for x in keys_to_lanes(keys[350:]))
    state, hits = port.step_ref(spec,
                                port.make_step_params(*pargs, device="cpu"),
                                state, lo, hi)
    assert_same((ref[0], ref[1][350:]), (port.state_to_numpy(state),
                                        hits.numpy()))


def test_state_from_numpy_checks_layout():
    spec = port.StepSpec(width=256, window_slots=2, main_slots=8)
    arrays = port.state_to_numpy(port.init_step_state(spec, device="cpu"))
    arrays["wmeta"] = arrays["wmeta"][:1]
    with pytest.raises(ValueError, match="wmeta"):
        port.state_from_numpy(spec, arrays, "cpu")


def test_step_api_defaults_to_the_card():
    """Params and state are made on the card unless the caller asks for the
    CPU; without a card they raise rather than land on the CPU, where
    ``step`` would quietly run the plain version."""
    spec = port.StepSpec(width=256, window_slots=2, main_slots=8)
    arrays = port.state_to_numpy(port.init_step_state(spec, device="cpu"))
    makers = [lambda: port.make_step_params(2, 8, 6, 100, 7),
              lambda: port.init_step_state(spec)["counters"],
              lambda: port.state_from_numpy(spec, arrays)["regs"]]
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()



def test_shards1_is_the_identical_program():
    """shards=1 (the default) records the identical program: the
    exactness-ladder pin, through the port's fingerprint registry (R7,
    repro_torch.analysis.program_lint), as the reference pins its own
    (tests/test_sketch_step.py)."""
    from repro_torch.analysis.program_lint import (assert_identical_program,
                                                   pin_program_text)
    assert_identical_program("shards1", device="cpu")
    # ... and the sharded program is genuinely different: its launches
    # carry the [global || delta] halves and shard widths
    base = pin_program_text("cpu")
    sharded = pin_program_text("cpu", shards=2)
    assert sharded != base
    assert "halves=2" in sharded and "halves=1" in base

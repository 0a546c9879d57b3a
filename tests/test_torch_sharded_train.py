"""The port's sharded training (``distributed.shardings.ShardingPolicy``
over a ``RankGrid``) on gloo ranks on the CPU, against its one-rank step.

The four architectures of the reference's lowering test
(tests/test_distributed.py, its config edits, fp32 compute) take two
AdamW steps on the grids (2, 1), (1, 2) and (2, 2), through
``distributed.launch.run_ranks`` (bodies in tests/torch_sharded_ranks.py),
while this process runs the one-rank references.

Tolerances, as |sharded - one rank| over max |one rank| per master
leaf: every element within 1e-5 of the one-rank step that takes the
grid's data-parallel blocks as its microbatches (it sums the same
per-block gradients; only the norm's reduction order differs, 1.2e-7
measured).  Against the one-rank step on the whole batch (the blocks'
gradients summed in another order) all but 0.5% of each leaf's elements
within 1e-5, and those few within ``R.ADAM_MOVE`` a step in absolute
terms: AdamW divides the first moment by the root of the second, so an
element whose gradient is within rounding of zero, or whose gradients
nearly cancel over the two steps, moves by up to the learning rate on a
rounding difference (at most 3 elements of a leaf measured, 1 of xLSTM's
512-element sLSTM bias).
Losses: 1e-5 relative.  A bf16 case stays within 1.5x the reference's
own bf16-vs-fp32 distance.

``train()`` is run in fp32 compute by patching the driver's
``get_config`` (``R.fp32_config``), in the ranks and here.
"""
import concurrent.futures
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
from repro.checkpoint.store import restore_checkpoint as jax_restore
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw, wsd as jax_wsd
from repro.train import build_train_step as jax_build_train_step
from repro.train import make_train_state as jax_make_train_state
from repro.train.train_step import TrainState as JaxTrainState
from repro_torch.check_runs import numpy_params
from repro_torch.checkpoint.store import latest_step
from repro_torch.distributed.launch import run_ranks
import repro_torch.train.driver as driver
from repro_torch.train.driver import train

GRIDS2 = [(2, 1), (1, 2)]
CASES2 = [dict(arch=a, grid=g) for a in R.ARCHS for g in GRIDS2]
MICRO = dict(arch="qwen3-4b", grid=(2, 1), microbatches=2)
CASES4 = ([dict(arch=a, grid=(2, 2)) for a in R.ARCHS]
          + [dict(arch="qwen3-4b", grid=(2, 2), cast_once=False),
             dict(arch="qwen3-4b", grid=(2, 2), dtype="bfloat16"),
             dict(arch="qwen3-4b", grid=(2, 2), dtype="bfloat16",
                  cast_once=False),
             dict(arch="qwen3-4b", grid=(2, 2), opt="adafactor"),
             dict(arch="zamba2-1.2b", grid=(2, 2), opt="adafactor")])


def grid4(rank, cases, root):
    return R.sharded_cases(rank, cases), R.driver_resume(rank, root)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The gloo runs, started together; their results when asked for."""
    root = str(tmp_path_factory.mktemp("sharded"))
    pool = concurrent.futures.ThreadPoolExecutor(3)
    on = {g: [c for c in CASES2 if c["grid"] == g] for g in GRIDS2}
    twos = {(2, 1): pool.submit(run_ranks, R.grid21, 2, root,
                                on[(2, 1)] + [MICRO], root, timeout=240),
            (1, 2): pool.submit(run_ranks, R.sharded_cases, 2, root,
                                on[(1, 2)], timeout=240)}
    four = pool.submit(run_ranks, grid4, 4, root, CASES4, root,
                       timeout=240)

    def two():
        by_grid = {(2, 1): iter(twos[(2, 1)].result()[0][0]),
                   (1, 2): iter(twos[(1, 2)].result()[0])}
        return [next(by_grid[c["grid"]]) for c in CASES2]
    yield {"two": two, "micro": lambda: twos[(2, 1)].result()[0][0][-1],
           "preempt": lambda: twos[(2, 1)].result()[0][1],
           "four": lambda: four.result()[0], "root": root}
    pool.shutdown(wait=True)


@pytest.fixture
def fp32_driver(monkeypatch):
    monkeypatch.setattr(driver, "get_config", R.fp32_config)


@functools.lru_cache(maxsize=None)
def uninterrupted(root: str) -> tuple:
    """The losses of an uninterrupted one-rank train() of four steps."""
    out = os.path.join(root, "cont")
    train(steps=4, out_dir=out, **R.DRIVER)
    return tuple(R.driver_losses(out))


def rel(got, want) -> float:
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def assert_masters_close(got: dict, want: dict, tol: float,
                         frac: float = 0.0, bound: float = 0.0, what=""):
    """Per leaf, all but ``frac`` of the elements within ``tol`` of the
    leaf's largest magnitude, and those within ``bound`` absolute."""
    assert got.keys() == want.keys()
    for k in want:
        scale = np.max(np.abs(want[k])) + 1e-12
        diff = np.abs(got[k] - want[k])
        off = diff > tol * scale
        assert off.sum() <= frac * off.size, (what, k, int(off.sum()),
                                              rel(got[k], want[k]))
        assert not off.any() or diff.max() <= bound, (what, k,
                                                      float(diff.max()))


def dp(grid) -> int:
    return grid[0]


@functools.lru_cache(maxsize=None)
def one_rank(items: tuple) -> dict:
    return R.run_case(dict(items))


def check(got, case, frac=5e-3):
    plain = tuple(sorted((k, v) for k, v in case.items() if k != "grid"))
    blocks = one_rank(plain + (("microbatches", dp(case["grid"])),))
    whole = one_rank(plain)
    np.testing.assert_allclose(got["loss"], blocks["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], whole["loss"], rtol=1e-5)
    assert_masters_close(got["params"], blocks["params"], 1e-5, what=case)
    assert_masters_close(got["params"], whole["params"], 1e-5, frac,
                         R.ADAM_MOVE * len(got["loss"]), what=case)


def jax_masters(dtype, steps=2) -> dict:
    """The JAX package's unsharded step on the bf16 case's weights."""
    cfg = R.case_cfg(dict(arch="qwen3-4b"))
    jcfg = jax_get_config("qwen3-4b", smoke=True).replace(
        compute_dtype=getattr(jnp, dtype), **R.edits("qwen3-4b"))
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, R.SEED))
    opt = jax_adamw(jax_wsd(*R.LR))
    state = JaxTrainState(params=params, opt=opt.init(params),
                          step=jnp.zeros((), jnp.int32))
    step = jax.jit(jax_build_train_step(jax_build_model(jcfg), opt,
                                        loss_chunk=R.CHUNK))
    for i in range(steps):
        state, _ = step(state, {"tokens": jnp.asarray(R.tokens(cfg, i))})
    return R.flat(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)), state.params))


def test_bf16_case_within_the_references_own_distance(ranks):
    """(2, 2) in bf16 compute: per leaf, its distance from the JAX fp32
    step within 1.5x the JAX bf16 step's distance from it (or 1e-5)."""
    f32, b16 = jax_masters("float32"), jax_masters("bfloat16")
    got = ranks["four"]()[0][CASES4.index(
        dict(arch="qwen3-4b", grid=(2, 2), dtype="bfloat16"))]["params"]
    for k in f32:
        assert rel(got[k], f32[k]) <= max(1.5 * rel(b16[k], f32[k]),
                                          1e-5), k


@pytest.mark.parametrize("case", CASES2,
                         ids=[f"{c['arch']}-{c['grid']}" for c in CASES2])
def test_two_rank_grids_equal_one_rank_step(ranks, case):
    check(ranks["two"]()[CASES2.index(case)], case)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_grid_2x2_equals_one_rank_step(ranks, arch):
    i = CASES4.index(dict(arch=arch, grid=(2, 2)))
    check(ranks["four"]()[0][i], CASES4[i])


def test_cast_params_once_false_gives_the_same_numbers_in_fp32(ranks):
    """Gathering the fp32 masters and casting them after the gather gives
    the bits that gathering their cast gives."""
    res = ranks["four"]()[0]
    base = dict(arch="qwen3-4b", grid=(2, 2))
    a = res[CASES4.index(base)]
    b = res[CASES4.index(dict(base, cast_once=False))]
    assert a["loss"] == b["loss"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])


def test_cast_params_once_false_in_bf16_equals_one_rank_step(ranks):
    """In bf16 compute the knob changes the numbers, in the reference too
    (the embedding's rows are taken and their gradients summed in fp32):
    the sharded run with it equals the one-rank step with it."""
    case = dict(arch="qwen3-4b", grid=(2, 2), dtype="bfloat16",
                cast_once=False)
    got = ranks["four"]()[0][CASES4.index(case)]
    plain = tuple(sorted((k, v) for k, v in case.items() if k != "grid"))
    blocks = one_rank(plain + (("microbatches", 2),))
    np.testing.assert_allclose(got["loss"], blocks["loss"], rtol=1e-5)
    assert_masters_close(got["params"], blocks["params"], 1e-5, 5e-3,
                         R.ADAM_MOVE * len(got["loss"]))


def test_grid_2x1_with_microbatches_equals_one_rank_step(ranks):
    """Two microbatches on each of two data-parallel ranks: the one-rank
    step over the same four microbatches, summed in another order."""
    got = ranks["micro"]()
    want = one_rank((("arch", MICRO["arch"]), ("microbatches", 4)))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert_masters_close(got["params"], want["params"], 1e-5, 5e-3,
                         R.ADAM_MOVE * len(got["loss"]))


def test_preemption_of_one_rank_stops_the_grid_and_resumes(ranks,
                                                           fp32_driver):
    """SIGTERM reaching one rank of (2, 1) during step 2: every rank
    checkpoints step 2 and stops; the same call resumes, and the four
    losses equal an uninterrupted one-rank run's."""
    step, first, resumed = ranks["preempt"]()
    assert step == 2 and len(first) == 2 and len(resumed) == 4
    want = uninterrupted(ranks["root"])
    np.testing.assert_allclose(resumed, want, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-1.2b"])
def test_adafactor_sharded_equals_one_rank_step(ranks, arch):
    """Adafactor's factored means, its vr mean and its RMS clip are
    all-reduced over the axes that split each leaf."""
    case = dict(arch=arch, grid=(2, 2), opt="adafactor")
    check(ranks["four"]()[0][CASES4.index(case)], case, frac=0.0)


def test_checkpoint_from_2x2_resumes_on_4x1_one_rank_and_jax(ranks,
                                                            fp32_driver):
    """train() on (2, 2) for two steps writes a canonical checkpoint;
    resumed on (4, 1) and on one rank, the next two losses equal an
    uninterrupted one-rank run's; the reference's restore_checkpoint
    reads it into the JAX train state."""
    resumed = ranks["four"]()[1]
    first = os.path.join(ranks["root"], "grid22")
    ckpt = os.path.join(first, "ckpt")
    assert latest_step(ckpt) == 2
    one = os.path.join(ranks["root"], "one")
    shutil.copytree(first, one)
    train(steps=4, out_dir=one, **R.DRIVER)
    want = uninterrupted(ranks["root"])
    assert len(want) == 4 and len(resumed) == 4
    np.testing.assert_allclose(resumed, want, rtol=1e-5)
    np.testing.assert_allclose(R.driver_losses(one), want, rtol=1e-5)

    jm = jax_build_model(jax_get_config("qwen3-4b", smoke=True))
    jopt = jax_adamw(jax_wsd(1e-3, 1, 4, 4))
    template = jax.eval_shape(lambda k: jax_make_train_state(jm, jopt, k),
                              jax.random.PRNGKey(0))
    payload = jax_restore(ckpt, 2, {"state": template})
    assert int(payload["state"].step) == 2
    assert int(payload["state"].opt["step"]) == 2
    # the masters rank 0 gathered, read back by both packages alike
    from repro_torch.checkpoint.store import restore_checkpoint
    port = restore_checkpoint(ckpt, 2, {"state": (jax.tree_util.tree_map(
        lambda a: torch.empty(a.shape, device="meta"),
        template.params),)}, device="cpu")["state"][0]
    want = R.flat(port)
    got = R.flat(jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a)), payload["state"].params))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

"""Rank bodies of tests/test_torch_sharded_train.py and
tests/test_torch_pipeline_compression.py: module-level functions that
``repro_torch.distributed.launch.run_ranks`` calls on each gloo rank, and
the cases they share with the parent.  Not a test module; it imports
nothing of jax, so a rank starts quickly.

A training case is a dict: ``arch``, ``grid`` (the rank grid's shape; None
for the plain one-rank step), ``opt`` ("adamw" or "adafactor"), ``dtype``
(the compute dtype's name), ``cast_once``, ``steps``, ``each`` and
``microbatches``.  Its weights are
``check_runs.numpy_params`` of the reference's lowering-test config
(tests/test_distributed.py), so the JAX package can take the same ones.
"""
import os
import shutil
import signal

import numpy as np
import torch

from repro_torch.check_runs import numpy_params
from repro_torch.configs import get_config
from repro_torch.distributed.compression import compressed_allreduce_int8
from repro_torch.distributed.mesh import make_debug_mesh
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.distributed.shardings import ShardingPolicy
from repro_torch.models import Model
from repro_torch.models.common import NULL_POLICY, leaf_tree
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import make_optimizer, wsd
import repro_torch.train.driver as driver
from repro_torch.checkpoint.store import latest_step
from repro_torch.train.driver import train
from repro_torch.train.train_step import TrainState, build_train_step

ARCHS = ("qwen3-4b", "llama4-scout-17b-a16e", "zamba2-1.2b", "xlstm-1.3b")
B, S, CHUNK, SEED = 4, 16, 8, 3
LR = (1e-3, 1, 10, 10)
# AdamW moves an element by at most lr |m^| / sqrt(v^) <= lr a step (the
# ratio is <= 1.0003 at b1 0.9, b2 0.95 over two steps), so an element on
# which two reduction orders disagree differs by at most twice that
ADAM_MOVE = 2 * LR[0]


def edits(arch: str) -> dict:
    """tests/test_distributed.py's edits of the smoke config."""
    if arch.startswith("xlstm"):
        return dict(n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=512)
    return dict(n_heads=8, n_kv_heads=4, d_ff=256, vocab_size=512)


def case_cfg(case):
    return get_config(case["arch"], smoke=True).replace(
        compute_dtype=getattr(torch, case.get("dtype", "float32")),
        cast_params_once=case.get("cast_once", True), **edits(case["arch"]))


def tokens(cfg, step: int) -> np.ndarray:
    return np.random.default_rng(100 + step).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (k,)))
        return out
    return {"/".join(path): tree.detach().float().cpu().numpy().copy()}


def run_case(case) -> dict:
    """The case's steps: {"loss", "grad_norm": per step, "params": the
    whole fp32 masters after the last, flat, and with ``each`` in the case
    "each": after every step, and for the plain step with ``each``
    "grads": the gradients of the first step}.  On a grid every rank
    returns them."""
    cfg = case_cfg(case)
    model = Model(cfg, device="cpu")
    params = params_from_numpy(cfg, numpy_params(cfg, SEED), device="cpu",
                               train=True)
    opt = make_optimizer(case.get("opt", "adamw"), wsd(*LR))
    state = TrainState(params=params, opt=None,
                       step=torch.zeros((), dtype=torch.int32))
    policy = None
    if case.get("grid"):
        policy = ShardingPolicy(make_debug_mesh(tuple(case["grid"]),
                                                device="cpu"))
        policy.shard(state, opt)
    else:
        state.opt = opt.init(leaf_tree(params))
    step = build_train_step(model, opt, policy=policy or NULL_POLICY,
                            loss_chunk=CHUNK,
                            microbatches=case.get("microbatches", 1))
    out = {"loss": [], "grad_norm": [], "each": []}
    n = case.get("steps", 2)
    for i in range(n):
        state, m = step(state, {"tokens": torch.from_numpy(tokens(cfg, i))})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0 and case.get("each") and policy is None:
            out["grads"] = flat(leaf_tree(state.params, "grad"))
        if case.get("each") or i == n - 1:
            masters = (policy.state_tree(state, opt)[0] if policy
                       else leaf_tree(state.params))
            out["each"].append(flat(masters))
    out["params"] = out["each"][-1]
    return out


def sharded_cases(rank: int, cases: list) -> list:
    """Each case on this rank (one thread: the ranks share the host's
    cores); rank 0's results (the others' are None)."""
    torch.set_num_threads(1)
    out = [run_case(c) for c in cases]
    return out if rank == 0 else None


DRIVER = dict(arch="qwen3-4b", global_batch=4, seq_len=16, ckpt_every=2,
              lr=1e-3, device="cpu")


def fp32_config(arch: str, smoke: bool = True):
    """The driver's config in fp32 compute, so that runs on different
    grids agree to 1e-5 (``train`` reads ``driver.get_config``)."""
    return get_config(arch, smoke=smoke).replace(compute_dtype=torch.float32)


def grid21(rank: int, cases: list, root: str) -> tuple:
    return sharded_cases(rank, cases), driver_preempted(rank, root)


def driver_preempted(rank: int, root: str):
    """train() for four steps on a (2, 1) grid, SIGTERM reaching rank 1
    alone as it takes step 2's batch, then the same call again: (the step
    of the first run's last checkpoint, its losses, the losses after the
    second) on rank 0."""
    torch.set_num_threads(1)
    driver.get_config = fp32_config
    out = os.path.join(root, "preempt")
    args = dict(DRIVER, ckpt_every=10, steps=4, out_dir=out)
    real, calls = driver.next_batch, []

    def next_batch(*a):
        calls.append(None)
        if rank == 1 and len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*a)
    mesh = make_debug_mesh((2, 1))
    driver.next_batch = next_batch
    try:
        train(mesh=mesh, policy=ShardingPolicy(mesh), **args)
    finally:
        driver.next_batch = real
    first = (latest_step(os.path.join(out, "ckpt")), driver_losses(out))
    mesh.barrier()
    train(mesh=mesh, policy=ShardingPolicy(mesh), **args)
    return first + (driver_losses(out),) if rank == 0 else None


def driver_resume(rank: int, root: str) -> list:
    """train() on a (2, 2) grid for two steps (a checkpoint at step 2), a
    copy of its directory resumed on (4, 1) for two more: rank 0's losses
    of the resumed run."""
    driver.get_config = fp32_config
    first, second = os.path.join(root, "grid22"), os.path.join(root,
                                                               "grid41")
    mesh = make_debug_mesh((2, 2))
    train(steps=2, out_dir=first, mesh=mesh, policy=ShardingPolicy(mesh),
          **DRIVER)
    if rank == 0:
        shutil.copytree(first, second)
    mesh.barrier()
    mesh = make_debug_mesh((4, 1))
    train(steps=4, out_dir=second, mesh=mesh, policy=ShardingPolicy(mesh),
          **DRIVER)
    return driver_losses(second) if rank == 0 else None


def driver_losses(out_dir: str) -> list:
    import json
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


# ---------------------------------------------------------------------------
# pipeline and compression
# ---------------------------------------------------------------------------

def block_fn(p: dict, h: torch.Tensor) -> torch.Tensor:
    """One layer of the pipeline cases: tanh(h W + b)."""
    return torch.tanh(h @ p["w"] + p["b"])


def pipeline_case(seed: int = 0, L: int = 8, D: int = 16, Bt: int = 8):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((L, D, D)) / np.sqrt(D)
                    ).astype(np.float32),
              "b": (rng.standard_normal((L, D)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((Bt, D)).astype(np.float32)
    return params, x


def sequential(params: dict, x: np.ndarray) -> np.ndarray:
    h = torch.from_numpy(x)
    for i in range(params["w"].shape[0]):
        h = block_fn({k: torch.from_numpy(v[i]) for k, v in params.items()},
                     h)
    return h.numpy()


def pipeline_ranks(rank: int, n_micros: tuple) -> list:
    """pipeline_apply over a ("stage",) grid of every rank, for each
    n_micro: every rank's output."""
    torch.set_num_threads(1)
    mesh = make_debug_mesh((torch.distributed.get_world_size(),),
                           ("stage",))
    params, x = pipeline_case()
    stacked = {k: torch.from_numpy(v) for k, v in params.items()}
    return [pipeline_apply(mesh, "stage", block_fn, stacked,
                           torch.from_numpy(x), m).numpy()
            for m in n_micros]


def compression_inputs(n: int = 8, seed: int = 0) -> np.ndarray:
    """(n, 64, 32) per-rank contributions (the reference test's shape)."""
    return np.random.default_rng(seed).standard_normal(
        (n, 64, 32)).astype(np.float32)


def compression_ranks(rank: int, steps: int) -> dict:
    """compressed_allreduce_int8 over every rank of a ("data",) grid (one
    thread a rank) from a
    zero error: the first call's mean and error, then the accumulated mean
    of ``steps`` calls with error feedback (the reference test's
    convergence run)."""
    torch.set_num_threads(1)
    n = torch.distributed.get_world_size()
    group = make_debug_mesh((n,), ("data",)).groups["data"]
    x = torch.from_numpy(compression_inputs(n)[rank])
    err = torch.zeros_like(x)
    mean, first_err = compressed_allreduce_int8(x, group, err)
    out = {"mean": mean.numpy(), "error": first_err.numpy()}
    acc, err = torch.zeros_like(x, dtype=torch.float64), first_err
    acc += mean.double()
    for _ in range(steps - 1):
        m, err = compressed_allreduce_int8(x, group, err)
        acc += m.double()
    out["acc"] = (acc / steps).numpy()
    return out

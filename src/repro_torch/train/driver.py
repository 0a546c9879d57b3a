"""End-to-end training driver: config -> model -> train loop with fault
tolerance, on the card unless ``device="cpu"``.

Counterpart of ``repro/train/driver.py``: a deterministic, resumable data
pipeline over the W-TinyLFU shard cache; asynchronous checkpoints of the
train state and the pipeline's cursor in the reference's layout (either
package resumes the other's); resume from the latest; a SIGTERM/SIGINT
handler that checkpoints, then exits; ``metrics.jsonl`` with the
reference's fields.  With a ``distributed.shardings.ShardingPolicy``
(``policy=``, over ``mesh``, a ``RankGrid``) every rank of the grid runs
``train()``: the state is sharded, each rank trains on its block of every
batch, and rank 0 of the grid writes the metrics and the checkpoints, in
the canonical unsharded layout, which restores into any grid shape
(elastic) and into either package.  ``maybe_init_distributed`` reads the
reference's environment variables into ``torch.distributed``.

    python -m repro_torch.train.driver --arch qwen3-4b --steps 20 --out DIR
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data.pipeline import (CachedShardReader, ShardSpec,
                                       SyntheticShardStore, TokenPipeline)
from repro_torch.kernels.sketch_common import resolve_device
from repro_torch.models import build_model
from repro_torch.models.common import NULL_POLICY
from repro_torch.optim import make_optimizer, wsd
from .train_step import (build_train_step, load_state_tree, make_train_state,
                         state_tree)


def maybe_init_distributed() -> None:
    """``torch.distributed`` from REPRO_COORDINATOR (host:port),
    REPRO_NUM_PROCESSES and REPRO_PROCESS_ID, when the first is set."""
    coord = os.environ.get("REPRO_COORDINATOR")
    if coord:
        import torch.distributed as dist
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{coord}",
            world_size=int(os.environ["REPRO_NUM_PROCESSES"]),
            rank=int(os.environ["REPRO_PROCESS_ID"]))


def make_pipeline(cfg, *, global_batch: int, seq_len: int,
                  seed: int) -> TokenPipeline:
    """The driver's pipeline: 64 synthetic shards of 4,096 tokens, 8 of
    them cached."""
    spec = ShardSpec(n_shards=64, tokens_per_shard=4096,
                     vocab_size=cfg.vocab_size, seed=seed)
    return TokenPipeline(CachedShardReader(SyntheticShardStore(spec),
                                           capacity_shards=8, seed=seed),
                         seq_len=seq_len, global_batch=global_batch,
                         seed=seed)


def next_batch(pipeline: TokenPipeline, cfg, device) -> dict:
    """The pipeline's next batch on ``device`` (tokens repeated over the
    codebooks for audio, as the reference's driver does)."""
    toks = pipeline.next_batch()["tokens"]
    if cfg.n_codebooks:
        toks = np.repeat(toks[..., None], cfg.n_codebooks, -1)
    return {"tokens": torch.from_numpy(toks).to(device)}


def train(arch: str, *, smoke: bool = True, steps: int = 20,
          out_dir: str = "/tmp/repro_run", global_batch: int = 8,
          seq_len: int = 64, ckpt_every: int = 5, microbatches: int = 1,
          mesh=None, policy=None, seed: int = 0, lr: float = 1e-3,
          resume: bool = True, optimizer: str = "adamw",
          device=None) -> dict:
    """Train ``arch``'s config for ``steps`` steps; returns the last
    step's metrics with ``wall_s``."""
    policy = policy or NULL_POLICY
    sharded = getattr(policy, "mesh", None) is not None
    if device is None and mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg, dev)
    opt = make_optimizer(optimizer, wsd(lr, max(1, steps // 10), steps,
                                        steps))
    pipeline = make_pipeline(cfg, global_batch=global_batch,
                             seq_len=seq_len, seed=seed)
    state = make_train_state(model, opt,
                             torch.Generator(device=dev).manual_seed(seed),
                             policy=policy)
    writer = not sharded or policy.mesh.rank == 0
    ckpt_dir = os.path.join(out_dir, "ckpt")
    ckpt = AsyncCheckpointer(ckpt_dir)
    start_step = 0
    last = latest_step(ckpt_dir) if resume else None
    if last is not None:
        tree = (policy.canonical_template(state, opt) if sharded
                else state_tree(state))
        payload = restore_checkpoint(
            ckpt_dir, last, {"state": tree, "data": pipeline.state_dict()},
            device="cpu" if sharded else dev)
        (policy.load_state_tree if sharded else load_state_tree)(
            state, payload["state"])
        pipeline.load_state_dict(payload["data"])
        start_step = int(state.step)
        if writer:
            print(f"[train] resumed from step {start_step}", flush=True)

    step_fn = build_train_step(model, opt, policy=policy,
                               microbatches=microbatches, loss_chunk=32)

    # -- preemption: checkpoint then exit -------------------------------------
    # On a grid the ranks agree each step (one all-reduce of the flag), so
    # a signal that reaches one rank stops all of them after the same step.
    preempted = {"flag": False}

    def stop() -> bool:
        if not sharded:
            return preempted["flag"]
        flag = torch.tensor([float(preempted["flag"])],
                            device=policy.mesh.device)
        return bool(policy.mesh.all_reduce(flag).item() > 0)

    def _handler(signum, frame):
        preempted["flag"] = True
    old_handlers = {s: signal.signal(s, _handler)
                    for s in (signal.SIGTERM, signal.SIGINT)}

    os.makedirs(out_dir, exist_ok=True)
    metrics_out = {}
    t_start = time.time()
    try:
        with open(os.path.join(out_dir, "metrics.jsonl") if writer
                  else os.devnull, "a") as logf:
            for step in range(start_step, steps):
                batch = next_batch(pipeline, cfg, dev)
                t0 = time.time()
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                rec = {"step": step + 1, "loss": loss,
                       "grad_norm": float(metrics.get("grad_norm", 0.0)),
                       "lr": float(metrics.get("lr", 0.0)),
                       "tokens_per_s": global_batch * seq_len
                       / max(1e-9, time.time() - t0)}
                rec.update(pipeline.cache_stats)
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
                metrics_out = rec
                stopping = stop()
                if ((step + 1) % ckpt_every == 0 or stopping
                        or step + 1 == steps):
                    tree = (policy.state_tree(state, opt) if sharded
                            else state_tree(state))
                    if writer:
                        ckpt.save(int(state.step),
                                  {"state": tree,
                                   "data": pipeline.state_dict()})
                if stopping:
                    print(f"[train] preempted at step {step + 1}; "
                          "checkpoint written", flush=True)
                    break
        ckpt.wait()
        if sharded:         # the checkpoint is on disk for every rank
            policy.mesh.barrier()
    finally:
        for s, h in old_handlers.items():
            signal.signal(s, h)
    metrics_out["wall_s"] = time.time() - t_start
    return metrics_out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="/tmp/repro_run")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    maybe_init_distributed()
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                out_dir=args.out, global_batch=args.global_batch,
                seq_len=args.seq_len, microbatches=args.microbatches,
                optimizer=args.optimizer, device=args.device)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

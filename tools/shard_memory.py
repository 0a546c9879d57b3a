"""Per-rank bytes of the sharded training state, counted from a config's
leaves and ``ShardingPolicy``'s blocks (shapes only: ``device="meta"``,
nothing is allocated and no rank is started).

For a grid shape, every rank's coordinates are walked, and each rank's
bytes are the sum over the reference's leaves of:

* the module's whole leaf (fp32), into which each step gathers the
  masters, and its whole gradient buffer (fp32);
* this rank's block of the fp32 master and of the reduce-scattered
  gradient;
* this rank's blocks of the optimizer state (AdamW's m and v, or
  Adafactor's factored vr / vc and v);
* the largest leaf's gathered compute-dtype cast, transient.

The largest rank's total is printed beside the plain one-card step's
(whole masters, gradients and optimizer state).  Activations are not
counted.

    PYTHONPATH=src python tools/shard_memory.py --arch qwen3-4b \\
        --layers 36 --grid 4,1 --grid 2,2 [--optimizer adafactor]
"""
from __future__ import annotations

import argparse
import itertools
import math

from repro_torch.configs import get_config
from repro_torch.distributed.mesh import RankGrid
from repro_torch.distributed.shardings import ShardingPolicy
from repro_torch.models import Model
from repro_torch.optim import adafactor, adamw, wsd

F32 = 4


def leaves(arch: str, layers: int | None):
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    module = Model(cfg, device="cpu").module(train=True, device="meta")
    return cfg, module


def opt_blocks(optimizer: str, blocks: dict) -> int:
    """Bytes of the optimizer state of these (block-shaped) leaves."""
    opt = (adamw if optimizer == "adamw" else adafactor)(wsd(1e-3, 1, 1, 1))
    state = opt.init(blocks)

    def size(t):
        if isinstance(t, dict):
            return sum(size(v) for v in t.values())
        return t.numel() * t.element_size() if t.ndim else 0
    return size({k: v for k, v in state.items() if k != "step"})


def per_rank(module, cfg, shape, optimizer: str) -> list:
    """[(coordinates, bytes by part)] for every rank of a ``shape`` grid
    over ("data", "model")."""
    axes = ("data", "model")
    out = []
    for coords in itertools.product(*(range(n) for n in shape)):
        grid = RankGrid(axis_names=axes, sizes=tuple(shape),
                        coords=coords, groups={a: None for a in axes + ("*",)})
        pol = ShardingPolicy(grid)
        whole = masters = 0
        blocks = {}
        largest = 0
        for leaf, spec in zip(module.ref_leaves, pol.leaf_specs(module)):
            n = leaf.value.numel()
            whole += 2 * n * F32
            blk = pol.block(leaf.value, spec)
            masters += blk.numel() * F32
            blocks["/".join(leaf.path)] = blk
            largest = max(largest, n)
        parts = {"whole leaves + gradients": whole,
                 "master blocks": masters,
                 "gradient blocks": masters,
                 "optimizer blocks": opt_blocks(optimizer, blocks),
                 "gathered cast (largest leaf)":
                     largest * cfg.compute_dtype.itemsize}
        out.append((coords, parts))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--grid", action="append", default=[],
                    help="data,model (repeatable)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    args = ap.parse_args()
    cfg, module = leaves(args.arch, args.layers)
    n = sum(leaf.value.numel() for leaf in module.ref_leaves)
    plain = 2 * n * F32 + opt_blocks(
        args.optimizer, {"/".join(leaf.path): leaf.value
                         for leaf in module.ref_leaves})
    gb = 1e9
    print(f"{args.arch}, {cfg.n_layers} layers: {n:,} parameters; the plain "
          f"one-card step holds {plain / gb:.2f} GB of masters, gradients "
          f"and {args.optimizer} state")
    for g in args.grid or ["1,1"]:
        shape = tuple(int(x) for x in g.split(","))
        ranks = per_rank(module, cfg, shape, args.optimizer)
        coords, parts = max(ranks, key=lambda r: sum(r[1].values()))
        total = sum(parts.values())
        print(f"grid {shape} ({math.prod(shape)} ranks): the largest rank "
              f"{coords} holds {total / gb:.2f} GB ("
              + ", ".join(f"{k} {v / gb:.2f}" for k, v in parts.items())
              + ")")


if __name__ == "__main__":
    main()

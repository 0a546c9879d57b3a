"""Train step: loss = chunked cross-entropy + the MoE routers' aux loss,
gradients accumulated over microbatches, the optimizer applied.

Counterpart of ``repro/train/train_step.py``, family-agnostic through
``models.api``.  ``TrainState`` holds the training module (its fp32
masters stacked per reference leaf: ``models.common.stack_leaves``), the
optimizer's state and the step.  Backward adds every parameter's gradient
into its leaf's fp32 buffer in place, so microbatches sum there, as the
reference's scan sums them, before the division by their count.
``state_tree`` / ``load_state_tree`` give the state as the reference's
tree (``(params, opt, step)``: the checkpoint layout of either package).

With a ``distributed.shardings.ShardingPolicy`` (``policy=``) the state is
sharded (``policy.shard``): ``master`` holds this rank's blocks of the fp32
masters and ``opt`` its blocks of the optimizer state, and the step
gathers the masters into the module, runs forward and backward on this
rank's block of the batch, reduce-scatters the gradients and applies the
optimizer to the blocks.  The metrics are the data-parallel ranks' means
(``tokens`` their sum).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models.api import Model
from repro_torch.models.common import NULL_POLICY, leaf_tree
from repro_torch.optim.optimizers import Optimizer
from .losses import chunked_cross_entropy


@dataclass
class TrainState:
    params: torch.nn.Module
    opt: Any
    step: torch.Tensor          # 0-d int32, on the host
    # sharded (ShardingPolicy.shard): this rank's blocks of the fp32
    # masters; the module then holds the whole leaves each step gathers
    master: Any = None


def make_train_state(model: Model, optimizer: Optimizer,
                     generator: torch.Generator,
                     policy=NULL_POLICY) -> TrainState:
    """Random fp32 masters from ``generator`` (drawing on the model's
    device) and the optimizer's zero state; with a ``ShardingPolicy``
    sharded (the optimizer state made for the blocks alone)."""
    params = model.init(generator, train=True)
    step = torch.zeros((), dtype=torch.int32)
    if getattr(policy, "mesh", None) is not None:
        return policy.shard(TrainState(params=params, opt=None, step=step),
                            optimizer)
    return TrainState(params=params, opt=optimizer.init(leaf_tree(params)),
                      step=step)


def state_tree(state: TrainState) -> tuple:
    """The state as the reference's ``TrainState`` flattens: (params tree,
    optimizer state, step)."""
    return (leaf_tree(state.params), state.opt, state.step)


@torch.no_grad()
def load_state_tree(state: TrainState, tree) -> TrainState:
    """Copy a restored ``state_tree`` into ``state`` (the masters in place:
    they are the module's storage)."""
    params, opt, step = tree

    def copy(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                copy(dst[k], src[k])
        else:
            dst.copy_(src)
    copy(leaf_tree(state.params), params)
    copy(state.opt, opt)
    state.step = torch.as_tensor(step, dtype=torch.int32).cpu()
    return state


def build_loss_fn(model: Model, policy=NULL_POLICY, remat: bool = True,
                  loss_chunk: int = 256):
    def loss_fn(params, batch):
        hidden, aux = model.hidden_train(params, batch, policy=policy,
                                         remat=remat)
        nll, metrics = chunked_cross_entropy(params, hidden, batch["tokens"],
                                             model.cfg, chunk=loss_chunk,
                                             policy=policy)
        metrics["aux_loss"] = aux
        return nll + aux, metrics
    return loss_fn


def build_train_step(model: Model, optimizer: Optimizer, *,
                     policy=NULL_POLICY, microbatches: int = 1,
                     remat: bool = True, loss_chunk: int = 256) -> Callable:
    """``step(state, batch) -> (state, metrics)``; the state is updated in
    place.  Metrics as the reference's: the loss function's (nll, tokens,
    aux_loss) with one microbatch, and grad_norm, lr and loss.  A
    ``ShardingPolicy`` takes a state it has sharded."""
    loss_fn = build_loss_fn(model, policy, remat, loss_chunk)
    sharded = getattr(policy, "mesh", None) is not None

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if sharded != (state.master is not None):
            raise ValueError("a ShardingPolicy's step takes the state it "
                             "sharded (policy.shard), the plain step a "
                             "state that is not sharded")
        split = False
        if sharded:
            policy.gather_params(state, model.cfg)
            batch, split = policy.batch_block(batch)
        leaves = state.params.ref_leaves
        for leaf in leaves:
            leaf.grad.zero_()
        if microbatches == 1:
            loss, metrics = loss_fn(state.params, batch)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}
        else:
            def to_micro(x):
                if x.shape[0] % microbatches:
                    raise ValueError(f"batch {x.shape[0]} is not a multiple "
                                     f"of {microbatches} microbatches")
                return x.reshape(microbatches, x.shape[0] // microbatches,
                                 *x.shape[1:])
            mb = {k: to_micro(v) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].value.device)
            for i in range(microbatches):
                l, _ = loss_fn(state.params, {k: v[i] for k, v in mb.items()})
                l.backward()
                loss = loss + l.detach()
            with torch.no_grad():
                for leaf in leaves:
                    leaf.grad.div_(microbatches)
            loss = loss / microbatches
            metrics = {}
        if sharded:
            loss, metrics = _dp_means(policy, loss, metrics, split)
            _, state.opt, opt_metrics = optimizer.apply(
                state.master, policy.reduce_grads(state.params, split),
                state.opt, layout=policy.layout(state.params))
        else:
            _, state.opt, opt_metrics = optimizer.apply(
                leaf_tree(state.params), leaf_tree(state.params, "grad"),
                state.opt)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        state.step = state.step + 1
        return state, metrics

    return step


def _dp_means(policy, loss, metrics: dict, split: bool):
    """The loss and the loss function's metrics over the data-parallel
    ranks (one all-reduce): means, ``tokens`` a sum.  Each rank's block has
    the same rows and positions, so the mean of the blocks' means is the
    batch's mean."""
    if not split:
        return loss, metrics
    keys = [k for k in ("nll", "aux_loss", "tokens") if k in metrics]
    dp = policy.dp_axes()
    n = 1
    for a in dp:
        n *= policy.mesh.axis_size(a)
    vals = torch.stack([loss.float()] + [torch.as_tensor(
        metrics[k], dtype=torch.float32, device=loss.device) for k in keys])
    policy.mesh.all_reduce(vals, dp)
    out = dict(metrics)
    for k, v in zip(keys, vals[1:].unbind()):
        out[k] = v if k == "tokens" else v / n
    return vals[0] / n, out

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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models.api import Model
from repro_torch.models.common import leaf_tree
from repro_torch.optim.optimizers import Optimizer
from .losses import chunked_cross_entropy


@dataclass
class TrainState:
    params: torch.nn.Module
    opt: Any
    step: torch.Tensor          # 0-d int32, on the host


def make_train_state(model: Model, optimizer: Optimizer,
                     generator: torch.Generator) -> TrainState:
    """Random fp32 masters from ``generator`` (drawing on the model's
    device) and the optimizer's zero state."""
    params = model.init(generator, train=True)
    return TrainState(params=params, opt=optimizer.init(leaf_tree(params)),
                      step=torch.zeros((), dtype=torch.int32))


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


def build_loss_fn(model: Model, remat: bool = True, loss_chunk: int = 256):
    def loss_fn(params, batch):
        hidden, aux = model.hidden_train(params, batch, remat=remat)
        nll, metrics = chunked_cross_entropy(params, hidden, batch["tokens"],
                                             model.cfg, chunk=loss_chunk)
        metrics["aux_loss"] = aux
        return nll + aux, metrics
    return loss_fn


def build_train_step(model: Model, optimizer: Optimizer, *,
                     microbatches: int = 1, remat: bool = True,
                     loss_chunk: int = 256) -> Callable:
    """``step(state, batch) -> (state, metrics)``; the state is updated in
    place.  Metrics as the reference's: the loss function's (nll, tokens,
    aux_loss) with one microbatch, and grad_norm, lr and loss."""
    loss_fn = build_loss_fn(model, remat, loss_chunk)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
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
            def split(x):
                if x.shape[0] % microbatches:
                    raise ValueError(f"batch {x.shape[0]} is not a multiple "
                                     f"of {microbatches} microbatches")
                return x.reshape(microbatches, x.shape[0] // microbatches,
                                 *x.shape[1:])
            mb = {k: split(v) for k, v in batch.items()}
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
        _, state.opt, opt_metrics = optimizer.apply(
            leaf_tree(state.params), leaf_tree(state.params, "grad"),
            state.opt)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        state.step = state.step + 1
        return state, metrics

    return step

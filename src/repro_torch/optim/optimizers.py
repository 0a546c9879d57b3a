"""AdamW and Adafactor on the reference's leaves, in plain PyTorch.

Counterpart of ``repro/optim/optimizers.py`` (not ``torch.optim``, whose
rules differ).  The optimizers see the reference's tree: a stack of
per-layer parameters is one leaf with its stack axes in front (a training
module's ``ref_leaves``, ``models.common.stack_leaves``), so weight decay
and Adafactor's factoring follow the stacked ``ndim`` (a per-layer norm
weight (L, M) is decayed and factored over the layer axis; ``final_norm``
is not), and Adafactor's RMS update clip is taken over the whole stacked
leaf.  The state is one tensor per leaf in the reference's shapes and
names (``m``, ``v``, ``step``; ``f/{vr, vc | v}``, ``step``), so
checkpoints cross between the packages; ``step`` is a 0-d int32 tensor
on the host, so the schedule reads it without waiting for the card.

    opt = adamw(lr_schedule, ...)
    state = opt.init(params)
    params, state, metrics = opt.apply(params, grads, state)

``params`` and ``grads`` are dict trees of tensors (``common.leaf_tree``
of a training module and of its gradients); ``apply`` updates the
parameters and the state in place (the stacked masters are the module's
storage) and returns them with ``{"grad_norm", "lr"}``.  ``layout``
(``distributed.shardings.PolicyLayout``) gives the reductions over a tree
of blocks sharded over ranks: the global norm and Adafactor's means; by
default they are the plain ones over whole leaves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


def _leaves(tree) -> list:
    """The tree's leaves in the reference's order (keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _map(fn, tree):
    """``fn`` on each leaf of a dict tree (its results may be dicts)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of their fp32 squares (a 0-d tensor
    on the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in _leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return _map(lambda g: g * scale, grads), norm


class _Whole:
    """The reductions over whole leaves on one process."""

    def global_norm(self, grads):
        return global_norm(grads)

    def leaf(self, i: int) -> "_Whole":
        return self

    def mean(self, x, dim: int, leaf_dim=None, keepdim: bool = False):
        return x.mean(dim, keepdim=keepdim)

    def mean_all(self, x):
        return torch.mean(x)


WHOLE = _Whole()


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    apply: Callable        # (params, grads, state) -> (params, state, metrics)
    name: str = "opt"


def adamw(lr_fn: Callable, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          max_grad_norm: float = 1.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"m": _map(zeros, params), "v": _map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32)}

    def apply(params, grads, state, layout=WHOLE):
        step = state["step"] + 1
        lr = lr_fn(step)
        norm = layout.global_norm(grads)
        scale = _clip_scale(norm, max_grad_norm)        # clipped in the loop
        t = step.float()
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
        lr_f = float(lr)
        for p, g, m, v in zip(_leaves(params), _leaves(grads),
                              _leaves(state["m"]), _leaves(state["v"])):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            pf = p.float()
            if p.dim() >= 2:
                u = u + weight_decay * pf
            p.copy_(pf - lr_f * u)
        state = dict(state, step=step)
        return params, state, {"grad_norm": norm, "lr": lr}

    return Optimizer(init=init, apply=torch.no_grad()(apply), name="adamw")


def adafactor(lr_fn: Callable, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_rate: float = 0.8, weight_decay: float = 0.0,
              max_grad_norm: float = 1.0) -> Optimizer:
    """Factored second moments over the last two dims of >= 2-D leaves."""

    def init(params):
        def per(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"f": _map(per, params),
                "step": torch.zeros((), dtype=torch.int32)}

    def apply(params, grads, state, layout=WHOLE):
        step = state["step"] + 1
        lr = lr_fn(step)
        norm = layout.global_norm(grads)
        scale = _clip_scale(norm, max_grad_norm)        # clipped in the loop
        beta = float(1.0 - step.float() ** (-decay_rate))
        lr_f = float(lr)
        for i, (p, g, s) in enumerate(zip(_leaves(params), _leaves(grads),
                                          _states(params, state["f"]))):
            red = layout.leaf(i)
            g = g.float() * scale
            g2 = g * g + eps
            if p.dim() >= 2:
                s["vr"].mul_(beta).add_((1 - beta) * red.mean(g2, -1))
                s["vc"].mul_(beta).add_((1 - beta) * red.mean(g2, -2))
                vr, vc = s["vr"], s["vc"]
                vr_mean = red.mean(vr, -1, leaf_dim=-2, keepdim=True)
                denom = ((vr / torch.clamp(vr_mean, min=eps))[..., None]
                         * vc[..., None, :])
                u = g * torch.rsqrt(denom + eps)
            else:
                s["v"].mul_(beta).add_((1 - beta) * g2)
                u = g * torch.rsqrt(s["v"] + eps)
            rms = torch.sqrt(red.mean_all(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            pf = p.float()
            wd = weight_decay if p.dim() >= 2 else 0.0
            p.copy_(pf - lr_f * u - lr_f * wd * pf)
        state = dict(state, step=step)
        return params, state, {"grad_norm": norm, "lr": lr}

    return Optimizer(init=init, apply=torch.no_grad()(apply),
                     name="adafactor")


def _states(params, f):
    """Adafactor's per-leaf state dicts, in the params' leaf order."""
    if isinstance(params, dict):
        return [s for k in sorted(params) for s in _states(params[k], f[k])]
    return [f]


def make_optimizer(name: str, lr_fn: Callable, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, **kw)
    raise ValueError(name)

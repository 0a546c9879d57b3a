"""Weights carried across between the JAX package and the port.

The JAX package keeps a model's parameters as a dict tree whose layer
stacks carry leading layer axes: the attention families' ``layers``
(superblocks: ``attn{j}``, ``mlp{j}``, ``moe{j}``, ``moe{j}_norm``), zamba's
``groups`` (two axes: group, layer) and ``tail``, xLSTM's ``supers`` (its
``mlstm`` stack a second axis), and musicgen's per-codebook ``embed``
(K,V,M) and ``out_head`` (K,M,V).  The port's modules mirror that tree:
a dict key is an attribute, and a stacked subtree is an ``nn.ModuleList``
whose i-th module takes index i of the stack's next axis.

``params_from_numpy`` loads such a tree (numpy arrays), or the (path,
array) leaves of one handed over one at a time (``check_runs.numpy_leaves``,
so that a large model's tree never sits whole in host memory), into the
family's module, casting as the reference's ``cast_params`` does;
``params_to_numpy`` gives the tree back (fp32 numpy arrays, exact for
bf16 weights).  With the same tree both frameworks compute the same
function.  With ``train=True`` the module is the training storage (fp32
masters, ``common.stack_leaves``); ``grads_to_numpy`` gives its gradients
in the reference's tree, and ``tree_to_numpy`` / ``tree_from_numpy``
carry an optimizer's state (a dict tree of tensors) either way.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.sketch_common import resolve_device
from .api import Model
from .common import ModelConfig, by_path, leaf_tree


def _flatten(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def _name(path) -> str:
    return "params" + "".join(f"[{k!r}]" for k in path)


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree, device=None,
                      train: bool = False) -> nn.Module:
    """The family's module (``Model(cfg).module(train)``) holding
    ``tree``'s weights, on ``device`` (the card unless ``"cpu"``).
    ``tree`` is the reference's dict tree or an iterable of its (path,
    array) leaves."""
    model = Model(cfg, resolve_device(device)).module(train)
    want = by_path(model)
    leaves = _flatten(tree) if isinstance(tree, dict) else tree
    seen = set()
    for path, a in leaves:
        path = tuple(path)
        if path not in want or path in seen:
            raise ValueError(f"{_name(path)}: keys {sorted(map(str, want))}"
                             " do not hold it once")
        seen.add(path)
        a = np.asarray(a)
        for idx, p in want[path]:
            leaf = a[idx]
            if leaf.shape != tuple(p.shape):
                raise ValueError(f"{_name(path)}{list(idx)}: shape "
                                 f"{leaf.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(leaf)))
        del a
    missing = set(want) - seen
    if missing:
        raise ValueError(f"params: keys {sorted(map(str, missing))} "
                         "missing")
    return model


@torch.no_grad()
def params_to_numpy(cfg: ModelConfig, model: nn.Module) -> dict:
    """``model``'s weights as the JAX package's tree of fp32 numpy
    arrays."""
    tree: dict = {}
    for path, items in by_path(model).items():
        stack = tuple(max(i[k] for i, _ in items) + 1
                      for k in range(len(items[0][0])))
        arr = np.empty(stack + tuple(items[0][1].shape), np.float32)
        for idx, p in items:
            arr[idx] = p.detach().float().cpu().numpy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


def tree_to_numpy(tree):
    """A dict tree of tensors as one of numpy arrays (host copies)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def tree_from_numpy(tree, device=None):
    """A dict tree of numpy arrays as one of tensors on ``device`` (the
    card unless ``"cpu"``); 0-d leaves (an optimizer's ``step``) stay on
    the host."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dev) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.from_numpy(a.copy()).to("cpu" if a.ndim == 0 else dev)


def grads_to_numpy(model: nn.Module) -> dict:
    """A training module's gradients as the reference's tree (fp32)."""
    return tree_to_numpy(leaf_tree(model, "grad"))

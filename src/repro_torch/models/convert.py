"""Weights carried across between the JAX package and the port.

The JAX package keeps a model's parameters as a dict tree
(``repro.models.transformer.init_params``): ``embed`` (V, M),
``final_norm`` (M,), ``out_head`` (M, V) unless the embeddings are tied,
and ``layers`` = {``attn0``: {...}, ``mlp0``: {...}} with every leaf
stacked on a leading layer axis.  ``params_from_numpy`` loads such a tree
(numpy arrays) into the port's ``Transformer``, casting as the reference's
``cast_params`` does; ``params_to_numpy`` gives the tree back (fp32 numpy
arrays, exact for bf16 weights).  With the same tree both frameworks
compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.sketch_common import resolve_device
from .common import ModelConfig
from .transformer import Transformer

_BLOCK = ("attn0", "mlp0")


def _leaves(module: torch.nn.Module) -> dict:
    return dict(module.named_parameters(recurse=False))


def _mismatch(what: str, got, want) -> None:
    if set(got) != set(want):
        raise ValueError(f"{what}: keys {sorted(got)} != {sorted(want)}")


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict,
                      device=None) -> Transformer:
    """The port's ``Transformer`` holding ``tree``'s weights, on
    ``device`` (the card unless ``"cpu"``)."""
    model = Transformer(cfg, resolve_device(device))
    top = _leaves(model)
    _mismatch("params", set(tree), set(top) | {"layers"})
    for name, p in top.items():
        p.copy_(torch.from_numpy(np.asarray(tree[name])))
    _mismatch("params['layers']", set(tree["layers"]), set(_BLOCK))
    for part in _BLOCK:
        sub = tree["layers"][part]
        _mismatch(f"params['layers'][{part!r}]", set(sub),
                  set(_leaves(getattr(model.layers[0], part))))
        for li, blk in enumerate(model.layers):
            for name, p in _leaves(getattr(blk, part)).items():
                p.copy_(torch.from_numpy(np.asarray(sub[name][li])))
    return model


@torch.no_grad()
def params_to_numpy(cfg: ModelConfig, model: Transformer) -> dict:
    """``model``'s weights as the JAX package's tree of fp32 numpy
    arrays."""
    def arr(p):
        return p.detach().float().cpu().numpy()

    tree = {name: arr(p) for name, p in _leaves(model).items()}
    tree["layers"] = {
        part: {name: np.stack([arr(_leaves(getattr(blk, part))[name])
                               for blk in model.layers])
               for name in _leaves(getattr(model.layers[0], part))}
        for part in _BLOCK}
    return tree

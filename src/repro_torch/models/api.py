"""Model API over the family implementations.

Counterpart of ``repro/models/api.py``: ``Model`` exposes ``init``,
``init_cache``, ``prefill``, ``decode`` and ``lm_head`` with the
reference's arguments, plus an explicit ``device`` (the card unless
``"cpu"``), for every family: dense, moe, vlm and audio
(``transformer``), hybrid_ssm (``zamba``) and xlstm (``xlstm``).
``hidden_train`` and ``input_specs`` come with the training slice
(ROADMAP queue 1 item 14, training).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.sketch_common import resolve_device
from . import transformer, xlstm, zamba
from .common import ModelConfig

_TRAINING = ("ROADMAP queue 1 item 14 (training): forward_train, "
             "hidden_train and input_specs come with the training slice")


def _family_mod(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return transformer
    if cfg.family == "hybrid_ssm":
        return zamba
    if cfg.family == "xlstm":
        return xlstm
    raise ValueError(cfg.family)


# each family module's parameter module and cache constructor
_PARTS = {transformer: (transformer.Transformer, transformer.init_kv_cache),
          zamba: (zamba.Zamba, zamba.init_cache),
          xlstm: (xlstm.XLSTM, xlstm.init_cache)}


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.cfg.attn_scores_bf16:
            raise NotImplementedError("attn_scores_bf16: the port's "
                                      "attention keeps fp32 scores")
        self._mod = _family_mod(self.cfg)
        self.device = resolve_device(self.device)

    # -- parameters -----------------------------------------------------------
    def module(self) -> torch.nn.Module:
        """The family's parameter module, uninitialised, on the device."""
        return _PARTS[self._mod][0](self.cfg, self.device)

    def init(self, generator: torch.Generator) -> torch.nn.Module:
        """Random weights from ``generator``, which must draw on the
        model's device."""
        return self.module().init(self.cfg, generator)

    # -- training (the next slice) --------------------------------------------
    def hidden_train(self, params, batch, remat: bool = True):
        raise NotImplementedError(_TRAINING)

    def input_specs(self, kind: str) -> dict:
        raise NotImplementedError(_TRAINING)

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        """The family's serving cache, on ``device`` (the model's unless
        given)."""
        return _PARTS[self._mod][1](self.cfg, batch, max_len, dtype,
                                    self.device if device is None
                                    else device)

    def prefill(self, params, batch: dict, cache: dict):
        return self._mod.forward_prefill(
            params, batch["tokens"], self.cfg, cache,
            vision_embeds=batch.get("vision_embeds"))

    def decode(self, params, tokens: torch.Tensor, cache: dict):
        return self._mod.forward_decode(params, tokens, self.cfg, cache)

    def lm_head(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return transformer.lm_head(params, hidden, self.cfg)


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)

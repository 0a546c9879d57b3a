"""Model API over the ported family.

Counterpart of ``repro/models/api.py``: ``Model`` exposes ``init``,
``init_cache``, ``prefill``, ``decode`` and ``lm_head`` with the
reference's arguments, plus an explicit ``device`` (the card unless
``"cpu"``).  The port serves the dense family; ``hidden_train`` and
``input_specs`` come with the training slice (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.sketch_common import resolve_device
from . import transformer
from .common import ModelConfig


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device | str | None = None

    def __post_init__(self):
        cfg = self.cfg
        if (cfg.family != "dense" or cfg.n_experts or cfg.n_codebooks
                or cfg.n_vis_tokens):
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} (experts, codebooks, "
                "vision tokens, SSM blocks) is ROADMAP queue 1 item 14; the "
                "port serves the dense family")
        if cfg.attn_scores_bf16:
            raise NotImplementedError("attn_scores_bf16: the port's "
                                      "attention keeps fp32 scores")
        self.device = resolve_device(self.device)

    # -- parameters -----------------------------------------------------------
    def init(self, generator: torch.Generator) -> transformer.Transformer:
        """Random weights from ``generator``, which must draw on the
        model's device."""
        return transformer.Transformer(self.cfg, self.device).init(
            self.cfg, generator)

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return transformer.init_kv_cache(self.cfg, batch, max_len, dtype,
                                         self.device)

    def prefill(self, params, batch: dict, cache: dict):
        return transformer.forward_prefill(params, batch["tokens"], self.cfg,
                                           cache)

    def decode(self, params, tokens: torch.Tensor, cache: dict):
        return transformer.forward_decode(params, tokens, self.cfg, cache)

    def lm_head(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return transformer.lm_head(params, hidden, self.cfg)


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)

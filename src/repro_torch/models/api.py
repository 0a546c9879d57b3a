"""Model API over the family implementations.

Counterpart of ``repro/models/api.py``: ``Model`` exposes ``init``,
``hidden_train``, ``init_cache``, ``prefill``, ``decode``, ``lm_head`` and
``input_specs`` with the reference's arguments, plus an explicit
``device`` (the card unless ``"cpu"``), for every family: dense, moe, vlm
and audio (``transformer``), hybrid_ssm (``zamba``) and xlstm (``xlstm``).
``module(train=True)`` and ``init(..., train=True)`` give the training
storage (fp32 masters that require grad, stacked per reference leaf:
``common.stack_leaves``); ``input_specs`` gives ``device="meta"`` tensors,
the counterpart of the reference's ``jax.ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.sketch_common import resolve_device
from . import transformer, xlstm, zamba
from .common import NULL_POLICY, ModelConfig, stack_leaves, train_storage

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def _family_mod(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return transformer
    if cfg.family == "hybrid_ssm":
        return zamba
    if cfg.family == "xlstm":
        return xlstm
    raise ValueError(cfg.family)


def is_subquadratic(cfg: ModelConfig) -> bool:
    """Archs eligible for the long_500k cell (SSM / hybrid / linear-attn)."""
    return cfg.family in ("hybrid_ssm", "xlstm")


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
    def module(self, train: bool = False, device=None) -> torch.nn.Module:
        """The family's parameter module, uninitialised, on the model's
        device (or ``device``: ``"meta"`` gives shapes without storage);
        with ``train`` in the training storage."""
        dev = self.device if device is None else torch.device(device)
        if not train:
            return _PARTS[self._mod][0](self.cfg, dev)
        with train_storage():
            return stack_leaves(_PARTS[self._mod][0](self.cfg, dev))

    def init(self, generator: torch.Generator,
             train: bool = False) -> torch.nn.Module:
        """Random weights from ``generator``, which must draw on the
        model's device."""
        return self.module(train).init(self.cfg, generator)

    # -- training forward (head applied by train/losses.py, chunked) ---------
    def hidden_train(self, params, batch: dict, policy=NULL_POLICY,
                     remat: bool = True):
        """(hidden (B,S',M), aux_loss) of a training module."""
        return self._mod.forward_train(
            params, batch["tokens"], self.cfg,
            vision_embeds=batch.get("vision_embeds"), policy=policy,
            remat=remat)

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        """The family's serving cache, on ``device`` (the model's unless
        given)."""
        return _PARTS[self._mod][1](self.cfg, batch, max_len, dtype,
                                    self.device if device is None
                                    else device)

    def prefill(self, params, batch: dict, cache: dict, policy=NULL_POLICY):
        return self._mod.forward_prefill(
            params, batch["tokens"], self.cfg, cache,
            vision_embeds=batch.get("vision_embeds"), policy=policy)

    def decode(self, params, tokens: torch.Tensor, cache: dict,
               policy=NULL_POLICY):
        return self._mod.forward_decode(params, tokens, self.cfg, cache,
                                        policy=policy)

    def lm_head(self, params, hidden: torch.Tensor,
                policy=NULL_POLICY) -> torch.Tensor:
        return transformer.lm_head(params, hidden, self.cfg, policy)

    # -- dry-run input specs ---------------------------------------------------
    def input_specs(self, kind: str) -> dict:
        """Stand-ins (``device="meta"``: shape and dtype, no storage) for
        each input of a ``SHAPES`` kind."""
        cfg = self.cfg
        sh = SHAPES[kind]
        B, S = sh["global_batch"], sh["seq_len"]
        meta = torch.device("meta")

        def tokens(s):
            shape = (B, s, cfg.n_codebooks) if cfg.n_codebooks else (B, s)
            return torch.empty(shape, dtype=torch.int32, device=meta)
        if sh["kind"] in ("train", "prefill"):
            specs = {"tokens": tokens(S)}
            if cfg.n_vis_tokens:
                specs["vision_embeds"] = torch.empty(
                    (B, cfg.n_vis_tokens, cfg.d_model), dtype=torch.bfloat16,
                    device=meta)
            return specs
        return {"tokens": tokens(1), "cache": self.init_cache(B, S,
                                                              device=meta)}


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)

"""xLSTM stack: superblocks of (``slstm_period`` - 1) mLSTM blocks and one
sLSTM block (xLSTM[7:1] at 48 layers = 6 superblocks), no separate FFN.

Counterpart of ``repro/models/xlstm.py``.  ``XLSTM`` holds the reference's
tree: ``embed``, ``final_norm``, ``out_head`` and ``supers`` (per
superblock ``mlstm``, a stack of ``{"p", "norm"}``, and ``slstm``,
``{"p", "norm"}``), every layer's leaf but its norm weights in the
compute dtype.  The cache is
``{"mlstm" (n_super, n_ml, B, H, hd, hd+1), "slstm" {h, c, n, m}
(n_super, B, M), "pos"}``, all states fp32, updated in place.
``forward_train`` recomputes each mLSTM block in its backward, as the
reference checkpoints each (the sLSTM blocks are not).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import (NULL_POLICY, ModelConfig, _param, cast_params,
                     dense_init, embed_init)
from .layers import rmsnorm
from .mlstm import (MLSTM, SLSTM, init_mlstm_state, init_slstm_state,
                    mlstm_decode_step, mlstm_forward, slstm_decode_step,
                    slstm_forward)
from .transformer import lm_head


def _split(cfg: ModelConfig):
    per = cfg.slstm_period
    if cfg.n_layers % per:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"slstm_period {per}")
    return cfg.n_layers // per, per - 1      # (n_super, mlstm per super)


class Cell(nn.Module):
    """One block: the mixer ``p`` and its pre-norm ``norm``."""

    def __init__(self, mixer: nn.Module, cfg: ModelConfig, device=None):
        super().__init__()
        self.p = mixer
        self.norm = _param((cfg.d_model,), cfg, device)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> None:
        self.p.init(cfg, g)
        self.norm.fill_(1.0)


class Super(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _, n_ml = _split(cfg)
        self.mlstm = nn.ModuleList(Cell(MLSTM(cfg, device), cfg, device)
                                   for _ in range(n_ml))
        self.slstm = Cell(SLSTM(cfg, device), cfg, device)


class XLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        V, M = cfg.padded_vocab, cfg.d_model
        n_super, _ = _split(cfg)
        self.embed = _param((V, M), cfg, device)
        self.final_norm = _param((M,), cfg, device)
        self.out_head = _param((M, V), cfg, device)
        self.supers = nn.ModuleList(Super(cfg, device)
                                    for _ in range(n_super))

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> "XLSTM":
        """Random weights from ``g``, in the reference's order (the
        superblocks first) and distributions."""
        dev = self.embed.device
        for sup in self.supers:
            for cell in sup.mlstm:
                cell.init(cfg, g)
            sup.slstm.init(cfg, g)
        self.embed.copy_(embed_init(tuple(self.embed.shape), g, device=dev))
        self.final_norm.fill_(1.0)
        self.out_head.copy_(dense_init(tuple(self.out_head.shape), g,
                                       device=dev))
        return self


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """The states (fp32 whatever ``dtype``, as in the reference)."""
    n_super, n_ml = _split(cfg)
    ml = init_mlstm_state(cfg, batch, device)
    return {"mlstm": ml.new_zeros((n_super, n_ml) + tuple(ml.shape)),
            "slstm": {k: a.new_zeros((n_super,) + tuple(a.shape)) for k, a
                      in init_slstm_state(cfg, batch, device).items()},
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _embed(params: XLSTM, tokens, cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens, params.embed).to(cfg.compute_dtype)


def forward_train(params: XLSTM, tokens: torch.Tensor, cfg: ModelConfig, *,
                  vision_embeds=None, policy=NULL_POLICY,
                  remat: bool = True):
    """Returns (hidden (B,S,M) before the final norm, aux_loss 0)."""
    params = cast_params(params, cfg)
    x = policy.act(_embed(params, tokens, cfg), "residual")

    def ml_body(x, cell):
        h = rmsnorm(x, cell.norm, cfg.norm_eps)
        return policy.act(x + mlstm_forward(cell.p, h, cfg)[0], "residual")

    for sup in params.supers:
        for cell in sup.mlstm:
            x = (checkpoint(ml_body, x, cell, use_reentrant=False) if remat
                 else ml_body(x, cell))
        h = rmsnorm(x, sup.slstm.norm, cfg.norm_eps)
        x = policy.act(x + slstm_forward(sup.slstm.p, h, cfg)[0], "residual")
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def run_stack(params: XLSTM, x: torch.Tensor, cfg: ModelConfig,
              cache: dict, *, carry: bool, decode: bool = False):
    """Every block over x, the states written into ``cache`` in place:
    from the cache's states (``carry``) or from zero."""
    B = x.shape[0]
    sl = cache["slstm"]
    for s, sup in enumerate(params.supers):
        for i, cell in enumerate(sup.mlstm):
            h = rmsnorm(x, cell.norm, cfg.norm_eps)
            st = cache["mlstm"][s, i, :B] if carry else None
            if decode:
                out, st = mlstm_decode_step(cell.p, h, st, cfg)
            else:
                out, st = mlstm_forward(cell.p, h, cfg, initial_state=st)
            x = x + out
            cache["mlstm"][s, i, :B] = st
        h = rmsnorm(x, sup.slstm.norm, cfg.norm_eps)
        st = {k: a[s, :B] for k, a in sl.items()} if carry else None
        if decode:
            out, st = slstm_decode_step(sup.slstm.p, h, st, cfg)
        else:
            out, st = slstm_forward(sup.slstm.p, h, cfg, initial_state=st)
        x = x + out
        for k, a in st.items():
            sl[k][s, :B] = a
    return x


@torch.no_grad()
def forward_prefill(params: XLSTM, tokens: torch.Tensor, cfg: ModelConfig,
                    cache: dict, vision_embeds=None, policy=NULL_POLICY):
    """Run the prompt from zero states; returns (cache, last-token hidden
    (B,1,M)).  ``policy`` as the reference's, which no hook of these blocks
    reads."""
    x = _embed(params, tokens, cfg)
    B, S, _ = x.shape
    x = run_stack(params, x, cfg, cache, carry=False)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return cache, x[:, -1:]


@torch.no_grad()
def forward_decode(params: XLSTM, tokens: torch.Tensor, cfg: ModelConfig,
                   cache: dict, policy=NULL_POLICY):
    """One decode step over every batch row: (logits (B,1,V), cache)."""
    x = _embed(params, tokens, cfg)
    x = run_stack(params, x, cfg, cache, carry=True, decode=True)
    cache["pos"] = cache["pos"] + 1
    return lm_head(params, x, cfg, policy), cache

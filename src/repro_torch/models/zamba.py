"""Zamba2-style hybrid backbone: Mamba2 layers with one *shared*
attention+MLP block applied after every ``attn_every`` of them.

Counterpart of ``repro/models/zamba.py`` (its simplifications: the shared
block reads the hidden stream directly and is re-applied with the same
weights).  ``Zamba`` holds the reference's tree: ``embed``, ``final_norm``,
``out_head`` (kept, as the reference keeps it, though the embeddings are
tied and the head reads ``embed``), ``shared_attn``, ``shared_mlp``,
``groups`` (``n_layers // attn_every`` groups of ``attn_every``
``MambaLayer``s: the reference's two-level stack) and ``tail`` (the
remaining layers).  Each layer's leaves but its norm weights are in the
compute dtype (the reference's cast of its stacks).  The cache is ``{"mamba": {"conv",
"ssm"}, "k", "v", "pos"}``, the layer axis first, updated in place; its
conv leaf takes the dtype the reference's would come back in (that of the
cache and the compute dtype, promoted).  ``forward_train`` recomputes each
Mamba2 layer in its backward, as the reference checkpoints each (the shared
block is not).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import (NULL_POLICY, ModelConfig, _param, cast_params,
                     dense_init, embed_init)
from .layers import rmsnorm
from .mamba2 import (Mamba2, init_mamba_state, mamba2_decode_step,
                     mamba2_forward)
from .transformer import (MLP, Attention, attn_block_decode,
                          attn_block_train, lm_head, mlp_block)


def _split(cfg: ModelConfig):
    groups = cfg.n_layers // cfg.attn_every
    tail = cfg.n_layers % cfg.attn_every
    return groups, tail


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.mamba = Mamba2(cfg, device)
        self.norm = _param((cfg.d_model,), cfg, device)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> None:
        self.mamba.init(cfg, g)
        self.norm.fill_(1.0)


class Zamba(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        V, M = cfg.padded_vocab, cfg.d_model
        groups, tail = _split(cfg)
        self.embed = _param((V, M), cfg, device)
        self.final_norm = _param((M,), cfg, device)
        self.out_head = _param((M, V), cfg, device)
        self.shared_attn = Attention(cfg, device)
        self.shared_mlp = MLP(cfg, device)
        self.groups = nn.ModuleList(
            nn.ModuleList(MambaLayer(cfg, device)
                          for _ in range(cfg.attn_every))
            for _ in range(groups))
        if tail:
            self.tail = nn.ModuleList(MambaLayer(cfg, device)
                                      for _ in range(tail))

    def mamba_layers(self):
        """Every Mamba2 layer in order: the groups', then the tail's."""
        out = [layer for grp in self.groups for layer in grp]
        return out + list(getattr(self, "tail", ()))

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> "Zamba":
        """Random weights from ``g``, in the reference's order and
        distributions."""
        dev = self.embed.device
        self.embed.copy_(embed_init(tuple(self.embed.shape), g, device=dev))
        self.final_norm.fill_(1.0)
        self.out_head.copy_(dense_init(tuple(self.out_head.shape), g,
                                       device=dev))
        self.shared_attn.init(cfg, g)
        self.shared_mlp.init(cfg, g)
        for layer in self.mamba_layers():
            layer.init(cfg, g)
        return self


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    groups, tail = _split(cfg)
    n = groups * cfg.attn_every + tail
    st = init_mamba_state(cfg, batch, dtype, device)
    kv = (groups, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"mamba": {k: torch.zeros((n,) + tuple(a.shape), dtype=a.dtype,
                                     device=device) for k, a in st.items()},
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def promote_conv(cache: dict, dtype: torch.dtype) -> None:
    """Widen the cache's conv leaf to the dtype the step's states come back
    in (the reference returns the stacked new states, promoted)."""
    conv = cache["mamba"]["conv"]
    wide = torch.promote_types(conv.dtype, dtype)
    if wide != conv.dtype:
        cache["mamba"] = dict(cache["mamba"], conv=conv.to(wide))


def _store_state(cache: dict, li: int, state: dict) -> None:
    for k, a in state.items():
        cache["mamba"][k][li, :a.shape[0]] = a


def _embed(params: Zamba, tokens, cfg: ModelConfig) -> torch.Tensor:
    return F.embedding(tokens, params.embed).to(cfg.compute_dtype)


def mamba_block(layer: MambaLayer, x: torch.Tensor, cfg: ModelConfig,
                state: dict | None, policy=NULL_POLICY):
    h = rmsnorm(x, layer.norm, cfg.norm_eps)
    out, fin = mamba2_forward(layer.mamba, h, cfg, initial_state=state,
                              policy=policy)
    return x + out, fin


def layer_schedule(params: Zamba, cfg: ModelConfig):
    """(Mamba2 layer index, layer, group whose shared block follows it or
    None) for every layer in order."""
    groups, _ = _split(cfg)
    for li, layer in enumerate(params.mamba_layers()):
        g = li // cfg.attn_every
        last = li % cfg.attn_every == cfg.attn_every - 1 and g < groups
        yield li, layer, g if last else None


def forward_train(params: Zamba, tokens: torch.Tensor, cfg: ModelConfig, *,
                  vision_embeds=None, policy=NULL_POLICY,
                  remat: bool = True):
    """Returns (hidden (B,S,M) before the final norm, aux_loss 0)."""
    params = cast_params(params, cfg)
    x = _embed(params, tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = policy.act(x, "residual")

    def body(x, layer):
        return policy.act(mamba_block(layer, x, cfg, None, policy)[0],
                          "residual")

    for _, layer, g in layer_schedule(params, cfg):
        x = (checkpoint(body, x, layer, use_reentrant=False) if remat
             else body(x, layer))
        if g is not None:
            x, _ = attn_block_train(params.shared_attn, x, cfg, positions,
                                    policy)
            x = mlp_block(params.shared_mlp, x, cfg, policy)
            x = policy.act(x, "residual")
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def forward_prefill(params: Zamba, tokens: torch.Tensor, cfg: ModelConfig,
                    cache: dict, vision_embeds=None, policy=NULL_POLICY):
    """Run the prompt from zero states, fill the cache in place; returns
    (cache, last-token hidden (B,1,M))."""
    x = _embed(params, tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    promote_conv(cache, x.dtype)
    for li, layer, g in layer_schedule(params, cfg):
        x, fin = mamba_block(layer, x, cfg, None, policy)
        _store_state(cache, li, fin)
        if g is not None:
            x, (k, v) = attn_block_train(params.shared_attn, x, cfg,
                                         positions, policy)
            x = mlp_block(params.shared_mlp, x, cfg, policy)
            cache["k"][g, :B, :S] = k.to(cache["k"].dtype)
            cache["v"][g, :B, :S] = v.to(cache["v"].dtype)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return cache, x[:, -1:]


@torch.no_grad()
def forward_decode(params: Zamba, tokens: torch.Tensor, cfg: ModelConfig,
                   cache: dict, policy=NULL_POLICY):
    """One decode step over every batch row: (logits (B,1,V), cache)."""
    x = _embed(params, tokens, cfg)
    pos = cache["pos"]
    promote_conv(cache, x.dtype)
    for li, layer, g in layer_schedule(params, cfg):
        st = {k: a[li] for k, a in cache["mamba"].items()}
        h = rmsnorm(x, layer.norm, cfg.norm_eps)
        out, fin = mamba2_decode_step(layer.mamba, h, st, cfg)
        x = x + out
        _store_state(cache, li, fin)
        if g is not None:
            x = attn_block_decode(params.shared_attn, x, cfg, pos,
                                  cache["k"][g], cache["v"][g], policy)
            x = mlp_block(params.shared_mlp, x, cfg, policy)
    cache["pos"] = pos + 1
    return lm_head(params, x, cfg, policy), cache


"""The dense decoder-only stack (mistral-nemo, chatglm3, minicpm, qwen3):
GQA, partial RoPE, qk-norm, scaled embeddings and residuals, tied or
separate output head.

Counterpart of the dense part of ``repro/models/transformer.py``.  The
parameters are ``nn.Module``s (``Attention``, ``MLP``, ``Block``,
``Transformer``) with the reference's names; the reference's stacked layer
axis becomes ``Transformer.layers``, and its ``lax.scan`` a loop over them.
The reference casts every fp32 parameter of two or more dimensions to the
compute dtype on each call (``cast_params``); the port stores those
parameters in the compute dtype once, which gives the same values, and
keeps the 1-D norm weights in the parameter dtype.  The KV cache is
updated in place.  Experts, codebooks and vision tokens are not ported.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .common import ModelConfig, dense_init, embed_init
from .layers import (rmsnorm, rope_cos_sin, apply_rope, flash_attention,
                     decode_attention, swiglu)


def _param(shape, cfg: ModelConfig, device) -> nn.Parameter:
    """An uninitialised parameter: the compute dtype at two or more
    dimensions (the reference's cast), else the parameter dtype."""
    dt = cfg.compute_dtype if len(shape) >= 2 else cfg.param_dtype
    return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        M, hd = cfg.d_model, cfg.hd
        self.norm = _param((M,), cfg, device)
        self.wq = _param((M, cfg.n_heads * hd), cfg, device)
        self.wk = _param((M, cfg.n_kv_heads * hd), cfg, device)
        self.wv = _param((M, cfg.n_kv_heads * hd), cfg, device)
        self.wo = _param((cfg.n_heads * hd, M), cfg, device)
        if cfg.qk_norm:
            self.q_norm = _param((hd,), cfg, device)
            self.k_norm = _param((hd,), cfg, device)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> None:
        hd, dev = cfg.hd, self.wq.device
        self.norm.fill_(1.0)
        for w in (self.wq, self.wk, self.wv):
            w.copy_(dense_init(tuple(w.shape), g, device=dev))
        self.wo.copy_(dense_init(tuple(self.wo.shape), g, device=dev,
                                 scale=1.0 / math.sqrt(cfg.n_heads * hd)))
        if cfg.qk_norm:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        M, F = cfg.d_model, cfg.d_ff
        self.norm = _param((M,), cfg, device)
        self.w_gate = _param((M, F), cfg, device)
        self.w_up = _param((M, F), cfg, device)
        self.w_down = _param((F, M), cfg, device)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> None:
        dev = self.w_up.device
        self.norm.fill_(1.0)
        self.w_gate.copy_(dense_init(tuple(self.w_gate.shape), g, device=dev))
        self.w_up.copy_(dense_init(tuple(self.w_up.shape), g, device=dev))
        self.w_down.copy_(dense_init(tuple(self.w_down.shape), g, device=dev,
                                     scale=1.0 / math.sqrt(cfg.d_ff)))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.attn0 = Attention(cfg, device)
        self.mlp0 = MLP(cfg, device)


class Transformer(nn.Module):
    """Embedding, ``n_layers`` blocks, final norm and (unless the
    embeddings are tied) the output head."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        V, M = cfg.padded_vocab, cfg.d_model
        self.embed = _param((V, M), cfg, device)
        self.final_norm = _param((M,), cfg, device)
        if not cfg.tie_embeddings:
            self.out_head = _param((M, V), cfg, device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> "Transformer":
        """Random weights drawn from ``g`` (a generator on the parameters'
        device), in the reference's order and distributions."""
        dev = self.embed.device
        self.embed.copy_(embed_init(tuple(self.embed.shape), g, device=dev))
        self.final_norm.fill_(1.0)
        if not cfg.tie_embeddings:
            self.out_head.copy_(dense_init(tuple(self.out_head.shape), g,
                                           device=dev))
        for blk in self.layers:
            blk.attn0.init(cfg, g)
            blk.mlp0.init(cfg, g)
        return self


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.hd
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    q = (h @ p.wq).reshape(B, S, cfg.n_heads, hd)
    k = (h @ p.wk).reshape(B, S, cfg.n_kv_heads, hd)
    v = (h @ p.wv).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    rot = int(hd * cfg.rotary_pct)
    cos, sin = rope_cos_sin(positions, rot - rot % 2, cfg.rope_theta)
    q = apply_rope(q, cos, sin, cfg.rotary_pct)
    k = apply_rope(k, cos, sin, cfg.rotary_pct)
    return q, k, v


def attn_out(p: Attention, x: torch.Tensor, o: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The output projection and the (scaled) residual."""
    o = o.reshape(x.shape[0], x.shape[1], -1) @ p.wo
    return x + o * cfg.residual_scale


def attn_block_train(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor):
    """Causal self-attention over the whole segment (prefill); returns
    (x, (k, v))."""
    q, k, v = _qkv(p, x, cfg, positions)
    o = flash_attention(q, k, v, causal=True,
                        softcap=cfg.attn_logit_softcap)
    return attn_out(p, x, o, cfg), (k, v)


def attn_block_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                      pos: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor) -> torch.Tensor:
    """x (B,1,M); pos (B,) index of the new token; caches (B,Smax,Hkv,hd),
    into which the new k/v are written in place (at pos, clamped to the
    last slot as the reference's dynamic_update_slice clamps)."""
    q, k, v = _qkv(p, x, cfg, pos[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    idx = pos.long().clamp(0, k_cache.shape[1] - 1)
    k_cache[rows, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, idx] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, pos + 1,
                         softcap=cfg.attn_logit_softcap)
    return attn_out(p, x, o, cfg)


def mlp_block(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    return x + swiglu(h, p.w_gate, p.w_up, p.w_down) * cfg.residual_scale


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params: Transformer, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """tokens (B,S) -> (B,S,M) in the compute dtype."""
    return params.embed[tokens].to(cfg.compute_dtype) * cfg.scale_emb


def lm_head(params: Transformer, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """x (B,S,M) -> logits (B,S,V) fp32."""
    h = rmsnorm(x, params.final_norm, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.out_head
    logits = (h @ w).float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits


# ---------------------------------------------------------------------------
# serving forward passes
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


@torch.no_grad()
def forward_prefill(params: Transformer, tokens: torch.Tensor,
                    cfg: ModelConfig, cache: dict):
    """Run the prompt, fill the KV cache in place; returns (cache,
    last-token hidden (B,1,M))."""
    x = embed_tokens(params, tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for li, blk in enumerate(params.layers):
        x, (k, v) = attn_block_train(blk.attn0, x, cfg, positions)
        x = mlp_block(blk.mlp0, x, cfg)
        cache["k"][li, :B, :S] = k.to(cache["k"].dtype)
        cache["v"][li, :B, :S] = v.to(cache["v"].dtype)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return cache, x[:, -1:]


@torch.no_grad()
def forward_decode(params: Transformer, tokens: torch.Tensor,
                   cfg: ModelConfig, cache: dict):
    """One decode step over every batch row.  tokens (B,1) -> (logits
    (B,1,V), cache), the cache updated in place."""
    x = embed_tokens(params, tokens, cfg)
    pos = cache["pos"]
    for li, blk in enumerate(params.layers):
        x = attn_block_decode(blk.attn0, x, cfg, pos, cache["k"][li],
                              cache["v"][li])
        x = mlp_block(blk.mlp0, x, cfg)
    cache["pos"] = pos + 1
    return lm_head(params, x, cfg), cache

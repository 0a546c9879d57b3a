"""The attention families' decoder-only stack: dense (mistral-nemo,
chatglm3, minicpm, qwen3: GQA, partial RoPE, qk-norm, scaled embeddings and
residuals, tied or separate head), moe (llama4 scout and maverick: a
shared expert and top-1 routed experts on every ``moe_every``-th layer),
vlm (llava-next: precomputed vision embeddings prepended at prefill) and
audio (musicgen: K codebooks summed at the input, K output heads).

Counterpart of ``repro/models/transformer.py``.  The parameters are
``nn.Module``s with the reference's names (``Attention``, ``MLP``,
``moe.MoE``, ``Block``, ``Transformer``): the reference's stacked layer
axis becomes ``Transformer.layers``, one ``Block`` per superblock of
``moe_every`` layers (``attn{j}``, then ``moe{j}`` with ``moe{j}_norm`` or
``mlp{j}``; one layer, ``attn0`` and ``mlp0``, without experts), and its
``lax.scan`` a loop over them.  The reference casts every fp32 parameter
of two or more dimensions to the compute dtype on each call
(``cast_params``); the port stores those parameters in the compute dtype
once, which gives the same values, and keeps the 1-D norm weights in the
parameter dtype (they enter only through ``rmsnorm``, which casts them).
The KV cache is updated in place.  ``forward_train`` reads a training
module (fp32 masters) through ``cast_params``, as the reference does, and
recomputes each superblock in its backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).  Every
function takes the reference's ``policy`` and calls ``policy.act`` where it
does, with its kinds; the attention reads the KV heads unrepeated, so the
reference's two ``attn_q`` sites on the repeated K and V see them at their
own (B, S, Hkv, hd).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import (NULL_POLICY, ModelConfig, _param, cast_params,
                     dense_init, embed_init)
from .layers import (rmsnorm, rope_cos_sin, apply_rope, flash_attention,
                     decode_attention, swiglu)
from .moe import MoE, moe_layer


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


def _is_moe_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    """MoE sits on the last slot of each ``moe_every`` superblock."""
    return cfg.n_experts > 0 and (layer_idx % cfg.moe_every
                                  == cfg.moe_every - 1)


def n_attn(cfg: ModelConfig) -> int:
    """Layers per superblock."""
    return cfg.moe_every if cfg.n_experts else 1


class Block(nn.Module):
    """One superblock: ``attn{j}`` and ``moe{j}`` (with ``moe{j}_norm``)
    or ``mlp{j}`` for each of its layers j."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        M = cfg.d_model
        for j in range(n_attn(cfg)):
            setattr(self, f"attn{j}", Attention(cfg, device))
            if _is_moe_layer(cfg, j):
                setattr(self, f"moe{j}", MoE(cfg, device))
                setattr(self, f"moe{j}_norm", _param((M,), cfg, device))
            else:
                setattr(self, f"mlp{j}", MLP(cfg, device))

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> None:
        for j in range(n_attn(cfg)):
            getattr(self, f"attn{j}").init(cfg, g)
            if hasattr(self, f"moe{j}"):
                getattr(self, f"moe{j}").init(cfg, g)
                getattr(self, f"moe{j}_norm").fill_(1.0)
            else:
                getattr(self, f"mlp{j}").init(cfg, g)


class Transformer(nn.Module):
    """Embedding (per codebook with ``n_codebooks``), the superblocks,
    final norm and (unless the embeddings are tied) the output head."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        V, M, K = cfg.padded_vocab, cfg.d_model, cfg.n_codebooks
        self.embed = _param((K, V, M) if K else (V, M), cfg, device)
        self.final_norm = _param((M,), cfg, device)
        if K:
            self.out_head = _param((K, M, V), cfg, device)
        elif not cfg.tie_embeddings:
            self.out_head = _param((M, V), cfg, device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in
                                    range(cfg.n_layers // n_attn(cfg)))

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> "Transformer":
        """Random weights drawn from ``g`` (a generator on the parameters'
        device), in the reference's order and distributions."""
        dev = self.embed.device
        self.embed.copy_(embed_init(tuple(self.embed.shape), g, device=dev))
        self.final_norm.fill_(1.0)
        if hasattr(self, "out_head"):
            self.out_head.copy_(dense_init(tuple(self.out_head.shape), g,
                                           device=dev))
        for blk in self.layers:
            blk.init(cfg, g)
        return self


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor, policy=NULL_POLICY):
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
    q = policy.act(q, "attn_q")
    return q, k, v


def attn_out(p: Attention, x: torch.Tensor, o: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """The output projection and the (scaled) residual."""
    o = o.reshape(x.shape[0], x.shape[1], -1) @ p.wo
    return x + o * cfg.residual_scale


def attn_block_train(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                     positions: torch.Tensor, policy=NULL_POLICY):
    """Causal self-attention over the whole segment (prefill); returns
    (x, (k, v))."""
    q, k, v = _qkv(p, x, cfg, positions, policy)
    o = flash_attention(q, policy.act(k, "attn_q"), policy.act(v, "attn_q"),
                        causal=True, softcap=cfg.attn_logit_softcap)
    return attn_out(p, x, o, cfg), (k, v)


def attn_block_decode(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                      pos: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      policy=NULL_POLICY) -> torch.Tensor:
    """x (B,1,M); pos (B,) index of the new token; caches (B,Smax,Hkv,hd),
    into which the new k/v are written in place (at pos, clamped to the
    last slot as the reference's dynamic_update_slice clamps)."""
    q, k, v = _qkv(p, x, cfg, pos[:, None], policy)
    rows = torch.arange(x.shape[0], device=x.device)
    idx = pos.long().clamp(0, k_cache.shape[1] - 1)
    k_cache[rows, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, idx] = v[:, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, pos + 1,
                         softcap=cfg.attn_logit_softcap)
    return attn_out(p, x, o, cfg)


def mlp_block(p: MLP, x: torch.Tensor, cfg: ModelConfig,
              policy=NULL_POLICY) -> torch.Tensor:
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    return x + swiglu(h, p.w_gate, p.w_up, p.w_down,
                      policy) * cfg.residual_scale


def ffn_or_moe(block: Block, j: int, x: torch.Tensor, cfg: ModelConfig,
               policy=NULL_POLICY):
    """Layer j's feed-forward half; returns (x, aux_loss)."""
    moe = getattr(block, f"moe{j}", None)
    if moe is not None:
        h = rmsnorm(x, getattr(block, f"moe{j}_norm"), cfg.norm_eps)
        out, aux = moe_layer(moe, h, cfg, policy)
        return x + out * cfg.residual_scale, aux
    return mlp_block(getattr(block, f"mlp{j}"), x, cfg, policy), 0.0


def layer_blocks(params: "Transformer", cfg: ModelConfig):
    """(layer index, superblock, j) for every layer, in order."""
    na = n_attn(cfg)
    for s, blk in enumerate(params.layers):
        for j in range(na):
            yield s * na + j, blk, j


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params: Transformer, tokens: torch.Tensor,
                 cfg: ModelConfig, vision_embeds=None) -> torch.Tensor:
    """tokens (B,S) or (B,S,K) -> (B,S',M) in the compute dtype, with the
    vision embeddings (B,n_vis,M), when given, in front."""
    emb = params.embed
    if cfg.n_codebooks:
        x = 0
        for k in range(cfg.n_codebooks):        # summed in the weights' dtype
            x = x + F.embedding(tokens[..., k], emb[k])
    else:
        x = F.embedding(tokens, emb)
    x = x.to(cfg.compute_dtype) * cfg.scale_emb
    if cfg.n_vis_tokens and vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    return x


def lm_head(params: Transformer, x: torch.Tensor, cfg: ModelConfig,
            policy=NULL_POLICY) -> torch.Tensor:
    """x (B,S,M) -> logits (B,S,V), or (B,S,K,V) with codebooks, fp32."""
    params = cast_params(params, cfg)
    h = rmsnorm(x, params.final_norm, cfg.norm_eps)
    if cfg.n_codebooks:
        logits = torch.einsum("bsm,kmv->bskv", h, params.out_head)
    else:
        w = params.embed.T if cfg.tie_embeddings else params.out_head
        logits = h @ w.to(h.dtype)
    logits = policy.act(logits.float(), "logits")
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def forward_train(params: Transformer, tokens: torch.Tensor,
                  cfg: ModelConfig, *, vision_embeds=None,
                  policy=NULL_POLICY, remat: bool = True):
    """Returns (hidden (B,S',M) before the final norm, aux_loss): the head
    and the loss are the caller's (``train/losses.py``)."""
    params = cast_params(params, cfg)
    x = embed_tokens(params, tokens, cfg, vision_embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = policy.act(x, "residual")

    def superblock(x, aux, blk):
        for j in range(n_attn(cfg)):
            x, _ = attn_block_train(getattr(blk, f"attn{j}"), x, cfg,
                                    positions, policy)
            x = policy.act(x, "residual")
            x, a = ffn_or_moe(blk, j, x, cfg, policy)
            x = policy.act(x, "residual")
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.layers:
        if remat:
            x, aux = checkpoint(superblock, x, aux, blk, use_reentrant=False)
        else:
            x, aux = superblock(x, aux, blk)
    return x, aux


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
                    cfg: ModelConfig, cache: dict, vision_embeds=None,
                    policy=NULL_POLICY):
    """Run the prompt (after the vision embeddings, when given), fill the
    KV cache in place; returns (cache, last-token hidden (B,1,M))."""
    x = embed_tokens(params, tokens, cfg, vision_embeds)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = policy.act(x, "residual")
    for li, blk, j in layer_blocks(params, cfg):
        x, (k, v) = attn_block_train(getattr(blk, f"attn{j}"), x, cfg,
                                     positions, policy)
        x, _ = ffn_or_moe(blk, j, x, cfg, policy)
        x = policy.act(x, "residual")
        cache["k"][li, :B, :S] = k.to(cache["k"].dtype)
        cache["v"][li, :B, :S] = v.to(cache["v"].dtype)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return cache, x[:, -1:]


@torch.no_grad()
def forward_decode(params: Transformer, tokens: torch.Tensor,
                   cfg: ModelConfig, cache: dict, policy=NULL_POLICY):
    """One decode step over every batch row.  tokens (B,1) or (B,1,K) ->
    (logits (B,1,V) or (B,1,K,V), cache), the cache updated in place."""
    x = embed_tokens(params, tokens, cfg)
    pos = cache["pos"]
    x = policy.act(x, "residual")
    for li, blk, j in layer_blocks(params, cfg):
        x = attn_block_decode(getattr(blk, f"attn{j}"), x, cfg, pos,
                              cache["k"][li], cache["v"][li], policy)
        x, _ = ffn_or_moe(blk, j, x, cfg, policy)
    cache["pos"] = pos + 1
    return lm_head(params, x, cfg, policy), cache

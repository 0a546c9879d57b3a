"""Continue-prefill ("extend"): run a token segment on top of an existing
cache, the primitive behind prefix-cache reuse.  A prefix hit restores KV
blocks (attention families) or a state snapshot (SSM families) and the
engine extends only the uncached suffix.  ``policy`` is the reference's
activation hook, passed on to the blocks.

Counterpart of ``repro/serve/extend.py``.  The reference copies a batch
slot's cache out and back around the call; here ``cache`` may be views of
the engine's slot, and the new K/V and states are written into it in
place (a leaf the call must widen, zamba's conv state in fp32 compute, is
replaced in ``cache`` instead, and the engine copies it back).  The
attention reads K and V straight from the cache (through its strides, up
to ``start + S``) with the query rows at ``q_offset=start``.  ``start`` is
a host int.  As in the reference, zamba and xLSTM always continue from the
states in ``cache``, at ``start == 0`` too.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.models import zamba as Z
from repro_torch.models.common import NULL_POLICY, ModelConfig
from repro_torch.models.layers import flash_attention


def _attn_extend(p: T.Attention, x: torch.Tensor, cfg: ModelConfig,
                 start: int, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, policy=NULL_POLICY) -> torch.Tensor:
    """x (B,S,M); caches (B,Smax,Hkv,hd) valid to ``start``; the new
    segment's K/V are written at [start:start+S] in place."""
    B, S, _ = x.shape
    if start + S > k_cache.shape[1]:
        raise ValueError(f"extend: {start} + {S} tokens exceed the cache's "
                         f"{k_cache.shape[1]} slots")
    positions = (start + torch.arange(S, device=x.device)).expand(B, S)
    q, k, v = T._qkv(p, x, cfg, positions, policy)
    k_cache[:, start:start + S] = k.to(k_cache.dtype)
    v_cache[:, start:start + S] = v.to(v_cache.dtype)
    o = flash_attention(q, k_cache, v_cache, causal=True, q_offset=start,
                        kv_len=start + S, softcap=cfg.attn_logit_softcap)
    return T.attn_out(p, x, o, cfg)


@torch.no_grad()
def transformer_extend(params: T.Transformer, tokens: torch.Tensor,
                       cfg: ModelConfig, cache: dict, start: int, *,
                       vision_embeds=None, policy=NULL_POLICY):
    """tokens (B,S) or (B,S,K) after ``start`` cached positions (the
    vision embeddings go in front at ``start == 0`` only); returns (cache,
    last-token hidden (B,1,M)) with ``cache["pos"]`` = start + S'."""
    x = T.embed_tokens(params, tokens, cfg,
                       vision_embeds if start == 0 else None)
    B, S, _ = x.shape
    for li, blk, j in T.layer_blocks(params, cfg):
        x = _attn_extend(getattr(blk, f"attn{j}"), x, cfg, start,
                         cache["k"][li], cache["v"][li], policy)
        x, _ = T.ffn_or_moe(blk, j, x, cfg, policy)
    cache["pos"][:] = start + S
    return cache, x[:, -1:]


@torch.no_grad()
def zamba_extend(params: Z.Zamba, tokens: torch.Tensor, cfg: ModelConfig,
                 cache: dict, start: int, *, policy=NULL_POLICY):
    """Mamba2 from the cache's states, the shared attention over the
    cache's KV at ``q_offset=start`` (the flash kernel)."""
    x = Z._embed(params, tokens, cfg)
    B, S, _ = x.shape
    Z.promote_conv(cache, x.dtype)
    for li, layer, g in Z.layer_schedule(params, cfg):
        st = {k: a[li] for k, a in cache["mamba"].items()}
        x, fin = Z.mamba_block(layer, x, cfg, st, policy)
        Z._store_state(cache, li, fin)
        if g is not None:
            x = _attn_extend(params.shared_attn, x, cfg, start,
                             cache["k"][g], cache["v"][g], policy)
            x = T.mlp_block(params.shared_mlp, x, cfg, policy)
    cache["pos"][:] = start + S
    return cache, x[:, -1:]


@torch.no_grad()
def xlstm_extend(params: X.XLSTM, tokens: torch.Tensor, cfg: ModelConfig,
                 cache: dict, start: int):
    """Pure state continuation from the cache's states."""
    x = X._embed(params, tokens, cfg)
    S = x.shape[1]
    x = X.run_stack(params, x, cfg, cache, carry=True)
    cache["pos"][:] = start + S
    return cache, x[:, -1:]


def extend(model, params, tokens: torch.Tensor, cache: dict, start: int, *,
           vision_embeds=None, policy=NULL_POLICY):
    cfg = model.cfg
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return transformer_extend(params, tokens, cfg, cache, start,
                                  vision_embeds=vision_embeds, policy=policy)
    if cfg.family == "hybrid_ssm":
        return zamba_extend(params, tokens, cfg, cache, start, policy=policy)
    if cfg.family == "xlstm":
        return xlstm_extend(params, tokens, cfg, cache, start)
    raise ValueError(cfg.family)

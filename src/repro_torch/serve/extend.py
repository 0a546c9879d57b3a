"""Continue-prefill ("extend"): run a token segment on top of an existing
KV cache, the primitive behind prefix-cache reuse.  A prefix hit restores
KV blocks and the engine extends only the uncached suffix.

Counterpart of ``repro/serve/extend.py`` for the attention families.  The
reference copies a batch slot's cache out and back around the call; here
``cache`` may be a view of the engine's slot, and the new K/V are written
into it in place.  The attention reads K and V straight from the cache
(through its strides, up to ``start + S``) with the query rows at
``q_offset=start``.  ``start`` is a host int.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import flash_attention


def _attn_extend(p: T.Attention, x: torch.Tensor, cfg: ModelConfig,
                 start: int, k_cache: torch.Tensor,
                 v_cache: torch.Tensor) -> torch.Tensor:
    """x (B,S,M); caches (B,Smax,Hkv,hd) valid to ``start``; the new
    segment's K/V are written at [start:start+S] in place."""
    B, S, _ = x.shape
    if start + S > k_cache.shape[1]:
        raise ValueError(f"extend: {start} + {S} tokens exceed the cache's "
                         f"{k_cache.shape[1]} slots")
    positions = (start + torch.arange(S, device=x.device)).expand(B, S)
    q, k, v = T._qkv(p, x, cfg, positions)
    k_cache[:, start:start + S] = k.to(k_cache.dtype)
    v_cache[:, start:start + S] = v.to(v_cache.dtype)
    o = flash_attention(q, k_cache, v_cache, causal=True, q_offset=start,
                        kv_len=start + S, softcap=cfg.attn_logit_softcap)
    return T.attn_out(p, x, o, cfg)


@torch.no_grad()
def transformer_extend(params: T.Transformer, tokens: torch.Tensor,
                       cfg: ModelConfig, cache: dict, start: int):
    """tokens (B,S) after ``start`` cached positions; returns (cache,
    last-token hidden (B,1,M)) with ``cache["pos"]`` = start + S."""
    x = T.embed_tokens(params, tokens, cfg)
    B, S, _ = x.shape
    for li, blk in enumerate(params.layers):
        x = _attn_extend(blk.attn0, x, cfg, start, cache["k"][li],
                         cache["v"][li])
        x = T.mlp_block(blk.mlp0, x, cfg)
    cache["pos"][:] = start + S
    return cache, x[:, -1:]


def zamba_extend(*args, **kw):
    raise NotImplementedError("zamba extend (Mamba2 state continuation) is "
                              "ROADMAP queue 1 item 14")


def xlstm_extend(*args, **kw):
    raise NotImplementedError("xLSTM extend (mLSTM/sLSTM state "
                              "continuation) is ROADMAP queue 1 item 14")


def extend(model, params, tokens: torch.Tensor, cache: dict, start: int):
    cfg = model.cfg
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return transformer_extend(params, tokens, cfg, cache, start)
    if cfg.family == "hybrid_ssm":
        return zamba_extend(model, params, tokens, cache, start)
    if cfg.family == "xlstm":
        return xlstm_extend(model, params, tokens, cache, start)
    raise ValueError(cfg.family)

"""Chunked cross-entropy: the final norm, the vocab projection and the
softmax run per chunk of sequence positions under
``torch.utils.checkpoint``, so the whole (B, S, V) fp32 logits tensor
never exists (the backward recomputes one chunk at a time).

Counterpart of ``repro/train/losses.py``: plain LM head, tied embeddings,
multi-codebook audio heads (the codebooks' losses averaged) and the vlm
vision prefix (no loss on its positions); padded vocab columns are masked
at -1e30.  The head weights are cast to the hidden dtype once, before the
chunks (the reference casts them in each chunk: the same values).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import NULL_POLICY, ModelConfig
from repro_torch.models.layers import rmsnorm


def _head_weights(params, cfg: ModelConfig):
    if cfg.n_codebooks:
        return params.out_head                       # (K, M, V)
    if cfg.tie_embeddings:
        return params.embed.T                        # (M, V)
    return params.out_head


def _chunk_logits(h, w, cfg: ModelConfig, policy=NULL_POLICY):
    """h (B, c, M) -> fp32 logits (B, c, V) or (B, c, K, V)."""
    if cfg.n_codebooks:
        logits = torch.einsum("bcm,kmv->bckv", h, w)
    else:
        logits = h @ w
    logits = policy.act(logits.float(), "logits")
    if cfg.padded_vocab != cfg.vocab_size:
        # mask storage-padding columns so softmax is over the true vocab
        col = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return logits


def chunked_cross_entropy(params, hidden, tokens, cfg: ModelConfig, *,
                          chunk: int = 256, policy=NULL_POLICY):
    """hidden (B, S', M) before the final norm (applied here); tokens
    (B, S) or (B, S, K).  Returns (mean nll, metrics): position t predicts
    token t + 1; the vlm vision prefix's positions are excluded."""
    B = hidden.shape[0]
    off = cfg.n_vis_tokens if cfg.family == "vlm" else 0
    h = hidden[:, off:hidden.shape[1] - 1]
    labels = tokens[:, 1:].long()
    T = h.shape[1]
    w = _head_weights(params, cfg).to(h.dtype)
    norm_w = params.final_norm

    pad = (-T) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, ((0, 0) if cfg.n_codebooks else ())
                       + (0, pad))
    mask = (torch.arange(h.shape[1], device=h.device) < T).float()

    def one_chunk(h_c, l_c, m_c, w, norm_w):
        h_c = rmsnorm(h_c, norm_w, cfg.norm_eps)
        logits = _chunk_logits(h_c, w, cfg, policy)          # fp32
        lse = torch.logsumexp(logits, dim=-1)
        true = logits.gather(-1, l_c[..., None])[..., 0]
        nll = lse - true                                     # (B,c)[,K]
        if cfg.n_codebooks:
            nll = nll.mean(-1)
        mm = m_c.expand(nll.shape)
        return (nll * mm).sum(), mm.sum()

    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], chunk):
        s, n = checkpoint(one_chunk, h[:, c0:c0 + chunk],
                          labels[:, c0:c0 + chunk], mask[None, c0:c0 + chunk],
                          w, norm_w, use_reentrant=False)
        loss_sum = loss_sum + s
        count = count + n
    loss = loss_sum / torch.clamp(count, min=1.0)
    return loss, {"nll": loss, "tokens": count}

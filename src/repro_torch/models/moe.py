"""Switch-style top-1 MoE with capacity-bounded scatter dispatch and an
optional shared expert (the llama4 family).

Counterpart of ``repro/models/moe.py``.  Per batch row, each token goes to
its router's argmax expert (first index on ties) at the position given by
a cumulative count over the row; tokens past the expert's capacity ``C``
are dropped (their residual passes through).  The kept tokens are added
into (E * C) slots by ``index_add_``: every kept token has a slot of its
own and a dropped one adds zeros, so the sums are the tokens themselves,
as in the reference's scatter.  The experts run as batched products over
the expert axis, and the tokens are gathered back and scaled by their
gate.  The reference's sharding hints (``policy=``) are not ported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import NULL_POLICY, ModelConfig, _param, dense_init


def moe_capacity(cfg: ModelConfig, seq: int) -> int:
    c = int(math.ceil(seq / cfg.n_experts * cfg.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)      # padded as the reference pads


class MoE(nn.Module):
    """The router, the stacked expert FFNs and the shared expert."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        M, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _param((M, E), cfg, device)
        self.w_gate = _param((E, M, Fd), cfg, device)
        self.w_up = _param((E, M, Fd), cfg, device)
        self.w_down = _param((E, Fd, M), cfg, device)
        if cfg.n_shared_experts:
            Fs = Fd * cfg.n_shared_experts
            self.shared_gate = _param((M, Fs), cfg, device)
            self.shared_up = _param((M, Fs), cfg, device)
            self.shared_down = _param((Fs, M), cfg, device)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> None:
        dev = self.router.device
        down = 1.0 / math.sqrt(cfg.d_ff)
        for name, p in self.named_parameters():
            scale = down if name in ("w_down", "shared_down") else None
            p.copy_(dense_init(tuple(p.shape), g, device=dev, scale=scale))


def moe_layer(p: MoE, x: torch.Tensor, cfg: ModelConfig,
              policy=NULL_POLICY):
    """x (B, S, M) -> (out (B, S, M), aux_loss scalar)."""
    B, S, M = x.shape
    E = cfg.n_experts
    C = moe_capacity(cfg, S)

    logits = (x @ p.router).float()                                 # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    e_idx = probs.argmax(-1)                                        # first max
    gate = probs.gather(-1, e_idx[..., None])[..., 0]               # (B,S)

    # load-balancing aux loss (Switch eq. 4-6)
    onehot = F.one_hot(e_idx, E).float()                            # (B,S,E)
    aux = ((onehot.mean(1) * probs.mean(1)).sum(-1).mean() * E
           * cfg.router_aux_coef)

    # capacity: the token's position within its expert, per batch row
    pos_in_e = (onehot.cumsum(1) * onehot).sum(-1).long() - 1       # (B,S)
    keep = pos_in_e < C
    slot = e_idx * C + torch.where(keep, pos_in_e, 0)               # (B,S)

    # scatter dispatch: (B, S, M) -> (B, E*C, M)
    rows = torch.arange(B, device=x.device)[:, None] * (E * C)
    dispatched = torch.zeros((B * E * C, M), dtype=x.dtype, device=x.device)
    dispatched.index_add_(0, (rows + slot).reshape(-1),
                          (x * keep[..., None].to(x.dtype)).reshape(-1, M))
    dispatched = policy.act(dispatched.view(B, E, C, M), "moe_dispatch")

    # expert FFNs, batched over the expert axis
    h = (F.silu(torch.einsum("becm,emf->becf", dispatched, p.w_gate))
         * torch.einsum("becm,emf->becf", dispatched, p.w_up))
    h = policy.act(h, "moe_hidden")
    eout = torch.einsum("becf,efm->becm", h, p.w_down)              # (B,E,C,M)
    eout = policy.act(eout, "moe_combine")

    # gather combine
    out = eout.reshape(B, E * C, M).gather(
        1, slot[..., None].expand(B, S, M))                         # (B,S,M)
    out = out * (gate * keep.to(gate.dtype))[..., None].to(x.dtype)

    if cfg.n_shared_experts:
        sh = F.silu(x @ p.shared_gate) * (x @ p.shared_up)
        out = out + sh @ p.shared_down
    return out, aux

"""Mamba2 (SSD) mixer: the chunked parallel scan for prefill and extend, and
the recurrent step for decode (the zamba2 hybrid backbone).

Counterpart of ``repro/models/mamba2.py``, plain PyTorch as the reference
is plain jnp.  The sequence is split into chunks of ``ssm_chunk``
positions (the time axis padded to a multiple with inert steps: dt = 0, so
decay 1 and no input); inside a chunk the masked (L x L) decay
"attention" (masked before ``exp``), across chunks the (H, P, N) state
carried by a loop over the chunks.  The reference's cast points are kept:
the products in the compute dtype, ``att``, ``w_end``, ``w_in`` and the
carried states cast to it, the gate arithmetic and the states in fp32;
the three-operand products pair their operands as the reference's
``jnp.einsum`` does (its contraction path).
The conv state has the dtype of the inputs it was cut from (the compute
dtype, or the cache's when that is wider), as in the reference.
"""
from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import NULL_POLICY, ModelConfig, _param, dense_init
from .layers import rmsnorm

NEG_INF = -1e30


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return d_in, H, cfg.ssm_head_dim, cfg.ssm_state


class Mamba2(nn.Module):
    """One Mamba2 mixer's weights (the reference's ``init_mamba_params``
    leaves): the norm weight in the parameter dtype, every other leaf in
    the compute dtype, as the reference's cast of its layer stack leaves
    them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d_in, H, P, N = ssm_dims(cfg)
        conv_ch = d_in + 2 * N                  # x + B + C (single group)
        M = cfg.d_model

        def param(*shape):
            return _param(shape, cfg, device, cast=True)
        self.in_proj = param(M, 2 * d_in + 2 * N + H)
        self.conv_w = param(cfg.ssm_conv, conv_ch)
        self.conv_b = param(conv_ch)
        self.dt_bias = param(H)
        self.A_log = param(H)
        self.D = param(H)
        self.norm_w = _param((d_in,), cfg, device)
        self.out_proj = param(d_in, M)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> None:
        dev = self.in_proj.device
        H = self.A_log.shape[0]
        self.in_proj.copy_(dense_init(tuple(self.in_proj.shape), g,
                                      device=dev))
        self.conv_w.copy_(dense_init(tuple(self.conv_w.shape), g, device=dev,
                                     scale=0.5))
        self.conv_b.zero_()
        self.dt_bias.zero_()
        self.A_log.copy_(torch.from_numpy(np.log(np.linspace(
            1.0, 16.0, H, dtype=np.float32))))
        self.D.fill_(1.0)
        self.norm_w.fill_(1.0)
        self.out_proj.copy_(dense_init(tuple(self.out_proj.shape), g,
                                       device=dev))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv1d.  x (B,S,C); w (K,C); state (B,K-1,C) holds
    the previous segment's trailing inputs.  Returns (silu(y), new
    state)."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state.to(torch.promote_types(state.dtype, x.dtype)),
                    x.to(torch.promote_types(state.dtype, x.dtype))], dim=1)
    S = x.shape[1]
    y = 0
    for i in range(K):
        y = y + xp[:, i:i + S] * w[i]
    y = y + b
    return F.silu(y), xp[:, -(K - 1):]


def _split_in(p: Mamba2, x: torch.Tensor, cfg: ModelConfig, conv_state,
              policy=NULL_POLICY):
    d_in, H, P, N = ssm_dims(cfg)
    zxbcdt = policy.act(x @ p.in_proj, "mamba_proj")
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * N, H], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p.conv_w.to(x.dtype),
                                   p.conv_b.to(x.dtype), conv_state)
    xbc = policy.act(xbc, "mamba_proj")
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())
    return z, xs, Bm, Cm, dt, A, conv_state


def _gated_out(p: Mamba2, y: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    y = y * F.silu(z)
    y = rmsnorm(y, p.norm_w, cfg.norm_eps)
    return y @ p.out_proj


def mamba2_forward(p: Mamba2, x: torch.Tensor, cfg: ModelConfig, *,
                   initial_state: dict | None = None, policy=NULL_POLICY):
    """x (B,S,M) -> (y (B,S,M), final state {conv (B,K-1,C), ssm
    (B,H,P,N) fp32}), from ``initial_state`` (zeros if None)."""
    B, S, M = x.shape
    d_in, H, P, N = ssm_dims(cfg)
    L = min(cfg.ssm_chunk, S)
    dt_x = x.dtype

    conv0 = None if initial_state is None else initial_state["conv"]
    z, xs, Bm, Cm, dt, A, conv_state = _split_in(p, x, cfg, conv0, policy)
    xs = xs.reshape(B, S, H, P)

    # pad the time axis to a chunk multiple: padded steps are inert
    S_orig = S
    pad = (-S) % L
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        S += pad
    nc = S // L
    dlog = dt * A                                          # log decay <= 0

    xs_c = (xs * dt.to(xs.dtype)[..., None]).reshape(B, nc, L, H, P)
    xs_c = policy.act(xs_c, "mamba_chunk")
    B_c = Bm.reshape(B, nc, L, N)
    C_c = Cm.reshape(B, nc, L, N)
    cum = dlog.reshape(B, nc, L, H).cumsum(2)              # (B,nc,L,H)
    total = cum[:, :, -1]                                  # (B,nc,H)

    # intra-chunk: masked decay attention (fp32 products of the inputs)
    cb = torch.einsum("bcln,bcsn->bcls", C_c.float(), B_c.float())
    dmask = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,L,L,H)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    dmask = torch.where(causal[None, None, :, :, None], dmask, NEG_INF)
    att = policy.act((torch.exp(dmask) * cb[..., None]).to(dt_x), "mamba_att")
    y_intra = torch.einsum("bclsh,bcshp->bclhp", att, xs_c)

    # chunk states and the loop across chunks
    w_end = torch.exp(total[:, :, None, :] - cum).to(dt_x)
    S_c = torch.einsum("bclhp,bcln->bchpn", xs_c * w_end[..., None], B_c)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state["ssm"].float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)                                  # state before c
        h = h * torch.exp(total[:, c])[:, :, None, None] + S_c[:, c].float()
    h_prev = torch.stack(h_prevs, 1)                       # (B,nc,H,P,N)

    # inter-chunk output: C_t . exp(cum_t) h_prev
    w_in = torch.exp(cum).to(dt_x)
    y_inter = torch.einsum("bclnh,bchpn->bclhp",
                           C_c[..., None] * w_in[:, :, :, None, :],
                           h_prev.to(dt_x))

    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + xs * p.D.to(dt_x)[None, None, :, None]
    y = y.reshape(B, S, d_in)[:, :S_orig]
    return _gated_out(p, y, z, cfg), {"conv": conv_state, "ssm": h}


def mamba2_decode_step(p: Mamba2, x: torch.Tensor, state: dict,
                       cfg: ModelConfig):
    """One token.  x (B,1,M); state {conv (B,K-1,C), ssm (B,H,P,N)} ->
    (y (B,1,M), new state)."""
    B = x.shape[0]
    d_in, H, P, N = ssm_dims(cfg)
    z, xs, Bm, Cm, dt, A, conv_state = _split_in(p, x, cfg, state["conv"])
    xs = xs.reshape(B, H, P)
    dt = dt[:, 0]                                          # (B,H)
    decay = torch.exp(dt * A)
    dx = xs.float() * dt[..., None]                        # (B,H,P)
    ssm = (state["ssm"] * decay[:, :, None, None]
           + torch.einsum("bhp,bn->bhpn", dx, Bm[:, 0].float()))
    y = torch.einsum("bhpn,bn->bhp", ssm, Cm[:, 0].float())
    y = y.to(x.dtype) + xs * p.D.to(x.dtype)[None, :, None]
    return (_gated_out(p, y.reshape(B, 1, d_in), z, cfg),
            {"conv": conv_state, "ssm": ssm})


def init_mamba_state(cfg: ModelConfig, batch: int, dtype, device=None):
    d_in, H, P, N = ssm_dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * N),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=device)}

"""xLSTM blocks: the chunked-parallel mLSTM (matrix memory) and the strictly
recurrent sLSTM (scalar memory with a block-diagonal recurrence).

Counterpart of ``repro/models/mlstm.py``, plain PyTorch as the reference
is plain jnp.  The mLSTM is the Mamba2 chunk machinery with the
normaliser carried as an extra value column, sigmoid gates (log-sigmoid
in the chunked form) and ``num / max(|den|, 1)``; the time axis is padded
to a chunk multiple with steps whose forget gate is 1 and input weight 0.
The sLSTM keeps the paper's exponential gating with the ``m`` stabiliser
and runs a loop over time, as the reference's ``lax.scan`` does: a few
small operations a token and layer.  The cast points are the reference's
(products in the compute dtype, ``att``/``w_end``/``w_in`` and the carried
states cast to it, gates and states in fp32), and its three-operand
products pair their operands as its ``jnp.einsum`` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, _param, dense_init
from .layers import rmsnorm

NEG_INF = -1e30


def mlstm_dims(cfg: ModelConfig):
    d_in = int(cfg.proj_factor * cfg.d_model)
    H = cfg.n_heads
    return d_in, H, d_in // H


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """One mLSTM's weights (``init_mlstm_params``): the norm weight in the
    parameter dtype, the rest in the compute dtype."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        M = cfg.d_model
        d_in, H, _ = mlstm_dims(cfg)

        def param(*shape):
            return _param(shape, cfg, device, cast=True)
        self.up_x = param(M, d_in)
        self.up_z = param(M, d_in)
        self.w_q = param(d_in, d_in)
        self.w_k = param(d_in, d_in)
        self.w_v = param(d_in, d_in)
        self.w_gates = param(d_in, 2 * H)              # i, f per head
        self.gate_bias = param(2 * H)
        self.norm_w = _param((d_in,), cfg, device)
        self.down = param(d_in, M)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> None:
        dev = self.up_x.device
        H = self.gate_bias.shape[0] // 2
        for w in (self.up_x, self.up_z, self.w_q, self.w_k, self.w_v,
                  self.w_gates):
            w.copy_(dense_init(tuple(w.shape), g, device=dev))
        self.gate_bias.copy_(torch.cat([
            torch.zeros(H), 3.0 + torch.arange(H) * 0.5]))
        self.norm_w.fill_(1.0)
        self.down.copy_(dense_init(tuple(self.down.shape), g, device=dev))


def _mlstm_core_chunked(q, k, v, lf, li, chunk: int, h0=None):
    """Chunked gated linear attention with a normaliser column.  q, k, v
    (B,S,H,D); lf, li (B,S,H) log forget and log input gates (<= 0).
    Returns (y (B,S,H,D), final state (B,H,D,D+1) fp32)."""
    B, S, H, D = q.shape
    L = min(chunk, S)
    scale = 1.0 / math.sqrt(D)
    dt_q = q.dtype

    S_orig = S
    pad = (-S) % L
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        lf = F.pad(lf, (0, 0, 0, pad))
        li = F.pad(li, (0, 0, 0, pad), value=NEG_INF)
        S += pad
    nc = S // L

    vn = torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype,
                                  device=v.device)], -1)
    qc = (q * scale).reshape(B, nc, L, H, D)
    kc = k.reshape(B, nc, L, H, D)
    vc = vn.reshape(B, nc, L, H, D + 1)
    li_c = li.reshape(B, nc, L, H)
    cum = lf.reshape(B, nc, L, H).cumsum(2)             # (B,nc,L,H)
    total = cum[:, :, -1]

    # intra-chunk: att[t,s] = exp(cum_t - cum_s + li_s) (q_t . k_s), s <= t
    qk = torch.einsum("bclhd,bcshd->bclsh", qc.float(), kc.float())
    dmask = (cum[:, :, :, None, :] - cum[:, :, None, :, :]
             + li_c[:, :, None, :, :])                  # (B,nc,L,L,H)
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    dmask = torch.where(causal[None, None, :, :, None], dmask, NEG_INF)
    att = (torch.exp(dmask) * qk).to(dt_q)
    y_intra = torch.einsum("bclsh,bcshd->bclhd", att, vc)

    # chunk states and the loop across chunks
    w_end = torch.exp(total[:, :, None, :] - cum + li_c).to(dt_q)
    S_c = torch.einsum("bclhd,bclhe->bchde", kc, w_end[..., None] * vc)
    h = (torch.zeros((B, H, D, D + 1), dtype=torch.float32, device=q.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(total[:, c])[:, :, None, None] + S_c[:, c].float()
    h_prev = torch.stack(h_prevs, 1)                    # (B,nc,H,D,D+1)

    w_in = torch.exp(cum).to(dt_q)
    y_inter = torch.einsum("bclhd,bchde->bclhe", qc * w_in[..., None],
                           h_prev.to(dt_q))
    y = (y_intra + y_inter).reshape(B, S, H, D + 1)[:, :S_orig]
    num, den = y[..., :-1], y[..., -1:]
    return num / torch.clamp(den.abs(), min=1.0), h


def _mlstm_in(p: MLSTM, x: torch.Tensor, shape):
    xin = x @ p.up_x
    z = x @ p.up_z
    q, k, v = ((xin @ w).reshape(shape) for w in (p.w_q, p.w_k, p.w_v))
    gates = (xin @ p.w_gates).float() + p.gate_bias.float()
    return z, q, k, v, gates


def _mlstm_out(p: MLSTM, y: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    y = rmsnorm(y, p.norm_w, cfg.norm_eps) * F.silu(z)
    return y @ p.down


def mlstm_forward(p: MLSTM, x: torch.Tensor, cfg: ModelConfig, *,
                  initial_state: torch.Tensor | None = None):
    """x (B,S,M) -> (y (B,S,M), final state (B,H,hd,hd+1) fp32)."""
    B, S, M = x.shape
    d_in, H, hd = mlstm_dims(cfg)
    z, q, k, v, gates = _mlstm_in(p, x, (B, S, H, hd))
    li = F.logsigmoid(gates[..., :H])                   # log input gate
    lf = F.logsigmoid(gates[..., H:])                   # log forget gate
    y, state = _mlstm_core_chunked(q, k, v, lf, li, cfg.ssm_chunk,
                                   h0=initial_state)
    return _mlstm_out(p, y.reshape(B, S, d_in), z, cfg), state


def mlstm_decode_step(p: MLSTM, x: torch.Tensor, state: torch.Tensor,
                      cfg: ModelConfig):
    """x (B,1,M); state (B,H,hd,hd+1) fp32."""
    B = x.shape[0]
    d_in, H, hd = mlstm_dims(cfg)
    z, q, k, v, gates = _mlstm_in(p, x, (B, H, hd))
    gates = gates[:, 0]
    i_g = torch.sigmoid(gates[..., :H])
    f_g = torch.sigmoid(gates[..., H:])
    vn = torch.cat([v, torch.ones((B, H, 1), dtype=v.dtype,
                                  device=v.device)], -1)
    kv = torch.einsum("bhd,bhe->bhde", k.float(), vn.float())
    state = state * f_g[:, :, None, None] + kv * i_g[:, :, None, None]
    # the reference divides by a numpy float64 scalar, which promotes the
    # bf16 query to fp32 first
    y = torch.einsum("bhd,bhde->bhe", q.float() / math.sqrt(hd), state)
    num, den = y[..., :-1], y[..., -1:]
    y = (num / torch.clamp(den.abs(), min=1.0)).to(x.dtype)
    return _mlstm_out(p, y.reshape(B, 1, d_in), z, cfg), state


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None):
    d_in, H, hd = mlstm_dims(cfg)
    return torch.zeros((batch, H, hd, hd + 1), dtype=torch.float32,
                       device=device)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """One sLSTM's weights (``init_slstm_params``): the norm weight in the
    parameter dtype, the rest in the compute dtype."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        M, H = cfg.d_model, cfg.n_heads
        hd = M // H

        def param(*shape):
            return _param(shape, cfg, device, cast=True)
        self.w_x = param(M, 4 * M)
        self.r = param(H, hd, 4 * hd)
        self.b = param(4 * M)
        self.norm_w = _param((M,), cfg, device)
        self.out = param(M, M)

    @torch.no_grad()
    def init(self, cfg: ModelConfig, g: torch.Generator) -> None:
        dev = self.w_x.device
        hd = self.r.shape[1]
        self.w_x.copy_(dense_init(tuple(self.w_x.shape), g, device=dev))
        self.r.copy_(dense_init(tuple(self.r.shape), g, device=dev,
                                scale=1.0 / math.sqrt(hd)))
        self.b.zero_()
        self.norm_w.fill_(1.0)
        self.out.copy_(dense_init(tuple(self.out.shape), g, device=dev))


def _slstm_cell(p: SLSTM, xt: torch.Tensor, state: dict,
                cfg: ModelConfig) -> dict:
    """One timestep.  xt (B, 4M) = x @ w_x + b; state {h, c, n, m} of
    (B, M) fp32."""
    M, H = cfg.d_model, cfg.n_heads
    B = xt.shape[0]
    hr = state["h"].reshape(B, H, M // H)
    rec = torch.einsum("bhd,hde->bhe", hr.to(xt.dtype),
                       p.r.to(xt.dtype)).reshape(B, 4 * M)
    pre = (xt + rec).float()
    zt, it, ft, ot = torch.split(pre, M, dim=-1)
    # exponential gating with the stabiliser (xLSTM eq. 15-17)
    m_new = torch.maximum(ft + state["m"], it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + state["m"] - m_new)
    c = f_p * state["c"] + i_p * torch.tanh(zt)
    n = f_p * state["n"] + i_p
    h = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
    return {"h": h, "c": c, "n": n, "m": m_new}


def slstm_forward(p: SLSTM, x: torch.Tensor, cfg: ModelConfig, *,
                  initial_state: dict | None = None):
    """x (B,S,M) -> (y (B,S,M), final state); a loop over time."""
    B, S, M = x.shape
    xw = x @ p.w_x + p.b.to(x.dtype)
    st = (initial_state if initial_state is not None
          else init_slstm_state(cfg, B, x.device))
    hs = []
    for t in range(S):
        st = _slstm_cell(p, xw[:, t], st, cfg)
        hs.append(st["h"])
    y = torch.stack(hs, 1).to(x.dtype)
    y = rmsnorm(y, p.norm_w, cfg.norm_eps)
    return y @ p.out, st


def slstm_decode_step(p: SLSTM, x: torch.Tensor, state: dict,
                      cfg: ModelConfig):
    xw = (x @ p.w_x + p.b.to(x.dtype))[:, 0]
    new = _slstm_cell(p, xw, state, cfg)
    y = rmsnorm(new["h"].to(x.dtype)[:, None, :], p.norm_w, cfg.norm_eps)
    return y @ p.out, new


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return {k: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                           device=device) for k in ("h", "c", "n", "m")}

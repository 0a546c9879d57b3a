"""Core layers: RMSNorm, RoPE (incl. partial/"2d"), blocked attention for
prefill and extend, decode attention, SwiGLU MLP.

Counterpart of ``repro/models/layers.py``, same layouts at every function:
activations (B, S, M), heads (B, S, H, D).  ``flash_attention`` is the
kernel module's wrapper (``kernels/flash_attention.py``): on the card it
launches the hand-written kernel, which takes the KV heads as they are (no
``repeat_kv``).  ``decode_attention`` is plain PyTorch, as it is jnp in the
reference.  Where the reference asks for fp32 products of bf16 operands
(``preferred_element_type``), the operands are cast to fp32 first: the
products are exact, and fp32 matmuls on the card run without TF32 unless a
caller turns it on.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import NEG_INF, flash_attention
from .common import NULL_POLICY

__all__ = ["rmsnorm", "rope_cos_sin", "apply_rope", "flash_attention",
           "decode_attention", "swiglu"]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


@functools.lru_cache(maxsize=32)
def _inv_freq(rot_dim: int, theta: float, device: torch.device):
    """The reference's float32 numpy inverse frequencies, copied to
    ``device`` once: a copy from pageable host memory waits for the card,
    so it is kept out of every layer's forward."""
    inv = 1.0 / (theta ** (np.arange(0, rot_dim, 2, dtype=np.float32)
                           / rot_dim))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


def rope_cos_sin(positions: torch.Tensor, rot_dim: int, theta: float):
    """positions (...,) int -> cos/sin (..., rot_dim//2) fp32."""
    ang = (positions.float()[..., None]
           * _inv_freq(rot_dim, theta, positions.device))
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, rot//2).  Rotates the first
    ``rotary_pct * D`` dims (half-split convention)."""
    d = x.shape[-1]
    rot = int(d * rotary_pct)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr.chunk(2, dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < d else out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-token attention over a (padded) KV cache.

    q (B, 1, Hq, D); caches (B, Smax, Hkv, D); pos (B,) = number of valid
    cache slots (the new token's k/v already written at pos-1)."""
    B, _, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) \
        * (1.0 / math.sqrt(D))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = torch.arange(Smax, device=q.device)[None, :] < pos[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(q.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, policy=NULL_POLICY) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return policy.act(h, "ffn_hidden") @ w_down

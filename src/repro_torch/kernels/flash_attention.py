"""Blocked online-softmax attention: plain PyTorch version and CUDA wrapper.

Counterpart of ``repro/kernels/flash_attention.py`` (``flash_attention_tpu``)
and of the jnp ``flash_attention`` in ``repro/models/layers.py``, whose
contract it takes: causal or full attention, ``q_offset`` (the position of
q's first row, for an extend after a cached prefix), ``kv_len`` (keys at or
past it are masked, for a cache longer than its valid part) and a ``tanh``
softcap.  q is (B, Sq, Hq, D); k and v are (B, Skv, Hkv, D) with Hq a
multiple of Hkv, and query head h reads KV head h // (Hq / Hkv), which is
what the reference's ``repeat_kv`` before the call means.  Scores are fp32
dot products times 1/sqrt(D), then the softcap; masked scores are -1e30;
the running max, denominator and accumulator are fp32, P is rounded to q's
dtype before P·V, and the result is acc / max(l, 1e-30) in q's dtype.
Every row needs at least one key it may see (kv_len >= 1).

``flash_attention_ref`` is the plain version: the online softmax over
64-key tiles, with k and v cast to q's dtype first (the reference reads
the bf16 cache as the compute dtype).  Tiles past the last key any row may
see are skipped; in the reference they add exact zeros.
``flash_attention`` is the wrapper: on CUDA tensors it launches the
hand-written kernel in ``csrc/flash_attention.cu`` (bf16 only); on CPU
tensors it runs the plain version.  There is no fallback from the kernel to
the plain version.  The kernel (wgmma and a TMA ring of 128-key K/V tiles,
one CTA per 128 rows of up to 16 query heads that share a KV head; see the
source) reads K and V through their strides, so a slice of the KV cache
goes in without a copy, and cache slots past ``kv_len`` never reach its
output, whatever they hold.
"""
from __future__ import annotations

import math

import torch

from .sketch_common import _check

NEG_INF = -1e30
TILE = 64                       # keys per tile of the plain version
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def _check_inputs(q, k, v, kv_len) -> None:
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
           "q, k, v must be (B, S, H, D)")
    B, _, Hq, D = q.shape
    _check(k.shape == v.shape, f"k {tuple(k.shape)} and v {tuple(v.shape)} "
           "differ")
    _check(k.shape[0] == B and k.shape[3] == D,
           f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    _check(Hq % k.shape[2] == 0, f"{Hq} query heads are not a multiple of "
           f"{k.shape[2]} KV heads")
    _check(k.device == q.device and v.device == q.device,
           "q, k and v must lie on one device")
    if isinstance(kv_len, torch.Tensor):
        _check(kv_len.shape == (B,) and kv_len.device == q.device,
               "kv_len must be a (B,) tensor on q's device")
    elif kv_len is not None:
        _check(int(kv_len) >= 1, "kv_len must be >= 1")


def _visit(Sq: int, Skv: int, causal: bool, q_offset: int, kv_len) -> int:
    """Keys any row may see: the extent of the tile loop."""
    n = Skv
    if causal:
        n = min(n, q_offset + Sq)
    if kv_len is not None and not isinstance(kv_len, torch.Tensor):
        n = min(n, int(kv_len))
    return n


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0, kv_len=None,
                        softcap: float = 0.0) -> torch.Tensor:
    """Plain version on any device; ``kv_len`` is None, an int or a (B,)
    tensor.  Returns (B, Sq, Hq, D) in q's dtype."""
    _check_inputs(q, k, v, kv_len)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dt, dev = q.dtype, q.device
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    if kv_len is None:
        limit = torch.full((B,), Skv, device=dev)
    elif isinstance(kv_len, torch.Tensor):
        limit = kv_len.to(torch.int64).clamp(max=Skv)
    else:
        limit = torch.full((B,), min(int(kv_len), Skv), device=dev)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=dev)
    for k0 in range(0, _visit(Sq, Skv, causal, q_offset, kv_len), TILE):
        kb = k[:, k0:k0 + TILE].to(dt).float()          # (B, kb, Hkv, D)
        vb = v[:, k0:k0 + TILE].to(dt).float()
        s = torch.einsum("bhgqd,bkhd->bhgqk", qf, kb) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        k_pos = k0 + torch.arange(kb.shape[1], device=dev)
        mask = (k_pos[None, :] < limit[:, None])[:, None, :]   # (B, 1, kb)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])[None]
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(dt).float(), vb)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(dt)


def _strided_ptr(name: str, t: torch.Tensor) -> int:
    """The data pointer of a CUDA tensor the kernel reads through its
    strides: last dimension contiguous, 16-byte aligned rows."""
    _check(t.is_cuda, f"flash_attention: {name} must be a CUDA tensor")
    _check(t.stride(3) == 1, f"flash_attention: {name}'s last dimension "
           "must be contiguous")
    _check(all(s % 8 == 0 for s in t.stride()[:3])
           and t.data_ptr() % 16 == 0,
           f"flash_attention: {name}'s rows must be 16-byte aligned")
    _check(max(t.stride()[:3]) < 2**31, f"flash_attention: {name}'s strides "
           "must fit in 32 bits")
    return t.data_ptr()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, q_offset: int, kv_len, softcap: float
            ) -> torch.Tensor:
    """One launch of ``csrc/flash_attention.cu`` on the current stream;
    returns the (B, Sq, Hq, D) output.  No host sync."""
    from ._build import launch
    _check(q.is_cuda and k.is_cuda and v.is_cuda,
           "flash_attention: the kernel takes CUDA tensors only")
    _check(q.dtype == k.dtype == v.dtype == torch.bfloat16,
           "flash_attention: the kernel takes bf16 q, k and v")
    B, Sq, Hq, D = q.shape
    _check(D in KERNEL_HEAD_DIMS, f"flash_attention: head dim {D} not in "
           f"{KERNEL_HEAD_DIMS}")
    q = q.contiguous()
    if q.data_ptr() % 16:           # the kernel's TMA map needs 16-byte rows
        q = q.clone()
    kp, vp = _strided_ptr("k", k), _strided_ptr("v", v)
    out = torch.empty_like(q)
    if isinstance(kv_len, torch.Tensor):
        lens, default = kv_len.to(torch.int32).contiguous(), 0
    else:
        lens, default = 0, k.shape[1] if kv_len is None else int(kv_len)
    launch("flash_attention", "flash_attention_launch", q, kp, vp, out, lens,
           B, Sq, k.shape[1], Hq, k.shape[2], D, *k.stride()[:3],
           *v.stride()[:3], int(causal), int(q_offset), default,
           float(softcap), 1.0 / math.sqrt(D))
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0, kv_len=None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention with :func:`flash_attention_ref`'s contract.  CUDA
    tensors: one kernel launch (a failed build or launch raises); CPU
    tensors: the plain version."""
    _check_inputs(q, k, v, kv_len)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
              softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    return _launch(q, k, v, **kw)


flash_attention.launches = 0    # kernel launches since the last reset to 0

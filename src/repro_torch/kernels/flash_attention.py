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

Training: when grad mode is on and q, k or v requires grad,
``flash_attention`` goes through ``FlashAttentionFn``, whose contract is
the training call's (causal, ``q_offset`` 0, no ``kv_len``, as many keys as
queries; any other differentiable call raises).  Its forward is the
kernel's training instance, which also writes each row's log-sum-exp
(``m + log l`` of the scaled, capped scores, fp32, (B, Hq, Sq)); its
backward is the hand-written kernel of ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd``), the standard recomputation from that LSE, with
dk and dv summed over the query heads of each KV head (the VJP of the
reference's ``repeat_kv``).  On CPU tensors the two are the plain
versions, ``flash_attention_ref(..., return_lse=True)`` and
``flash_attention_bwd_ref``.  No path returns an output cut off from the
graph.
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


def _check_train(q, k, v, causal, q_offset, kv_len) -> None:
    """The differentiable call's contract: causal self-attention over the
    whole segment."""
    _check(causal and q_offset == 0 and kv_len is None
           and k.shape[1] == q.shape[1],
           "flash_attention: a differentiable call takes causal attention "
           "with q_offset 0, no kv_len and as many keys as queries (the "
           "training contract)")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0, kv_len=None,
                        softcap: float = 0.0, return_lse: bool = False):
    """Plain version on any device; ``kv_len`` is None, an int or a (B,)
    tensor.  Returns (B, Sq, Hq, D) in q's dtype, and with ``return_lse``
    also each row's log-sum-exp of its scores (B, Hq, Sq) fp32."""
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
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(dt)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, Hq, Sq)
    return out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            softcap: float = 0.0):
    """Plain version of the backward kernel (causal, q_offset 0, every key
    valid), tile by tile over 64 keys: delta = rowsum(dO o O); P =
    exp(s - lse); dV = P^T dO with P rounded to q's dtype as the forward
    rounds it; dS = P o (dO V^T - delta), times 1 - (s / cap)^2 with a
    softcap; dQ = dS K / sqrt(D); dK = dS^T Q / sqrt(D); dK and dV summed
    over each KV head's query heads.  Returns (dq, dk, dv) in q's dtype."""
    _check_inputs(q, k, v, None)
    _check_train(q, k, v, True, 0, None)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    dt, dev = q.dtype, q.device
    scale = 1.0 / math.sqrt(D)

    def grouped(x):                     # (B, S, Hq, D) -> (B, Hkv, G, S, D)
        return x.float().reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)
    qf, dof = grouped(q), grouped(do)
    delta = (dof * grouped(o)).sum(-1)                  # (B, Hkv, G, S)
    lsef = lse.float().reshape(B, Hkv, G, S)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, Hkv, S, D), device=dev)
    dv = torch.zeros((B, Hkv, S, D), device=dev)
    q_pos = torch.arange(S, device=dev)
    for k0 in range(0, S, TILE):
        kb = k[:, k0:k0 + TILE].to(dt).float().transpose(1, 2)  # (B,Hkv,kb,D)
        vb = v[:, k0:k0 + TILE].to(dt).float().transpose(1, 2)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * scale
        if softcap:
            t = torch.tanh(s / softcap)
            s = t * softcap
        k_pos = k0 + torch.arange(kb.shape[2], device=dev)
        vis = q_pos[:, None] >= k_pos[None, :]
        p = torch.where(vis, torch.exp(s - lsef[..., None]), 0.0)
        dv[:, :, k0:k0 + TILE] = torch.einsum(
            "bhgqk,bhgqd->bhkd", p.to(dt).float(), dof)
        ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", dof, vb)
                  - delta[..., None])
        if softcap:
            ds = ds * (1.0 - t * t)
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, kb) * scale
        dk[:, :, k0:k0 + TILE] = torch.einsum("bhgqk,bhgqd->bhkd", ds,
                                              qf) * scale
    return (dq.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(dt),
            dk.transpose(1, 2).to(dt), dv.transpose(1, 2).to(dt))


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


def _check_kernel(name: str, *ts: torch.Tensor) -> None:
    _check(all(t.is_cuda for t in ts),
           f"{name}: the kernel takes CUDA tensors only")
    _check(all(t.dtype == torch.bfloat16 for t in ts),
           f"{name}: the kernel takes bf16 tensors")
    D = ts[0].shape[3]
    _check(D in KERNEL_HEAD_DIMS, f"{name}: head dim {D} not in "
           f"{KERNEL_HEAD_DIMS}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with 16-byte aligned rows (the kernels' loads and
    the TMA maps need them)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, q_offset: int, kv_len, softcap: float
            ) -> torch.Tensor:
    """One launch of ``csrc/flash_attention.cu`` on the current stream;
    returns the (B, Sq, Hq, D) output.  No host sync."""
    from ._build import launch
    _check_kernel("flash_attention", q, k, v)
    B, Sq, Hq, D = q.shape
    q = _aligned(q)
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


def _launch_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  softcap: float):
    """One launch of the forward kernel's training instance: (out, lse)."""
    from ._build import launch
    _check_kernel("flash_attention", q, k, v)
    B, S, Hq, D = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    launch("flash_attention", "flash_attention_train_launch", q, k, v, out,
           lse, B, S, Hq, k.shape[2], D, float(softcap), 1.0 / math.sqrt(D))
    flash_attention.launches += 1
    return out, lse


def bwd_scratch(B: int, S: int, Hq: int, D: int) -> tuple[int, int]:
    """(fp32 words, int32 words) of the backward kernel's scratch.  At head
    dims 64 and 128: per (batch, head, row) of S rounded up to 64-row query
    tiles, the row's lse log2(e) and delta and D floats of the fp32 dQ
    accumulator; one ordering counter per (batch, head, query tile) and
    the work counter (the kernel zeroes them).  At 16 and 32: delta."""
    if D < 64:
        return B * Hq * S, 1
    tiles = -(-S // 64)
    return B * Hq * tiles * 64 * (2 + D), B * Hq * tiles + 1


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, softcap: float = 0.0):
    """(dq, dk, dv) of causal attention, :func:`flash_attention_bwd_ref`'s
    contract.  CUDA tensors: one launch of ``csrc/flash_attention_bwd.cu``
    (its three kernels on the current stream, scratch from
    :func:`bwd_scratch`; a failed build or launch, or a call outside the
    contract, raises); CPU tensors: the plain version.  The kernel's
    results do not depend on the run: its dQ partials are added in a fixed
    order."""
    _check_inputs(q, k, v, None)
    _check_train(q, k, v, True, 0, None)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, lse, softcap=softcap)
    from ._build import launch
    _check_kernel("flash_attention_bwd", q, k, v, o, do)
    B, S, Hq, D = q.shape
    _check(o.shape == q.shape and do.shape == q.shape,
           "flash_attention_bwd: o and dO must have q's shape")
    _check(lse.shape == (B, Hq, S) and lse.dtype == torch.float32
           and lse.is_cuda, "flash_attention_bwd: lse must be (B, Hq, S) "
           "fp32 on the card")
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    n_work, n_counters = bwd_scratch(B, S, Hq, D)
    work = torch.empty(n_work, dtype=torch.float32, device=q.device)
    counters = torch.empty(n_counters, dtype=torch.int32, device=q.device)
    launch("flash_attention_bwd", "flash_attention_bwd_launch", q, k, v, o,
           do, lse, work, counters, dq, dk, dv, B, S, Hq, k.shape[2], D,
           float(softcap), 1.0 / math.sqrt(D))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0    # launches since the last reset to 0


class FlashAttentionFn(torch.autograd.Function):
    """Causal attention under autograd: the training forward (the kernel's
    LSE instance on CUDA, the plain version on the CPU), which saves q, k,
    v, the output and the LSE, and ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, softcap: float):
        if q.device.type == "cpu":
            out, lse = flash_attention_ref(q, k, v, causal=True,
                                           softcap=softcap, return_lse=True)
        else:
            out, lse = _launch_train(q, k, v, softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.softcap = softcap
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse,
                                         softcap=ctx.softcap)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0, kv_len=None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention with :func:`flash_attention_ref`'s contract.  CUDA
    tensors: one kernel launch (a failed build or launch raises); CPU
    tensors: the plain version.  With grad mode on and an input that
    requires grad: ``FlashAttentionFn`` (the training contract)."""
    _check_inputs(q, k, v, kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _check_train(q, k, v, causal, q_offset, kv_len)
        return FlashAttentionFn.apply(q, k, v, float(softcap))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
              softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    return _launch(q, k, v, **kw)


flash_attention.launches = 0    # launches of either instance since the
                                # last reset to 0

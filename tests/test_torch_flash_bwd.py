"""The flash attention backward's plain version and the autograd Function
against autograd and against JAX (CPU).

``flash_attention_bwd_ref`` and ``FlashAttentionFn``'s backward (which is
it on the CPU) against ``torch.autograd`` of ``flash_attention_ref``, and
against ``jax.vjp`` of the reference's ``layers.flash_attention`` after
``repeat_kv`` (the function the reference trains through), over GQA
groups 1, 4 and 5, softcap 0 and 30 and odd lengths (in bf16:
tests/test_torch_flash_bwd_bf16.py); the forward's LSE against a direct
logsumexp.  Tolerances are max |port - other| over max
|other| per gradient: 1e-5 in fp32 (the two sum in other orders); 2e-2
in bf16 against JAX, whose autodiff rounds its own cotangents to bf16 at
other points (the kernel's bound on the card, chip_smoke phase 42).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import flash_attention as jax_flash
from repro.models.transformer import repeat_kv
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref)

CASES = [(2, 37, 4, 4, 16, 0.0), (1, 67, 8, 2, 32, 30.0),
         (2, 45, 10, 2, 16, 0.0), (1, 129, 5, 1, 64, 30.0)]
IDS = ["G1", "G4-cap", "G5", "G5-long-cap"]


def inputs(B, S, Hq, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    do = rng.standard_normal((B, S, Hq, D), dtype=np.float32)
    return q, k, v, do


def rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_ref_and_function_match_autograd_fp32(case):
    B, S, Hq, Hkv, D, cap = case
    q, k, v, do = (torch.from_numpy(a) for a in inputs(*case[:5]))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_ref(*leaves, softcap=cap)
    want = torch.autograd.grad(out, leaves, do)
    o, lse = flash_attention_ref(q, k, v, softcap=cap, return_lse=True)
    got = flash_attention_bwd_ref(q, k, v, o, do, lse, softcap=cap)
    leaves2 = [t.clone().requires_grad_() for t in (q, k, v)]
    out2 = flash_attention(*leaves2, softcap=cap)
    assert out2.grad_fn is not None and torch.equal(out2.detach(), o)
    via_fn = torch.autograd.grad(out2, leaves2, do)
    for a, b, c in zip(got, via_fn, want):
        assert a.shape == c.shape and a.dtype == torch.float32
        assert torch.equal(a, b)
        assert rel(a, c) < 1e-5


def check_against_jax_vjp(case, dtype):
    """The port's gradients through ``flash_attention`` (the Function on
    the CPU) against the reference's VJP, each within the bound."""
    B, S, Hq, Hkv, D, cap = case
    G = Hq // Hkv
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    arrs = inputs(*case[:5], seed=1)

    def jf(q, k, v):
        return jax_flash(q, repeat_kv(k, G), repeat_kv(v, G), causal=True,
                         q_block=16, kv_block=32, softcap=cap)
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in arrs)
    jout, vjp = jax.vjp(jf, jq, jk, jv)
    want = vjp(jdo)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrs)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, softcap=cap)
    got = torch.autograd.grad(out, leaves, do)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert rel(out.detach(), np.asarray(jout, np.float32)) < (
        1e-5 if dtype == "float32" else 2e-2)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tdt
        err = rel(a, np.asarray(b, np.float32))
        assert err < tol, f"d{name}: {err}"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_matches_jax_vjp_fp32(case):
    check_against_jax_vjp(case, "float32")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_is_the_rows_logsumexp(case):
    B, S, Hq, Hkv, D, cap = case
    q, k, v, _ = (torch.from_numpy(a) for a in inputs(*case[:5], seed=2))
    _, lse = flash_attention_ref(q, k, v, softcap=cap, return_lse=True)
    G = Hq // Hkv
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(G, 2)) \
        / math.sqrt(D)
    if cap:
        s = torch.tanh(s / cap) * cap
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    want = torch.logsumexp(s.masked_fill(~causal, -float("inf")), -1)
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    assert float((lse - want).abs().max()) < 1e-5


def test_differentiable_calls_outside_the_training_contract_raise():
    q, k, v, do = (torch.from_numpy(a) for a in inputs(1, 9, 2, 1, 16))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    for bad in (dict(causal=False), dict(q_offset=2), dict(kv_len=5)):
        with pytest.raises(ValueError, match="training contract"):
            flash_attention(*leaves, **bad)
    with pytest.raises(ValueError, match="training contract"):
        flash_attention_bwd(q, k[:, :5], v[:, :5], q, do,
                            torch.zeros(1, 2, 9))
    # without grad the serving contract stands
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=False)
    assert out.grad_fn is None and out.shape == q.shape


def test_function_saves_what_backward_reads():
    q, k, v, do = (torch.from_numpy(a) for a in inputs(2, 21, 4, 2, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, 0.0)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[3].shape == q.shape
    assert saved[4].shape == (2, 4, 21) and saved[4].dtype == torch.float32
    out.backward(do)
    assert all(t.grad is not None and t.grad.shape == t.shape
               for t in leaves)

"""The port's attention (repro_torch.kernels.flash_attention) against the
JAX package's: the plain version ``flash_attention_ref`` against the jnp
``layers.flash_attention`` (q_offset, kv_len, softcap, ragged lengths, GQA
through ``repeat_kv`` on the JAX side) and against the Pallas kernel
``flash_attention_tpu`` in interpret mode at tests/test_flash_kernel.py's
shapes.  Inputs are made with numpy from a seed.  Tolerances: 2e-5 in
fp32 (the reference's own kernel-vs-oracle bound; the port's 64-key tiles
sum in another order) and 2e-2 in bf16 (the reference's bf16 bound; P is
rounded to bf16 against another running max).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_tpu
from repro.models.layers import flash_attention as jax_flash
from repro.models.transformer import repeat_kv
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(1)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def inputs(seed, B, Sq, Skv, Hq, Hkv, D, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jx, [torch.from_numpy(a).to(tdt) for a in arrs]


def as_np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len, softcap, q_block,
#  kv_block)
CASES = [
    (2, 64, 64, 4, 4, 32, True, 0, None, 0.0, 16, 32),
    (1, 100, 100, 4, 2, 16, True, 0, None, 0.0, 32, 64),      # ragged
    (2, 37, 90, 8, 2, 16, True, 53, None, 0.0, 16, 32),       # extend
    (1, 24, 160, 4, 1, 32, True, 136, None, 0.0, 16, 64),     # GQA 4
    (2, 33, 200, 16, 1, 16, True, 100, [133, 150], 0.0, 16, 64),  # kv_len
    (1, 70, 70, 4, 4, 64, False, 0, None, 0.0, 32, 32),       # full
    (2, 40, 130, 4, 2, 32, False, 0, [77, 130], 0.0, 16, 64),
    (1, 96, 96, 4, 2, 32, True, 0, None, 30.0, 32, 64),       # softcap
    (1, 50, 178, 8, 4, 16, True, 128, None, 5.0, 16, 32),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_ref_matches_jax_layers_flash_attention(case, dtype):
    (B, Sq, Skv, Hq, Hkv, D, causal, off, kv_len, cap, qb,
     kb) = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = inputs(case, B, Sq, Skv, Hq, Hkv, D, dtype)
    G = Hq // Hkv
    want = jax_flash(jq, repeat_kv(jk, G), repeat_kv(jv, G), causal=causal,
                     q_block=qb, kv_block=kb, q_offset=off,
                     kv_len=None if kv_len is None
                     else jnp.asarray(kv_len, jnp.int32), softcap=cap)
    got = fa.flash_attention_ref(
        tq, tk, tv, causal=causal, q_offset=off, softcap=cap,
        kv_len=None if kv_len is None else torch.tensor(kv_len))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("B,S,H,D,qb,kb", [
    (2, 256, 4, 64, 64, 64),
    (1, 512, 2, 128, 128, 64),
    (2, 128, 8, 32, 32, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_ref_matches_pallas_kernel_interpret(B, S, H, D, qb, kb, causal):
    (jq, jk, jv), (tq, tk, tv) = inputs(B * S + D, B, S, S, H, H, D)
    want = flash_attention_tpu(jq, jk, jv, causal=causal, q_block=qb,
                               kv_block=kb, interpret=True)
    got = fa.flash_attention_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-5,
                               atol=2e-5)


def test_int_kv_len_equals_sliced_cache():
    """kv_len as an int over a longer cache == the cache cut at kv_len
    (what the reference's extend passes), and a tensor kv_len agrees,
    within 1e-6: the last tile's products have other shapes."""
    (_, _, _), (tq, tk, tv) = inputs(5, 1, 20, 300, 4, 2, 32)
    want = fa.flash_attention_ref(tq, tk[:, :120], tv[:, :120], q_offset=100)
    got = fa.flash_attention_ref(tq, tk, tv, q_offset=100, kv_len=120)
    got_t = fa.flash_attention_ref(tq, tk, tv, q_offset=100,
                                   kv_len=torch.tensor([120]))
    for g in (got, got_t):
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_wrapper_runs_the_plain_version_on_cpu():
    (_, _, _), (tq, tk, tv) = inputs(6, 1, 40, 40, 4, 2, 16, "bfloat16")
    before = fa.flash_attention.launches
    got = fa.flash_attention(tq, tk, tv, softcap=20.0)
    assert torch.equal(got, fa.flash_attention_ref(tq, tk, tv, softcap=20.0))
    assert fa.flash_attention.launches == before


def test_input_checks():
    (_, _, _), (tq, tk, tv) = inputs(7, 1, 8, 8, 3, 2, 16)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(tq, tk, tv)
    (_, _, _), (tq, tk, tv) = inputs(7, 1, 8, 8, 4, 2, 16)
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_attention(tq, tk, tv, kv_len=0)
    with pytest.raises(ValueError, match="differ"):
        fa.flash_attention(tq, tk, tv[:, :4])

"""The port's Mamba2, mLSTM and sLSTM blocks (repro_torch.models.mamba2,
.mlstm) against the JAX package's on the CPU, one layer's numpy weights
on both sides: the chunked scans over one exact chunk and over three with
the time axis padded, from a random initial state (the conv state in the
cache's bf16), the final states, and the decode step from them; the sLSTM's
time loop from a random state.  The JAX side gets its leaves in the
compute dtype, as the reference's ``cast_params`` leaves a layer stack's,
and runs jitted.  Tolerances as in ``tests/torch_family_cases.py`` (1e-4
fp32, 0.05 bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm2
from repro.models import mlstm as jml
from repro_torch.check_runs import numpy_params
from repro_torch.models import mamba2, mlstm
from torch_family_cases import DTYPES, TOL, jax_tree, pair, rel

torch.set_num_threads(1)


def cast(leaves, jdt):
    return {k: jnp.asarray(v, jdt) for k, v in leaves.items()}


def module(cls, cfg, leaves):
    mod = cls(cfg, device="cpu")
    for k, v in leaves.items():
        getattr(mod, k).data.copy_(torch.from_numpy(v))
    return mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 23, 40])
def test_mamba2_chunks_and_initial_state_match(S, dtype):
    """Mamba2 over S tokens (one exact chunk; one padded; three, the last
    padded) from
    a random initial state, then its decode step from the final state."""
    jcfg, cfg = pair("zamba2_1p2b", dtype)
    tree = numpy_params(cfg, seed=9)["groups"]["mamba"]
    p = {k: v[0, 0] for k, v in tree.items()}
    jdt, tdt = DTYPES[dtype]
    jp = cast(p, jdt)
    mod = module(mamba2.Mamba2, cfg, p)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    d_in, H, P, N = mamba2.ssm_dims(cfg)
    conv = rng.standard_normal((2, cfg.ssm_conv - 1, d_in + 2 * N),
                               dtype=np.float32)
    ssm = rng.standard_normal((2, H, P, N), dtype=np.float32)
    jst = {"conv": jnp.asarray(conv, jnp.bfloat16), "ssm": jnp.asarray(ssm)}
    tst = {"conv": torch.from_numpy(conv).to(torch.bfloat16),
           "ssm": torch.from_numpy(ssm)}
    jy, jfin = jax.jit(lambda p, x, s: jm2.mamba2_forward(
        p, x, jcfg, initial_state=s))(jp, jnp.asarray(x, jdt), jst)
    ty, tfin = mamba2.mamba2_forward(mod, torch.from_numpy(x).to(tdt), cfg,
                                     initial_state=tst)
    assert rel(ty, jy) < TOL[dtype]
    assert tfin["conv"].dtype == torch.promote_types(torch.bfloat16, tdt)
    assert rel(tfin["ssm"], jfin["ssm"]) < TOL[dtype]
    assert rel(tfin["conv"], jfin["conv"]) < TOL[dtype]
    x1 = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
    jy, jst = jax.jit(lambda p, x, s: jm2.mamba2_decode_step(
        p, x, s, jcfg))(jp, jnp.asarray(x1, jdt), jfin)
    ty, tst = mamba2.mamba2_decode_step(mod, torch.from_numpy(x1).to(tdt),
                                        tfin, cfg)
    assert rel(ty, jy) < TOL[dtype]
    assert rel(tst["ssm"], jst["ssm"]) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 23, 40])
def test_mlstm_and_slstm_match(S, dtype):
    """mLSTM over S tokens from a random initial state and its decode step;
    the sLSTM's time loop from a random state and its decode step."""
    jcfg, cfg = pair("xlstm_1p3b", dtype)
    tree = numpy_params(cfg, seed=11)["supers"]
    rng = np.random.default_rng(S)
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jx1, tx1 = jnp.asarray(x1, jdt), torch.from_numpy(x1).to(tdt)

    p = {k: v[0, 0] for k, v in tree["mlstm"]["p"].items()}
    mod = module(mlstm.MLSTM, cfg, p)
    d_in, H, hd = mlstm.mlstm_dims(cfg)
    h0 = rng.standard_normal((2, H, hd, hd + 1), dtype=np.float32) * 0.3
    jy, jst = jax.jit(lambda p, x, s: jml.mlstm_forward(
        p, x, jcfg, initial_state=s))(cast(p, jdt), jx, jnp.asarray(h0))
    ty, tst = mlstm.mlstm_forward(mod, tx, cfg,
                                  initial_state=torch.from_numpy(h0))
    assert rel(ty, jy) < TOL[dtype] and rel(tst, jst) < TOL[dtype]
    jy, jst = jax.jit(lambda p, x, s: jml.mlstm_decode_step(
        p, x, s, jcfg))(cast(p, jdt), jx1, jst)
    ty, tst = mlstm.mlstm_decode_step(mod, tx1, tst, cfg)
    assert rel(ty, jy) < TOL[dtype] and rel(tst, jst) < TOL[dtype]

    p = {k: v[0] for k, v in tree["slstm"]["p"].items()}
    mod = module(mlstm.SLSTM, cfg, p)
    st = {k: rng.standard_normal((2, cfg.d_model), dtype=np.float32) * 0.3
          for k in ("h", "c", "n", "m")}
    st["n"] = np.abs(st["n"]) + 1.0
    jy, jst = jax.jit(lambda p, x, s: jml.slstm_forward(
        p, x, jcfg, initial_state=s))(cast(p, jdt), jx, jax_tree(st))
    ty, tst = mlstm.slstm_forward(
        mod, tx, cfg, initial_state={k: torch.from_numpy(v)
                                     for k, v in st.items()})
    assert rel(ty, jy) < TOL[dtype]
    for k in st:
        assert rel(tst[k], jst[k]) < TOL[dtype], k
    jy, jst = jax.jit(lambda p, x, s: jml.slstm_decode_step(
        p, x, s, jcfg))(cast(p, jdt), jx1, jst)
    ty, tst = mlstm.slstm_decode_step(mod, tx1, tst, cfg)
    assert rel(ty, jy) < TOL[dtype]

"""The port's one-rank training step against the JAX package's unsharded
``build_train_step``, and the ``policy.act`` hook sites against the
reference's (CPU).

* The four architectures of tests/test_torch_sharded_train.py (the
  reference's lowering-test configs, fp32 compute, the same numpy weights
  and batches), two AdamW steps: losses and gradient norms within 1e-4
  relative of the JAX step's (tests/test_torch_train.py's bound), the
  first step's gradients within 1e-4 of each leaf's largest magnitude on
  every element, the masters after each step within 1e-4 of each leaf's
  largest magnitude for all but 0.5% of its elements, and those within
  ``R.ADAM_MOVE`` a step absolute (AdamW's division by the gradient's
  own size, tests/test_torch_sharded_train.py; at most 3 elements of a
  leaf measured).  The reference's sharded lowering fails on the CPU for
  three of the four, so its unsharded step is the oracle; the gloo grids
  are held to the port's one-rank step in
  tests/test_torch_sharded_train.py.
* A ``ShardingPolicy`` on a grid of ones without ``torch.distributed``
  computes the plain step's bits.
* A recording policy sees, per family, the (kind, shape) pairs the
  reference's hooks see in the training loss, prefill and decode, but for
  two documented differences: the reference's ``attn_blk`` sites are in
  its jnp blocked attention, which the port's flash kernel replaces, and
  the port's attention reads K and V unrepeated, so its two ``attn_q``
  sites on them see (B, S, Hkv, hd) where the reference's see the repeated
  (B, S, Hq, hd).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw, wsd as jax_wsd
from repro.train import build_train_step as jax_build_train_step
from repro.train.train_step import TrainState as JaxTrainState
from repro.train.train_step import build_loss_fn as jax_build_loss_fn
from repro_torch.check_runs import numpy_params
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.train_step import build_loss_fn
from test_torch_sharded_train import assert_masters_close


def jax_run(arch: str, steps: int = 2) -> dict:
    """Losses, gradient norms, the masters after each step and the first
    step's gradients."""
    cfg = R.case_cfg(dict(arch=arch))
    jcfg = jax_get_config(arch, smoke=True).replace(
        compute_dtype=jnp.float32, **R.edits(arch))
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, R.SEED))
    opt = jax_adamw(jax_wsd(*R.LR))
    state = JaxTrainState(params=params, opt=opt.init(params),
                          step=jnp.zeros((), jnp.int32))
    jm = jax_build_model(jcfg)
    step = jax.jit(jax_build_train_step(jm, opt, loss_chunk=R.CHUNK))
    loss_fn = jax_build_loss_fn(jm, loss_chunk=R.CHUNK)
    grads = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))(
        params, {"tokens": jnp.asarray(R.tokens(cfg, 0))})
    out = {"loss": [], "grad_norm": [], "params": [],
           "grads": R.flat(jax.tree_util.tree_map(
               lambda a: torch.tensor(np.asarray(a, np.float32)), grads))}
    for i in range(steps):
        state, m = step(state, {"tokens": jnp.asarray(R.tokens(cfg, i))})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["params"].append(R.flat(jax.tree_util.tree_map(
            lambda a: torch.tensor(np.asarray(a, np.float32)),
            state.params)))
    return out


@pytest.mark.parametrize("arch", R.ARCHS)
def test_one_rank_step_equals_jax_unsharded_step(arch):
    want = jax_run(arch)
    got = R.run_case(dict(arch=arch, grid=None, each=True))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    assert_masters_close(got["grads"], want["grads"], 1e-4)
    for i, (mine, ref) in enumerate(zip(got["each"], want["params"])):
        assert_masters_close(mine, ref, 1e-4, 5e-3, R.ADAM_MOVE * (i + 1))
    # a grid of ones without torch.distributed: the plain step's bits
    one = R.run_case(dict(arch=arch, grid=(1, 1)))
    assert one["loss"] == got["loss"]
    for k in got["params"]:
        np.testing.assert_array_equal(one["params"][k], got["params"][k])


class Recorder:
    def __init__(self):
        self.seen = set()

    def act(self, x, kind):
        self.seen.add((kind, tuple(int(d) for d in x.shape)))
        return x


FAMILIES = ["qwen3-4b", "llama4-scout-17b-a16e", "llava-next-34b",
            "musicgen-medium", "zamba2-1.2b", "xlstm-1.3b"]
B, S = 2, 16


def batches(cfg):
    rng = np.random.default_rng(0)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    t = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    out = {"tokens": t}
    if cfg.n_vis_tokens:
        out["vision_embeds"] = (rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def jax_sites(arch) -> dict:
    jcfg = jax_get_config(arch, smoke=True).replace(compute_dtype=jnp.float32)
    jm = jax_build_model(jcfg)
    params = jax.eval_shape(lambda k: jm.init(k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    b = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
         for k, v in batches(jcfg).items()}
    out = {}
    rec = Recorder()
    jax.eval_shape(lambda p, x: jax_build_loss_fn(jm, rec, loss_chunk=8)(
        p, x), params, b)
    out["train"] = rec.seen
    cache = jax.eval_shape(lambda: jm.init_cache(B, 32, jnp.float32))
    rec = Recorder()
    jax.eval_shape(lambda p, x, c: jm.prefill(p, x, c, policy=rec),
                   params, b, cache)
    out["prefill"] = rec.seen
    tok = jax.ShapeDtypeStruct((B, 1) + b["tokens"].shape[2:], jnp.int32)
    rec = Recorder()
    jax.eval_shape(lambda p, t, c: jm.decode(p, t, c, policy=rec),
                   params, tok, cache)
    out["decode"] = rec.seen
    return out


def port_sites(arch) -> dict:
    cfg = get_config(arch, smoke=True).replace(compute_dtype=torch.float32)
    m = Model(cfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in batches(cfg).items()}
    out = {}
    train = params_from_numpy(cfg, numpy_params(cfg, 0), device="cpu",
                              train=True)
    rec = Recorder()
    build_loss_fn(m, rec, loss_chunk=8)(train, b)
    out["train"] = rec.seen
    params = m.init(torch.Generator().manual_seed(0))
    cache = m.init_cache(B, 32, torch.float32)
    rec = Recorder()
    m.prefill(params, b, cache, policy=rec)
    out["prefill"] = rec.seen
    rec = Recorder()
    m.decode(params, b["tokens"][:, :1], cache, policy=rec)
    out["decode"] = rec.seen
    return out


def expected(ref: set, cfg) -> set:
    """The reference's pairs as the port's hooks see them."""
    out = {(k, s) for k, s in ref if k != "attn_blk"}
    for k, s in ref:
        if k == "attn_q" and s[1] > 1:           # K and V, unrepeated
            out.add((k, s[:2] + (cfg.n_kv_heads,) + s[3:]))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_policy_hook_sites_match_the_reference(arch):
    cfg = get_config(arch, smoke=True)
    want, got = jax_sites(arch), port_sites(arch)
    for path in ("train", "prefill", "decode"):
        assert got[path] == expected(want[path], cfg), (arch, path)
    assert any(k == "residual" for k, _ in got["train"])


def test_cast_params_once_false_casts_where_the_reference_uses():
    """cast_params_once=False: the view casts the matrices (the reference
    casts them at each use: the same values) and leaves a layer's 1-D
    leaves and the embedding fp32, as the reference's fp32 tree does."""
    from repro_torch.models.common import cast_params
    cfg = get_config("zamba2-1.2b", smoke=True)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0),
                                           train=True)
    for once in (True, False):
        view = cast_params(params, cfg.replace(cast_params_once=once))
        layer = view.mamba_layers()[0].mamba
        assert layer.in_proj.dtype == torch.bfloat16
        small = torch.bfloat16 if once else torch.float32
        assert layer.dt_bias.dtype == layer.A_log.dtype == small
        assert view.embed.dtype == small
        assert layer.norm_w.dtype == torch.float32       # rmsnorm casts it

"""Shared by the tests of the port's training path against the JAX
package's (tests/test_torch_train*.py): the same numpy weights and batch
through the reference's ``build_loss_fn`` under ``jax.value_and_grad``
and the port's loss on a training module under ``backward``, and the
comparison of their gradient trees.  Not a test module; it imports jax
and is not part of the port.

Tolerances, as max |port - JAX| over max |JAX| per leaf: 1e-4 with fp32
compute (the reference's own fp32 bound, tests/test_models.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.train.train_step import build_loss_fn as jax_build_loss_fn
from repro_torch.check_runs import numpy_params
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.convert import grads_to_numpy, params_from_numpy
from repro_torch.train.train_step import build_loss_fn

TOL = 1e-4
# one smoke config of each family
FAMILY_ARCHS = {"dense": "qwen3-4b", "moe": "llama4-scout-17b-a16e",
                "vlm": "llava-next-34b", "audio": "musicgen-medium",
                "hybrid_ssm": "zamba2-1.2b", "xlstm": "xlstm-1.3b"}
SEQ, CHUNK = 19, 8


def pair(arch, **kw):
    """(JAX config, port config) of ``arch``'s smoke config in fp32."""
    return (jax_get_config(arch, smoke=True).replace(
                compute_dtype=jnp.float32, **kw),
            get_config(arch, smoke=True).replace(
                compute_dtype=torch.float32, **kw))


def batch_np(cfg, B=2, S=SEQ, seed=6) -> dict:
    """Tokens (B, S[, K]) and, for vlm, 0.02-scaled vision embeddings."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.n_codebooks:
        t = ((t[..., None] + np.arange(cfg.n_codebooks)) % cfg.vocab_size
             ).astype(np.int32)
    out = {"tokens": t}
    if cfg.n_vis_tokens:
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vis_tokens, cfg.d_model), dtype=np.float32) * 0.02
    return out


def flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (k,)))
        return out
    return {"/".join(path): np.asarray(tree, np.float32)}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


@functools.lru_cache(maxsize=None)
def jax_loss_grads(arch: str, seed: int = 3):
    """(loss, metrics, flat grads) of the reference's loss (remat on)."""
    jcfg, cfg = pair(arch)
    jm = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, seed))
    batch = {k: jnp.asarray(v) for k, v in batch_np(cfg).items()}
    fn = jax.jit(jax.value_and_grad(jax_build_loss_fn(jm, loss_chunk=CHUNK),
                                    has_aux=True))
    (loss, metrics), grads = fn(params, batch)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            flat(jax.device_get(grads)))


def port_loss_grads(arch: str, seed: int = 3, remat: bool = True):
    """The same through the port on the CPU."""
    _, cfg = pair(arch)
    m = Model(cfg, device="cpu")
    params = params_from_numpy(cfg, numpy_params(cfg, seed), device="cpu",
                               train=True)
    batch = {k: torch.from_numpy(v) for k, v in batch_np(cfg).items()}
    loss, metrics = build_loss_fn(m, remat=remat, loss_chunk=CHUNK)(
        params, batch)
    loss.backward()
    return (loss.item(), {k: float(torch.as_tensor(v).detach())
                          for k, v in metrics.items()},
            flat(grads_to_numpy(params)))


def trp_jax(dtype: str) -> list:
    """Run TRP through the JAX package on the CPU: [(loss, grad_norm)] of
    its three steps (check_runs.TRP_PINS in bf16, TRP_FP32_PINS in
    fp32).  ~18 GB of host memory at the peak: run alone."""
    from repro.optim import adamw as jax_adamw, wsd as jax_wsd
    from repro.train import build_train_step as jax_build_train_step
    from repro.train.train_step import TrainState
    from repro_torch.check_runs import (TRP_LAYERS, TRP_LR, TRP_SEED,
                                        numpy_leaves, trp_tokens)
    cfg = get_config("qwen3-4b").replace(n_layers=TRP_LAYERS)
    jcfg = jax_get_config("qwen3-4b").replace(
        n_layers=TRP_LAYERS,
        compute_dtype={"bfloat16": jnp.bfloat16, "float32": jnp.float32}[
            dtype])
    params: dict = {}
    for path, a in numpy_leaves(cfg, TRP_SEED):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.asarray(a)
        del a
    opt = jax_adamw(jax_wsd(*TRP_LR))
    state = TrainState(params=params, opt=opt.init(params),
                       step=jnp.zeros((), jnp.int32))
    del params
    step = jax.jit(jax_build_train_step(jax_build_model(jcfg), opt),
                   donate_argnums=0)
    batch = {"tokens": jnp.asarray(trp_tokens(cfg))}
    out = []
    for _ in range(3):
        state, metrics = step(state, batch)
        out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return out

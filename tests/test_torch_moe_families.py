"""The port's MoE family (llama4 scout: experts on every layer; maverick:
on every second) against the JAX package's on the CPU: the drive of
``tests/torch_family_cases.py`` in fp32 and bf16, and the routing itself,
held identical in fp32 (the expert of every token, its position within
the expert and whether it is kept, with capacity drops) with the layer's
output within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.check_runs import numpy_params
from repro_torch.models import moe
from torch_family_cases import check_drive, jax_tree, pair, rel

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e",
                                  "llama4_maverick_400b_a17b"])
def test_prefill_extend_decode_match(arch, dtype):
    check_drive(arch, dtype)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_routing_identical_in_fp32(capacity_factor):
    """The router's expert, the capacity position and the kept tokens are
    those of the reference in fp32 (0.5: a quarter of the tokens and more
    dropped), and the layer's output within 1e-4."""
    jcfg, cfg = pair("llama4_scout_17b_a16e", "float32",
                     capacity_factor=capacity_factor)
    tree = numpy_params(cfg, seed=7)["layers"]["moe0"]
    p = {k: v[0] for k, v in tree.items()}
    x = np.random.default_rng(8).standard_normal((3, 70, cfg.d_model),
                                                 dtype=np.float32)
    mod = moe.MoE(cfg, device="cpu")
    for k, v in p.items():
        getattr(mod, k).data.copy_(torch.from_numpy(v))
    want_out, want_aux = jmoe.moe_layer(jax_tree(p), jnp.asarray(x), jcfg)
    got_out, got_aux = moe.moe_layer(mod, torch.from_numpy(x), cfg)
    assert rel(got_out, want_out) < 1e-4
    assert abs(float(got_aux) - float(want_aux)) < 1e-6
    # the reference's routing, step by step in jnp
    probs = jax.nn.softmax((jnp.asarray(x) @ p["router"]).astype(jnp.float32),
                           -1)
    e_idx = np.asarray(jnp.argmax(probs, -1))
    onehot = jax.nn.one_hot(e_idx, cfg.n_experts, dtype=jnp.float32)
    pos = np.asarray((jnp.cumsum(onehot, 1) * onehot).sum(-1) - 1.0,
                     np.int64)
    C = jmoe.moe_capacity(jcfg, x.shape[1])
    assert C == moe.moe_capacity(cfg, x.shape[1])
    g_probs = torch.softmax((torch.from_numpy(x) @ mod.router).float(), -1)
    g_idx = g_probs.argmax(-1).numpy()
    np.testing.assert_array_equal(g_idx, e_idx)
    g_pos = (torch.nn.functional.one_hot(torch.from_numpy(g_idx),
                                         cfg.n_experts).cumsum(1)
             .gather(-1, torch.from_numpy(g_idx)[..., None])[..., 0] - 1)
    np.testing.assert_array_equal(g_pos.numpy() < C, pos < C)
    dropped = int((pos >= C).sum())
    assert (dropped > 0) == (capacity_factor < 1)

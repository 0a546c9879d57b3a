"""The port's training path against the JAX package's (CPU), part 1: the
attention families' gradients, the optimizers and the schedules.

For one smoke config of the dense, moe and vlm families (audio, hybrid_ssm
and xlstm: tests/test_torch_train_ssm.py), in fp32 on the same numpy
weights and batch: the loss, the aux loss and every gradient leaf, in the
reference's stacked tree, within 1e-4 relative of ``jax.value_and_grad``
of the reference's ``build_loss_fn``.  One AdamW and one Adafactor apply
from identical numpy params, grads and state: every parameter and state
leaf within 1e-6 relative (the stacked per-layer norm weights decayed and
factored over the layer axis, ``final_norm`` neither).  The WSD schedule
bit-equal in float32; cosine within 2 ulp (XLA's float32 cos and
PyTorch's differ in their last bits at a few steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as jax_adafactor
from repro.optim import adamw as jax_adamw
from repro.optim import schedules as jax_schedules
from repro_torch.check_runs import numpy_params
from repro_torch.models.common import leaf_tree
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        tree_from_numpy, tree_to_numpy)
from repro_torch.optim import adafactor, adamw, schedules
from torch_train_cases import (FAMILY_ARCHS, TOL, flat, jax_loss_grads,
                               pair, port_loss_grads, rel)


def check_family_grads(family):
    arch = FAMILY_ARCHS[family]
    j_loss, j_metrics, j_grads = jax_loss_grads(arch)
    p_loss, p_metrics, p_grads = port_loss_grads(arch)
    assert set(p_grads) == set(j_grads)
    assert abs(p_loss - j_loss) <= TOL * abs(j_loss)
    assert abs(p_metrics["aux_loss"] - j_metrics["aux_loss"]) <= 1e-6
    assert p_metrics["tokens"] == j_metrics["tokens"]
    for k in j_grads:
        assert p_grads[k].shape == j_grads[k].shape, k
        assert rel(p_grads[k], j_grads[k]) < TOL, k


@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_family_grads_match_jax_fp32(family):
    check_family_grads(family)


def opt_inputs(kind: str):
    """qwen3's smoke tree, random grads and a random state after 2 steps,
    all numpy."""
    _, cfg = pair("qwen3-4b")
    params = numpy_params(cfg, seed=5)
    rng = np.random.default_rng(8)

    def like(a, pos=False, scale=1.0):
        x = rng.standard_normal(a.shape).astype(np.float32) * scale
        return np.abs(x) + 1e-3 if pos else x
    grads = jax.tree_util.tree_map(lambda a: like(a, scale=0.05), params)
    if kind == "adamw":
        state = {"m": jax.tree_util.tree_map(lambda a: like(a, scale=0.01),
                                             params),
                 "v": jax.tree_util.tree_map(
                     lambda a: like(a, pos=True, scale=1e-3), params),
                 "step": np.int32(2)}
    else:
        def per(a):
            if a.ndim >= 2:
                return {"vr": like(a[..., 0], pos=True, scale=1e-3),
                        "vc": like(a[..., 0, :], pos=True, scale=1e-3)}
            return {"v": like(a, pos=True, scale=1e-3)}
        state = {"f": jax.tree_util.tree_map(per, params),
                 "step": np.int32(2)}
    return cfg, params, grads, state


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_apply_matches_jax(kind):
    cfg, params, grads, state = opt_inputs(kind)
    lr = (schedules.wsd(1e-2, 2, 10, 10), jax_schedules.wsd(1e-2, 2, 10, 10))
    if kind == "adamw":
        opt, jopt = adamw(lr[0]), jax_adamw(lr[1])
    else:
        opt, jopt = (adafactor(lr[0], weight_decay=0.01),
                     jax_adafactor(lr[1], weight_decay=0.01))
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    j_params, j_state, j_metrics = jax.jit(jopt.apply)(
        jt(params), jt(grads), jt(state))
    module = params_from_numpy(cfg, params, device="cpu", train=True)
    p_state = tree_from_numpy(state, device="cpu")
    _, p_state, p_metrics = opt.apply(leaf_tree(module),
                                      tree_from_numpy(grads, device="cpu"),
                                      p_state)
    assert int(p_state["step"]) == 3 and p_state["step"].dtype == torch.int32
    assert abs(float(p_metrics["grad_norm"]) - float(j_metrics["grad_norm"])
               ) <= 1e-6 * float(j_metrics["grad_norm"])
    assert float(p_metrics["lr"]) == float(j_metrics["lr"])
    got = flat(params_to_numpy(cfg, module))
    want = flat(jax.device_get(j_params))
    moved = 0
    for k in want:
        assert rel(got[k], want[k]) < 1e-6, k
        moved += not np.array_equal(want[k], flat(params)[k])
    assert moved == len(want)
    got_s = flat({k: v for k, v in tree_to_numpy(p_state).items()
                  if k != "step"})
    want_s = flat({k: v for k, v in jax.device_get(j_state).items()
                   if k != "step"})
    assert set(got_s) == set(want_s)
    for k in want_s:
        assert got_s[k].shape == want_s[k].shape, k
        assert rel(got_s[k], want_s[k]) < 1e-6, k
    if kind == "adafactor":
        # a stacked per-layer norm weight (L, M) is factored over the layers
        assert got_s["f/layers/attn0/norm/vc"].shape == (cfg.d_model,)
        assert got_s["f/final_norm/v"].shape == (cfg.d_model,)


def test_adamw_decays_stacked_norms_not_final_norm():
    cfg, params, grads, state = opt_inputs("adamw")
    zeros = jax.tree_util.tree_map(np.zeros_like, grads)
    st = {"m": jax.tree_util.tree_map(np.zeros_like, params),
          "v": jax.tree_util.tree_map(np.zeros_like, params),
          "step": np.int32(0)}
    module = params_from_numpy(cfg, params, device="cpu", train=True)
    adamw(schedules.constant(0.1)).apply(
        leaf_tree(module), tree_from_numpy(zeros, device="cpu"),
        tree_from_numpy(st, device="cpu"))
    got = params_to_numpy(cfg, module)
    np.testing.assert_array_equal(got["final_norm"], params["final_norm"])
    np.testing.assert_allclose(got["layers"]["attn0"]["norm"],
                               params["layers"]["attn0"]["norm"] * 0.99,
                               rtol=1e-6)


def test_schedules_in_float32():
    for s in range(0, 130):
        f = schedules.wsd(3e-4, 10, 60, 50)
        g = jax_schedules.wsd(3e-4, 10, 60, 50)
        assert f(s).dtype == torch.float32
        assert f(s).item() == float(np.float32(g(jnp.int32(s))))
        c, d = schedules.cosine(3e-4, 5, 40), jax_schedules.cosine(3e-4, 5,
                                                                   40)
        a = np.float32(c(s).item()).view(np.int32)
        b = np.float32(d(jnp.int32(s))).view(np.int32)
        assert abs(int(a) - int(b)) <= 2, s
    assert schedules.constant(0.1)(7).item() == np.float32(0.1)


if __name__ == "__main__":
    # check_runs.TRP_PINS and TRP_FP32_PINS (each run in its own process:
    # ~18 GB at the peak)
    import subprocess
    import sys
    for dtype in ("bfloat16", "float32"):
        code = ("from torch_train_cases import trp_jax; "
                f"print(repr(trp_jax({dtype!r})))")
        out = subprocess.run([sys.executable, "-c", code], check=True,
                             capture_output=True, text=True).stdout
        print(dtype, out.strip().splitlines()[-1])

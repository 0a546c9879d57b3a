"""The port's sharding rules (``distributed/shardings.py``) against the
reference's (CPU): ``param_spec`` / ``tree_specs`` for every leaf of every
architecture's full config and of its AdamW and Adafactor states,
``act_spec`` for every kind (with and without ``seq_parallel``),
``batch_specs`` and each family's decode ``cache_specs``, on
("data", "model") and ("pod", "data", "model") grids.  The reference's side
uses tests/test_distributed.py's FakeMesh (its rule tables read only the
axis names; its batch and cache specs are ``NamedSharding``s of a
one-device mesh); the port's trees are shapes without storage
(``device="meta"``).  Specs compare as tuples, exactly."""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import get_config as jax_get_config
from repro.distributed.shardings import ShardingPolicy as JaxPolicy
from repro.models import build_model as jax_build_model
from repro.optim import adafactor as jax_adafactor, adamw as jax_adamw
from repro.optim import wsd as jax_wsd
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.mesh import make_debug_mesh
from repro_torch.distributed.shardings import ShardingPolicy
from repro_torch.models import Model
from repro_torch.models.common import leaf_tree
from repro_torch.optim import adafactor, adamw, wsd

AXES = {"2d": ("data", "model"), "pod": ("pod", "data", "model")}


class FakeMesh:
    def __init__(self, axis_names):
        self.axis_names = axis_names


def jax_policy(axes, fsdp=True, seq_parallel=False, mesh=None):
    pol = JaxPolicy.__new__(JaxPolicy)
    pol.mesh = mesh if mesh is not None else FakeMesh(axes)
    pol.fsdp = fsdp
    pol.seq_parallel = seq_parallel
    pol.__post_init__()
    return pol


def jax_specs(tree) -> dict:
    """path string -> spec tuple of a spec (or NamedSharding) tree."""
    from repro.distributed.shardings import _path_str
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec)
        or hasattr(x, "spec"))
    return {_path_str(p): tuple(getattr(s, "spec", s)) for p, s in flat}


def port_specs(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_specs(v, path + (str(k),)))
        return out
    if isinstance(tree, tuple) and tree and isinstance(tree[0], dict):
        out = {}
        for i, v in enumerate(tree):
            out.update(port_specs(v, path + (str(i),)))
        return out
    return {"/".join(path): tuple(tree)}


@functools.lru_cache(maxsize=None)
def jax_param_shapes(arch):
    model = jax_build_model(jax_get_config(arch))
    return jax.eval_shape(lambda k: model.init(k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def port_params(arch):
    return leaf_tree(Model(get_config(arch), device="cpu").module(
        train=True, device="meta"))


OPTS = {"adamw": (adamw, jax_adamw), "adafactor": (adafactor, jax_adafactor)}


@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("arch", list_archs())
def test_tree_specs_equal_the_reference_for_every_leaf(arch, axes):
    """Parameters and both optimizers' states, as the train state's
    (params, opt, step) tree: every leaf's spec equal."""
    jparams = jax_param_shapes(arch)
    params = port_params(arch)
    jpol, pol = jax_policy(AXES[axes]), ShardingPolicy(FakeMesh(AXES[axes]))
    for name, (popt, jopt) in OPTS.items():
        jstate = (jparams, jax.eval_shape(jopt(jax_wsd(1e-3, 1, 4, 4)).init,
                                          jparams),
                  jax.ShapeDtypeStruct((), jnp.int32))
        state = (params, popt(wsd(1e-3, 1, 4, 4)).init(params),
                 torch.zeros((), dtype=torch.int32))
        want = jax_specs(jpol.tree_specs(jstate))
        got = port_specs(pol.tree_specs(state))
        assert got == want, (arch, name)
        assert any("model" in s for s in got.values())
    # param_spec on the bare parameter tree, fsdp off too
    for fsdp in (True, False):
        jp = jax_policy(AXES[axes], fsdp=fsdp)
        p = ShardingPolicy(FakeMesh(AXES[axes]), fsdp=fsdp)
        assert (port_specs(p.tree_specs(params))
                == jax_specs(jp.tree_specs(jparams)))


KINDS = ["residual", "logits", "attn_q", "attn_kv", "attn_blk", "ffn_hidden",
         "moe_dispatch", "moe_hidden", "moe_combine", "mamba_proj",
         "mamba_chunk", "mamba_att", "other"]


@pytest.mark.parametrize("axes", list(AXES))
def test_act_spec_every_kind(axes):
    for sp in (False, True):
        jp = jax_policy(AXES[axes], seq_parallel=sp)
        p = ShardingPolicy(FakeMesh(AXES[axes]), seq_parallel=sp)
        for kind in KINDS:
            for ndim, shape in ((3, (4, 32, 64)), (3, (4, 30, 64)),
                                (4, (4, 32, 8, 64)), (5, (4, 2, 16, 8, 8))):
                want = jp.act_spec(kind, ndim, shape)
                got = p.act_spec(kind, ndim, shape)
                assert got == (None if want is None else tuple(want)), (
                    kind, ndim, shape, sp)
        x = torch.zeros(2, 3)
        assert p.act(x, "residual") is x


def one_device_mesh(axes):
    return jax.make_mesh((1,) * len(axes), axes, devices=jax.devices()[:1])


@pytest.mark.parametrize("axes", list(AXES))
def test_batch_specs(axes):
    jp = jax_policy(AXES[axes], mesh=one_device_mesh(AXES[axes]))
    p = ShardingPolicy(FakeMesh(AXES[axes]))
    for B in (1, 4):
        jb = {"tokens": jax.ShapeDtypeStruct((B, 16), jnp.int32),
              "vision_embeds": jax.ShapeDtypeStruct((B, 8, 32), jnp.bfloat16)}
        b = {"tokens": torch.empty((B, 16), device="meta"),
             "vision_embeds": torch.empty((B, 8, 32), device="meta")}
        assert port_specs(p.batch_specs(b)) == jax_specs(jp.batch_specs(jb))
    assert p.batch_specs({"t": torch.empty((1, 5))}) == {"t": ()}


@pytest.mark.parametrize("axes", list(AXES))
@pytest.mark.parametrize("arch", ["qwen3-4b", "llama4-scout-17b-a16e",
                                  "musicgen-medium", "zamba2-1.2b",
                                  "xlstm-1.3b"])
def test_cache_specs_each_family(arch, axes):
    jp = jax_policy(AXES[axes], mesh=one_device_mesh(AXES[axes]))
    p = ShardingPolicy(FakeMesh(AXES[axes]))
    jm = jax_build_model(jax_get_config(arch, smoke=True))
    m = Model(get_config(arch, smoke=True), device="cpu")
    for batch in (1, 4):
        jc = jax.eval_shape(lambda: jm.init_cache(batch, 64))
        c = m.init_cache(batch, 64, device="meta")
        assert (port_specs(p.cache_specs(c, batch))
                == jax_specs(jp.cache_specs(jc, batch))), (arch, batch)


def test_rank_grid_without_torch_distributed():
    """A grid of ones runs its collectives as copies, on the card unless
    the caller asks for the CPU; any other shape needs that many ranks,
    the production mesh 256 (512 multi-pod)."""
    from repro_torch.distributed.mesh import make_production_mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_debug_mesh((1, 1))
    g = make_debug_mesh((1, 1), device="cpu")
    assert g.shape == {"data": 1, "model": 1} and g.rank == 0
    assert g.device == torch.device("cpu")
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(g.all_gather(x, "data", 1), x)
    assert torch.equal(g.reduce_scatter(x, "model", 0), x)
    with pytest.raises(ValueError):
        make_debug_mesh((2, 2))
    for pod in (False, True):
        with pytest.raises(RuntimeError, match="needs"):
            make_production_mesh(multi_pod=pod)

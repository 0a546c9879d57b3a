"""The port's VLM and audio families (llava-next, musicgen) against the
JAX package's on the CPU, the weights of every family carried across
(``check_runs.numpy_params`` / ``numpy_leaves`` -> ``params_from_numpy``
and back), seeded random weights for every family, and the training entry
points that come with the next slice.  The drive and its tolerances are
``tests/torch_family_cases.py``'s.

Run as a script, it prints the JAX pin M1 of ``repro_torch.check_runs``
(llama4-scout at full width and one layer, a 1,280-token prompt and 4
greedy decodes; held on the card by ``chip_smoke.py``): ``PYTHONPATH=src
python tests/test_torch_families.py``, ~15 GB of host memory (the fp32
tree is never whole: each leaf is cast to bf16 as it is drawn) and ~70 s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.check_runs import numpy_leaves, numpy_params
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from torch_family_cases import check_drive, inputs

torch.set_num_threads(1)
FAMILIES = ["llama4_scout_17b_a16e", "llama4_maverick_400b_a17b",
            "llava_next_34b", "musicgen_medium", "zamba2_1p2b", "xlstm_1p3b"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llava_next_34b", "musicgen_medium"])
def test_prefill_extend_decode_match(arch, dtype):
    check_drive(arch, dtype)


NORMS = ("norm", "q_norm", "k_norm", "final_norm", "norm_w")


@pytest.mark.parametrize("arch", FAMILIES)
def test_params_round_trip(arch):
    """Every leaf comes back as the reference's ``cast_params`` leaves it
    (bf16 at two or more dimensions of its tree, stack axes included), the
    norm weights exact in fp32; the tree loads again to the same module,
    and so do its leaves handed over one at a time."""
    cfg = get_config(arch, smoke=True)
    tree = numpy_params(cfg, seed=5)
    model = params_from_numpy(cfg, tree, device="cpu")
    back = params_to_numpy(cfg, model)
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(tree)]
    for (path, a), (_, b) in zip(flat(tree), flat(back)):
        name = path[-1].key
        norm = name in NORMS or name.endswith("_norm")
        want = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                if a.ndim >= 2 and not norm else a)
        np.testing.assert_array_equal(b, want, err_msg=str(path))
    for other in (back, numpy_leaves(cfg, 5)):
        again = params_from_numpy(cfg, other, device="cpu")
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  again.named_parameters()):
            assert torch.equal(p, q), n
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(cfg, list(numpy_leaves(cfg, 5))[:-1], device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(cfg, {**tree, "extra": tree["embed"]},
                          device="cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_init_is_seeded_and_serves(arch):
    cfg = get_config(arch, smoke=True)
    m = Model(cfg, device="cpu")
    a = m.init(torch.Generator().manual_seed(0))
    b = m.init(torch.Generator().manual_seed(0))
    c = m.init(torch.Generator().manual_seed(1))
    for (n, p), (_, q), (_, r) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(p, q) and bool(torch.isfinite(p).all()), n
        if p.dim() >= 2:
            assert not torch.equal(p, r), n
    toks, vis = inputs(cfg)
    batch = {"tokens": torch.from_numpy(toks[:1, :5])}
    if vis is not None:
        batch["vision_embeds"] = torch.from_numpy(vis[:1])
    cache, h = m.prefill(a, batch, m.init_cache(1, 16))
    logits, cache = m.decode(a, torch.from_numpy(toks[:1, 5:6]), cache)
    assert bool(torch.isfinite(m.lm_head(a, h)).all())
    assert bool(torch.isfinite(logits).all())
    assert cache["pos"].tolist() == [6 + cfg.n_vis_tokens]


if __name__ == "__main__":
    from torch_family_cases import print_depth_pins
    print_depth_pins("M1", "llama4-scout-17b-a16e", 1)

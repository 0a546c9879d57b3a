"""The port's dense models (repro_torch.models) against the JAX package's
(the other families: tests/test_torch_families.py and its siblings), and
every architecture's config:
the layers (rmsnorm, RoPE, decode attention, SwiGLU), and ``Model.prefill``
then ``Model.decode`` on the four dense smoke configs (qwen3: qk-norm and
GQA; chatglm3: partial RoPE; minicpm: scale_emb, scale_depth, tied
embeddings and a padded vocabulary; mistral-nemo), with the same weights
carried across (``check_runs.numpy_params`` -> ``params_from_numpy``) and
the same tokens.  Tolerances, as max |port - JAX| over max |JAX|: 1e-4
with fp32 compute (the two frameworks sum matmuls and round exp/cos in
other orders and ulps), 0.05 with bf16 compute (the reference's own
decode/forward bound in tests/test_models.py; bf16 rounds at other places
in XLA and PyTorch).  The KV cache is bf16 in both modes; with fp32
compute a value that an fp32 difference of an ulp moves across a rounding
boundary differs by one bf16 ulp, so there the cache is held elementwise
to 2^-7 of each value (a bf16 ulp is 2^-8 to 2^-7 of it).

Run as a script, it prints the depth-2 pin of ``repro_torch.check_runs``
(qwen3-4b at full width and two layers, prefill 1,280 tokens and decode 4;
held on the card by ``chip_smoke.py``): ``PYTHONPATH=src python
tests/test_torch_models.py``, a few minutes and ~8 GB on a CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import layers as jl
from repro_torch.check_runs import numpy_params
from repro_torch.configs import DENSE, get_config, list_archs
from repro_torch.models import Model, build_model, layers as pl
from repro_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)
TOL = {"float32": 1e-4, "bfloat16": 0.05}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def pair(arch, dtype):
    """(JAX config, port config) of ``arch``'s smoke config in ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    return (jax_get_config(arch, smoke=True).replace(compute_dtype=jdt),
            get_config(arch, smoke=True).replace(compute_dtype=tdt))


def jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("arch", list_archs())
def test_configs_match_the_reference(arch):
    for smoke in (False, True):
        want = dataclasses.asdict(jax_get_config(arch, smoke=smoke))
        got = dataclasses.asdict(get_config(arch, smoke=smoke))
        for k in ("compute_dtype", "param_dtype"):
            assert str(got.pop(k)).split(".")[-1] == \
                np.dtype(want.pop(k)).name
        assert got == want


def test_model_defaults_to_the_card():
    cfg = get_config("qwen3-4b", smoke=True)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32), dtype=np.float32)
    w = 1 + 0.1 * rng.standard_normal(32, dtype=np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    assert rel(pl.rmsnorm(tx, torch.from_numpy(w)),
               jl.rmsnorm(jx, jnp.asarray(w))) < TOL[dtype]
    pos = rng.integers(0, 3000, (2, 9))
    for pct in (1.0, 0.5):
        rot = int(32 * pct)
        jc, js = jl.rope_cos_sin(jnp.asarray(pos), rot, 1e6)
        tc, ts = pl.rope_cos_sin(torch.from_numpy(pos), rot, 1e6)
        assert rel(tc, jc) < 1e-5 and rel(ts, js) < 1e-5
        assert rel(pl.apply_rope(tx, tc, ts, pct),
                   jl.apply_rope(jx, jc, js, pct)) < TOL[dtype]
    h = rng.standard_normal((2, 5, 16), dtype=np.float32)
    ws = [rng.standard_normal(s, dtype=np.float32) * 0.25
          for s in ((16, 24), (16, 24), (24, 16))]
    assert rel(pl.swiglu(torch.from_numpy(h).to(tdt),
                         *(torch.from_numpy(a).to(tdt) for a in ws)),
               jl.swiglu(jnp.asarray(h, jdt),
                         *(jnp.asarray(a, jdt) for a in ws))) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_decode_attention_matches(dtype, softcap):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 1, 8, 16), dtype=np.float32)
    kc, vc = (rng.standard_normal((3, 40, 2, 16), dtype=np.float32)
              for _ in range(2))
    pos = np.array([1, 17, 40], np.int32)
    want = jl.decode_attention(jnp.asarray(q, jdt), jnp.asarray(kc, jdt),
                               jnp.asarray(vc, jdt), jnp.asarray(pos),
                               softcap=softcap)
    got = pl.decode_attention(torch.from_numpy(q).to(tdt),
                              torch.from_numpy(kc).to(tdt),
                              torch.from_numpy(vc).to(tdt),
                              torch.from_numpy(pos), softcap=softcap)
    assert got.dtype == tdt
    assert rel(got, want) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches(arch, dtype):
    """Prefill 31 tokens (odd: ragged tiles) of two sequences, then decode
    three: last hidden, KV cache, logits and positions against JAX."""
    jcfg, cfg = pair(arch, dtype)
    tree = numpy_params(cfg, seed=3)
    jm, m = jax_build_model(jcfg), Model(cfg, device="cpu")
    jp, params = jax_tree(tree), params_from_numpy(cfg, tree, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 34))
    jc, tc = jm.init_cache(2, 48), m.init_cache(2, 48)
    jc, jh = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :31])}, jc)
    tc, th = m.prefill(params, {"tokens": torch.from_numpy(toks[:, :31])},
                       tc)
    assert rel(th, jh) < TOL[dtype]
    for k in ("k", "v"):
        want = np.asarray(jc[k], np.float32)
        if dtype == "float32":
            assert np.all(np.abs(tc[k].float().numpy() - want)
                          <= 2.0 ** -7 * np.abs(want))
        else:
            assert rel(tc[k], want) < TOL[dtype]
    for i in range(31, 34):
        jl_, jc = jm.decode(jp, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = m.decode(params, torch.from_numpy(toks[:, i:i + 1]), tc)
        assert tl.shape == (2, 1, cfg.vocab_size) and tl.dtype == torch.float32
        assert rel(tl, jl_) < TOL[dtype], f"decode step {i}"
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [34, 34]
    assert rel(m.lm_head(params, th), jm.lm_head(jp, jh)) < TOL[dtype]


@pytest.mark.parametrize("arch", DENSE)
def test_params_round_trip(arch):
    cfg = get_config(arch, smoke=True)
    tree = numpy_params(cfg, seed=5)
    model = params_from_numpy(cfg, tree, device="cpu")
    back = params_to_numpy(cfg, model)
    flat = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(tree)]
    for (path, a), (_, b) in zip(flat(tree), flat(back)):
        # matrices are held in bf16 (the reference's cast), norms in fp32
        want = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                if a.ndim - ("layers" in str(path)) >= 2 else a)
        np.testing.assert_array_equal(b, want, err_msg=str(path))
    again = params_from_numpy(cfg, back, device="cpu")
    for (n, p), (_, q) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(cfg, {**tree, "extra": tree["embed"]},
                          device="cpu")


def test_model_init_is_seeded():
    cfg = get_config("minicpm-2b", smoke=True)
    m = Model(cfg, device="cpu")
    a = m.init(torch.Generator().manual_seed(0))
    b = m.init(torch.Generator().manual_seed(0))
    c = m.init(torch.Generator().manual_seed(1))
    for (n, p), (_, q), (_, r) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(p, q), n
        if p.dim() >= 2:
            assert not torch.equal(p, r), n
            assert float(p.float().abs().max()) > 0
    w = a.layers[0].attn0.wq.float()
    assert abs(float(w.std()) * 64 ** 0.5 - 0.88) < 0.1   # ±2σ truncation


def d2_pins():
    """The depth-2 pin: the JAX package's top-8 ids and logits per step."""
    from repro_torch.check_runs import (D2_MAX_LEN, D2_SEED, D2_STEPS,
                                        d2_prompt)
    jcfg = jax_get_config("qwen3-4b").replace(n_layers=2)
    tree = numpy_params(get_config("qwen3-4b").replace(n_layers=2), D2_SEED)
    # cast as cast_params does, up front, to halve the memory
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16 if a.ndim >= 2 else a.dtype),
        tree)
    del tree
    m = jax_build_model(jcfg)
    cache = m.init_cache(1, D2_MAX_LEN)
    prompt = jnp.asarray(d2_prompt(jcfg.vocab_size)[None], jnp.int32)
    cache, h = m.prefill(params, {"tokens": prompt}, cache)
    logits = m.lm_head(params, h)[0, 0]
    out = []
    for step in range(D2_STEPS + 1):
        lg = np.asarray(logits, np.float32)
        ids = np.argsort(-lg, kind="stable")[:8]
        out.append((tuple(int(i) for i in ids),
                    tuple(float(lg[i]) for i in ids)))
        if step < D2_STEPS:
            tok = jnp.asarray([[int(ids[0])]], jnp.int32)
            logits, cache = m.decode(params, tok, cache)
            logits = logits[0, 0]
    return out


if __name__ == "__main__":
    import time
    t0 = time.perf_counter()
    print("D2_PINS = [")
    for ids, lg in d2_pins():
        print(f"    ({ids},\n     {tuple(round(x, 6) for x in lg)}),")
    print("]")
    print(f"# {time.perf_counter() - t0:.1f} s")

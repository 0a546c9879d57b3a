"""The port's ServeEngine (repro_torch.serve.engine) on the MoE, VLM, audio,
hybrid-SSM and xLSTM families, held to the JAX package's engine on the
CPU.  The JAX engine's results are pins of ``repro_torch.check_runs``
(its SSM branch runs an extend per segment, some ten seconds each on this
CPU for a smoke config): ``FAMILY_SERVE_PINS``, the stats and every token
of serve.driver's smoke setup with fp32 compute on the ``numpy_params``
weights (zamba2 and xLSTM reuse snapshots); ``CARRY_PINS``, the tokens of
prompt b served after prompt a in the one slot of a ``max_batch=1`` engine
and of b alone (the reference's slot-state carry-over); ``LF_PINS``, the
stats of runs LZ, LX and LM at smoke width with the published vocabulary
(held on the card at full width by ``chip_smoke.py``).  Also: a restored
snapshot is a copy (the extends that follow never write into the pool),
and the codebook family's tokens are per codebook.

Run as a script, it prints the pins from the JAX engine (its extends
jitted per start, which computes what the reference's eager extend
computes): ``PYTHONPATH=src python tests/test_torch_family_serving.py``, a
few minutes.
"""
import numpy as np
import pytest
import torch

from repro_torch.check_runs import (CARRY_PINS, FAMILY_SERVE_PINS,
                                    LF_CELLS, LF_NEW_TOKENS, LF_PINS,
                                    LF_WORKLOAD, numpy_params)
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeEngine
from repro_torch.serve.driver import make_workload

torch.set_num_threads(1)
FAMILIES = ["llama4_scout_17b_a16e", "llama4_maverick_400b_a17b",
            "llava_next_34b", "musicgen_medium", "zamba2_1p2b", "xlstm_1p3b"]
SMOKE_ENGINE = dict(max_batch=4, max_len=128, block_size=8, pool_slots=48)
CARRY_ENGINE = dict(max_batch=1, max_len=64, block_size=8, pool_slots=8)


def smoke_cfg(arch):
    return get_config(arch, smoke=True).replace(compute_dtype=torch.float32)


def port_engine(cfg, engine_kw, seed=0, **kw):
    m = Model(cfg, device="cpu")
    return ServeEngine(m, params_from_numpy(cfg, numpy_params(cfg, seed),
                                            device="cpu"), **engine_kw, **kw)


def replay(eng, prompts, new_tokens):
    for p in prompts:
        eng.submit(p, new_tokens)
    return eng.run()


def carry_prompts(cfg):
    """Prompts a and b: no block in common, 20 tokens each."""
    rng = np.random.default_rng(21)
    return [list(rng.integers(0, cfg.vocab_size, 20)) for _ in range(2)]


@pytest.mark.parametrize("arch", FAMILIES)
def test_engine_matches_jax_pins(arch):
    """serve.driver's smoke setup (max_batch 4, block 8, 48 pool slots; 16
    prompts of 24 shared and 9 own tokens, 3 new tokens each), fp32: every
    stat and every token equal to the JAX engine's."""
    cfg = smoke_cfg(arch)
    eng = port_engine(cfg, SMOKE_ENGINE)
    got = replay(eng, make_workload(cfg, 16, seed=1), 3)
    stats, tokens = FAMILY_SERVE_PINS[arch]
    assert eng.stats == stats
    assert got == tokens
    if cfg.family in ("hybrid_ssm", "xlstm"):
        assert stats["tokens_reused"] > 0       # snapshots were reused
    if cfg.n_codebooks:
        assert all(len(t) == cfg.n_codebooks for v in got.values()
                   for t in v)


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "xlstm_1p3b"])
def test_slot_state_carries_over_like_jax(arch):
    """The reference's caveat, reproduced: a finished request's slot keeps
    its recurrent states (only ``pos`` is reset) and a request that finds
    no snapshot continues them.  Prompt b served after prompt a in one slot
    gives JAX's tokens for that, and leaves other states in the slot than
    b alone (with these weights zamba2's four tokens agree with b alone's,
    xLSTM's do not)."""
    cfg = smoke_cfg(arch)
    a, b = carry_prompts(cfg)
    eng_ab, eng_b = (port_engine(cfg, CARRY_ENGINE) for _ in range(2))
    after_a = replay(eng_ab, [a, b], 4)[1]
    alone = replay(eng_b, [b], 4)[0]
    want_after_a, want_alone = CARRY_PINS[arch]
    assert after_a == want_after_a and alone == want_alone
    states = {"hybrid_ssm": ("mamba", "ssm"),
              "xlstm": ("mlstm",)}[cfg.family]

    def slot_state(eng):
        leaf = eng.cache
        for k in states:
            leaf = leaf[k]
        return leaf
    assert not torch.equal(slot_state(eng_ab), slot_state(eng_b))
    if cfg.family == "xlstm":
        assert after_a != alone


def test_restored_snapshot_is_a_copy():
    """Every snapshot a request restores is, after its extends and decodes,
    still what was stored: ``PayloadPool.load`` clones and the slot is
    written, never the pool (64 slots: nothing is evicted)."""
    cfg = smoke_cfg("zamba2_1p2b")
    eng = port_engine(cfg, dict(SMOKE_ENGINE, pool_slots=64))
    kept, loaded = {}, []
    load = eng.pool.load

    def recording_load(slot):
        loaded.append(slot)
        kept[slot] = {k: {n: a[slot].clone() for n, a in v.items()}
                      if isinstance(v, dict) else v[slot].clone()
                      for k, v in eng.pool.pool.items()}
        return load(slot)

    eng.pool.load = recording_load
    replay(eng, make_workload(cfg, 16, seed=1), 3)
    assert loaded and eng.stats["tokens_reused"] > 0
    for slot in loaded:
        for k, v in eng.pool.pool.items():
            for n, a in (v.items() if isinstance(v, dict) else [(k, v)]):
                want = kept[slot][k][n] if isinstance(v, dict) \
                    else kept[slot][k]
                assert torch.equal(a[slot], want), (slot, k, n)


@pytest.mark.parametrize("cell", sorted(LF_CELLS))
def test_full_width_cell_stats_at_smoke_width(cell):
    """Runs LZ, LX and LM on the port at smoke width with the published
    vocabulary (the device sketch's plain versions): every stat equals the
    JAX pin that chip_smoke.py holds the full-width runs to."""
    arch, engine_kw, _ = LF_CELLS[cell]
    cfg = get_config(arch, smoke=True).replace(
        vocab_size=get_config(arch).vocab_size)
    m = Model(cfg, device="cpu")
    eng = ServeEngine(m, m.init(torch.Generator().manual_seed(0)),
                      **engine_kw, device_sketch=True)
    wl = dict(LF_WORKLOAD)
    out = replay(eng, make_workload(cfg, wl.pop("n_requests"), **wl),
                 LF_NEW_TOKENS)
    assert len(out) == LF_WORKLOAD["n_requests"]
    assert all(len(t) == LF_NEW_TOKENS for t in out.values())
    assert eng.stats == LF_PINS[cell]


# ---------------------------------------------------------------------------
# the pins, from the JAX engine
# ---------------------------------------------------------------------------

def jax_engine(arch, engine_kw, *, fp32=True, vocab=None, seed=0,
               device_sketch=False):
    import jax
    import jax.numpy as jnp
    import repro.serve.engine as jengine
    from repro.configs import get_config as jax_get_config
    from repro.models import build_model
    from repro.serve import prefix_cache as jpc
    from repro.serve.extend import extend as jax_extend
    jcfg = jax_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    if fp32:
        jcfg = jcfg.replace(compute_dtype=jnp.float32)
    if vocab:
        jcfg, cfg = jcfg.replace(vocab_size=vocab), cfg.replace(
            vocab_size=vocab)
    model = build_model(jcfg)
    jitted = {}

    def extend(model, params, toks, cache, start):
        key = (id(model), start)
        if key not in jitted:
            jitted[key] = jax.jit(
                lambda p, t, c: jax_extend(model, p, t, c, start))
        return jitted[key](params, toks, cache)

    jengine.extend = extend
    eng = jengine.ServeEngine(
        model, jax.tree_util.tree_map(jnp.asarray, numpy_params(cfg, seed)),
        **engine_kw)
    if device_sketch:
        eng.prefix_cache.admission = jpc.DeviceAdmission(
            eng.prefix_cache.capacity, 8, use_pallas=False)
    return eng


def jax_tokens(out):
    return {r: [[int(x) for x in t] if isinstance(t, list) else int(t)
                for t in v] for r, v in out.items()}


def print_pins():
    import time
    from repro.serve import driver as jdriver
    t0 = time.perf_counter()
    print("FAMILY_SERVE_PINS = {")
    for arch in FAMILIES:
        eng = jax_engine(arch, SMOKE_ENGINE)
        out = replay(eng, jdriver.make_workload(eng.cfg, 16, seed=1), 3)
        print(f"    {arch!r}: ({eng.stats},\n        {jax_tokens(out)}),")
    print("}")
    print("CARRY_PINS = {")
    for arch in ("zamba2_1p2b", "xlstm_1p3b"):
        a, b = carry_prompts(smoke_cfg(arch))
        after_a = replay(jax_engine(arch, CARRY_ENGINE), [a, b], 4)[1]
        alone = replay(jax_engine(arch, CARRY_ENGINE), [b], 4)[0]
        print(f"    {arch!r}: ({jax_tokens({0: after_a})[0]}, "
              f"{jax_tokens({0: alone})[0]}),")
    print("}")
    print("LF_PINS = {")
    for cell, (arch, engine_kw, _) in sorted(LF_CELLS.items()):
        eng = jax_engine(arch, engine_kw, fp32=False, device_sketch=True,
                         vocab=get_config(arch).vocab_size)
        wl = dict(LF_WORKLOAD)
        prompts = jdriver.make_workload(eng.cfg, wl.pop("n_requests"), **wl)
        out = replay(eng, prompts, LF_NEW_TOKENS)
        assert len(out) == len(prompts)
        print(f"    {cell!r}: {eng.stats},")
    print("}")
    print(f"# {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    print_pins()

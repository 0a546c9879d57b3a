"""The port's data pipeline, checkpoints and driver against the JAX
package's (CPU).

The pipeline's batches and ``cache_stats`` equal the reference's bit for
bit over 40 steps (its shard cache is the port's host W-TinyLFU) and
resume from ``state_dict``; the port's driver interrupted and resumed
equals its continuous run (the reference's tests/test_checkpoint_data.py
bound, 1e-4); a training checkpoint (the train state and the data cursor)
written by either package restores in the other and gives the same next
two losses within 1e-5 in fp32 (the second reads the restored optimizer
state); the trained fp32 masters serve through ``ServeEngine``
(tests/test_system.py's train-then-serve).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import restore_checkpoint as jax_restore
from repro.checkpoint.store import save_checkpoint as jax_save
from repro.data import pipeline as jax_pipeline
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import wsd as jax_wsd
from repro.train import build_train_step as jax_build_train_step
from repro.train import make_train_state as jax_make_train_state
from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.models import Model, build_model
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import adamw, make_optimizer, wsd
from repro_torch.serve import ServeEngine
from repro_torch.train import build_train_step, make_train_state
from repro_torch.train.driver import train
from repro_torch.train.train_step import load_state_tree, state_tree
from torch_train_cases import batch_np, pair


def pipe(mod, seed=0):
    spec = mod.ShardSpec(n_shards=32, tokens_per_shard=2048,
                         vocab_size=1000, seed=seed)
    return mod.TokenPipeline(
        mod.CachedShardReader(mod.SyntheticShardStore(spec),
                              capacity_shards=6, seed=seed),
        seq_len=64, global_batch=4, seed=seed)


@pytest.mark.parametrize("seed", [0, 7])
def test_pipeline_equals_reference_bit_for_bit(seed):
    ref, port = pipe(jax_pipeline, seed), pipe(pipeline, seed)
    for _ in range(40):
        a, b = ref.next_batch()["tokens"], port.next_batch()["tokens"]
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert ref.cache_stats == port.cache_stats
    st = port.cache_stats
    assert st["shard_cache_hit_ratio"] > 0.3 and st["cold_fetches"] < 160


def test_pipeline_resume_replays():
    ref = pipe(pipeline)
    batches = [ref.next_batch()["tokens"] for _ in range(8)]
    fresh = pipe(pipeline)
    for _ in range(3):
        fresh.next_batch()
    resumed = pipe(pipeline)
    resumed.load_state_dict(fresh.state_dict())
    for i in range(3, 8):
        np.testing.assert_array_equal(resumed.next_batch()["tokens"],
                                      batches[i])


def test_driver_interrupted_equals_continuous(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    kw = dict(global_batch=4, seq_len=32, ckpt_every=3, device="cpu")
    cont = train("chatglm3-6b", steps=6, out_dir=a, **kw)
    train("chatglm3-6b", steps=3, out_dir=b, **kw)
    assert latest_step(os.path.join(b, "ckpt")) == 3
    resumed = train("chatglm3-6b", steps=6, out_dir=b, **kw)
    assert abs(cont["loss"] - resumed["loss"]) < 1e-4
    lines = open(os.path.join(b, "metrics.jsonl")).read().splitlines()
    assert len(lines) == 6
    assert set(cont) >= {"step", "loss", "grad_norm", "lr", "tokens_per_s",
                         "shard_cache_hit_ratio", "cold_fetches", "wall_s"}


ARCH = "qwen3-4b"


def jax_side():
    jcfg, cfg = pair(ARCH)
    jm = jax_build_model(jcfg)
    opt = jax_adamw(jax_wsd(1e-2, 1, 10, 10))
    step = jax.jit(jax_build_train_step(jm, opt, loss_chunk=8))
    return jm, opt, step


def port_side():
    _, cfg = pair(ARCH)
    m = build_model(cfg, device="cpu")
    opt = adamw(wsd(1e-2, 1, 10, 10))
    return m, opt, build_train_step(m, opt, loss_chunk=8)


def batches(n):
    _, cfg = pair(ARCH)
    return [batch_np(cfg, seed=20 + i) for i in range(n)]


def next_two(step_fn, state, bs, to):
    out = []
    for b in bs:
        state, metrics = step_fn(state, {k: to(v) for k, v in b.items()})
        out.append(float(metrics["loss"]))
    return out


def test_checkpoint_written_by_jax_resumes_in_the_port(tmp_path):
    bs = batches(3)
    jm, jopt, jstep = jax_side()
    jstate = jax_make_train_state(jm, jopt, jax.random.PRNGKey(0))
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in bs[0].items()})
    jax_save(str(tmp_path), 1, {"state": jstate, "data": {"step": 1}})
    want = next_two(jstep, jstate, bs[1:], jnp.asarray)

    m, opt, step = port_side()
    state = make_train_state(m, opt, torch.Generator().manual_seed(9))
    data = {"step": 0}
    payload = restore_checkpoint(str(tmp_path), 1,
                                 {"state": state_tree(state), "data": data},
                                 device="cpu")
    load_state_tree(state, payload["state"])
    assert payload["data"] == {"step": 1} and int(state.step) == 1
    assert int(state.opt["step"]) == 1
    got = next_two(step, state, bs[1:], torch.from_numpy)
    assert np.allclose(got, want, rtol=0, atol=1e-5), (got, want)


def test_checkpoint_written_by_the_port_resumes_in_jax(tmp_path):
    bs = batches(3)
    m, opt, step = port_side()
    state = make_train_state(m, opt, torch.Generator().manual_seed(4))
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                            bs[0].items()})
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(int(state.step), {"state": state_tree(state),
                              "data": {"step": 1}})
    ck.wait()
    want = next_two(step, state, bs[1:], torch.from_numpy)

    jm, jopt, jstep = jax_side()
    template = jax_make_train_state(jm, jopt, jax.random.PRNGKey(3))
    payload = jax_restore(str(tmp_path), 1, {"state": template,
                                             "data": {"step": 0}})
    jstate = payload["state"]
    assert payload["data"] == {"step": 1} and int(jstate.step) == 1
    got = next_two(jstep, jstate, bs[1:], jnp.asarray)
    assert np.allclose(got, want, rtol=0, atol=1e-5), (got, want)


def test_train_then_serve_roundtrip(tmp_path):
    """Train on a tiny corpus with a shared prefix, checkpoint the fp32
    masters, serve them with prefix reuse."""
    cfg = get_config("chatglm3-6b", smoke=True)
    m = build_model(cfg, device="cpu")
    opt = make_optimizer("adamw", wsd(2e-3, 3, 60, 20))
    state = make_train_state(m, opt, torch.Generator().manual_seed(0))
    step = build_train_step(m, opt, loss_chunk=16)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 16)
    losses = []
    for _ in range(10):
        suffix = rng.integers(0, cfg.vocab_size, (4, 16))
        toks = np.concatenate([np.tile(prefix, (4, 1)), suffix], axis=1)
        state, metrics = step(state, {"tokens": torch.from_numpy(
            toks.astype(np.int32))})
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]

    save_checkpoint(str(tmp_path), int(state.step), params_to_numpy(
        cfg, state.params))
    tree = restore_checkpoint(str(tmp_path), int(state.step),
                              params_to_numpy(cfg, state.params),
                              device="cpu")
    params = params_from_numpy(cfg, {k: _np(v) for k, v in tree.items()},
                               device="cpu")
    eng = ServeEngine(Model(cfg, device="cpu"), params, max_batch=2,
                      max_len=96, block_size=8, pool_slots=16)
    p1 = list(prefix) + list(rng.integers(0, cfg.vocab_size, 9))
    p2 = list(prefix) + list(rng.integers(0, cfg.vocab_size, 9))
    eng.submit(p1, 4)
    out1 = eng.run()
    eng.submit(p2, 4)
    out2 = eng.run()
    assert len(out1) == 1 and len(out2) == 1
    assert eng.stats["block_hits"] >= 2


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()

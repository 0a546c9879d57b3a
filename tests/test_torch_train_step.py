"""The reference's training machinery tests, run on the port (CPU):
tests/test_models.py's microbatch, Adafactor and schedule cases and
tests/test_system.py's optimizer and loss properties, with the
reference's bounds, on weights drawn by the port's own init (the
train-step cases per architecture: tests/test_torch_train_archs.py)."""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.common import leaf_tree, param_count
from repro_torch.optim import (adamw, clip_by_global_norm, cosine,
                               global_norm, make_optimizer, wsd)
from repro_torch.train import (build_loss_fn, build_train_step,
                               chunked_cross_entropy, make_train_state)


def make_batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, shape).astype(np.int32))}
    if cfg.n_vis_tokens:
        batch["vision_embeds"] = torch.from_numpy(
            rng.normal(size=(B, cfg.n_vis_tokens, cfg.d_model)) * 0.02
        ).to(torch.bfloat16)
    return batch


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_microbatch_equivalence():
    """Gradients accumulated over 2 microbatches == one batch (compared at
    the gradient buffers, within the reference's bf16 bound)."""
    cfg = get_config("qwen3_4b", smoke=True)
    m = build_model(cfg, device="cpu")
    batch = make_batch(cfg, 4, 32)
    grads = []
    for mb in (1, 2):
        opt = adamw(wsd(1e-3, 5, 100, 50))
        state = make_train_state(m, opt, gen())
        _, metrics = build_train_step(m, opt, microbatches=mb,
                                      loss_chunk=16)(state, batch)
        grads.append([leaf.grad.clone() for leaf in state.params.ref_leaves])
        if mb == 2:
            assert set(metrics) == {"loss", "grad_norm", "lr"}
    for a, b in zip(*grads):
        rel = float((a - b).abs().max() / (a.abs().max() + 1e-8))
        assert rel < 0.05


def test_microbatch_sum_is_exact_in_fp32():
    """In fp32 the accumulated gradient is the mean of the halves'."""
    cfg = get_config("qwen3_4b", smoke=True).replace(
        compute_dtype=torch.float32)
    m = build_model(cfg, device="cpu")
    params = m.init(gen(), train=True)
    batch = make_batch(cfg, 4, 32)
    loss_fn = build_loss_fn(m, loss_chunk=16)
    halves = []
    for sl in (slice(0, 2), slice(2, 4)):
        for leaf in params.ref_leaves:
            leaf.grad.zero_()
        loss_fn(params, {k: v[sl] for k, v in batch.items()})[0].backward()
        halves.append([leaf.grad.clone() for leaf in params.ref_leaves])
    opt = adamw(wsd(1e-3, 5, 100, 50))
    state = make_train_state(m, opt, gen())
    build_train_step(m, opt, microbatches=2, loss_chunk=16)(state, batch)
    for a, b, g in zip(*halves, [l.grad for l in state.params.ref_leaves]):
        torch.testing.assert_close(g, (a + b) / 2, rtol=1e-6, atol=1e-7)


def test_adafactor_trains():
    cfg = get_config("minicpm_2b", smoke=True)
    m = build_model(cfg, device="cpu")
    opt = make_optimizer("adafactor", cosine(3e-3, 5, 200))
    state = make_train_state(m, opt, gen(1))
    step = build_train_step(m, opt, loss_chunk=16)
    batch = make_batch(cfg, 4, 32)
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(6)]
    assert all(map(math.isfinite, losses)) and losses[-1] < losses[0]


def test_adafactor_state_is_factored():
    cfg = get_config("qwen3_4b", smoke=True)
    params = build_model(cfg, device="cpu").init(gen(), train=True)
    opt = make_optimizer("adafactor", cosine(1e-3, 5, 200))
    st = opt.init(leaf_tree(params))
    n_state = param_count({k: v for k, v in st.items() if k != "step"})
    assert n_state < 0.2 * param_count(params)     # O(n + m) per matrix


def test_wsd_schedule_shape():
    f = wsd(1.0, warmup=10, stable=100, decay=100, floor_frac=0.1)
    assert float(f(0)) < 0.2
    assert abs(float(f(50)) - 1.0) < 1e-6
    assert abs(float(f(110)) - 1.0) < 1e-6


@pytest.mark.parametrize("max_norm", [0.1, 0.7, 3.0, 4.9, 13.0, 100.0])
def test_clip_never_exceeds(max_norm):
    g = {"a": torch.tensor([3.0, -4.0]), "b": torch.tensor([[12.0]])}
    clipped, norm = clip_by_global_norm(g, max_norm)
    assert float(norm) == 13.0
    assert float(global_norm(clipped)) <= max_norm * 1.001 + 1e-6


def test_adamw_step_bounded():
    """Adam's updates are bounded by about lr whatever the grad scale."""
    opt = make_optimizer("adamw", lambda s: torch.tensor(0.1),
                         weight_decay=0.0, max_grad_norm=1e9)
    for scale in [1e-6, 1.0, 1e6]:
        p = {"w": torch.ones(4)}
        st = opt.init(p)
        opt.apply(p, {"w": torch.full((4,), scale)}, st)
        assert float((p["w"] - 1.0).abs().max()) < 0.5


def test_chunked_xent_matches_direct():
    cfg = get_config("qwen3-4b", smoke=True)
    m = build_model(cfg, device="cpu")
    params = m.init(gen(), train=True)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32))
    with torch.no_grad():
        h, _ = m.hidden_train(params, {"tokens": toks})
        loss, _ = chunked_cross_entropy(params, h, toks, cfg, chunk=8)
        logits = m.lm_head(params, h)[:, :-1]
        lab = toks[:, 1:].long()
        ref = (torch.logsumexp(logits, -1)
               - logits.gather(-1, lab[..., None])[..., 0]).mean()
    assert abs(float(loss) - float(ref)) < 1e-3


@pytest.mark.parametrize("T", [2, 3, 15, 16, 17, 40])
def test_chunked_xent_any_length(T):
    cfg = get_config("musicgen_medium", smoke=True)
    m = build_model(cfg, device="cpu")
    params = m.init(gen(), train=True)
    toks = torch.from_numpy(np.random.default_rng(T).integers(
        0, cfg.vocab_size, (2, T, cfg.n_codebooks)).astype(np.int32))
    with torch.no_grad():
        h, _ = m.hidden_train(params, {"tokens": toks})
        loss, metr = chunked_cross_entropy(params, h, toks, cfg, chunk=16)
    assert math.isfinite(float(loss))
    assert int(metr["tokens"]) == 2 * (T - 1)

"""Every architecture's smoke config trains on the port (CPU): the
reference's tests/test_models.py ``test_train_step_reduces_loss`` with its
bounds (six AdamW steps on one batch: finite losses, the last below the
first, the first within 1.5 of ln V)."""
import math

import pytest

from repro_torch.configs import get_config, list_archs
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer, wsd
from repro_torch.train import build_train_step, make_train_state
from test_torch_train_step import gen, make_batch


@pytest.mark.parametrize("arch", list_archs())
def test_train_step_reduces_loss(arch):
    cfg = get_config(arch, smoke=True)
    m = build_model(cfg, device="cpu")
    opt = make_optimizer("adamw", wsd(1e-3, 5, 100, 50))
    state = make_train_state(m, opt, gen())
    step = build_train_step(m, opt, loss_chunk=16)
    batch = make_batch(cfg, 4, 32)
    losses = []
    for _ in range(6):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(map(math.isfinite, losses))
    assert losses[-1] < losses[0], f"no learning: {losses}"
    # a fresh model's loss is about ln(V)
    assert abs(losses[0] - math.log(cfg.vocab_size)) < 1.5
    assert int(state.step) == 6 and int(state.opt["step"]) == 6
    assert set(metrics) >= {"loss", "grad_norm", "lr", "nll", "tokens",
                            "aux_loss"}

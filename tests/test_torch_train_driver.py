"""``Model.hidden_train``, ``Model.input_specs`` and the driver's
``train()`` for every architecture's smoke config on the port (CPU):
the reference's forward-shape test (tests/test_models.py), the input
specs as ``device="meta"`` tensors of the reference's ``SHAPES``, and two
driver steps each (metrics with the reference's fields, a checkpoint)."""
import json
import math
import os

import pytest
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models import build_model
from repro_torch.models.api import SHAPES
from repro_torch.train.driver import train
from test_torch_train_step import gen, make_batch


@pytest.mark.parametrize("arch", list_archs())
def test_hidden_train_shapes_finite(arch):
    cfg = get_config(arch, smoke=True)
    m = build_model(cfg, device="cpu")
    params = m.init(gen(), train=True)
    B, S = 2, 32
    h, aux = m.hidden_train(params, make_batch(cfg, B, S))
    S_out = S + (cfg.n_vis_tokens or 0)
    assert h.shape == (B, S_out, cfg.d_model) and h.dtype == torch.bfloat16
    assert h.requires_grad and aux.dtype == torch.float32
    logits = m.lm_head(params, h)
    want = ((B, S_out, cfg.n_codebooks, cfg.vocab_size) if cfg.n_codebooks
            else (B, S_out, cfg.vocab_size))
    assert logits.shape == want
    assert bool(torch.isfinite(logits).all()) and math.isfinite(aux.item())
    # the training storage: fp32 masters that require grad, one stacked
    # tensor (and gradient buffer) per reference leaf
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in params.parameters())
    assert sum(leaf.value.numel() for leaf in params.ref_leaves) == sum(
        p.numel() for p in params.parameters())


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_are_meta(arch):
    cfg = get_config(arch, smoke=False)
    m = build_model(cfg, device="cpu")
    for kind, sh in SHAPES.items():
        specs = m.input_specs(kind)
        B, S = sh["global_batch"], sh["seq_len"]
        toks = specs["tokens"]
        assert toks.device.type == "meta" and toks.dtype == torch.int32
        s = S if sh["kind"] in ("train", "prefill") else 1
        assert toks.shape == ((B, s, cfg.n_codebooks) if cfg.n_codebooks
                              else (B, s))
        if sh["kind"] == "decode":
            leaves = [specs["cache"]]
            while leaves:
                x = leaves.pop()
                if isinstance(x, dict):
                    leaves.extend(x.values())
                else:
                    assert x.device.type == "meta"
        elif cfg.n_vis_tokens:
            assert specs["vision_embeds"].shape == (B, cfg.n_vis_tokens,
                                                    cfg.d_model)


@pytest.mark.parametrize("arch", list_archs())
def test_driver_trains_every_arch(arch, tmp_path):
    out = train(arch, steps=2, out_dir=str(tmp_path), global_batch=2,
                seq_len=16, ckpt_every=2, device="cpu")
    assert math.isfinite(out["loss"]) and out["step"] == 2
    lines = [json.loads(x) for x in
             open(tmp_path / "metrics.jsonl").read().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert os.path.isdir(tmp_path / "ckpt" / "step_0000000002")

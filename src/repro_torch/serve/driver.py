"""Serving driver: a ``ServeEngine`` for an architecture, replaying a
multi-tenant workload and reporting the prefix cache's hit ratio, reuse
and admission statistics.

Counterpart of ``repro/serve/driver.py``.  On the card by default:

  PYTHONPATH=src python -m repro_torch.serve.driver --arch qwen3-4b
  PYTHONPATH=src python -m repro_torch.serve.driver --arch qwen3-4b --full

The first replays the reference's smoke workload on the smoke config;
``--full`` serves run L of ``repro_torch.check_runs`` (the published config,
random weights from ``--seed``: 24 prompts of 1,024 shared tenant tokens
and 256 user tokens).  Admission runs on the host sketch unless
``--device-sketch``.  ``--device cpu`` runs the plain versions on the CPU
(smoke sizes only, in practice).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.check_runs import L_ENGINE, L_NEW_TOKENS, L_WORKLOAD
from repro_torch.configs import get_config
from repro_torch.models import build_model
from .engine import ServeEngine


def make_workload(cfg, n_requests: int, n_tenants: int = 12,
                  prefix_len: int = 24, suffix_len: int = 9, seed: int = 0):
    """Zipf-popular tenants sharing per-tenant prompt prefixes (the
    reference's numpy draws, so the same prompts)."""
    rng = np.random.default_rng(seed)
    prefixes = [list(rng.integers(0, cfg.vocab_size, prefix_len))
                for _ in range(n_tenants)]
    ranks = np.arange(1, n_tenants + 1, dtype=np.float64) ** -1.0
    p = ranks / ranks.sum()
    out = []
    for _ in range(n_requests):
        t = rng.choice(n_tenants, p=p)
        out.append(prefixes[t] + list(rng.integers(0, cfg.vocab_size,
                                                   suffix_len)))
    return out


def serve(arch: str, *, smoke: bool = True, n_requests: int = 40,
          policy: str = "wtinylfu", max_new_tokens: int = 4,
          pool_slots: int = 48, device_sketch: bool = False, seed: int = 0,
          engine: dict | None = None, workload: dict | None = None,
          device=None) -> dict:
    """Replay ``make_workload(cfg, n_requests, **workload)`` through a
    ``ServeEngine`` (the reference's smoke engine unless ``engine`` gives
    its keyword arguments); returns the engine's stats with ``completed``
    and the wall seconds of the replay."""
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init(gen)
    kw = dict(max_batch=4, max_len=128, block_size=8, pool_slots=pool_slots,
              prefix_policy=policy, device_sketch=device_sketch, seed=seed)
    kw.update(engine or {})
    eng = ServeEngine(model, params, **kw)
    for prompt in make_workload(cfg, n_requests, seed=seed,
                                **(workload or {})):
        eng.submit(prompt, max_new_tokens)
    t0 = time.perf_counter()
    results = eng.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    stats = dict(eng.stats)
    stats["completed"] = len(results)
    stats["wall_s"] = time.perf_counter() - t0
    return stats


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--policy", default="wtinylfu",
                    choices=["lru", "tinylfu", "wtinylfu"])
    ap.add_argument("--full", action="store_true",
                    help="run L: the published config at L's sizes")
    ap.add_argument("--device-sketch", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    if args.full:
        wl = dict(L_WORKLOAD)
        out = serve(args.arch, smoke=False, n_requests=wl.pop("n_requests"),
                    policy=args.policy, max_new_tokens=L_NEW_TOKENS,
                    device_sketch=args.device_sketch, seed=args.seed,
                    engine=L_ENGINE, workload=wl, device=args.device)
    else:
        out = serve(args.arch, n_requests=args.requests, policy=args.policy,
                    device_sketch=args.device_sketch, seed=args.seed,
                    device=args.device)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

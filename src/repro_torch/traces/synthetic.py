"""Synthetic traces for the port's runs: numpy copies of the reference's
generators (``repro/traces/synthetic.py``), key-for-key identical to them."""
from __future__ import annotations

import numpy as np


def zipf_probs(n_items: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


def _sample_from_probs(probs: np.ndarray, length: int,
                       rng: np.random.Generator) -> np.ndarray:
    cdf = np.cumsum(probs)
    cdf[-1] = 1.0
    u = rng.random(length)
    return np.searchsorted(cdf, u, side="right").astype(np.int64)


def zipf_trace(length: int, n_items: int = 1_000_000, alpha: float = 0.9,
               seed: int = 0) -> np.ndarray:
    """Static Zipf trace; ranks are shuffled into arbitrary key ids."""
    rng = np.random.default_rng(seed)
    ranks = _sample_from_probs(zipf_probs(n_items, alpha), length, rng)
    perm = rng.permutation(n_items).astype(np.int64)
    return perm[ranks]


def scan_then_hotspot_trace() -> np.ndarray:
    """25k one-shot sequential scan then a 35k Zipf(1.0) hotspot over 2k
    items: the golden trace of ``tests/test_device_simulate.py``."""
    rng = np.random.default_rng(13)
    scan = np.arange(100_000, 125_000, dtype=np.int64)
    hot = _sample_from_probs(zipf_probs(2_000, 1.0), 35_000,
                             rng).astype(np.int64)
    return np.concatenate([scan, hot])

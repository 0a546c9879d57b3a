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


def fickle_churn_trace(length: int, n_hot: int = 2000, alpha: float = 1.0,
                       hot_frac: float = 0.7, seed: int = 0) -> np.ndarray:
    """A stable Zipf hot set interleaved with one-hit wonders (§2.3's
    "fickle" churn: every churn key is seen exactly once)."""
    rng = np.random.default_rng(seed)
    hot = _sample_from_probs(zipf_probs(n_hot, alpha), length, rng)
    is_hot = rng.random(length) < hot_frac
    n_cold = int((~is_hot).sum())
    # one-hit wonders: fresh ids above the hot range, each seen once
    cold = n_hot + np.arange(n_cold, dtype=np.int64)
    out = np.empty(length, dtype=np.int64)
    out[is_hot] = hot[is_hot]
    out[~is_hot] = cold
    return out


def tenant_lanes_trace(streams: int, length: int, n_items: int = 10_000,
                       alpha: float = 0.9, tenant_alpha: float = 1.0,
                       drift_every: int = 0, seed: int = 0) -> np.ndarray:
    """Multi-tenant lane trace for ``DeviceWTinyLFU(streams=B)``: a
    ``(streams, length)`` int64 key matrix, row b = tenant b's accesses.

    Tenant popularity ``Zipf(tenant_alpha)`` over the lanes sets each
    tenant's working set: the rank-r tenant draws from a ``Zipf(alpha)``
    over ``n_items / r^tenant_alpha`` keys (floor 64).  Key ids are offset
    per lane into disjoint ranges.  ``drift_every > 0`` re-draws each
    lane's rank->key permutation every ``drift_every`` accesses, with a
    per-lane phase offset of ``b * drift_every / streams`` accesses.
    """
    if streams < 1:
        raise ValueError(f"streams {streams} must be >= 1")
    rng = np.random.default_rng(seed)
    tenant_rank = rng.permutation(streams) + 1        # rank 1 = hottest
    out = np.empty((streams, length), dtype=np.int64)
    for b in range(streams):
        nb = max(64, int(n_items / tenant_rank[b] ** tenant_alpha))
        probs = zipf_probs(nb, alpha)
        ranks = _sample_from_probs(probs, length, rng)
        perm = rng.permutation(nb).astype(np.int64)
        if drift_every and drift_every > 0:
            phase = (b * drift_every) // streams
            pos = 0
            while pos < length:
                nxt = min(length, pos + (drift_every - (pos + phase)
                                         % drift_every))
                out[b, pos:nxt] = perm[ranks[pos:nxt]]
                perm = rng.permutation(nb).astype(np.int64)
                pos = nxt
        else:
            out[b] = perm[ranks]
        out[b] += b * (n_items + 64)                  # disjoint id ranges
    return out


def multi_tenant_prompt_trace(n_requests: int, n_tenants: int = 200,
                              tenant_alpha: float = 1.0,
                              prefix_blocks_mean: int = 24,
                              suffix_blocks_mean: int = 6,
                              block_reuse_alpha: float = 0.8,
                              seed: int = 0) -> np.ndarray:
    """Serving workload: each request touches its tenant's shared prefix
    blocks (ids stable per tenant) then some per-request suffix blocks
    (unique).  Emits the block-id access stream seen by the prefix cache.
    ``block_reuse_alpha`` is accepted, as the reference accepts it, and
    unused, as there."""
    rng = np.random.default_rng(seed)
    tprobs = zipf_probs(n_tenants, tenant_alpha)
    tenant_prefix_len = rng.poisson(prefix_blocks_mean, n_tenants) + 4
    # globally unique block id ranges per tenant
    prefix_base = np.concatenate([[0], np.cumsum(tenant_prefix_len)])[:-1]
    next_suffix = int(prefix_base[-1] + tenant_prefix_len[-1])
    chunks = []
    tenants = _sample_from_probs(tprobs, n_requests, rng)
    for t in tenants:
        plen = tenant_prefix_len[t]
        chunks.append(prefix_base[t] + np.arange(plen))
        slen = rng.poisson(suffix_blocks_mean) + 1
        chunks.append(np.arange(next_suffix, next_suffix + slen))
        next_suffix += slen
    return np.concatenate(chunks).astype(np.int64)

"""Trace generators of the benchmark: a frozen copy of the port's synthetic
traces (NumPy only), key for key.  The yardstick keeps its own copy so that
a later change to the program's generators cannot move the benchmark's
inputs; ``tinylfu_bench/tests/test_bench_generators.py`` pins a digest of
each generator's output."""
from __future__ import annotations

import numpy as np


def zipf_probs(n_items: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    return w / w.sum()


def _cdf(probs: np.ndarray) -> np.ndarray:
    cdf = np.cumsum(probs)
    cdf[-1] = 1.0
    return cdf


def _sample_from_cdf(cdf: np.ndarray, length: int,
                     rng: np.random.Generator) -> np.ndarray:
    u = rng.random(length)
    return np.searchsorted(cdf, u, side="right").astype(np.int64)


def _sample_from_probs(probs: np.ndarray, length: int,
                       rng: np.random.Generator) -> np.ndarray:
    return _sample_from_cdf(_cdf(probs), length, rng)


def zipf_trace(length: int, n_items: int = 1_000_000, alpha: float = 0.9,
               seed: int = 0) -> np.ndarray:
    """Static Zipf trace; ranks are shuffled into arbitrary key ids."""
    rng = np.random.default_rng(seed)
    ranks = _sample_from_probs(zipf_probs(n_items, alpha), length, rng)
    perm = rng.permutation(n_items).astype(np.int64)
    return perm[ranks]


def youtube_dynamic_trace(length: int, weeks: int = 21,
                          items_per_week: int = 8000, alpha: float = 0.9,
                          churn: float = 0.4, seed: int = 0) -> np.ndarray:
    """Weekly popularity snapshots (paper §5.2 [12]): every week, a fraction
    ``churn`` of the active set is replaced by brand-new videos and ranks are
    re-drawn; accesses within a week are i.i.d. from that week's Zipf."""
    rng = np.random.default_rng(seed)
    per_week = length // weeks
    probs = zipf_probs(items_per_week, alpha)
    active = np.arange(items_per_week, dtype=np.int64)
    next_id = items_per_week
    out = np.empty(weeks * per_week, dtype=np.int64)
    for w in range(weeks):
        if w > 0:
            n_new = int(items_per_week * churn)
            repl = rng.choice(items_per_week, size=n_new, replace=False)
            active = active.copy()
            active[repl] = np.arange(next_id, next_id + n_new)
            next_id += n_new
            rng.shuffle(active)          # fresh rank assignment each week
        idx = _sample_from_probs(probs, per_week, rng)
        out[w * per_week:(w + 1) * per_week] = active[idx]
    return out


def wiki_drift_trace(length: int, n_items: int = 400_000, alpha: float = 0.9,
                     drift_every: int = 20_000, drift_frac: float = 0.02,
                     seed: int = 0) -> np.ndarray:
    """Gradually changing Zipf (paper's Wikipedia trace behaviour): every
    ``drift_every`` accesses, ``drift_frac`` of items swap ranks."""
    rng = np.random.default_rng(seed)
    probs = zipf_probs(n_items, alpha)
    perm = rng.permutation(n_items).astype(np.int64)
    out = np.empty(length, dtype=np.int64)
    pos = 0
    n_swap = max(2, int(n_items * drift_frac))
    while pos < length:
        chunk = min(drift_every, length - pos)
        idx = _sample_from_probs(probs, chunk, rng)
        out[pos:pos + chunk] = perm[idx]
        pos += chunk
        a = rng.choice(n_items, size=n_swap, replace=False)
        b = rng.choice(n_items, size=n_swap, replace=False)
        perm[a], perm[b] = perm[b].copy(), perm[a].copy()
    return out


def spc1_like_trace(length: int, n_random: int = 200_000, alpha: float = 1.0,
                    scan_frac: float = 0.55, mean_scan: int = 400,
                    scan_space: int = 4_000_000, seed: int = 0) -> np.ndarray:
    """SPC1-like [44]: interleave long ascending sequential scans over a huge
    address space (cache-polluting, never re-used) with zipf random I/O over a
    hot region.  Scan keys are offset above the random region."""
    rng = np.random.default_rng(seed)
    cdf = _cdf(zipf_probs(n_random, alpha))     # built once, not per burst
    out = np.empty(length, dtype=np.int64)
    pos = 0
    scan_ptr = 0
    while pos < length:
        if rng.random() < scan_frac:
            slen = min(int(rng.exponential(mean_scan)) + 16, length - pos)
            start = scan_ptr
            scan_ptr = (scan_ptr + slen) % scan_space
            seq = (np.arange(start, start + slen) % scan_space) + n_random
            out[pos:pos + slen] = seq
            pos += slen
        else:
            rlen = min(int(rng.exponential(mean_scan * 0.6)) + 8, length - pos)
            out[pos:pos + rlen] = _sample_from_cdf(cdf, rlen, rng)
            pos += rlen
    return out


def oltp_like_trace(length: int, n_pages: int = 100_000, alpha: float = 0.8,
                    log_frac: float = 0.6, burst: int = 4,
                    seed: int = 0) -> np.ndarray:
    """OLTP-like [44] (§5.1): "ascending lists of sequential block accesses
    sprinkled with a few random accesses" — a transaction log appends to
    ever-increasing block ids (each touched a handful of times in a short
    burst, then never again = the paper's 'sparse bursts'), plus zipf reads
    over the database pages."""
    rng = np.random.default_rng(seed)
    cdf = _cdf(zipf_probs(n_pages, alpha))     # built once, not per burst
    out = np.empty(length, dtype=np.int64)
    pos = 0
    log_ptr = 0
    while pos < length:
        if rng.random() < log_frac:
            # short ascending burst re-touching the current tail of the log
            blen = min(int(rng.integers(2, burst * 2)), length - pos)
            base = log_ptr
            log_ptr += max(1, blen // burst)
            seq = base + (np.arange(blen) % burst)
            out[pos:pos + blen] = seq + n_pages
            pos += blen
        else:
            rlen = min(int(rng.integers(1, 8)), length - pos)
            out[pos:pos + rlen] = _sample_from_cdf(cdf, rlen, rng)
            pos += rlen
    return out


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


def phase_shift_trace(length: int, n_hot: int = 2000, alpha: float = 0.9,
                      working_set: int = 1200, advance: float = 0.25,
                      seed: int = 0) -> np.ndarray:
    """A stationary Zipf first half, then a pure recency pattern: keys drawn
    uniformly from a ``working_set`` that slides forward by ``advance`` keys
    per access over fresh ids, so only a large window hits there (a static
    window loses one half or the other; the adaptive window's golden)."""
    rng = np.random.default_rng(seed)
    h1 = length // 2
    first = _sample_from_probs(zipf_probs(n_hot, alpha), h1, rng)
    base = n_hot + (np.arange(length - h1) * advance).astype(np.int64)
    second = base + rng.integers(0, working_set, size=length - h1)
    return np.concatenate([first, second.astype(np.int64)])


def glimpse_trace(length: int, loop_items: int = 5000, n_random: int = 50_000,
                  alpha: float = 0.9, loop_frac: float = 0.65,
                  seed: int = 0) -> np.ndarray:
    """Glimpse: a loop over more items than the cache holds (LRU's
    pathological case) mixed with Zipf accesses."""
    rng = np.random.default_rng(seed)
    probs = zipf_probs(n_random, alpha)
    out = np.empty(length, dtype=np.int64)
    pos = 0
    lp = 0
    while pos < length:
        if rng.random() < loop_frac:
            slen = min(int(rng.integers(200, 2000)), length - pos)
            seq = (lp + np.arange(slen)) % loop_items
            lp = (lp + slen) % loop_items
            out[pos:pos + slen] = seq + n_random
            pos += slen
        else:
            rlen = min(int(rng.integers(50, 500)), length - pos)
            out[pos:pos + rlen] = _sample_from_probs(probs, rlen, rng)
            pos += rlen
    return out


def panel_traces(length: int = 60_000, seed: int = 0) -> dict:
    """The policy panel's trace families, each separating the policies
    along one axis: ``"zipf"`` (stationary skew), ``"scan-hot"`` (a
    one-pass scan, then a Zipf hotspot), ``"churn"`` (a hot set diluted by
    one-hit wonders) and ``"loop"`` (a cyclic scan slightly larger than the
    cache, plus noise).  Returns ``{name: (length,) int64 trace}``."""
    half = length // 2
    scan = np.arange(1 << 20, (1 << 20) + half, dtype=np.int64)
    hot = _sample_from_probs(zipf_probs(2_000, 1.0), length - half,
                             np.random.default_rng(seed + 1))
    return {
        "zipf": zipf_trace(length, n_items=length, alpha=0.9, seed=seed),
        "scan-hot": np.concatenate([scan, hot]),
        "churn": fickle_churn_trace(length, seed=seed),
        "loop": glimpse_trace(length, seed=seed),
    }


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

"""Deterministic, resumable data pipeline with a W-TinyLFU host shard cache.

Counterpart of ``repro/data/pipeline.py``, host-side numpy as the
reference is, over the port's host ``core.wtinylfu.WTinyLFU``: the same
decisions, so the same batches and cache statistics bit for bit.  The
paper's admission at the data layer: tokenized shards live on slow
storage and hosts keep a bounded in-RAM cache of decoded shards; shard
popularity is skewed (sequence-packing curricula, multi-epoch sampling),
so the cache keeps what W-TinyLFU admits.

Determinism and fault tolerance: the sample stream is a pure function of
(seed, step, host_id), so a restarted job replays the same batches from
any step; ``state_dict`` / ``load_state_dict`` carry the cursor through
checkpoints (``train/driver.py`` saves it beside the model).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.wtinylfu import WTinyLFU


@dataclass
class ShardSpec:
    n_shards: int
    tokens_per_shard: int
    vocab_size: int
    seed: int = 0


class SyntheticShardStore:
    """Stand-in for remote blob storage: shard i is generated from the seed
    (a zipf-ish token stream).  ``fetches`` counts cold reads, the metric
    the cache exists to lower."""

    def __init__(self, spec: ShardSpec):
        self.spec = spec
        self.fetches = 0

    def fetch(self, shard_id: int) -> np.ndarray:
        self.fetches += 1
        rng = np.random.default_rng((self.spec.seed << 20) ^ shard_id)
        # squared uniform concentrates the mass on low token ids
        u = rng.random(self.spec.tokens_per_shard)
        toks = (u * u * self.spec.vocab_size).astype(np.int32)
        return np.minimum(toks, self.spec.vocab_size - 1)


class CachedShardReader:
    """A W-TinyLFU-guarded shard cache in host RAM."""

    def __init__(self, store: SyntheticShardStore, capacity_shards: int = 16,
                 seed: int = 0):
        self.store = store
        self.cache_policy = WTinyLFU(capacity_shards, sample_factor=8,
                                     seed=seed)
        self.payloads: dict[int, np.ndarray] = {}
        self.hits = 0
        self.misses = 0

    def read(self, shard_id: int) -> np.ndarray:
        hit = self.cache_policy.access(shard_id)
        if hit and shard_id in self.payloads:
            self.hits += 1
            return self.payloads[shard_id]
        self.misses += 1
        data = self.store.fetch(shard_id)
        if shard_id in self.cache_policy:
            self.payloads[shard_id] = data
            # drop the payloads of keys the policy evicted
            policy = self.cache_policy
            live = set(self.payloads) & (set(policy.window)
                                         | set(policy.main.probation)
                                         | set(policy.main.protected))
            for k in list(self.payloads):
                if k not in live:
                    del self.payloads[k]
        return data


class TokenPipeline:
    """Packs fixed-length sequences from shards, sampled with zipf-skewed
    shard weights (curriculum and dedup reweighting in real corpora)."""

    def __init__(self, reader: CachedShardReader, *, seq_len: int,
                 global_batch: int, host_id: int = 0, n_hosts: int = 1,
                 shard_alpha: float = 1.0, seed: int = 0):
        self.reader = reader
        self.seq_len = seq_len
        self.batch = global_batch // n_hosts
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.seed = seed
        self.step = 0
        n = reader.store.spec.n_shards
        w = np.arange(1, n + 1, dtype=np.float64) ** (-shard_alpha)
        self._probs = w / w.sum()

    def _rng(self, step: int) -> np.random.Generator:
        h = hashlib.sha256(
            f"{self.seed}:{step}:{self.host_id}".encode()).digest()
        return np.random.default_rng(int.from_bytes(h[:8], "little"))

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, st: dict) -> None:
        self.step = int(st["step"])

    def next_batch(self) -> dict:
        rng = self._rng(self.step)
        spec = self.reader.store.spec
        toks = np.empty((self.batch, self.seq_len), np.int32)
        cdf = np.cumsum(self._probs)
        for b in range(self.batch):
            sid = int(np.searchsorted(cdf, rng.random()))
            shard = self.reader.read(sid)
            off = int(rng.integers(0, spec.tokens_per_shard - self.seq_len))
            toks[b] = shard[off:off + self.seq_len]
        self.step += 1
        return {"tokens": toks}

    @property
    def cache_stats(self) -> dict:
        r = self.reader
        n = r.hits + r.misses
        return {"shard_cache_hit_ratio": r.hits / n if n else 0.0,
                "cold_fetches": r.store.fetches}

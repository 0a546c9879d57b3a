"""Continuous-batching serving engine with TinyLFU-guarded prefix caching.

Counterpart of ``repro/serve/engine.py`` for the attention families, with
the reference's schedule kept exactly: a request takes ``free_slots.pop()``
and leaves the queue by ``pop(0)``; per request, the prompt's block hashes
are looked up in the ``PrefixCache``, the cached KV blocks are gathered
from the ``PayloadPool`` into the request's batch slot, and ``extend`` runs
only the uncached suffix; every tick decodes all batch slots at once, with
greedy argmax (first index on ties); a finished request offers each of its
prompt's blocks the cache does not hold, storing the payload in the pool
before the cache decides (so once the pool is full nothing more is
offered, as in the reference, whose pool has as many slots as its cache).

The pool lives on the model's device (the card unless ``"cpu"``), and so
does the admission sketch with ``device_sketch=True``; by default admission
runs on the host sketch (seeded by ``seed``), as in the reference.
``extend`` writes into the slot of the engine's KV cache in place, where
the reference copies the slot out and back.  SSM families raise in
``Model`` (ROADMAP queue 1 item 14); ``snapshot_every`` (blocks per SSM
prefix snapshot) is taken as in the reference and has no effect on the
dense family.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.models.api import Model
from .extend import extend
from .prefix_cache import PayloadPool, PrefixCache, block_hashes


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    out_tokens: list = field(default_factory=list)
    slot: int = -1
    prefix_blocks_reused: int = 0
    done: bool = False


class ServeEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 4,
                 max_len: int = 256, block_size: int = 16,
                 pool_slots: int = 64, prefix_policy: str = "wtinylfu",
                 sample_factor: int = 8, device_sketch: bool = False,
                 snapshot_every: int = 2, seed: int = 0):
        self.model = model
        self.params = params
        self.cfg = cfg = model.cfg
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_size = block_size
        # blocks per SSM prefix snapshot, as in the reference; the dense
        # family never reads it
        self.snapshot_every = snapshot_every
        self.cache = model.init_cache(max_batch, max_len)
        self.prefix_cache = PrefixCache(pool_slots, policy=prefix_policy,
                                        sample_factor=sample_factor,
                                        device_sketch=device_sketch,
                                        seed=seed, device=self.device)
        shp = (cfg.n_layers, block_size, cfg.n_kv_heads, cfg.hd)
        template = {"k": torch.empty(shp, dtype=torch.bfloat16,
                                     device="meta"),
                    "v": torch.empty(shp, dtype=torch.bfloat16,
                                     device="meta")}
        self.pool = PayloadPool(template, pool_slots, device=self.device)
        self.free_slots = list(range(max_batch))
        self.active: dict[int, Request] = {}
        self.queue: list[Request] = []
        self._next_rid = 0
        self.tokens_prefilled = 0
        self.tokens_reused = 0

    def _offer(self, h: int, payload) -> None:
        """Store the payload, then run the admission pipeline."""
        slot = self.pool.store(payload)
        if slot is None:
            return
        for freed in self.prefix_cache.insert(h, slot):
            self.pool.free(freed)

    # ----------------------------------------------------------------- prefill
    def _start(self, req: Request) -> None:
        b = self.free_slots.pop()
        req.slot = b
        self.active[req.rid] = req
        bs = self.block_size
        slots = self.prefix_cache.lookup(block_hashes(req.prompt, bs))
        n_reuse = len(slots)
        start = n_reuse * bs
        if n_reuse:
            payload = self.pool.load_many(slots)     # leaves (n,L,blk,H,D)
            for name in ("k", "v"):
                dst = self.cache[name][:, b, :start].unflatten(1,
                                                               (n_reuse, bs))
                dst.copy_(payload[name].transpose(0, 1))
        req.prefix_blocks_reused = n_reuse
        self.tokens_reused += start
        suffix = req.prompt[start:]
        self.tokens_prefilled += len(suffix)
        sub = {name: self.cache[name][:, b:b + 1] for name in ("k", "v")}
        sub["pos"] = self.cache["pos"][b:b + 1]
        toks = torch.tensor([suffix], dtype=torch.long, device=self.device)
        _, last_h = extend(self.model, self.params, toks, sub, start)
        logits = self.model.lm_head(self.params, last_h)
        self._emit(req, int(logits[0, 0].argmax()))

    # ------------------------------------------------------------------ decode
    def _emit(self, req: Request, tok: int) -> None:
        req.out_tokens.append(tok)
        if len(req.out_tokens) >= req.max_new_tokens:
            req.done = True

    def _decode_tick(self) -> None:
        toks = [0] * self.max_batch
        for req in self.active.values():
            toks[req.slot] = req.out_tokens[-1]
        t = torch.tensor(toks, dtype=torch.long,
                         device=self.device)[:, None]
        logits, self.cache = self.model.decode(self.params, t, self.cache)
        best = logits[:, 0].argmax(-1).tolist()     # one read per tick
        for req in self.active.values():
            if not req.done:
                self._emit(req, best[req.slot])

    # ------------------------------------------------------------------ finish
    def _finish(self, req: Request) -> None:
        b = req.slot
        bs = self.block_size
        for i, h in enumerate(block_hashes(req.prompt, bs)):
            if h in self.prefix_cache:
                continue
            s0 = i * bs
            self._offer(h, {name: self.cache[name][:, b, s0:s0 + bs]
                            for name in ("k", "v")})
        self.free_slots.append(b)
        self.cache["pos"][b] = 0

    # ------------------------------------------------------------------ driver
    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, list(map(int, prompt)),
                                  max_new_tokens))
        return rid

    def run(self) -> dict[int, list]:
        results = {}
        while self.queue or self.active:
            while self.queue and self.free_slots:
                self._start(self.queue.pop(0))
            if self.active:
                self._decode_tick()
                for rid in [r for r, q in self.active.items() if q.done]:
                    req = self.active.pop(rid)
                    self._finish(req)
                    results[rid] = req.out_tokens
        return results

    @property
    def stats(self) -> dict:
        pc = self.prefix_cache.stats
        return {
            "prefix_hit_ratio": pc.hit_ratio,
            "block_hits": pc.block_hits,
            "block_misses": pc.block_misses,
            "admitted": pc.admitted,
            "rejected": pc.rejected,
            "tokens_prefilled": self.tokens_prefilled,
            "tokens_reused": self.tokens_reused,
            "reuse_frac": self.tokens_reused /
                max(1, self.tokens_reused + self.tokens_prefilled),
            "pool_used": self.pool.used,
        }

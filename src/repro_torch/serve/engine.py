"""Continuous-batching serving engine with TinyLFU-guarded prefix caching.

Counterpart of ``repro/serve/engine.py``, with the reference's schedule
kept exactly: a request takes ``free_slots.pop()`` and leaves the queue by
``pop(0)``; every tick decodes all batch slots at once, with greedy
argmax (first index on ties; per codebook for audio, whose prompt and
fed-back tokens are repeated over the codebooks).

* Attention families (dense, moe, vlm, audio): the prompt's block hashes
  are looked up in the ``PrefixCache``, the cached KV blocks gathered from
  the ``PayloadPool`` into the request's batch slot, and ``extend`` runs
  only the uncached suffix; a finished request offers each of its
  prompt's blocks the cache does not hold.
* SSM families (hybrid_ssm, xlstm): the payload is a state snapshot of one
  slot (zamba: the Mamba2 states and the shared attention's KV; xLSTM:
  the mLSTM and sLSTM states).  ``lookup_snapshots`` finds the deepest
  cached snapshot (snapshots exist every ``snapshot_every`` blocks); it is
  copied into the slot and the rest of the prompt is prefilled in
  segments of ``snapshot_every * block_size`` tokens, each boundary's
  snapshot not yet cached offered as it is reached.  As in the reference,
  a finished request's slot keeps its states (only ``pos`` is reset), so
  a request that finds no snapshot continues the states its slot's last
  request left (a reference caveat the port reproduces).

An offer stores the payload in the pool before the cache decides (so once
the pool is full nothing more is offered, as in the reference, whose pool
has as many slots as its cache).  The pool lives on the model's device
(the card unless ``"cpu"``), and so does the admission sketch with
``device_sketch=True``; by default admission runs on the host sketch
(seeded by ``seed``), as in the reference.  ``extend`` writes into the
slot of the engine's cache in place, where the reference copies the slot
out and back; a restored snapshot is a copy (``PayloadPool.load``
clones), so nothing written into the slot reaches the pool.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.models.api import Model
from .extend import extend
from .prefix_cache import PayloadPool, PrefixCache, _tree_map, block_hashes


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    out_tokens: list = field(default_factory=list)
    slot: int = -1
    prefix_blocks_reused: int = 0
    done: bool = False


def _is_attn_family(cfg) -> bool:
    return cfg.family in ("dense", "moe", "vlm", "audio")


def _batch_axis(name: str, cfg) -> int:
    """The batch axis of a cache leaf (the stack axes come first)."""
    return 2 if cfg.family == "xlstm" and name == "mlstm" else 1


class ServeEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 4,
                 max_len: int = 256, block_size: int = 16,
                 pool_slots: int = 64, prefix_policy: str = "wtinylfu",
                 sample_factor: int = 8, device_sketch: bool = False,
                 snapshot_every: int = 2, seed: int = 0):
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_size = block_size
        self.snapshot_every = snapshot_every          # blocks per snapshot
        self.cache = model.init_cache(max_batch, max_len)
        self.prefix_cache = PrefixCache(pool_slots, policy=prefix_policy,
                                        sample_factor=sample_factor,
                                        device_sketch=device_sketch,
                                        seed=seed, device=self.device)
        self.pool = PayloadPool(self._payload_template(), pool_slots,
                                device=self.device)
        self.free_slots = list(range(max_batch))
        self.active: dict[int, Request] = {}
        self.queue: list[Request] = []
        self._next_rid = 0
        self.tokens_prefilled = 0
        self.tokens_reused = 0

    # ----------------------------------------------------------------- payload
    def _payload_template(self):
        """The pool's leaves (shapes and dtypes only): a block's KV for the
        attention families, one slot's state snapshot of
        ``init_cache(1, max_len)`` for the SSM families."""
        cfg = self.cfg
        if _is_attn_family(cfg):
            shp = (cfg.n_layers, self.block_size, cfg.n_kv_heads, cfg.hd)
            return {name: torch.empty(shp, dtype=torch.bfloat16,
                                      device="meta") for name in ("k", "v")}
        one = self.model.init_cache(1, self.max_len, device="meta")
        return self._state_snapshot_of(one, 0)

    def _slot_views(self, cache: dict, b: int, keep: bool) -> dict:
        """Views of batch slot b of every state leaf of ``cache`` (not
        ``pos``): the batch axis kept (b:b+1) or dropped."""
        def view(name, a):
            idx = [slice(None)] * _batch_axis(name, self.cfg)
            return a[tuple(idx + [slice(b, b + 1) if keep else b])]
        return {name: ({k: view(name, a) for k, a in leaf.items()}
                       if isinstance(leaf, dict) else view(name, leaf))
                for name, leaf in cache.items() if name != "pos"}

    def _state_snapshot_of(self, cache: dict, b: int) -> dict:
        """State snapshot payload for batch slot b (SSM families): views
        of the slot, which the pool copies when it stores them."""
        if _is_attn_family(self.cfg):
            raise ValueError(self.cfg.family)
        return self._slot_views(cache, b, keep=False)

    def _restore_snapshot(self, b: int, state: dict) -> None:
        _tree_map(lambda dst, src: dst.copy_(src),
                  self._slot_views(self.cache, b, keep=False), state)

    def _offer(self, h: int, payload) -> None:
        """Store the payload, then run the admission pipeline."""
        slot = self.pool.store(payload)
        if slot is None:
            return
        for freed in self.prefix_cache.insert(h, slot):
            self.pool.free(freed)

    def _tokens_arr(self, toks: list) -> torch.Tensor:
        """(1, S) token ids on the device, repeated over the codebooks
        (1, S, K) for audio."""
        t = torch.tensor([toks], dtype=torch.long, device=self.device)
        return self._codebooks(t)

    def _codebooks(self, t: torch.Tensor) -> torch.Tensor:
        K = self.cfg.n_codebooks
        return t[..., None].expand(*t.shape, K) if K else t

    def _extend_slot(self, b: int, toks: list, start: int) -> torch.Tensor:
        """``extend`` on views of slot b (written in place; a leaf the call
        replaced is copied back, cast as the reference's write-back casts);
        returns the last-token hidden state."""
        views = self._slot_views(self.cache, b, keep=True)
        sub = dict(views, pos=self.cache["pos"][b:b + 1])
        sub, last_h = extend(self.model, self.params, self._tokens_arr(toks),
                             sub, start)
        _tree_map(lambda dst, src: dst is src or dst.copy_(src), views,
                  {name: sub[name] for name in views})
        return last_h

    # ----------------------------------------------------------------- prefill
    def _start(self, req: Request) -> None:
        b = self.free_slots.pop()
        req.slot = b
        self.active[req.rid] = req
        bs = self.block_size
        prompt = req.prompt
        hashes = block_hashes(prompt, bs)
        if _is_attn_family(self.cfg):
            slots = self.prefix_cache.lookup(hashes)
            n_reuse = len(slots)
            start = n_reuse * bs
            if n_reuse:
                payload = self.pool.load_many(slots)  # leaves (n,L,blk,H,D)
                for name in ("k", "v"):
                    dst = self.cache[name][:, b, :start].unflatten(
                        1, (n_reuse, bs))
                    dst.copy_(payload[name].transpose(0, 1))
            req.prefix_blocks_reused = n_reuse
            self.tokens_reused += start
            self.tokens_prefilled += len(prompt) - start
            last_h = self._extend_slot(b, prompt[start:], start)
        else:
            # SSM: restore the deepest cached snapshot, prefill the rest in
            # segments, offering each boundary's snapshot
            snap = self.snapshot_every
            n_reuse, snap_slot = self.prefix_cache.lookup_snapshots(hashes,
                                                                    snap)
            start = n_reuse * bs
            if snap_slot is not None:
                self._restore_snapshot(b, self.pool.load(snap_slot))
            req.prefix_blocks_reused = n_reuse
            self.tokens_reused += start
            self.tokens_prefilled += len(prompt) - start
            seg = snap * bs
            pos, last_h = start, None
            while pos < len(prompt):
                nxt = min(pos + seg, len(prompt))
                last_h = self._extend_slot(b, prompt[pos:nxt], pos)
                pos = nxt
                n_blocks = pos // bs
                if pos % seg == 0 and pos % bs == 0:
                    h = hashes[n_blocks - 1] if n_blocks - 1 < len(hashes) \
                        else None
                    if h is not None and h not in self.prefix_cache:
                        self._offer(h, self._state_snapshot_of(self.cache, b))
        logits = self.model.lm_head(self.params, last_h)
        self._emit(req, logits[0, 0].argmax(-1).tolist())

    # ------------------------------------------------------------------ decode
    def _emit(self, req: Request, tok) -> None:
        """Append a greedy token (a list of one per codebook for audio)."""
        req.out_tokens.append(tok)
        if len(req.out_tokens) >= req.max_new_tokens:
            req.done = True

    def _decode_tick(self) -> None:
        toks = [0] * self.max_batch
        for req in self.active.values():
            last = req.out_tokens[-1]
            toks[req.slot] = last[0] if isinstance(last, list) else last
        t = torch.tensor(toks, dtype=torch.long,
                         device=self.device)[:, None]
        logits, self.cache = self.model.decode(self.params,
                                               self._codebooks(t),
                                               self.cache)
        best = logits[:, 0].argmax(-1).tolist()     # one read per tick
        for req in self.active.values():
            if not req.done:
                self._emit(req, best[req.slot])

    # ------------------------------------------------------------------ finish
    def _finish(self, req: Request) -> None:
        b = req.slot
        bs = self.block_size
        if _is_attn_family(self.cfg):
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

"""Device-resident W-TinyLFU trace simulation engine on PyTorch/CUDA.

Counterpart of ``repro/core/device_simulate.py``: ``simulate_trace`` and
``DeviceWTinyLFU.run`` push a whole trace through the fused per-access step
(``kernels/sketch_step.py``), one kernel launch per chunk, with the state
updated in place on the card between launches and no host sync per chunk.

Sizing mirrors the reference exactly (window 1%, SLRU 80/20, W =
sample_factor*C, cap = W/C with the doorkeeper absorbing one count), so the
port's state and hit counts equal the JAX engine's bit for bit.

This slice runs ``policy="wtinylfu"`` with a static window and an unsharded
sketch, in both table layouts, for one stream or ``streams=B`` tenant lanes
(one launch per chunk for all lanes), and ``simulate_sweep``'s grids of such
configurations, either one run per configuration or as lanes of one run.
Entry points run on the card unless the caller passes ``device="cpu"`` (the
plain version); without a card they raise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.kernels import sketch_step as ks
from repro_torch.kernels.sketch_step import (
    StepSpec, make_step_params, init_step_state, precompute_probes, step,
    resolve_device, R_HITS)
from repro_torch.kernels.sketch_common import keys_to_lanes, POLICIES
from .hashing import assoc_geometry, slots_for, _pow2ceil
from .simulate import SimResult


def _window_cap_max(capacity: int, window_cap: int,
                    window_max_frac: float) -> int:
    """Largest window quota the adaptive tables are sized for (copy of
    ``repro.core.adaptive.window_cap_max``)."""
    return max(window_cap,
               min(capacity - 1, int(round(capacity * window_max_frac))))


@dataclass(frozen=True)
class DeviceWTinyLFU:
    """One simulated W-TinyLFU configuration (host-side description).

    Same fields, sizing and eager validation as the reference class.
    ``assoc=None`` uses the exact flat tables, ``assoc=W`` the W-way
    set-associative tables; ``streams=B`` batches B tenant lanes.
    ``adaptive``, ``shards > 1``, ``mesh``, ``integrity`` and ``policy !=
    "wtinylfu"`` are accepted for sizing and refused by :meth:`run` until
    the port carries them.
    """
    capacity: int
    window_frac: float = 0.01
    sample_factor: int = 8
    protected_frac: float = 0.8
    counters_per_item: float = 1.0
    rows: int = 4
    doorkeeper: bool = True
    dk_bits_per_item: float = 4.0
    assoc: int | None = None
    counter_bits: int = 4
    adaptive: bool = False
    window_max_frac: float = 0.5
    shards: int = 1
    merge_every: int = 0
    mesh: object = None
    mesh_exchange: str = "chunk"
    integrity: bool = False
    streams: int = 1
    policy: str = "wtinylfu"

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"capacity {self.capacity} must be >= 1")
        if not 0.0 < self.window_frac < 1.0:
            raise ValueError(f"window_frac {self.window_frac} must be in "
                             "(0, 1) — it is the window's share of capacity")
        if not 0.0 < self.protected_frac < 1.0:
            raise ValueError(f"protected_frac {self.protected_frac} must be "
                             "in (0, 1)")
        if self.sample_factor < 1:
            raise ValueError(f"sample_factor {self.sample_factor} must be "
                             ">= 1 (W = sample_factor * capacity)")
        if self.counter_bits not in (4, 8):
            raise ValueError(f"counter_bits {self.counter_bits} must be 4 "
                             "(paper §3.4.1 nibbles) or 8 (byte counters)")
        if self.rows < 1:
            raise ValueError(f"rows {self.rows} must be >= 1")
        if self.assoc is not None and self.assoc < 1:
            raise ValueError(f"assoc {self.assoc} must be >= 1 ways (or "
                             "None for the flat exact tables)")
        if self.shards < 1 or (self.shards & (self.shards - 1)):
            raise ValueError(f"shards {self.shards} must be a power of two "
                             "(shard membership is a masked hash)")
        if self.merge_every < 0:
            raise ValueError(f"merge_every {self.merge_every} must be >= 0 "
                             "(0 = auto min(4096, sample_size))")
        if self.mesh_exchange not in ("chunk", "stale"):
            raise ValueError(f"mesh_exchange {self.mesh_exchange!r} must be "
                             "'chunk' or 'stale'")
        if self.integrity and self.shards <= 1:
            raise ValueError("integrity=True requires shards > 1: the "
                             "checksums cover the per-shard global sketch "
                             "halves, which only exist in sharded mode")
        if self.streams < 1:
            raise ValueError(f"streams {self.streams} must be >= 1 (the "
                             "number of lane-batched tenant caches; 1 = "
                             "the unbatched single-stream engine)")
        if self.streams > 1 and self.mesh is not None:
            raise ValueError(
                f"streams {self.streams} cannot combine with mesh=: lanes "
                "batch WHOLE per-tenant engines while the mesh partitions "
                "ONE engine's sketch across devices — shard tenants over "
                "meshes at the process level instead")
        if self.policy not in POLICIES:
            raise ValueError(f"policy {self.policy!r} must be one of "
                             f"{POLICIES}")
        if self.policy != "wtinylfu":
            if self.assoc is None:
                raise ValueError(
                    f"policy {self.policy!r} requires assoc= (the "
                    "competitor panel reuses the set-associative table "
                    "machinery; the flat exact tables are W-TinyLFU-only)")
            if self.shards > 1 or self.mesh is not None:
                raise ValueError(
                    f"policy {self.policy!r} cannot combine with shards/"
                    "mesh: the sharded sketch split serves the TinyLFU "
                    "admission filter — competitors run single-sketch")
            if self.adaptive:
                raise ValueError(
                    f"policy {self.policy!r} cannot combine with "
                    "adaptive=True: the hill-climbed quota rebalances the "
                    "W-TinyLFU window/main split (arc adapts its own "
                    "target p as runtime state instead)")
            if self.integrity:
                raise ValueError(
                    f"policy {self.policy!r} cannot combine with "
                    "integrity=True (it requires shards > 1)")
        if self.policy == "arc" and not self.doorkeeper:
            raise ValueError(
                "policy 'arc' requires doorkeeper=True: the B1/B2 ghost "
                "lists are Bloom halves addressed by the doorkeeper probe "
                "schedule, so dk_bits must be sized (> 0)")

    @property
    def window_cap(self) -> int:
        if self.policy in ("arc", "lfu"):
            return 1
        return max(1, int(round(self.capacity * self.window_frac)))

    @property
    def main_cap(self) -> int:
        if self.policy in ("arc", "lfu"):
            return max(1, self.capacity)
        return max(1, self.capacity - self.window_cap)

    @property
    def window_cap_max(self) -> int:
        """Largest quota the adaptive tables can host (static headroom)."""
        if not self.adaptive:
            return self.window_cap
        return _window_cap_max(self.capacity, self.window_cap,
                               self.window_max_frac)

    @property
    def main_cap_max(self) -> int:
        """Largest main capacity (window quota at its minimum of 1)."""
        return max(1, self.capacity - 1)

    @property
    def prot_cap(self) -> int:
        return max(1, int(self.main_cap * self.protected_frac))

    @property
    def sample_size(self) -> int:
        return self.sample_factor * self.capacity

    @property
    def cap(self) -> int:
        cmax = (1 << self.counter_bits) - 1
        return min(cmax, max(1, self.sample_factor
                             - (1 if self.doorkeeper else 0)))

    @property
    def width(self) -> int:
        w = _pow2ceil(int(max(1.0, self.counters_per_item * self.sample_size
                              / self.rows)))
        return max(8 * self.shards, w)

    @property
    def dk_bits(self) -> int:
        if not self.doorkeeper:
            return 0
        return max(32 * self.shards, _pow2ceil(int(self.sample_size
                                                   * self.dk_bits_per_item)))

    @property
    def merge_epoch(self) -> int:
        """Resolved sharded merge cadence (0 = auto min(4096, W))."""
        return self.merge_every or max(1, min(4096, self.sample_size))

    @property
    def ways(self) -> int | None:
        """Static gather width in set mode, from the main table's geometry
        (the window shares it so both tables use one block shape)."""
        if self.assoc is None:
            return None
        return assoc_geometry(self.main_cap_max if self.adaptive
                              else self.main_cap, self.assoc)[1]

    def _table_slots(self, cap: int, ways: int | None = None) -> int:
        if self.assoc is None:
            return cap
        return slots_for(cap, ways or self.ways)

    def spec(self, window_slots: int | None = None,
             main_slots: int | None = None,
             ways: int | None = None) -> StepSpec:
        """Static geometry; slots may be padded up for sweeps."""
        wsize = self.window_cap_max if self.adaptive else self.window_cap
        msize = self.main_cap_max if self.adaptive else self.main_cap
        return StepSpec(
            width=self.width, rows=self.rows, dk_bits=self.dk_bits,
            window_slots=window_slots or self._table_slots(wsize),
            main_slots=main_slots or self._table_slots(msize),
            assoc=(ways or self.ways) if self.assoc is not None else None,
            counter_bits=self.counter_bits, adaptive=self.adaptive,
            shards=self.shards, mesh_devices=self.mesh_devices,
            mesh_exchange=self.mesh_exchange if self.mesh is not None
            else "chunk", integrity=self.integrity, streams=self.streams,
            policy=self.policy)

    @property
    def mesh_devices(self) -> int:
        """Devices of the ``("shard",)`` mesh (0 = single-device layout)."""
        if self.mesh_exchange not in ("chunk", "stale"):
            raise ValueError(f"mesh_exchange {self.mesh_exchange!r} must be "
                             "'chunk' or 'stale'")
        if self.mesh is None:
            if self.mesh_exchange != "chunk":
                raise ValueError("mesh_exchange='stale' requires mesh= (a "
                                 "('shard',) mesh from "
                                 "distributed.mesh.make_shard_mesh)")
            return 0
        if tuple(self.mesh.axis_names) != ("shard",):
            raise ValueError(f"mesh axes {self.mesh.axis_names} != "
                             "('shard',) — build it with "
                             "distributed.mesh.make_shard_mesh")
        n = int(self.mesh.devices.size)
        if self.shards <= 1:
            raise ValueError("mesh execution requires shards > 1")
        if self.shards % n:
            raise ValueError(f"shards {self.shards} must be a multiple of "
                             f"the mesh size {n} (block placement)")
        return n

    def params(self, warmup: int = 0, device=None) -> torch.Tensor:
        """The params vector on ``device`` (the card unless ``"cpu"``)."""
        return make_step_params(self.window_cap, self.main_cap, self.prot_cap,
                                self.sample_size, self.cap, warmup,
                                counter_bits=self.counter_bits, device=device)

    def run(self, trace, *, warmup: int = 0, device=None, chunk: int = 512,
            trace_name: str = "?", climb=None, checkpoint_dir=None,
            checkpoint_every: int = 0, return_state: bool = False,
            on_checkpoint=None, fault_hook=None):
        """Simulate ``trace`` (``(B, T)`` with ``streams=B``) on ``device``
        (the card unless ``"cpu"``).  ``climb`` is ignored unless
        ``adaptive``, as in the reference.

        Checkpointing and fault injection (``checkpoint_dir``,
        ``checkpoint_every``, ``on_checkpoint``, ``fault_hook``) are not
        ported yet and raise.
        """
        if (checkpoint_dir is not None or fault_hook is not None
                or checkpoint_every or on_checkpoint is not None):
            raise NotImplementedError(
                "checkpoint/resume and fault injection are ROADMAP queue 1 "
                "item 11")
        return _simulate(self, trace, warmup=warmup, device=device,
                         chunk=chunk, trace_name=trace_name, climb=climb,
                         return_state=return_state)


def _trace_lanes(trace: np.ndarray, device) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    lo, hi = keys_to_lanes(np.asarray(trace).astype(np.uint64))
    return (torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device))


def _check_trace_streams(cfg: DeviceWTinyLFU, trace: np.ndarray):
    """Eager trace-shape vs ``streams`` validation."""
    trace = np.asarray(trace)
    if cfg.streams > 1:
        if trace.ndim != 2 or trace.shape[0] != cfg.streams:
            raise ValueError(
                f"streams {cfg.streams} expects a (B, T) = ({cfg.streams}, "
                f"T) trace — one key row per tenant lane; got trace shape "
                f"{tuple(trace.shape)}")
    elif trace.ndim != 1:
        raise ValueError(
            f"trace shape {tuple(trace.shape)} carries a lane axis but "
            "streams is 1 (the unbatched engine, bit-identical to a 1-D "
            f"run) — construct DeviceWTinyLFU(streams={trace.shape[0]}) "
            "to batch tenant lanes, or pass a 1-D trace")


def _policy_label(cfg: DeviceWTinyLFU, adaptive: bool) -> str:
    base = ("w-tinylfu(device)" if cfg.policy == "wtinylfu"
            else f"{cfg.policy}(device)")
    return base + ("+climb" if adaptive else "")


def _row_extra(cfg: DeviceWTinyLFU, climb, adaptive: bool) -> dict:
    """Config knobs of ``SimResult.extra``; knobs at their defaults stay
    absent, as in the reference."""
    extra = {}
    if cfg.policy != "wtinylfu":
        extra["policy"] = cfg.policy
    if cfg.mesh is not None:
        extra["mesh_devices"] = cfg.mesh_devices
        extra["mesh_exchange"] = cfg.mesh_exchange
    if cfg.shards > 1:
        extra["shards"] = cfg.shards
        extra["merge_every"] = (climb.epoch_len if adaptive and climb
                                else cfg.merge_epoch)
    if cfg.integrity:
        extra["integrity"] = True
    if cfg.streams > 1:
        extra["streams"] = cfg.streams
    return extra


def run_chunks(spec: StepSpec, params, state: dict, lo, hi, chunk: int,
               fn=step):
    """Chunked runner (counterpart of the reference's ``_run_pallas``): pad
    the access axis to whole chunks, hash every key once, then advance the
    state in place one chunk per ``fn`` call (``step``, or ``step_ref`` to
    drive the plain version) with the chunk's ``n_valid``; returns (state,
    the hit flags of the unpadded trace).  ``(B, T)`` lanes share the
    chunking: each call takes a ``(B, chunk)`` slice of every lane (laid
    out chunk-major, so each slice is contiguous).  ``step`` picks the
    kernel or the plain version by the tensors' device; on the card nothing
    here waits for it."""
    n = lo.shape[-1]
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be >= 1")
    pad = (-n) % chunk
    if pad:
        z = torch.zeros(lo.shape[:-1] + (pad,), dtype=lo.dtype,
                        device=lo.device)
        lo = torch.cat([lo, z], dim=-1)
        hi = torch.cat([hi, z], dim=-1)
    nc = lo.shape[-1] // chunk

    def chunk_major(x):             # (..., nc * chunk) -> (nc, ..., chunk)
        if x.dim() == 1:
            return x.reshape(nc, chunk)
        return x.reshape(x.shape[0], nc, chunk).transpose(0, 1).contiguous()

    lo, hi = chunk_major(lo), chunk_major(hi)
    probes = precompute_probes(spec, lo, hi)
    hits = []
    for c in range(nc):
        _, h = fn(spec, params, state, lo[c], hi[c], min(chunk, n - c * chunk),
                  tuple(p[c] for p in probes))
        hits.append(h)
    return state, torch.cat(hits, dim=-1)[..., :n]


def _simulate(cfg: DeviceWTinyLFU, trace, *, warmup: int, device, chunk: int,
              trace_name: str, climb, return_state: bool):
    del climb                       # ignored: the window is static
    ks._require_ported(cfg.spec())
    dev = resolve_device(device)
    trace = np.asarray(trace)
    _check_trace_streams(cfg, trace)
    spec = cfg.spec()
    params = cfg.params(warmup=warmup, device=dev)
    state = init_step_state(spec, cfg.window_cap, cfg.main_cap, device=dev)
    lo, hi = _trace_lanes(trace, dev)

    t0 = time.perf_counter()
    state, hits = run_chunks(spec, params, state, lo, hi, chunk)
    regs = state["regs"].cpu()                   # waits for the device
    wall = time.perf_counter() - t0

    # warmup applies per lane (each lane's own R_T register counts it)
    counted = (trace.shape[-1] - warmup) * cfg.streams
    extra = {"backend": "cuda" if dev.type == "cuda" else "plain",
             "window_frac": cfg.window_frac, "assoc": cfg.assoc,
             "device": _device_name(dev), **_row_extra(cfg, None, False)}
    if cfg.streams > 1:
        extra["lane_hits"] = [int(h) for h in regs[:, R_HITS]]
        n_hits = sum(extra["lane_hits"])
    else:
        n_hits = int(regs[R_HITS])
    res = SimResult(policy=_policy_label(cfg, False),
                    cache_size=cfg.capacity, trace=trace_name,
                    accesses=counted, hits=n_hits,
                    hit_ratio=n_hits / max(1, counted), wall_s=wall,
                    extra=extra)
    if return_state:
        return res, state, hits
    return res


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def simulate_trace(trace: np.ndarray, capacity: int, *,
                   window_frac: float = 0.01, sample_factor: int = 8,
                   warmup: int = 0, device=None, chunk: int = 512,
                   trace_name: str = "?", return_state: bool = False,
                   adaptive: bool = False, climb=None,
                   **cfg_kw) -> SimResult:
    """Device twin of ``simulate.run_trace(WTinyLFU(capacity), trace)``.

    Runs the hand-written CUDA kernel on the card, one launch per ``chunk``
    accesses; ``device="cpu"`` runs the plain version instead.  ``warmup``
    accesses update state but are not counted.  ``assoc=W`` (via cfg_kw)
    selects the W-way set-associative tables; ``counter_bits=8`` enables
    sample factors above 16.  With ``return_state`` the result comes with
    the final state dict and the per-access hit flags.
    """
    cfg = DeviceWTinyLFU(capacity, window_frac=window_frac,
                         sample_factor=sample_factor, adaptive=adaptive,
                         **cfg_kw)
    return _simulate(cfg, trace, warmup=warmup, device=device, chunk=chunk,
                     trace_name=trace_name, climb=climb,
                     return_state=return_state)


def simulate_sweep(trace: np.ndarray, capacities, *, window_fracs=(0.01,),
                   sample_factor: int = 8, warmup: int = 0,
                   trace_name: str = "?", verbose: bool = False,
                   mode: str = "auto", adaptive: bool = False, climb=None,
                   policies=("wtinylfu",), device=None, chunk: int = 512,
                   **cfg_kw) -> list[SimResult]:
    """Cartesian (capacity x window_frac) sweep (counterpart of the
    reference's ``simulate_sweep`` for static, unsharded, unmeshed,
    single-policy grids).

    ``mode="sequential"`` runs one configuration after another, each with
    its own tight geometry (sketch sized like the host's, bit-identical to
    its ``simulate_trace`` run).  ``mode="vmap"`` runs the whole grid as
    lanes of one run, one launch per chunk: every configuration takes the
    largest one's geometry (table slots padded up, excess slots marked as
    padding by a per-configuration ``init_step_state``) with its own params
    as a per-lane row.  ``"auto"`` picks ``"vmap"`` on the card, as the
    reference does on its accelerator, and ``"sequential"`` on the CPU.

    ``trace`` may be ``(N,)`` (shared by all configurations) or ``(G, N)``
    (one trace per grid point).  Rows carry the reference's schema
    (``grid``, ``grid_wall_s``, amortized ``wall_s``).  Adaptive, sharded,
    meshed and multi-policy grids are not ported yet and raise.
    """
    del climb                       # ignored: the window is static
    if adaptive:
        raise NotImplementedError(
            "adaptive sweeps (the hill-climbed window) are ROADMAP queue 1 "
            "item 7")
    policies = tuple(policies)
    if len(set(policies)) > 1:
        raise NotImplementedError(
            "policy grids (the policy panel) are ROADMAP queue 1 item 9")
    grid = [DeviceWTinyLFU(C, window_frac=wf, sample_factor=sample_factor,
                           policy=pol, **cfg_kw)
            for C in capacities for wf in window_fracs for pol in policies]
    gridlab = [(C, wf) for C in capacities for wf in window_fracs
               for pol in policies]
    if any(c.shards > 1 or c.integrity for c in grid):
        raise NotImplementedError(
            "sharded sweeps are ROADMAP queue 1 item 6")
    if any(c.mesh is not None for c in grid):
        raise NotImplementedError("mesh sweeps are ROADMAP queue 1 item 12")
    for c in grid:
        ks._require_ported(c.spec())
    dev = resolve_device(device)
    if mode == "auto":
        mode = "vmap" if dev.type == "cuda" else "sequential"
    if mode not in ("vmap", "sequential"):
        raise ValueError(f"unknown mode {mode!r}")

    trace = np.asarray(trace)
    shared_trace = trace.ndim == 1
    if not shared_trace and trace.shape[0] != len(grid):
        raise ValueError(f"trace grid dim {trace.shape[0]} != "
                         f"{len(grid)} configurations")
    n_per = trace.shape[-1]
    G = len(grid)

    t0 = time.perf_counter()
    if mode == "vmap":
        spec, states = _padded_grid(grid, dev)
        pstack = torch.stack([c.params(warmup=warmup, device=dev)
                              for c in grid])
        lo, hi = _trace_lanes(trace, dev)
        if shared_trace:
            lo, hi = lo.expand(G, n_per), hi.expand(G, n_per)
        if G > 1:
            spec = replace(spec, streams=G)
            state = {k: torch.stack([s[k] for s in states])
                     for k in states[0]}
        else:
            state, pstack, lo, hi = states[0], pstack[0], lo[0], hi[0]
        state, _ = run_chunks(spec, pstack, state, lo, hi, chunk)
        regs = state["regs"].reshape(G, -1).cpu()
    else:
        outs = []
        for gi, c in enumerate(grid):
            spec = c.spec()
            st = init_step_state(spec, c.window_cap, c.main_cap, device=dev)
            lo, hi = _trace_lanes(trace if shared_trace else trace[gi], dev)
            st, _ = run_chunks(spec, c.params(warmup=warmup, device=dev), st,
                               lo, hi, chunk)
            outs.append(st["regs"])
        regs = torch.stack(outs).cpu()
    wall = time.perf_counter() - t0

    counted = n_per - warmup
    backend = "cuda" if dev.type == "cuda" else "plain"
    out = []
    for g, (C, wf) in enumerate(gridlab):
        hits = int(regs[g, R_HITS])
        extra = {"backend": f"{backend}+{mode}", "window_frac": wf,
                 "grid": G, "grid_wall_s": wall, "assoc": grid[g].assoc,
                 "device": _device_name(dev),
                 **_row_extra(grid[g], None, False)}
        out.append(SimResult(
            policy=_policy_label(grid[g], False), cache_size=C,
            trace=trace_name, accesses=counted, hits=hits,
            hit_ratio=hits / max(1, counted),
            # per-row amortized wall; the grid's total is in grid_wall_s
            wall_s=wall / G, extra=extra))
        if verbose:
            print(f"  {trace_name:>12s} C={C:<7d} wf={wf:<5.2f} "
                  f"hit={out[-1].hit_ratio:.4f}  (grid of {G}, "
                  f"{wall:.1f}s total)", flush=True)
    return out


def _padded_grid(grid: list, device) -> tuple[StepSpec, list]:
    """The vmap sweep's shared geometry (the largest configuration's, table
    slots padded to fit every member) and each member's zeroed single-lane
    state on ``device``, its excess slots marked as padding.  A set-associative
    member whose main capacity is below the shared main set count would
    leave most of its sets without a way, so such grids are refused, as in
    the reference."""
    big = max(grid, key=lambda c: c.capacity)
    mslots = max(c._table_slots(c.main_cap, big.ways) for c in grid)
    if big.assoc is not None:
        msets = mslots // big.ways
        for c in grid:
            if c.main_cap < msets:
                raise ValueError(
                    f"vmap assoc sweep: main_cap {c.main_cap} < shared "
                    f"{msets} sets (capacity {c.capacity} vs "
                    f"{big.capacity}); run mode='sequential'")
    spec = big.spec(window_slots=max(c._table_slots(c.window_cap, big.ways)
                                     for c in grid),
                    main_slots=mslots, ways=big.ways)
    return spec, [init_step_state(spec, c.window_cap, c.main_cap,
                                  device=device) for c in grid]

"""Device-resident W-TinyLFU trace simulation engine on PyTorch/CUDA.

Counterpart of ``repro/core/device_simulate.py``: ``simulate_trace`` and
``DeviceWTinyLFU.run`` push a whole trace through the fused per-access step
(``kernels/sketch_step.py``), one kernel launch per chunk, with the state
updated in place on the card between launches and no host sync per chunk.

Sizing mirrors the reference exactly (window 1%, SLRU 80/20, W =
sample_factor*C, cap = W/C with the doorkeeper absorbing one count), so the
port's state and hit counts equal the JAX engine's bit for bit.

The port runs ``policy="wtinylfu"`` in both table layouts, for one
stream or ``streams=B`` tenant lanes (one launch per chunk for all lanes),
with an unsharded sketch or ``shards=S`` (one launch per merge epoch, then
the ``merge_halve`` fold, with ``integrity`` if asked), with a static window
or ``adaptive=True`` (one launch per climb epoch, then the fold when
sharded, the hill climb and ``rebalance``, all on the card); the policy
panel's competitors (``policy="s3fifo" | "arc" | "lfu"``) on the
set-associative tables, one stream or lanes; and ``simulate_sweep``'s grids
of such configurations (``policies=`` among them): one run per
configuration, or (unsharded, one policy) as lanes of one run.
``DeviceWTinyLFU.run(..., checkpoint_dir=, fault_hook=)`` runs one stream
in segments that end on epoch boundaries, saving the state tree after each
in the reference's checkpoint format and calling the fault hook between
them; ``resume_trace`` continues from the latest checkpoint, written by
either package on either device.  ``mesh=`` (a ``distributed.mesh.ShardMesh``)
runs a sharded configuration with its sketch deltas split over the ranks of
a ``("shard",)`` mesh, one process per rank (see ``_segment``); every rank
returns the same result.
Entry points run on the card unless the caller passes ``device="cpu"`` (the
plain version); without a card they raise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch

from repro_torch.analysis import program_trace
from repro_torch.kernels import sketch_step as ks
from repro_torch.kernels.sketch_step import (
    StepSpec, make_step_params, init_step_state, precompute_probes, step,
    rebalance, resolve_device, R_EHITS, R_HITS, R_WQUOTA)
from repro_torch.kernels.sketch_common import POLICIES
from repro_torch.kernels.sketch_merge import merge_halve, merge_halve_mesh
from repro_torch.distributed.mesh import SPLIT_LEAVES, ShardMesh
from .adaptive import resolve_climb, window_cap_max
from .hashing import assoc_geometry, slots_for, _pow2ceil
from .simulate import SimResult


@dataclass(frozen=True)
class DeviceWTinyLFU:
    """One simulated W-TinyLFU configuration (host-side description).

    Same fields, sizing and eager validation as the reference class.
    ``assoc=None`` uses the exact flat tables, ``assoc=W`` the W-way
    set-associative tables; ``streams=B`` batches B tenant lanes; ``shards=S``
    splits the sketch into S shards folded every ``merge_epoch`` accesses.
    ``adaptive=True`` hill-climbs the window quota between epochs.
    ``policy`` picks the W-TinyLFU rules or a competitor of the panel
    (``"s3fifo"``, ``"arc"``, ``"lfu"``; set-associative tables only).
    ``mesh`` (this rank's ``distributed.mesh.ShardMesh``) splits the
    sketch deltas of a sharded run over the mesh's ranks; ``mesh_exchange``
    is ``"chunk"`` (exact) or ``"stale"`` (stale-global admission).
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
        return window_cap_max(self.capacity, self.window_cap,
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
        if not isinstance(self.mesh, ShardMesh):
            raise ValueError(f"mesh {self.mesh!r} is not a ShardMesh — build "
                             "it with distributed.mesh.make_shard_mesh")
        n = int(self.mesh.size)
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
        (the card unless ``"cpu"``).  ``climb`` (default
        :class:`ClimbSpec`) is ignored unless ``adaptive``, as in the
        reference.

        With ``checkpoint_dir`` or ``fault_hook`` the trace runs in segments
        of ``checkpoint_every`` accesses, each ending on an epoch boundary
        (a clean state handoff), so the result equals the one-piece run bit
        for bit.  After each segment the state tree (the state, the
        climber's registers, the hit flags so far and, adaptive, the
        trajectory) is saved to ``checkpoint_dir`` by
        ``checkpoint.store.AsyncCheckpointer`` in the reference's format,
        and :func:`resume_trace` continues from the latest one.
        ``checkpoint_every`` must be a positive multiple of the run's epoch
        (``climb.epoch_len`` adaptive, ``merge_epoch`` sharded; anything
        for a static unsharded run); 0 picks about 32,768 accesses in whole
        epochs.  ``on_checkpoint(cursor)`` is called after each save is
        queued; ``fault_hook(cursor, state) -> state | None`` is called at
        each boundary but the last, just after the checkpoint, with the
        live state, and the run goes on from the state it returns (tensors
        or numpy, placed on the run's device), if any (``core.faults``).
        """
        return _run_checkpointed(
            self, trace, warmup=warmup, device=device, chunk=chunk,
            trace_name=trace_name, climb=climb,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            return_state=return_state, on_checkpoint=on_checkpoint,
            fault_hook=fault_hook)


def _trace_lanes(trace: np.ndarray, device) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The trace's keys as (lo, hi) contiguous int32 tensors on ``device``,
    bit for bit ``keys_to_lanes`` of the trace, in its shape.

    The span ``engine.lanes`` normalises the trace on the host: a
    C-contiguous, writeable uint64 or int64 NumPy array is taken as it is,
    viewed as pairs of int32 words; anything else is converted as
    ``keys_to_lanes`` converts it (``astype(uint64)``, C order), counted as
    ``keys_converted``.  The span ``engine.copy_in`` copies the 64-bit keys
    to the device once (``bytes_in``, 8 bytes a key) and splits them there
    into their little-endian 32-bit words, even words ``lo``, odd ``hi``;
    the device copy of the keys is released on return, and ``lo`` and
    ``hi`` never alias the caller's array."""
    with program_trace.span("engine.lanes"):
        keys = np.asarray(trace)
        if (not isinstance(trace, np.ndarray)
                or keys.dtype not in (np.uint64, np.int64)
                or not keys.flags.c_contiguous or not keys.flags.writeable):
            program_trace.count("keys_converted", keys.size)
            keys = keys.astype(np.uint64, order="C")
        words = keys.reshape(-1).view(np.int32).reshape(*keys.shape, 2)
    with program_trace.span("engine.copy_in"):
        program_trace.count("bytes_in", words.nbytes)
        words = torch.from_numpy(words).to(device)
        return (words[..., 0].clone(memory_format=torch.contiguous_format),
                words[..., 1].clone(memory_format=torch.contiguous_format))


def _host_in(x, device, dtype=None) -> torch.Tensor:
    """A host array (numpy or a CPU tensor) placed on the run's device,
    its bytes counted as the engine's ``bytes_in``."""
    t = torch.as_tensor(x)
    if t.device.type == "cpu":
        program_trace.count("bytes_in", t.nbytes)
    return t.to(device, dtype)


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
               fn=step, fold=None):
    """Chunked runner (counterpart of the reference's ``_run_pallas``): pad
    the access axis to whole chunks, hash every key once, then advance the
    state in place one chunk per ``fn`` call (``step``, or ``step_ref`` to
    drive the plain version) with the chunk's ``n_valid``; returns (state,
    the hit flags of the unpadded trace).  ``(B, T)`` lanes share the
    chunking: each call takes a ``(B, chunk)`` slice of every lane (laid
    out chunk-major, so each slice is contiguous).  ``step`` picks the
    kernel or the plain version by the tensors' device; on the card nothing
    here waits for it.

    ``fold(spec, params, state)`` (the sharded runs' ``merge_halve``, the
    adaptive runs' climb and rebalance) runs after every full chunk, never
    after a partial tail: the host knows which chunks are full, so it reads
    nothing from the card to decide.  While a program is recorded
    (``analysis.program_trace``) the loop, each chunk and each fold are
    marked.  ``lo`` and ``hi`` arrive split on the run's device
    (:func:`_trace_lanes`, the spans ``engine.lanes`` and
    ``engine.copy_in``); the probes' set-up and the loop are the spans
    ``engine.probes`` and ``engine.loop``; nothing is added to a chunk."""
    n = lo.shape[-1]
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be >= 1")
    if n == 0:
        return state, torch.zeros(lo.shape, dtype=torch.int32,
                                  device=lo.device)
    with program_trace.span("engine.probes"):
        pad = (-n) % chunk
        if pad:
            z = torch.zeros(lo.shape[:-1] + (pad,), dtype=lo.dtype,
                            device=lo.device)
            lo = torch.cat([lo, z], dim=-1)
            hi = torch.cat([hi, z], dim=-1)
        nc = lo.shape[-1] // chunk

        def chunk_major(x):         # (..., nc * chunk) -> (nc, ..., chunk)
            if x.dim() == 1:
                return x.reshape(nc, chunk)
            x = x.reshape(x.shape[0], nc, chunk)
            return x.transpose(0, 1).contiguous()

        lo, hi = chunk_major(lo), chunk_major(hi)
        probes = precompute_probes(spec, lo, hi)
    with program_trace.span("engine.loop"):
        hits = []
        rec = program_trace.active
        if rec is not None:
            rec.mark("loop_begin", program_trace.leaf_ids(state))
        for c in range(nc):
            n_valid = min(chunk, n - c * chunk)
            if rec is not None:
                rec.mark("chunk", c)
            _, h = fn(spec, params, state, lo[c], hi[c], n_valid,
                      tuple(p[c] for p in probes))
            hits.append(h)
            if fold is not None and n_valid == chunk:
                if rec is not None:
                    rec.mark("fold")
                fold(spec, params, state)
                if rec is not None:
                    rec.mark("fold_end")
        if rec is not None:
            rec.mark("loop_end", program_trace.leaf_ids(state))
        out = torch.cat(hits, dim=-1)[..., :n]
        hits.clear()        # a chunk's flags are freed inside the span
        return state, out


def _ops(spec: StepSpec, mesh):
    """(step function, epoch fold) of a run: the step and ``merge_halve``,
    or on a stale mesh (``spec.mesh_devices``) this rank's step and
    ``merge_halve_mesh`` over ``mesh``."""
    if not spec.mesh_devices:
        return step, merge_halve
    return (partial(step, rank=mesh.rank),
            lambda sp, p, st: merge_halve_mesh(sp, p, st, mesh))


def _run(cfg: DeviceWTinyLFU, spec: StepSpec, params, state: dict, lo, hi,
         chunk: int, mesh=None):
    """One configuration's run: ``chunk`` accesses per launch, or with
    ``shards > 1`` (the reference's ``_run_sharded``) one launch per merge
    epoch of ``cfg.merge_epoch`` accesses and the fold after every full
    epoch (``chunk`` does not apply)."""
    fn, fold = _ops(spec, mesh)
    if cfg.shards > 1:
        return run_chunks(spec, params, state, lo, hi, cfg.merge_epoch,
                          fn=fn, fold=fold)
    return run_chunks(spec, params, state, lo, hi, chunk, fn=fn)


@dataclass(frozen=True)
class ClimbSpec:
    """Hill-climber hyperparameters (resolved against a configuration).

    Same fields, defaults and ``resolve`` as the reference ``ClimbSpec``
    (see its docstring for each rule).  Every ``epoch_len`` accesses the
    climb compares the epoch's hits with the previous epoch's and moves the
    window quota; zero fields auto-size (``core/adaptive.resolve_climb``):
    ``delta0`` = wmax/16, ``wmax`` = the adaptive table headroom, ``tol`` =
    epoch_len/256, ``restart`` = epoch_len/16.
    """
    epoch_len: int = 4096
    delta0: int = 0
    wmin: int = 1
    wmax: int = 0
    tol: int = 0
    restart: int = 0
    warm_epochs: int = 3

    def resolve(self, cfg: DeviceWTinyLFU) -> np.ndarray:
        return np.asarray(
            resolve_climb(self.epoch_len, self.delta0, self.wmin, self.wmax,
                          self.tol, self.restart, self.warm_epochs,
                          cfg.window_cap_max),
            np.int32)


def _climb_carry0(cvec: torch.Tensor) -> torch.Tensor:
    """Fresh-run climber registers [prev=-1, dirn=1, delta=delta0, ewma=-1,
    trend=0, k=0]: (6,) for one climb vector, (6, B) for (B, 6)."""
    if cvec.dim() == 2:
        return torch.stack([_climb_carry0(cv) for cv in cvec], dim=1)
    one = torch.ones((), dtype=torch.int32, device=cvec.device)
    return torch.stack([-one, one, cvec[0].to(torch.int32), -one, one - 1,
                        one - 1])


def _climb_step(params, spec: StepSpec, state: dict, carry: torch.Tensor,
                ehits: torch.Tensor, climb: torch.Tensor) -> torch.Tensor:
    """One hill-climb update and ``rebalance`` between epochs, as tensor ops
    on the state's device (the reference's ``_climb_step``; the same rules
    as ``core/adaptive.climb_update``); returns the new carry.

    ``carry`` is the climber registers [prev, dirn, delta, ewma, trend, k]:
    (6,), or (6, B) with lanes, each register then a row of per-lane values;
    ``ehits`` the epoch's hits, () or (B,); ``climb`` the resolved vector,
    (6,) shared or (B, 6) per lane.  Every ``//`` rounds to the floor, as
    ``jnp.int32 //`` does (``diff``, ``trend`` and ``ehits - ewma`` go
    negative).  Nothing is read back to the host.
    """
    fd = ks._floordiv
    prev, dirn, delta, ewma, trend, k = carry.unbind(0)
    d0, wmin, wmax, tol, restart, warm_epochs = climb.unbind(-1)
    quota = state["regs"][..., R_WQUOTA]
    diff = ehits - prev
    adiff = diff - trend
    improved = adiff > tol
    regressed = adiff < -tol
    trend_n = torch.where(prev < 0, 0, trend + fd(diff - trend, 4))
    dirn_n = torch.where(regressed, -dirn, dirn)
    delta_n = torch.where(regressed, torch.clamp(fd(delta, 2), min=1),
                          torch.where(improved, delta,
                                      torch.clamp(fd(delta * 3, 4), min=1)))
    shift = (ehits - ewma).abs() > restart
    span4 = torch.maximum(d0, fd(wmax - wmin, 4))
    delta_n = torch.where(
        shift, torch.where(improved, torch.minimum(
            torch.maximum(delta_n, d0) * 2, span4), d0), delta_n)
    warm = k < warm_epochs
    ewma = torch.where(warm | (prev < 0), ehits, ewma + fd(ehits - ewma, 4))
    dirn = torch.where(warm, dirn, dirn_n)
    delta = torch.where(warm, delta, delta_n)
    trend = torch.where(warm, torch.where(prev < 0, 0, diff), trend_n)
    move = improved | regressed | shift
    step_q = torch.where(warm | ~move, 0, dirn * delta)
    nq = torch.minimum(torch.maximum(quota + step_q, wmin), wmax)
    dirn = torch.where(nq <= wmin, 1, torch.where(nq >= wmax, -1, dirn))
    rebalance(spec, params, state, nq)
    return torch.stack([ehits, dirn, delta, ewma, trend, k + 1])


def _run_adaptive(cfg: DeviceWTinyLFU, spec: StepSpec, params, state: dict,
                  lo, hi, climb: ClimbSpec, cvec: torch.Tensor | None = None,
                  carry: torch.Tensor | None = None, mesh=None):
    """The adaptive run (the reference's ``_run_adaptive``): one step launch
    per epoch of ``climb.epoch_len`` accesses; after each full epoch, in
    this order, the ``merge_halve`` fold (sharded), the climb and
    ``rebalance``; a partial tail epoch steps but never folds or climbs.

    ``cvec`` is the resolved climb vector ((6,), or (B, 6) per lane;
    default ``climb.resolve(cfg)``).  ``carry`` is the climber registers
    to start from (None: a fresh climb); a checkpointed run passes the
    previous segment's.  Returns (state, hit flags, the per-epoch (ehits,
    quota) rows as one device tensor of shape (epochs, 2) or (epochs, 2,
    B), read from the registers before each climb, or None with no full
    epoch, the climber registers after the last climb).  The host knows
    which epochs are full, so nothing here waits on the card.
    """
    if cvec is None:
        cvec = torch.as_tensor(climb.resolve(cfg), device=lo.device)
    if carry is None:
        carry = _climb_carry0(cvec)
        if spec.streams > 1 and carry.dim() == 1:
            carry = carry[:, None].repeat(1, spec.streams)
    rows = []
    fn, merge = _ops(spec, mesh)

    def fold(spec, params, state):
        nonlocal carry
        regs = state["regs"]
        ehits = regs[..., R_EHITS].clone()
        rows.append(torch.stack([ehits, regs[..., R_WQUOTA].clone()]))
        if spec.shards > 1:
            merge(spec, params, state)
        carry = _climb_step(params, spec, state, carry, ehits, cvec)

    state, hits = run_chunks(spec, params, state, lo, hi,
                             int(climb.epoch_len), fn=fn, fold=fold)
    return state, hits, (torch.stack(rows) if rows else None), carry


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
    sample factors above 16.  ``shards=S`` runs the sharded sketch, folded
    every ``merge_every`` accesses (0: ``min(4096, sample_size)``), with
    per-shard checksums and quarantine if ``integrity=True``.
    ``adaptive=True`` hill-climbs the window quota (``climb``, default
    :class:`ClimbSpec`) between epochs, on the card: ``extra`` carries
    ``final_quota`` and the per-epoch ``trajectory``; with ``shards`` the
    fold rides the climb epochs.  ``policy="s3fifo" | "arc" | "lfu"`` (via
    cfg_kw, with ``assoc``) runs a competitor of the policy panel; the
    reference's label (``"<policy>(device)"``) and ``extra["policy"]``
    come with it.  With ``return_state`` the result comes with the final
    state dict and the per-access hit flags.
    """
    cfg = DeviceWTinyLFU(capacity, window_frac=window_frac,
                         sample_factor=sample_factor, adaptive=adaptive,
                         **cfg_kw)
    return _run_checkpointed(cfg, trace, warmup=warmup, device=device,
                             chunk=chunk, trace_name=trace_name, climb=climb,
                             return_state=return_state)


# ---------------------------------------------------------------------------
# fault-tolerant execution: epoch-boundary checkpoint / resume
# ---------------------------------------------------------------------------

def _ckpt_epoch(cfg: DeviceWTinyLFU, climb: ClimbSpec) -> int:
    """The run's state-handoff granularity in accesses.

    Adaptive runs climb (and, sharded, merge) every ``climb.epoch_len``;
    sharded static runs merge every ``merge_epoch``; a static unsharded run
    has no boundary constraint at all (any split is a clean handoff), so its
    epoch only sets the auto checkpoint cadence."""
    if cfg.adaptive:
        return int(climb.epoch_len)
    if cfg.shards > 1:
        return int(cfg.merge_epoch)
    return max(1, min(4096, cfg.sample_size))


def _resolve_every(cfg: DeviceWTinyLFU, climb: ClimbSpec,
                   checkpoint_every: int) -> int:
    """Validated checkpoint cadence in accesses (0 = auto ~32k, rounded to
    whole epochs).  Epoch-chunked runs (adaptive / sharded) may only hand
    state off at epoch boundaries, so their cadence must be a multiple of
    the epoch: anything else could not reproduce the uninterrupted run."""
    E = _ckpt_epoch(cfg, climb)
    if checkpoint_every == 0:
        return E * max(1, 32768 // E)
    ce = int(checkpoint_every)
    chunked = cfg.adaptive or cfg.shards > 1
    if ce < 1 or (chunked and ce % E):
        kind = ("climb.epoch_len" if cfg.adaptive else
                "the resolved merge_epoch")
        raise ValueError(
            f"checkpoint_every {checkpoint_every} must be a positive "
            f"multiple of the run's epoch ({kind} = {E}): the engine "
            "hands state off only at epoch boundaries, so any other "
            "cadence cannot resume bit-identically")
    return ce


def _config_meta(cfg: DeviceWTinyLFU, climb: ClimbSpec, warmup: int,
                 n: int) -> dict:
    """JSON-safe fingerprint of the logical run configuration, stored in
    every checkpoint's manifest and verified by :func:`resume_trace`; the
    reference's keys and values, so checkpoints cross between the
    packages.  The device is not part of it: a checkpoint written on the
    card resumes on the CPU, and the reverse."""
    meta = {f: getattr(cfg, f) for f in (
        "capacity", "window_frac", "sample_factor", "protected_frac",
        "counters_per_item", "rows", "doorkeeper", "dk_bits_per_item",
        "assoc", "counter_bits", "adaptive", "window_max_frac", "shards",
        "merge_every", "integrity")}
    meta["mesh_exchange"] = (cfg.mesh_exchange if cfg.mesh is not None
                             else "chunk")
    if cfg.streams > 1:          # absent at 1, as in the reference
        meta["streams"] = cfg.streams
    if cfg.policy != "wtinylfu":  # absent at the default, as in the reference
        meta["policy"] = cfg.policy
    if cfg.adaptive:
        meta["climb"] = [int(x) for x in climb.resolve(cfg)]
    meta["warmup"] = int(warmup)
    meta["trace_len"] = int(n)
    return meta


def _from_mesh_state(spec: StepSpec, state: dict, mesh) -> dict:
    """This rank's mesh-layout state -> the single-device ``[global ||
    delta]`` layout (the canonical one checkpoints and callers see): the
    delta blocks of every rank are gathered over ``mesh`` (a collective:
    every rank calls it) and reordered into the delta half."""
    H, HD = spec.counter_words, spec.dk_words
    out = {k: v for k, v in state.items() if k not in SPLIT_LEAVES}
    delta = mesh.all_gather(state["dcounters"]).transpose(0, 1).reshape(H)
    ddk = (mesh.all_gather(state["ddoorkeeper"]).reshape(HD) if spec.dk_bits
           else torch.zeros_like(state["doorkeeper"]))
    out["counters"] = torch.cat([state["counters"], delta])
    out["doorkeeper"] = torch.cat([state["doorkeeper"], ddk])
    return out


def _to_mesh_state(spec: StepSpec, state: dict, mesh) -> dict:
    """The canonical ``[global || delta]`` layout -> rank ``mesh.rank``'s
    mesh layout: the global halves, and the delta blocks of the shards it
    owns, ``(L, rows, wps_shard)`` and ``(L, dkw_shard)``.  No collective:
    a checkpoint of any mesh size (or of a single-device run) restores
    onto any mesh whose size divides ``shards`` (elastic restore)."""
    H, HD, L = spec.counter_words, spec.dk_words, spec.local_shards
    owned = mesh.owned(spec.shards)
    own = slice(owned.start, owned.stop)
    out = {k: v for k, v in state.items()
           if k not in ("counters", "doorkeeper")}
    out["counters"] = state["counters"][:H].contiguous()
    out["doorkeeper"] = state["doorkeeper"][:HD].contiguous()
    out["dcounters"] = state["counters"][H:].reshape(
        spec.rows, spec.shards, spec.wps_shard).transpose(0, 1)[
            own].contiguous()
    out["ddoorkeeper"] = (
        state["doorkeeper"][HD:].reshape(spec.shards, spec.dkw_shard)[
            own].contiguous() if spec.dk_bits else
        torch.zeros((L, spec.dkw_shard), dtype=torch.int32,
                    device=state["counters"].device))
    return out


def _segment(cfg: DeviceWTinyLFU, spec: StepSpec, params, state: dict, lo,
             hi, climb: ClimbSpec, cvec, carry, chunk: int):
    """One contiguous trace slice through the right runner; returns (state,
    hits, the (epochs, 2) trajectory rows or None, carry).

    On a mesh (``cfg.mesh``, the reference's ``_mesh_runner``) every rank
    runs the same epochs over replicated tables.  ``"chunk"``: the delta
    blocks are gathered on entry (the one collective), the single-device
    sharded program runs on the replicated ``[global || delta]`` replica
    (step, fold, climb) and this rank's blocks are split out on exit, so the
    run equals the single-device one bit for bit.  ``"stale"``: the mesh
    layout is kept, each access runs the stale step (kernel mode 1e: delta
    writes stay on the owning rank, estimates read the global halves) and
    ``merge_halve_mesh`` gathers the deltas after every full epoch."""
    mesh = cfg.mesh
    if mesh is not None and spec.mesh_exchange == "chunk":
        flat = _from_mesh_state(spec, state, mesh)
        flat, hits, traj, carry = _segment(
            replace(cfg, mesh=None), replace(spec, mesh_devices=0), params,
            flat, lo, hi, climb, cvec, carry, chunk)
        return _to_mesh_state(spec, flat, mesh), hits, traj, carry
    if cfg.adaptive:
        return _run_adaptive(cfg, spec, params, state, lo, hi, climb, cvec,
                             carry, mesh=mesh)
    state, hits = _run(cfg, spec, params, state, lo, hi, chunk, mesh=mesh)
    return state, hits, None, carry


def _hook_state(spec: StepSpec, state: dict, dev: torch.device) -> dict:
    """A fault hook's state (tensors on any device, or numpy) on ``dev``,
    its keys and shapes checked against ``spec``.  Table addresses out of
    range are the step's to take, as the reference's are."""
    arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v)) for k, v in state.items()}
    return ks.state_from_numpy(spec, arrays, dev)


def _run_device(cfg: DeviceWTinyLFU, device) -> torch.device:
    """The run's device: the caller's, else a CUDA mesh's card, else the
    card (see ``resolve_device``)."""
    if (device is None and cfg.mesh is not None
            and cfg.mesh.device.type == "cuda"):
        return cfg.mesh.device
    return resolve_device(device)


def _run_checkpointed(cfg: DeviceWTinyLFU, trace, *, warmup=0, device=None,
                      chunk=512, trace_name="?", climb=None,
                      checkpoint_dir=None, checkpoint_every=0,
                      return_state=False, on_checkpoint=None,
                      fault_hook=None, _start=0, _state=None, _carry=None,
                      _hits_prefix=None, _traj_prefix=None):
    """The engine driver behind :meth:`DeviceWTinyLFU.run`,
    :func:`simulate_trace` and :func:`resume_trace` (the leading-underscore
    arguments are the resume handoff).  With no ``checkpoint_dir`` and no
    ``fault_hook`` the trace is one segment.  Otherwise every segment
    boundary is an epoch boundary, so the segments together reproduce the
    one-piece run bit for bit: hit sequence, climb trajectory and final
    state.  Each segment launches the step kernel on the card, or runs its
    plain version on the CPU.

    A save copies the state to host memory before it returns (which waits
    for the card); the disk write runs on a background thread while the
    next segment runs, and its error, if any, is raised here.

    The call is the span ``engine.run`` (``analysis.program_trace``), its
    phases in order its children: ``engine.lanes`` (the trace's keys made
    64-bit on the host, a view unless they must be converted) and
    ``engine.copy_in`` (their one copy to the run's device and the split
    into lanes there), ``engine.state``, then ``engine.probes`` and
    ``engine.loop`` a segment, and ``engine.finish``; its ``bytes_in``
    counts every host array placed on the run's device, and its
    ``keys_converted`` the keys that were converted (see
    :func:`_trace_lanes`)."""
    with program_trace.span("engine.run"):
        climb = climb or ClimbSpec()
        segmenting = checkpoint_dir is not None or fault_hook is not None
        if segmenting and cfg.streams > 1:
            raise ValueError(
                f"streams {cfg.streams} does not combine with checkpoint_dir/"
                "fault_hook: the checkpoint tree and fault surface are the "
                "single-tenant state layout — run per-tenant streams=1 runs "
                "for fault-tolerant execution")
        dev = _run_device(cfg, device)
        trace = np.asarray(trace)
        _check_trace_streams(cfg, trace)
        every = (_resolve_every(cfg, climb, checkpoint_every) if segmenting
                 else None)
        spec = cfg.spec()
        mesh = cfg.mesh

        def canonical(st):          # the single-device layout (collective)
            return st if mesh is None else _from_mesh_state(spec, st, mesh)

        lo, hi = _trace_lanes(trace, dev)
        n = lo.shape[-1]
        with program_trace.span("engine.state"):
            params = cfg.params(warmup=warmup, device=dev)
            state = (_state if _state is not None else
                     init_step_state(spec, cfg.window_cap, cfg.main_cap,
                                     device=dev))
            cvec = (_host_in(climb.resolve(cfg), dev) if cfg.adaptive
                    else None)
            carry = _host_in(_carry, dev) if _carry is not None else None
            ck = None
            if checkpoint_dir is not None:
                from repro_torch.checkpoint.store import AsyncCheckpointer
                meta = _config_meta(cfg, climb, warmup, n)
                if mesh is None or mesh.rank == 0:      # one writer per mesh
                    ck = AsyncCheckpointer(checkpoint_dir)
            zeros = torch.zeros(lo.shape[:-1] + (0,), dtype=torch.int32,
                                device=dev)

            def joined(parts):
                return (parts[0] if len(parts) == 1 else
                        torch.cat(parts, dim=-1)) if parts else zeros

            t0 = time.perf_counter()
            hits_parts = ([] if _hits_prefix is None
                          else [_host_in(_hits_prefix, dev, torch.int32)])
            traj_parts = []
            if _traj_prefix is not None:
                traj_parts.append(torch.stack(
                    [_host_in(x, dev, torch.int32) for x in _traj_prefix],
                    dim=1))
        i = _start
        while True:
            j = n if every is None else min(n, i + every)
            if j > i:
                state, hits, traj, carry = _segment(
                    cfg, spec, params, state, lo[..., i:j], hi[..., i:j],
                    climb, cvec, carry, chunk)
                hits_parts.append(hits)
                if traj is not None:
                    traj_parts.append(traj)
            i = j
            if checkpoint_dir is not None:
                tree = {"state": canonical(state),
                        "carry": (carry if carry is not None else
                                  torch.zeros((6,), dtype=torch.int32)),
                        "hits": joined(hits_parts)}
                if cfg.adaptive:
                    traj = torch.cat(traj_parts) if traj_parts else None
                    tree["ehits"] = traj[:, 0] if traj is not None else zeros
                    tree["quotas"] = (traj[:, 1] if traj is not None
                                      else zeros)
                if ck is not None:
                    ck.save(i, tree, extra_meta={**meta, "cursor": i})
                if on_checkpoint is not None:
                    on_checkpoint(i)
            if i >= n:
                break
            if fault_hook is not None:
                # the checkpoint just written holds the state before the
                # fault; a meshed run's hook sees (and returns) the
                # canonical layout
                mutated = fault_hook(i, canonical(state))
                if mutated is not None:
                    cspec = replace(spec, mesh_devices=0)
                    state = _hook_state(cspec, mutated, dev)
                    if mesh is not None:
                        state = _to_mesh_state(spec, state, mesh)
        with program_trace.span("engine.finish"):
            if ck is not None:
                ck.wait()
            if mesh is not None and checkpoint_dir is not None:
                mesh.barrier()      # no rank returns before the last save

            state = canonical(state)
            hits = joined(hits_parts)
            regs = state["regs"].cpu()              # waits for the device
            traj = torch.cat(traj_parts).cpu() if traj_parts else None
            wall = time.perf_counter() - t0

            # warmup applies per lane (each lane's own R_T register counts
            # it)
            counted = (n - warmup) * cfg.streams
            extra = {"backend": "cuda" if dev.type == "cuda" else "plain",
                     "window_frac": cfg.window_frac, "assoc": cfg.assoc,
                     "device": _device_name(dev),
                     **_row_extra(cfg, climb, cfg.adaptive)}
            if cfg.adaptive:
                extra["adaptive"] = True
                extra["final_quota"] = (
                    [int(q) for q in regs[:, R_WQUOTA]] if cfg.streams > 1
                    else int(regs[R_WQUOTA]))
                if traj is not None:
                    extra["trajectory"] = {
                        "epoch_len": climb.epoch_len,
                        "epoch_hits": traj[:, 0].tolist(),
                        "quota": traj[:, 1].tolist()}
            if cfg.streams > 1:
                extra["lane_hits"] = [int(h) for h in regs[:, R_HITS]]
                n_hits = sum(extra["lane_hits"])
            else:
                n_hits = int(regs[R_HITS])
            if checkpoint_dir is not None:
                extra["checkpoint_every"] = every
            if _start:
                extra["resumed_at"] = int(_start)
            res = SimResult(policy=_policy_label(cfg, cfg.adaptive),
                            cache_size=cfg.capacity, trace=trace_name,
                            accesses=counted, hits=n_hits,
                            hit_ratio=n_hits / max(1, counted),
                            wall_s=wall, extra=extra)
            if return_state:
                return res, state, hits
            return res


def resume_trace(trace, cfg: DeviceWTinyLFU, *, checkpoint_dir: str,
                 warmup: int = 0, device=None, chunk: int = 512,
                 trace_name: str = "?", climb: ClimbSpec | None = None,
                 checkpoint_every: int = 0, return_state: bool = False,
                 on_checkpoint=None, fault_hook=None):
    """Restore the latest complete checkpoint in ``checkpoint_dir`` and
    finish the run on ``device`` (the card unless ``"cpu"``); bit-identical
    to the uninterrupted ``cfg.run(trace, checkpoint_dir=...)`` (hit
    sequence, trajectory, final state).

    Checkpoints hold the reference's tree, leaf for leaf, so one written by
    the JAX package resumes here and the reverse, and one written on the
    card resumes on the CPU.  They hold the single-device layout, so a
    meshed run's checkpoint resumes on one device or on any mesh whose
    size divides ``cfg.shards``, and the reverse (elastic restore); every
    rank of a mesh calls this.  With no checkpoint yet (killed before the
    first), the resume is a fresh run (``resumed_at`` 0).  A checkpoint
    written under another logical configuration (any ``DeviceWTinyLFU``
    field, climb vector, warmup or trace length) raises ``ValueError``.
    """
    from repro_torch.checkpoint.store import (latest_step, load_meta,
                                              restore_checkpoint)
    climb = climb or ClimbSpec()
    common = dict(warmup=warmup, device=device, chunk=chunk,
                  trace_name=trace_name, climb=climb,
                  checkpoint_dir=checkpoint_dir,
                  checkpoint_every=checkpoint_every,
                  return_state=return_state, on_checkpoint=on_checkpoint,
                  fault_hook=fault_hook)
    step = latest_step(checkpoint_dir)
    if step is None:
        out = _run_checkpointed(cfg, trace, **common)
        (out[0] if return_state else out).extra["resumed_at"] = 0
        return out
    meta = dict(load_meta(checkpoint_dir, step))
    cursor = int(meta.pop("cursor", step))
    expect = _config_meta(cfg, climb, warmup, len(trace))
    if meta != expect:
        diffs = sorted(k for k in set(meta) | set(expect)
                       if meta.get(k) != expect.get(k))
        raise ValueError(
            f"checkpoint {checkpoint_dir!r} step {step} was saved under a "
            f"different configuration (differing fields: {diffs}) — resume "
            "with the original DeviceWTinyLFU / climb / warmup / trace")
    spec = cfg.spec()
    cspec = replace(spec, mesh_devices=0)       # the canonical layout
    template = {"state": {k: np.zeros(v, np.int32)
                          for k, v in ks._state_shapes(cspec).items()},
                "carry": np.zeros((6,), np.int32),
                "hits": np.zeros((cursor,), np.int32)}
    if cfg.adaptive:
        ne = cursor // int(climb.epoch_len)
        template["ehits"] = np.zeros((ne,), np.int32)
        template["quotas"] = np.zeros((ne,), np.int32)
    tree = restore_checkpoint(checkpoint_dir, step, template, device="cpu")
    arrays = {k: v.numpy() for k, v in tree["state"].items()}
    state = ks.state_from_numpy(cspec, arrays, _run_device(cfg, device))
    if cfg.mesh is not None:    # elastic: onto this mesh, whatever wrote it
        state = _to_mesh_state(spec, state, cfg.mesh)
        cfg.mesh.barrier()      # every rank has read before rank 0 writes
    return _run_checkpointed(
        cfg, trace, _start=cursor, _state=state,
        _carry=(tree["carry"] if cfg.adaptive else None),
        _hits_prefix=tree["hits"],
        _traj_prefix=((tree["ehits"], tree["quotas"]) if cfg.adaptive
                      else None),
        **common)


def simulate_sweep(trace: np.ndarray, capacities, *, window_fracs=(0.01,),
                   sample_factor: int = 8, warmup: int = 0,
                   trace_name: str = "?", verbose: bool = False,
                   mode: str = "auto", adaptive: bool = False, climb=None,
                   policies=("wtinylfu",), device=None, chunk: int = 512,
                   **cfg_kw) -> list[SimResult]:
    """Cartesian (capacity x window_frac x policy) sweep (counterpart of
    the reference's ``simulate_sweep``).

    ``mode="sequential"`` runs one configuration after another, each with
    its own tight geometry (sketch sized like the host's, bit-identical to
    its ``simulate_trace`` run).  ``mode="vmap"`` runs the whole grid as
    lanes of one run, one launch per chunk: every configuration takes the
    largest one's geometry (table slots padded up, excess slots marked as
    padding by a per-configuration ``init_step_state``) with its own params
    as a per-lane row.  ``"auto"`` picks ``"vmap"`` on the card, as the
    reference does on its accelerator, and ``"sequential"`` on the CPU; a
    sharded grid runs ``"sequential"`` only (each configuration's merge
    epochs), so ``"auto"`` resolves to it and ``"vmap"`` raises.

    ``adaptive=True`` hill-climbs every configuration's window
    (``window_fracs`` seed the quotas; ``climb`` is one :class:`ClimbSpec`
    or one per grid point).  ``"auto"`` resolves to ``"sequential"``;
    ``"vmap"`` runs the grid as lanes of one run with per-lane params,
    state, climb vector and climber registers, which needs one shared
    geometry (sweep ``window_fracs`` or climb hyperparameters) and one
    ``epoch_len``.

    ``policies=`` adds the policy panel's axis: each policy runs its own
    step rules, so a grid of several policies runs ``"sequential"``
    (``"auto"`` resolves to it, ``"vmap"`` raises); a grid of one
    competitor may run as lanes like any other.

    ``trace`` may be ``(N,)`` (shared by all configurations) or ``(G, N)``
    (one trace per grid point).  Rows carry the reference's schema
    (``grid``, ``grid_wall_s``, amortized ``wall_s``).  Meshed grids are
    run ``"sequential"`` only, each configuration on its mesh (``"auto"``
    resolves to it; ``"vmap"`` raises).
    """
    policies = tuple(policies)
    grid = [DeviceWTinyLFU(C, window_frac=wf, sample_factor=sample_factor,
                           adaptive=adaptive, policy=pol, **cfg_kw)
            for C in capacities for wf in window_fracs for pol in policies]
    gridlab = [(C, wf) for C in capacities for wf in window_fracs
               for pol in policies]
    if len(set(policies)) > 1:
        if mode == "vmap":
            raise ValueError(
                "policy grids run one compiled step program per policy (the "
                "dispatch is static, traced into the program): use "
                "mode='sequential'")
        if mode == "auto":
            mode = "sequential"
    meshed = any(c.mesh is not None for c in grid)
    if meshed:
        for c in grid:
            c.mesh_devices    # eager: reject bad mesh/shards combos up front
    dev = _run_device(grid[0], device)
    sharded = any(c.shards > 1 for c in grid)
    if mode == "auto":
        mode = ("vmap" if dev.type == "cuda"
                and not (sharded or adaptive or meshed) else "sequential")
    if mode not in ("vmap", "sequential"):
        raise ValueError(f"unknown mode {mode!r}")
    if adaptive:
        climb = climb or ClimbSpec()
        climbs = (list(climb) if isinstance(climb, (list, tuple))
                  else [climb] * len(grid))
        if len(climbs) != len(grid):
            raise ValueError(f"climb sequence length {len(climbs)} != "
                             f"{len(grid)} grid configurations")
    if meshed and mode == "vmap":
        raise ValueError("mesh sweeps run per-config mesh programs (the "
                         "lanes would silently run the single-device "
                         "path): use mode='sequential'")
    if sharded and mode == "vmap":
        raise ValueError("sharded sweeps run per-config epoch-chunked "
                         "programs: use mode='sequential'")

    trace = np.asarray(trace)
    shared_trace = trace.ndim == 1
    if not shared_trace and trace.shape[0] != len(grid):
        raise ValueError(f"trace grid dim {trace.shape[0]} != "
                         f"{len(grid)} configurations")
    n_per = trace.shape[-1]
    G = len(grid)

    t0 = time.perf_counter()
    if mode == "vmap" and adaptive:
        regs = _adaptive_lanes(grid, climbs, trace, warmup, dev)
    elif mode == "vmap":
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
            params = c.params(warmup=warmup, device=dev)
            st = _segment(c, spec, params, st, lo, hi,
                          climbs[gi] if adaptive else ClimbSpec(), None,
                          None, chunk)[0]
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
                 **_row_extra(grid[g], climbs[g] if adaptive else None,
                              adaptive)}
        if adaptive:
            extra["adaptive"] = True
            extra["final_quota"] = int(regs[g, R_WQUOTA])
        out.append(SimResult(
            policy=_policy_label(grid[g], adaptive), cache_size=C,
            trace=trace_name, accesses=counted, hits=hits,
            hit_ratio=hits / max(1, counted),
            # per-row amortized wall; the grid's total is in grid_wall_s
            wall_s=wall / G, extra=extra))
        if verbose:
            print(f"  {trace_name:>12s} C={C:<7d} wf={wf:<5.2f} "
                  f"hit={out[-1].hit_ratio:.4f}  (grid of {G}, "
                  f"{wall:.1f}s total)", flush=True)
    return out


def _adaptive_lanes(grid: list, climbs: list, trace: np.ndarray,
                    warmup: int, device) -> torch.Tensor:
    """An adaptive grid as lanes of one run: one shared geometry, per-lane
    params, state, climb vector and climber registers; returns the final
    (G, NREGS) registers on the host."""
    specs = {c.spec() for c in grid}
    if len(specs) != 1:
        raise ValueError(
            "adaptive vmap sweeps run the grid as lanes of ONE "
            "compiled program, which needs one shared static geometry; "
            f"this grid has {len(specs)} distinct geometries "
            "(capacities or sizing differ) — sweep window_fracs or "
            "climb hyperparameters, or use mode='sequential'")
    G = len(grid)
    lspec = specs.pop()
    epochs = {int(cl.epoch_len) for cl in climbs}
    if len(epochs) != 1:
        raise ValueError(
            "adaptive vmap sweeps climb in lockstep, so climb.epoch_len "
            f"must be uniform across the grid (got {sorted(epochs)}) — "
            "use mode='sequential' for mixed epoch lengths")
    pstack = torch.stack([c.params(warmup=warmup, device=device)
                          for c in grid])
    states = [init_step_state(lspec, c.window_cap, c.main_cap, device=device)
              for c in grid]
    cstack = torch.as_tensor(np.stack([cl.resolve(c)
                                       for cl, c in zip(climbs, grid)]),
                             device=device)
    lo, hi = _trace_lanes(trace, device)
    if trace.ndim == 1:
        lo, hi = lo.expand(G, -1), hi.expand(G, -1)
    if G == 1:
        st = _run_adaptive(grid[0], lspec, pstack[0], states[0], lo[0],
                           hi[0], climbs[0], cstack[0])[0]
        return st["regs"][None].cpu()
    state = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    st = _run_adaptive(grid[0], replace(lspec, streams=G), pstack, state, lo,
                       hi, climbs[0], cstack)[0]
    return st["regs"].cpu()


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

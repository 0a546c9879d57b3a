"""The ``("shard",)`` mesh of the sharded frequency sketch.

Counterpart of the sketch-shard part of ``repro/distributed/mesh.py``
(``_shard_mesh_size``, ``shard_placement``, ``make_shard_mesh``,
``mesh_state_shardings``).  The reference's mesh is a JAX device mesh that
``shard_map`` splits state over; the port runs one process per rank under
``torch.distributed`` (NCCL on the card, gloo on the CPU) and a
:class:`ShardMesh` is this rank's view of the mesh: its size, its rank, its
process group and device.  Every rank runs the identical replicated
computation over replicated cache tables; only the delta blocks of the
sketch (``dcounters``/``ddoorkeeper``, split along axis 0) differ, in block
placement: rank ``d`` of ``D`` owns shards ``[d S/D, (d + 1) S/D)``.

A mesh of one rank needs no process group: with ``torch.distributed`` not
initialised its gathers are copies.  With a group (a size-1 NCCL group on one
card among them) every gather is the group's collective.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# the leaves of the per-rank state that are split along axis 0; every other
# leaf is replicated
SPLIT_LEAVES = ("dcounters", "ddoorkeeper")


def _shard_mesh_size(n_shards: int, n_devices: int) -> int:
    """Ranks a ``("shard",)`` mesh uses for ``n_shards`` shards: the largest
    divisor of ``n_shards`` that fits ``n_devices`` (shards are a power of
    two, so the largest power of two <= both)."""
    if n_shards < 1 or n_devices < 1:
        raise ValueError(f"n_shards {n_shards} and n_devices {n_devices} "
                         "must be >= 1")
    n = min(n_shards, n_devices)
    while n_shards % n:
        n -= 1
    return n


def _initialised() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _world(group=None) -> tuple[int, int]:
    """(size, rank) of ``group`` (the default group when None), or (1, 0)
    when torch.distributed is not initialised."""
    import torch.distributed as dist
    if not _initialised():
        if group is not None:
            raise ValueError("a process group was given but "
                             "torch.distributed is not initialised")
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def owned_shards(n_shards: int, size: int, rank: int) -> range:
    """The shards whose delta blocks rank ``rank`` of a ``size``-rank mesh
    holds, in block placement: ``[rank S/size, (rank + 1) S/size)``.  The
    one placement rule: the mesh, the state's split and the step's rank
    base all take it from here."""
    if n_shards % size:
        raise ValueError(f"{n_shards} shards do not split over {size} ranks "
                         "(block placement needs shards % ranks == 0)")
    per = n_shards // size
    return range(rank * per, (rank + 1) * per)


def shard_placement(n_shards: int, devices=None) -> list:
    """Shard -> device map in block placement: with D mesh devices (the
    largest divisor of ``n_shards`` that fits ``devices``), device ``d``
    owns the ``n_shards / D`` consecutive shards ``[d S/D, (d + 1) S/D)``.
    ``devices`` defaults to the ranks of the default process group (``[0]``
    without one).  A device count that does not divide the shards uses the
    largest divisor, never an uneven split."""
    if n_shards < 1:
        raise ValueError(f"n_shards {n_shards} must be >= 1")
    devices = (list(range(_world()[0])) if devices is None
               else list(devices))
    if not devices:
        raise ValueError("shard placement needs at least one device")
    size = _shard_mesh_size(n_shards, len(devices))
    return [devices[d] for d in range(size)
            for _ in owned_shards(n_shards, size, d)]


@dataclass(frozen=True, eq=False)
class ShardMesh:
    """This rank's view of a 1-D ``("shard",)`` mesh of ``size`` ranks.

    ``group`` is the process group the collectives run on (None for a
    one-rank mesh without torch.distributed), ``rank`` this process's rank
    in it and ``device`` where this rank's state lives (``cuda:<local>`` for
    NCCL, the CPU for gloo unless the caller says otherwise)."""
    size: int
    rank: int
    group: object = None
    device: torch.device = torch.device("cpu")

    axis_names = ("shard",)

    def owned(self, n_shards: int) -> range:
        """The shards whose delta blocks this rank holds
        (:func:`owned_shards`)."""
        return owned_shards(n_shards, self.size, self.rank)

    def layout(self, state_keys) -> dict:
        """Per state leaf: ``"split"`` along axis 0 (the delta blocks) or
        ``"replicated"`` (the reference's ``mesh_state_shardings``)."""
        return {k: "split" if k in SPLIT_LEAVES else "replicated"
                for k in state_keys}

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along axis 0 in rank order (the
        reference's ``all_gather(..., tiled=True)``).  On CUDA tensors
        under NCCL the collective runs on the card; a mesh without a
        process group (one rank, torch.distributed not initialised)
        copies."""
        if not _initialised():
            return x.clone()
        import torch.distributed as dist
        x = x.contiguous()
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        if dist.get_backend(self.group) == "nccl":
            dist.all_gather_into_tensor(out, x, group=self.group)
        else:
            dist.all_gather(list(out.chunk(self.size)), x, group=self.group)
        return out

    def barrier(self):
        """Wait for every rank (nothing on a one-rank mesh)."""
        if _initialised():
            import torch.distributed as dist
            kw = {}
            if dist.get_backend(self.group) == "nccl":
                kw["device_ids"] = [self.device.index or 0]
            dist.barrier(group=self.group, **kw)


def make_shard_mesh(n_shards: int, require: int = 0, group=None,
                    device=None) -> ShardMesh:
    """This rank's ``("shard",)`` mesh over ``group`` (the default process
    group; a one-rank mesh without torch.distributed).

    The mesh takes the largest divisor of ``n_shards`` that the group's
    ranks can host, as the reference's does; the port runs one process per
    rank, so a group with more ranks than that raises (start as many ranks
    as the mesh uses).  ``require=D`` demands exactly D ranks and raises
    ``ValueError`` when the group cannot host them or ``n_shards`` does not
    split over them.  ``device`` is where the rank's state lives (default:
    ``cuda:<rank % cards>`` under NCCL, else the CPU)."""
    size, rank = _world(group)
    if require:
        if require > size:
            raise ValueError(
                f"make_shard_mesh(require={require}) but only {size} "
                "rank(s) are available: start that many ranks under "
                "torch.distributed")
        if n_shards % require:
            raise ValueError(
                f"make_shard_mesh(require={require}): {n_shards} shards do "
                "not split evenly (block placement needs shards % devices "
                "== 0)")
        n = require
    else:
        n = _shard_mesh_size(max(1, n_shards), size)
    if n != size:
        raise ValueError(
            f"a mesh of {n} ranks for {n_shards} shards, but the group has "
            f"{size}: the port runs one process per mesh rank, so start "
            f"{n} ranks")
    if device is None:
        import torch.distributed as dist
        nccl = _initialised() and dist.get_backend(group) == "nccl"
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if nccl else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":       # the kernels launch on the current card
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return ShardMesh(size=n, rank=rank, group=group, device=device)

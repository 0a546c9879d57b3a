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

The training meshes (``make_production_mesh``, ``make_debug_mesh``) are a
:class:`RankGrid`: this rank's view of a ``("data", "model")`` (or
``("pod", "data", "model")``) grid of ranks, its coordinates and one
process group per axis, over which ``distributed/shardings.py`` gathers and
reduces.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels.sketch_common import resolve_device

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


# ---------------------------------------------------------------------------
# training meshes: a grid of ranks
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class RankGrid:
    """This rank's view of a grid of ``prod(shape)`` ranks with named axes.

    Ranks are laid out row-major over the axes (the last axis varies
    fastest), as ``jax.make_mesh`` lays out devices.  ``coords`` are this
    rank's coordinates, ``groups`` one process group per axis: the ranks
    that differ from this one only on that axis, in coordinate order (None
    without torch.distributed, where every axis has size 1 and the
    collectives are copies).  ``shape`` maps axis names to sizes, as a JAX
    mesh's does."""
    axis_names: tuple
    sizes: tuple
    coords: tuple
    groups: dict
    device: torch.device = torch.device("cpu")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def rank(self) -> int:
        r = 0
        for c, n in zip(self.coords, self.sizes):
            r = r * n + c
        return r

    def axis_size(self, axis: str) -> int:
        return self.sizes[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The axis group's ``x`` concatenated along ``dim`` in coordinate
        order (every rank's ``x`` of one shape).  The ranks' blocks arrive
        one after another; moving that axis to ``dim`` copies only when
        ``dim`` has dimensions of more than one element before it."""
        if self.groups[axis] is None:
            return x.clone()
        import torch.distributed as dist
        n = self.axis_size(axis)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=self.groups[axis])
        shape = list(x.shape)
        shape[dim] *= n
        return out.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)

    def reduce_scatter(self, x: torch.Tensor, axis: str,
                       dim: int = 0) -> torch.Tensor:
        """The sum over the axis group of ``x``, split along ``dim`` into
        as many equal blocks as the axis has ranks: this rank's block,
        contiguous.  The blocks are laid one after another for the
        collective, a copy only when ``dim`` has dimensions of more than
        one element before it."""
        n = self.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over the {n} ranks of {axis!r}")
        if self.groups[axis] is None:
            return x.clone()
        import torch.distributed as dist
        shape = list(x.shape)
        shape[dim] //= n
        blocks = x.reshape(shape[:dim] + [n] + shape[dim:]).movedim(dim, 0)
        out = x.new_empty(shape)
        dist.reduce_scatter_tensor(
            out, blocks.contiguous().view([n * shape[0]] + shape[1:]),
            group=self.groups[axis])
        return out

    def all_reduce(self, x: torch.Tensor, axes=None) -> torch.Tensor:
        """The sum of ``x`` over the ranks that differ on ``axes`` (every
        axis by default: one all-reduce over the whole grid), in place."""
        axes = self.axis_names if axes is None else tuple(axes)
        if not axes or all(self.groups[a] is None for a in axes):
            return x
        import torch.distributed as dist
        if set(axes) == set(self.axis_names):
            dist.all_reduce(x, group=self.groups["*"])
        else:
            for a in axes:
                dist.all_reduce(x, group=self.groups[a])
        return x

    def barrier(self):
        if self.groups["*"] is not None:
            import torch.distributed as dist
            kw = {}
            if dist.get_backend(self.groups["*"]) == "nccl":
                kw["device_ids"] = [self.device.index or 0]
            dist.barrier(group=self.groups["*"], **kw)


def _rank_grid(shape, axes, device=None) -> RankGrid:
    """The grid over the default process group, which must hold exactly
    ``prod(shape)`` ranks (one process per rank)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    size, rank = _world()
    if size != n:
        raise ValueError(
            f"a {shape} grid needs {n} ranks, the process group has {size}:"
            " the port runs one process per rank")
    coords, r = [], rank
    for k in reversed(shape):
        coords.append(r % k)
        r //= k
    coords = tuple(reversed(coords))
    groups = {a: None for a in axes + ("*",)}
    if _initialised():
        import torch.distributed as dist
        strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        for i, a in enumerate(axes):
            # every rank makes every group, in the same order
            others = [range(k) for j, k in enumerate(shape) if j != i]
            for rest in itertools.product(*others):
                full = list(rest)
                full.insert(i, 0)
                base = sum(c * s for c, s in zip(full, strides))
                ranks = [base + c * strides[i] for c in range(shape[i])]
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[a] = g
        groups["*"] = dist.group.WORLD
        if device is None and dist.get_backend() == "gloo":
            device = torch.device("cpu")
    # NCCL, or no process group: the card unless the caller asks for the CPU
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return RankGrid(axis_names=axes, sizes=shape, coords=coords,
                    groups=groups, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None
                         ) -> RankGrid:
    """The reference's production mesh as a grid of ranks: (16, 16) over
    ("data", "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if _world()[0] < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {_world()[0]}: start them "
            "under torch.distributed (one process per card)")
    return _rank_grid(shape, axes, device)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device=None) -> RankGrid:
    """A small grid for tests: ``prod(shape)`` ranks of the default
    process group (gloo ranks on the CPU, ``launch.run_ranks``), or a grid
    of ones without torch.distributed (on the card unless ``device="cpu"``)."""
    return _rank_grid(shape, axes, device)

"""Rank bodies of the port's mesh tests (``tests/test_torch_mesh*.py``):
module-level functions that ``repro_torch.distributed.launch.run_ranks``
runs in spawned processes, one per rank of a gloo group on the CPU.
Imports torch, numpy and ``repro_torch`` only (no JAX in the ranks)."""
import numpy as np
import torch


def _np(state: dict) -> dict:
    return {k: v.numpy().copy() for k, v in state.items()}


def mesh_runs(rank: int, runs: list) -> list:
    """Each run ``(C, trace, kw)`` through ``simulate_trace`` on this rank's
    mesh (``make_shard_mesh(kw["shards"])`` over the group): (hits, extra,
    hit flags, the canonical final state as numpy)."""
    torch.set_num_threads(1)
    from repro_torch.core.device_simulate import simulate_trace
    from repro_torch.distributed.mesh import make_shard_mesh
    out = []
    for C, trace, kw in runs:             # kw may carry warmup= too
        mesh = make_shard_mesh(kw["shards"])
        r, st, h = simulate_trace(np.asarray(trace), C, mesh=mesh,
                                  return_state=True, device="cpu", **kw)
        out.append((r.hits, r.extra, h.numpy().copy(), _np(st)))
    return out


def placement(rank: int, n_shards: int) -> tuple:
    """This rank's view of ``make_shard_mesh(n_shards)`` and
    ``shard_placement(n_shards)`` over the group."""
    from repro_torch.distributed.mesh import make_shard_mesh, shard_placement
    mesh = make_shard_mesh(n_shards)
    x = torch.full((2, 3), rank, dtype=torch.int32)
    return (mesh.size, mesh.rank, list(mesh.owned(n_shards)),
            shard_placement(n_shards), mesh.all_gather(x).tolist())


def sweep_rows(rank: int, trace, caps, kw: dict) -> list:
    """``simulate_sweep`` of a meshed grid on this rank, and the
    ``ValueError`` messages of its mesh guards."""
    from repro_torch.core.device_simulate import simulate_sweep
    from repro_torch.distributed.mesh import make_shard_mesh
    mesh = make_shard_mesh(kw["shards"])
    rows = simulate_sweep(np.asarray(trace), caps, mesh=mesh, device="cpu",
                          **kw)
    errs = []
    for bad in (dict(mode="vmap"), dict(shards=1)):
        try:
            simulate_sweep(np.asarray(trace), caps, mesh=mesh, device="cpu",
                           **{**kw, **bad})
        except ValueError as e:
            errs.append(str(e))
    return [(r.hits, r.extra) for r in rows], errs


def checkpointed(rank: int, C: int, trace, kw: dict, ckdir: str,
                 every: int, resume: bool) -> tuple:
    """A checkpointed run of ``trace`` on this rank's mesh (``kw["mesh"]``:
    ``"chunk"`` or ``"stale"``; None, no mesh), or with ``resume`` the
    resume from the latest checkpoint in ``ckdir``.  Returns (hits, hit
    flags, canonical final state)."""
    torch.set_num_threads(1)
    from repro_torch.core.device_simulate import (DeviceWTinyLFU,
                                                  resume_trace)
    from repro_torch.distributed.mesh import make_shard_mesh
    kw = dict(kw)
    exchange = kw.pop("mesh")
    climb = kw.pop("climb", None)
    mesh = make_shard_mesh(kw["shards"]) if exchange else None
    cfg = DeviceWTinyLFU(C, mesh=mesh, mesh_exchange=exchange or "chunk",
                         **kw)
    trace = np.asarray(trace)
    if resume:
        r, st, h = resume_trace(trace, cfg, checkpoint_dir=ckdir,
                                checkpoint_every=every, climb=climb,
                                return_state=True, device="cpu")
    else:
        r, st, h = cfg.run(trace, checkpoint_dir=ckdir, climb=climb,
                           checkpoint_every=every, return_state=True,
                           device="cpu")
    return r.hits, h.numpy().copy(), _np(st), r.extra.get("resumed_at")


def many(rank: int, calls: list) -> list:
    """Several of the bodies above in one group: ``calls`` is a list of
    (function name, arguments after the rank)."""
    return [globals()[name](rank, *args) for name, args in calls]

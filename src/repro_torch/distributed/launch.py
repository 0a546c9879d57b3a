"""Run a function on the ranks of a ``torch.distributed`` group, one process
per rank, on one host.

The ranks meet through a ``FileStore`` in a directory the caller gives, so no
port is opened for the rendezvous.  Each rank calls ``fn(rank, *args)``
between ``init_process_group`` and ``destroy_process_group`` (the latter in a
``finally``) and its return value comes back to the caller; a rank that
raises, or a run that outlives ``timeout``, kills every rank and raises here,
so a hung rank fails its caller instead of stalling it.
"""
from __future__ import annotations

import os
import queue
import time
import traceback

import torch.multiprocessing as mp


def _rank_main(rank: int, n: int, backend: str, store_path: str, fn, args,
               out):
    import torch.distributed as dist
    try:
        if backend == "gloo":       # rank pairs meet on the loopback
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=n)
        try:
            out.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:           # reported, then the caller kills all
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, n: int, workdir: str, *args, backend: str = "gloo",
              timeout: float = 120.0) -> list:
    """``[fn(0, *args), ..., fn(n - 1, *args)]``, each in its own spawned
    process, rank r of an n-rank ``backend`` group.  ``fn`` and its
    arguments and results must pickle (``fn`` a module-level function)."""
    os.makedirs(workdir, exist_ok=True)
    store_path = os.path.join(workdir, f"store-{os.getpid()}-{time.time_ns()}")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, backend, store_path, fn, args, out))
             for r in range(n)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"run_ranks: {n - len(results)} of {n} "
                                   f"ranks still running after {timeout} s")
            try:
                rank, ok, val = out.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"run_ranks: a rank exited with code "
                                       f"{dead[0].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{val}")
            results[rank] = val
    finally:
        for p in procs:
            if p.is_alive():
                p.join(timeout=5 if len(results) == n else 0)
            if p.is_alive():
                p.kill()
                p.join()
        try:
            os.remove(store_path)
        except OSError:
            pass
    return [results[r] for r in range(n)]

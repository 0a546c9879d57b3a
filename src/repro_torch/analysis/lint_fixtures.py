"""Deliberately bad engine programs, one per active lint rule.

Counterpart of the reference's ``repro/analysis/lint_fixtures.py``.  Each
function takes a device and returns ``(runs, LintBounds)`` that must make
:func:`repro_torch.analysis.program_lint.lint_program` report its rule:
they are the negative tests of ``tests/test_torch_program_lint.py``.  Each
is the engine's chunk loop (``device_simulate.run_chunks``) on a real
configuration with one fault put in:

* R0: the loop runs the plain version (``step_ref``), never ``step``;
* R1: a ``.item()`` per chunk, a host read that waits for the card;
* R2: a per-access op loop that writes a quarter of ``mtab`` per access;
* R3: a ``clone()`` of ``mtab`` per chunk;
* R5: ``state["counters"]`` rebound to a new tensor inside the loop;
* R6: an ``all_reduce`` per chunk in the stale mesh mode;
* R7: an override that changes the instance (``assoc=4``), where the
  identical program was expected.
"""
from __future__ import annotations

from dataclasses import replace
from functools import partial

from .program_lint import (ACCESSES, MESH_CFG, T_STEP, T_TAIL, LintBounds,
                           _device, entry_trace, mesh_bounds, pin_recording,
                           process_group, record_program)

_CFG = dict(capacity=2048, assoc=8)


def _bad_runs(fn_of, device, cfg=_CFG, trips=(T_STEP,), mesh=None,
              fold_of=None, n=ACCESSES):
    """The chunk loop of ``DeviceWTinyLFU(**cfg)`` over the matrix trace's
    first ``n`` accesses, recorded at each chunk length in ``trips``, with
    ``fn_of(step_fn)`` as its step function (and ``fold_of(spec, mesh)``
    as its fold)."""
    from repro_torch.core import device_simulate as ds
    from repro_torch.kernels.sketch_step import init_step_state, step
    dev = _device(device)
    runs = []
    for trip in trips:
        kw = dict(cfg, merge_every=trip) if cfg.get("shards", 1) > 1 else cfg
        c = ds.DeviceWTinyLFU(mesh=mesh, **kw)
        spec, params = c.spec(), c.params(device=dev)
        if mesh is None:
            state = init_step_state(spec, c.window_cap, c.main_cap,
                                    device=dev)
        else:
            state = ds._to_mesh_state(spec, init_step_state(
                replace(spec, mesh_devices=0), c.window_cap, c.main_cap,
                device=dev), mesh)
        lo, hi = ds._trace_lanes(entry_trace(n), dev)
        base = step if mesh is None else partial(step, rank=mesh.rank)
        fold = None if fold_of is None else fold_of(spec, mesh)
        runs.append(record_program(lambda: ds.run_chunks(
            spec, params, state, lo, hi, trip, fn=fn_of(base), fold=fold),
            dev))
    return runs, LintBounds(access_trips=tuple(trips), accesses=n)


def bad_r0_plain_loop(device=None):
    """The loop drives the plain version directly: no launch (one chunk and
    a tail: every plain op is recorded)."""
    from repro_torch.kernels.sketch_step import step_ref
    return _bad_runs(lambda base: step_ref, device, n=T_STEP + T_TAIL)


def bad_r1_item_per_chunk(device=None):
    """A hit count read back with ``.item()`` after every chunk."""
    from repro_torch.kernels.sketch_step import R_HITS

    def fn_of(base):
        def fn(spec, params, state, *a):
            out = base(spec, params, state, *a)
            state["regs"][R_HITS].item()
            return out
        return fn
    return _bad_runs(fn_of, device)


def bad_r2_per_access_write(device=None):
    """A per-access op loop writing a quarter of the main table each
    access: O(capacity) work per access outside the launch."""
    def fn_of(base):
        def fn(spec, params, state, lo, hi, n_valid, probes):
            quarter = state["mtab"].shape[0] // 4
            for _ in range(n_valid):
                state["mtab"][:quarter].add_(0)
            return base(spec, params, state, lo, hi, n_valid, probes)
        return fn
    return _bad_runs(fn_of, device)


def bad_r3_table_clone(device=None):
    """A whole-table copy per chunk (``mtab.clone()``)."""
    def fn_of(base):
        def fn(spec, params, state, *a):
            state["mtab"].clone()
            return base(spec, params, state, *a)
        return fn
    return _bad_runs(fn_of, device)


def bad_r5_rebound_leaf(device=None):
    """``state["counters"]`` rebound to a copy in the first chunk: the
    loop ends on another tensor than it started with."""
    def fn_of(base):
        rebound = []

        def fn(spec, params, state, *a):
            if not rebound:
                state["counters"] = state["counters"].clone()
                rebound.append(True)
            return base(spec, params, state, *a)
        return fn
    return _bad_runs(fn_of, device)


def bad_r6_allreduce_per_chunk(device=None):
    """An ``all_reduce`` of the registers in every chunk of a stale mesh
    run (the per-access collective bug class, at chunk granularity), on the
    caller's process group or a one-rank group made for it."""
    import torch.distributed as dist
    from repro_torch.distributed.mesh import make_shard_mesh
    from repro_torch.kernels.sketch_merge import merge_halve_mesh
    dev = _device(device)

    def fn_of(base):
        def fn(spec, params, state, *a):
            out = base(spec, params, state, *a)
            dist.all_reduce(state["regs"].clone())
            return out
        return fn

    def fold_of(spec, mesh):
        return lambda sp, p, st: merge_halve_mesh(sp, p, st, mesh)

    with process_group(dev):
        mesh = make_shard_mesh(MESH_CFG["shards"], device=dev)
        runs, _ = _bad_runs(fn_of, dev, dict(MESH_CFG, mesh_exchange="stale"),
                            mesh=mesh, fold_of=fold_of)
    return runs, replace(mesh_bounds("stale"), access_trips=(T_STEP,))


def bad_r7_changed_instance(device=None):
    """The pin program and an override that is not a default (``assoc=4``
    against the base's 8 ways), where R7 wants the identical program."""
    return ([pin_recording(device), pin_recording(device, assoc=4)],
            LintBounds(identical=True))


#: rule id -> fixture (R4 is not applicable and has none)
FIXTURES = {
    "R0": bad_r0_plain_loop,
    "R1": bad_r1_item_per_chunk,
    "R2": bad_r2_per_access_write,
    "R3": bad_r3_table_clone,
    "R5": bad_r5_rebound_leaf,
    "R6": bad_r6_allreduce_per_chunk,
    "R7": bad_r7_changed_instance,
}

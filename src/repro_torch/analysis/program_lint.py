"""Lint of the engine's recorded programs: the in-place discipline as rules.

Counterpart of the reference's ``repro/analysis/program_lint.py``.  The
reference parses the HLO XLA compiled for an engine run; the port has no
compiler between it and the card, so its program is what the host
dispatches for a run: the step launches, the folds and every aten op
outside a launch, in order (:mod:`repro_torch.analysis.program_trace`).
:func:`record_program` records a run on either device; :func:`lint_program`
checks the rules over the recording, without running anything.  The rules
keep the reference's ids and contracts (``RULES``):

``R0``  the chunk loop exists and makes exactly one step launch per chunk,
        ceil(n / chunk) per run (per merge or climb epoch when the run
        folds).  Without it the other rules' scoping is void.
``R1``  no per-access dispatch: the engine's ops per chunk, outside the
        launch, are one constant at every chunk length, and the chunk loop
        reads nothing back to the host (on the card also under
        ``torch.cuda.set_sync_debug_mode("error")``).
``R2``  no table-shaped write (``table_elems_floor`` elements or more) in
        the chunk loop outside the folds; a fold writes a fixed number of
        them per epoch.
``R3``  no table-shaped copy or allocation in the chunk loop outside the
        folds (a clone, cat or copy of a state leaf per chunk); a fold makes
        a fixed number per epoch.
``R4``  not applicable: XLA-CPU's ``outer_dimension_partitions`` thread
        dispatch has no counterpart in a hand-written kernel.  Never
        reported.
``R5``  state updated in place: every leaf keeps its data pointer and
        storage from the loop's start to its end (and, where the entry asks,
        from the caller's state to the returned one), and no table-shaped
        copy of a leaf is made at entry or exit beyond the ones the engine
        documents (the chunk-mode mesh's gather and split).
``R6``  collective cadence: ``mesh_exchange="chunk"`` exchanges at entry and
        exit only, ``"stale"`` makes exactly the fold's gathers once per
        epoch and none elsewhere, a single device makes none.
``R7``  identical programs: spelling out a default (``shards=1``,
        ``streams=1``, ``policy="wtinylfu"``, ``adaptive=False``,
        ``integrity=False``) records the identical program, rendered as text
        with one line per event, and its SHA-256 digest matches the
        committed registry (``fingerprints.json``, keyed by torch version
        and device).

:func:`default_matrix` and :func:`run_matrix` run the engine over the
reference's 15 configurations (flat/assoc x static/adaptive x shards x
streams x policy x mesh chunk/stale), each at two chunk lengths; the mesh
entries run on two gloo ranks on the CPU (``distributed.launch.run_ranks``)
or on the caller's process group.  On the card every recorded run is also
profiled: its ``sketch_step`` kernels must equal its launch events.

  PYTHONPATH=src python -m repro_torch.analysis.program_lint --device cpu
  PYTHONPATH=src python -m repro_torch.analysis.program_lint   # the card

Exit codes: 0 clean (waived findings allowed), 1 violations, 2 internal
error.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.analysis import program_trace

# ---------------------------------------------------------------------------
# rule table (ids -> one-line contract; rendered by --list-rules)
# ---------------------------------------------------------------------------

RULES = {
    "R0": "the chunk loop exists and makes one step launch per chunk: "
          "ceil(n / chunk) per run (per merge or climb epoch when it folds)",
    "R1": "no per-access dispatch: engine ops per chunk are one constant at "
          "every chunk length, and the chunk loop makes no host read",
    "R2": "no table-shaped write in the chunk loop outside the folds; a fold "
          "writes a fixed number per epoch",
    "R3": "no table-shaped copy or allocation in the chunk loop outside the "
          "folds; a fold makes a fixed number per epoch",
    "R4": "not applicable: XLA-CPU's outer_dimension_partitions thread "
          "dispatch has no counterpart in a hand-written kernel (never "
          "reported)",
    "R5": "state updated in place: every leaf keeps its storage through the "
          "run, no table-shaped copy at entry beyond the documented ones",
    "R6": "collective cadence: chunk = entry/exit only, stale = the fold's "
          "gathers once per epoch, single-device = none",
    "R7": "identical programs: spelling out a default records the identical "
          "program, digest matches the committed registry",
}

# the reference's sizes, deliberately not powers of two so that no chunk or
# trace shape can coincide with a table's
T_STEP = 96          # plain step programs: accesses per chunk
E_EPOCH = 192        # runner programs: accesses per merge/climb epoch
NE_EPOCHS = 2        # full epochs per recorded run
T_TAIL = 23          # accesses in the partial tail chunk after them
B_LANES = 4          # lane-batched entries

TRIPS = (T_STEP, E_EPOCH)                   # each entry runs at both lengths
ACCESSES = NE_EPOCHS * E_EPOCH + T_TAIL     # 407 accesses a run


@dataclass(frozen=True)
class LintBounds:
    """Per-program parameters the rules check against.

    ``access_trips`` are the chunk lengths of the recorded runs, one per
    run, and ``accesses`` each run's length: R0 expects ceil(accesses /
    trip) launches.  ``table_elems_floor`` is the smallest op output
    (elements) R2/R3/R5 call table-shaped.  ``mesh_exchange`` selects the R6
    contract (None = single device, zero collectives) and
    ``fold_collectives`` the stale fold's count.  ``expect_aliases`` arms
    R5's boundary check with the number of state leaves the run must hand
    back as the caller's own tensors; ``entry_copies`` is the number of
    table-shaped copies of state leaves the engine documents outside the
    loop.  ``first_launch_reads`` host reads are allowed before the first
    launch (a state not marked in range is checked once).  ``identical``
    asks R7 that every run record the identical program.
    """
    access_trips: tuple = ()
    accesses: int = 0
    table_elems_floor: int = 1024
    mesh_exchange: str | None = None
    fold_collectives: int = 0
    expect_aliases: int | None = None
    entry_copies: int = 0
    first_launch_reads: int = 0
    identical: bool = False


@dataclass
class Violation:
    rule: str
    config: str
    where: str
    message: str

    def __str__(self):
        return f"[{self.rule}] {self.config}: {self.message} ({self.where})"

    def to_dict(self):
        return {"rule": self.rule, "config": self.config,
                "where": self.where, "message": self.message}


@dataclass
class Recording:
    """One recorded run: its events (``program_trace.Recorder``), what the
    run returned, on the card the number of ``sketch_step`` kernels the
    profiler saw (``kernels``) among all its device activities
    (``activities``), and the error of a synchronising call inside the
    chunk loop (``aborted``); ``boundary`` is the (caller's, returned)
    state leaves' ids where the run hands its state back; ``redone``
    counts the profiler sessions of the run that delivered no device
    activity at all, after which it was recorded again."""
    events: list
    result: object = None
    kernels: int | None = None
    activities: int | None = None
    aborted: str = ""
    boundary: tuple | None = None
    redone: int = 0


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

def _device(device) -> torch.device:
    from repro_torch.kernels.sketch_common import resolve_device
    return resolve_device(device)


def _step_kernels(prof) -> tuple[int, int]:
    """(``sketch_step`` kernels, all device activities) of a finished
    profiler run."""
    from torch.autograd import DeviceType
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    return sum("sketch_step_kernel" in n for n in names), len(names)


def record_program(run: Callable, device=None) -> Recording:
    """Run ``run()`` while recording the engine's events; returns the
    :class:`Recording` (``result`` holds what ``run`` returned).  On the
    card the run is profiled and runs its chunk loop under
    ``torch.cuda.set_sync_debug_mode("error")``: a synchronising call there
    ends the run and is recorded as a host read (``aborted``)."""
    card = _device(device).type == "cuda"
    out = Recording(events=[])
    prof = None
    if card:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
    with prof if prof is not None else contextlib.nullcontext():
        try:
            with program_trace.record(sync_debug=card) as rec:
                out.events = rec.events
                out.result = run()
        except RuntimeError as exc:
            if not (card and "synchroniz" in str(exc)):
                raise
            frames = [f for f in traceback.extract_tb(exc.__traceback__)
                      if "repro_torch" in f.filename
                      and not f.filename.endswith("program_trace.py")]
            at = (f" at {Path(frames[-1].filename).name}:{frames[-1].lineno}"
                  f" ({frames[-1].name}: {frames[-1].line})"
                  if frames else "")
            out.aborted = str(exc).splitlines()[0] + at
            out.events.append(("op", "<synchronizing call>", "host_read",
                               ()))
        if card:
            torch.cuda.synchronize()
    if prof is not None:
        out.kernels, out.activities = _step_kernels(prof)
    return out


def _dropped(rec: Recording) -> bool:
    """Whether the profiler delivered nothing for a run that launched: not
    one device activity, where the run's hashing alone makes dozens (a
    session CUPTI dropped; seen once in a full chip_smoke run)."""
    return rec.activities == 0 and bool(_launches(rec.events))


# ---------------------------------------------------------------------------
# the linter core: pure analysis of recorded events
# ---------------------------------------------------------------------------

@dataclass
class _Scopes:
    """A run's events cut at its marks: before the loop, each chunk, each
    fold, after the loop; and the loop marks' leaf ids."""
    entry: list = field(default_factory=list)
    chunks: list = field(default_factory=list)
    folds: list = field(default_factory=list)
    exit: list = field(default_factory=list)
    loop_begin: tuple | None = None
    loop_end: tuple | None = None


def _scopes(events) -> _Scopes:
    s = _Scopes()
    cur = s.entry
    for e in events:
        if e[0] != "mark":
            cur.append(e)
            continue
        what = e[1]
        if what == "loop_begin":
            s.loop_begin = e[2]
            cur = []                      # between marks: not a chunk
        elif what == "chunk":
            cur = []
            s.chunks.append(cur)
        elif what == "fold":
            cur = []
            s.folds.append(cur)
        elif what == "fold_end":
            cur = []
        elif what == "loop_end":
            s.loop_end = e[2]
            cur = s.exit
    return s


def _ops(events, cls=None):
    return [e for e in events if e[0] == "op"
            and (cls is None or e[2] == cls)]


def _numel(shapes) -> int:
    return max((math.prod(s) for s in shapes), default=0)


def _big(events, cls, floor):
    return [e for e in _ops(events, cls) if _numel(e[3]) >= floor]


def _launches(events):
    return [e for e in events if e[0] == "launch" and e[1] == "sketch_step"]


def render(events) -> str:
    """A recorded program as text, one line per event (addresses left
    out, so two runs of one program render alike)."""
    lines = []
    for e in events:
        if e[0] == "op":
            lines.append(f"op {e[1]} {e[2]} {list(e[3])}")
        elif e[0] in ("launch", "fold"):
            lines.append(f"{e[0]} {e[1]} "
                         + " ".join(f"{k}={v}" for k, v in e[2]))
        elif e[1] in ("loop_begin", "loop_end"):
            lines.append(f"mark {e[1]} "
                         + " ".join(f"{k}{list(shape)}"
                                    for k, _, _, shape in e[2]))
        else:
            lines.append(f"mark {e[1]}"
                         + ("" if e[2] is None else f" {e[2]}"))
    return "\n".join(lines) + "\n"


def _lint_run(run: Recording, i: int, bounds: LintBounds, config: str,
              stats: dict) -> list:
    trip = (bounds.access_trips[i] if i < len(bounds.access_trips)
            else None)
    here = f"run {i}" + (f" (chunk {trip})" if trip else "")
    out: list[Violation] = []

    def v(rule, where, msg):
        out.append(Violation(rule, config, f"{here}{where}", msg))

    s = _scopes(run.events)
    floor = bounds.table_elems_floor

    # R0: the chunk loop and one launch per chunk
    launches = _launches(run.events)
    if s.loop_begin is None:
        v("R0", "", "no chunk loop was recorded: the engine's run_chunks "
          "did not run, so the other rules' scoping is void")
    if trip and bounds.accesses:
        want = -(-bounds.accesses // trip)
        if len(launches) != want:
            v("R0", "", f"{len(launches)} step launches, expected "
              f"ceil({bounds.accesses} / {trip}) = {want}: one launch per "
              "chunk")
    for c, ev in enumerate(s.chunks):
        k = len(_launches(ev))
        if k != 1:
            v("R0", f" / chunk {c}", f"{k} step launches in one chunk, "
              "expected 1")
    if run.kernels is not None and run.kernels != len(launches):
        v("R0", "", f"the profiler saw {run.kernels} sketch_step kernels "
          f"for {len(launches)} recorded launches")

    # R1: host reads in the loop; ops per chunk
    allowed = bounds.first_launch_reads
    for c, ev in enumerate(s.chunks):
        reads = _ops(ev, "host_read")
        if c == 0 and allowed:
            first = next((j for j, e in enumerate(ev) if e[0] == "launch"),
                         len(ev))
            early = _ops(ev[:first], "host_read")
            reads = reads[min(allowed, len(early)):]
        for e in reads:
            v("R1", f" / chunk {c} / {e[1]}", "host read inside the chunk "
              "loop: every chunk waits for the card")
        if not (c == 0 and allowed):    # the first chunk's check is once
            stats["chunk_ops"].setdefault(here, []).append(len(_ops(ev)))
    for f, ev in enumerate(s.folds):
        for e in _ops(ev, "host_read"):
            v("R1", f" / fold {f} / {e[1]}", "host read inside a fold: "
              "every epoch waits for the card")
    if run.aborted:
        v("R1", "", f"a synchronising call inside the chunk loop: "
          f"{run.aborted}")

    # R2/R3: table-shaped writes and allocations per chunk, per fold
    for c, ev in enumerate(s.chunks):
        for e in _big(ev, "write", floor):
            v("R2", f" / chunk {c} / {e[1]}",
              f"writes {_numel(e[3])} elements outside the launch (floor "
              f"{floor}): a table-shaped write per chunk")
        for e in _big(ev, "alloc", floor):
            v("R3", f" / chunk {c} / {e[1]}",
              f"allocates {_numel(e[3])} elements outside the launch "
              f"(floor {floor}): a table-shaped copy per chunk")
    for ev in s.folds:
        stats["fold_writes"].setdefault(here, []).append(
            len(_big(ev, "write", floor)))
        stats["fold_allocs"].setdefault(here, []).append(
            len(_big(ev, "alloc", floor)))

    # R5: in place through the loop, at the boundary, no entry copies
    if s.loop_begin is not None and s.loop_end is not None:
        before = {k: (p, sp) for k, p, sp, _ in s.loop_begin}
        after = {k: (p, sp) for k, p, sp, _ in s.loop_end}
        for k in sorted(set(before) | set(after)):
            if before.get(k) != after.get(k):
                v("R5", f" / {k}", f"state[{k!r}] is another tensor at the "
                  "loop's end than at its start: the state was not updated "
                  "in place")
    if bounds.expect_aliases is not None and run.boundary is not None:
        cin, cout = ({k: (p, sp) for k, p, sp, _ in ids}
                     for ids in run.boundary)
        kept = sum(1 for k in cin if cout.get(k) == cin[k])
        if kept < bounds.expect_aliases:
            v("R5", " / boundary", f"only {kept} of "
              f"{bounds.expect_aliases} state leaves came back as the "
              "caller's own tensors")
    if s.loop_begin is not None:
        leaf_shapes = {shape for _, _, _, shape in s.loop_begin
                       if math.prod(shape) >= floor}
        copies = [e for e in _ops(s.entry + s.exit, "alloc")
                  if any(sh in leaf_shapes for sh in e[3])]
        if len(copies) > bounds.entry_copies:
            v("R5", " / entry", f"{len(copies)} table-shaped copies of state "
              f"leaves outside the loop ({', '.join(e[1] for e in copies)}"
              f"), the engine documents {bounds.entry_copies}")

    # R6: collective cadence
    coll_chunks = [(c, e) for c, ev in enumerate(s.chunks)
                   for e in _ops(ev, "collective")]
    coll_folds = [len(_ops(ev, "collective")) for ev in s.folds]
    coll_out = _ops(s.entry + s.exit, "collective")
    if bounds.mesh_exchange is None:
        for e in _ops(run.events, "collective"):
            v("R6", f" / {e[1]}", f"{e[1]} in a single-device run")
    elif bounds.mesh_exchange == "chunk":
        for c, e in coll_chunks:
            v("R6", f" / chunk {c} / {e[1]}", f"{e[1]} inside the chunk "
              "loop: chunk mode exchanges at entry and exit only (the "
              "per-access collective bug class)")
        for f, k in enumerate(coll_folds):
            if k:
                v("R6", f" / fold {f}", f"{k} collectives inside a fold: "
                  "chunk mode exchanges at entry and exit only")
    else:                               # "stale": the fold's gathers only
        for c, e in coll_chunks:
            v("R6", f" / chunk {c} / {e[1]}", f"{e[1]} inside a chunk: "
              "stale mode's one exchange is the per-epoch "
              "merge_halve_mesh fold")
        for f, k in enumerate(coll_folds):
            if k != bounds.fold_collectives:
                v("R6", f" / fold {f}", f"{k} collectives in a fold, "
                  f"expected the fold's {bounds.fold_collectives} gathers")
        for e in coll_out:
            v("R6", f" / {e[1]}", f"{e[1]} outside the loop: stale mode "
              "exchanges in the fold only")
    return out


def lint_program(runs: list, bounds: LintBounds, config: str = "") -> list:
    """Lint one entry's recorded runs (one per ``bounds.access_trips``)
    against ``bounds``.  Pure: nothing runs."""
    out: list[Violation] = []
    stats = {"chunk_ops": {}, "fold_writes": {}, "fold_allocs": {}}
    for i, run in enumerate(runs):
        out += _lint_run(run, i, bounds, config, stats)
    per_chunk = {n for counts in stats["chunk_ops"].values() for n in counts}
    if len(per_chunk) > 1:
        out.append(Violation(
            "R1", config, "chunk loop",
            f"engine ops per chunk vary ({stats['chunk_ops']}): work outside "
            "the launch grows with the chunk, a per-access dispatch"))
    for key, rule, what in (("fold_writes", "R2", "writes"),
                            ("fold_allocs", "R3", "allocations")):
        counts = {n for c in stats[key].values() for n in c}
        if len(counts) > 1:
            out.append(Violation(
                rule, config, "folds",
                f"table-shaped {what} per fold vary ({stats[key]}): a fold "
                "makes a fixed number per epoch"))
    if bounds.identical and runs:
        base = render(runs[0].events)
        for i, run in enumerate(runs[1:], 1):
            if render(run.events) != base:
                out.append(Violation(
                    "R7", config, f"run {i}",
                    "a different program than run 0 where the identical "
                    "one was expected"))
    return out


# ---------------------------------------------------------------------------
# R7: the fingerprint registry
# ---------------------------------------------------------------------------

REGISTRY_PATH = Path(__file__).with_name("fingerprints.json")

# the reference's canonical pin geometry
_FP_BASE = dict(width=256, rows=4, dk_bits=1024, window_slots=8,
                main_slots=64, assoc=8)

# contract name -> StepSpec override that must record the identical program
# to the base spec (the override merely spells out a default)
FINGERPRINT_CONTRACTS = {
    "shards1": {"shards": 1},
    "policy-default": {"policy": "wtinylfu"},
    "streams1": {"streams": 1},
    "adaptive-off": {"adaptive": False},
    "integrity-off": {"integrity": False},
}
_PIN_CHUNK = 8                       # the pin run: 16 keys in two chunks


def env_key(device=None) -> str:
    """Recorded programs may vary across torch versions and devices;
    digests are only comparable within one of them."""
    return f"torch-{torch.__version__}-{_device(device).type}"


def pin_recording(device=None, **overrides) -> Recording:
    """Record the canonical pin program: ``run_chunks`` of the base spec
    (with ``overrides``) over the keys 0..15 in two chunks, on a fresh
    state, with the reference's pin params."""
    from repro_torch.core.device_simulate import run_chunks
    from repro_torch.kernels.sketch_common import keys_to_lanes
    from repro_torch.kernels.sketch_step import (StepSpec, init_step_state,
                                                 make_step_params)
    dev = _device(device)
    spec = StepSpec(**{**_FP_BASE, **overrides})
    params = make_step_params(4, 48, 38, 700, 7, 0, device=dev)
    state = init_step_state(spec, device=dev)
    lo, hi = (torch.from_numpy(x).to(dev) for x in keys_to_lanes(
        np.arange(16, dtype=np.uint64)))
    return record_program(
        lambda: run_chunks(spec, params, state, lo, hi, _PIN_CHUNK), dev)


def pin_program_text(device=None, **overrides) -> str:
    """The canonical pin program (:func:`pin_recording`) as text."""
    return render(pin_recording(device, **overrides).events)


def _digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def load_registry(path: Path = REGISTRY_PATH) -> dict:
    if Path(path).exists():
        return json.loads(Path(path).read_text())
    return {}


def check_fingerprints(update: bool = False,
                       registry_path: Path = REGISTRY_PATH,
                       contracts: dict | None = None, device=None):
    """Verify every identical-program contract; returns ``(violations,
    notes)``.  Pair equality (base text == variant text) is always
    enforced; the committed digest is only compared when the registry has
    an entry for this environment (``--update`` writes one)."""
    contracts = FINGERPRINT_CONTRACTS if contracts is None else contracts
    violations: list[Violation] = []
    notes: list[str] = []
    base = pin_program_text(device)
    key = env_key(device)
    reg = load_registry(registry_path)
    env = reg.get(key, {})
    digests = {"base": _digest(base)}
    for name, ov in contracts.items():
        var = pin_program_text(device, **ov)
        digests[name] = _digest(var)
        if var != base:
            violations.append(Violation(
                "R7", name, "recording",
                f"spelling out the default ({ov}) records a DIFFERENT "
                "program — an identical-program contract broke"))
    if update:
        reg[key] = digests
        Path(registry_path).write_text(
            json.dumps(reg, indent=2, sort_keys=True) + "\n")
        notes.append(f"registry updated for {key} "
                     f"({len(digests)} digests)")
        return violations, notes
    if not env:
        notes.append(f"no registry entry for {key} — digest check skipped "
                     "(pair equality still enforced); run python -m "
                     "repro_torch.analysis.program_lint --update to pin "
                     "this environment")
        return violations, notes
    for name, dg in digests.items():
        want = env.get(name)
        if want is None:
            notes.append(f"contract {name!r} not in registry for {key}")
        elif want != dg:
            violations.append(Violation(
                "R7", name, key,
                "recorded-program digest drifted from the committed "
                "registry — if the change is intentional, refresh with "
                "python -m repro_torch.analysis.program_lint --update"))
    return violations, notes


def assert_identical_program(name: str, device=None):
    """Test-facing one-liner for the identical-program pins: records the
    base and the ``name`` contract's variant, asserts they render alike,
    and (when this environment is pinned) the committed digest."""
    ov = FINGERPRINT_CONTRACTS[name]
    base = pin_program_text(device)
    var = pin_program_text(device, **ov)
    assert var == base, (
        f"contract {name!r}: spelling out the default {ov} recorded a "
        "different program")
    env = load_registry().get(env_key(device), {})
    if env:
        assert _digest(var) == env[name], (
            f"contract {name!r}: program digest drifted from the committed "
            "fingerprints.json — refresh with python -m "
            "repro_torch.analysis.program_lint --update if intentional")


# ---------------------------------------------------------------------------
# the configuration matrix: run live, linted from the recording
# ---------------------------------------------------------------------------

class SkipEntry(Exception):
    """Raised by an entry's build when its environment prerequisite is
    missing."""


@dataclass
class MatrixEntry:
    label: str
    build: Callable            # () -> (list of Recording, LintBounds)
    note: str = ""
    # rule id -> reason: known, documented debt.  Waived violations are
    # still reported (status "waived") but do not fail the run; each one is
    # listed in ROADMAP queue 3.
    waive: dict = field(default_factory=dict)


def entry_trace(n: int = ACCESSES, streams: int = 1, seed: int = 5):
    """The matrix's key trace: Zipf(0.9) over 4,096 items, ``(n,)`` or one
    row per lane."""
    from repro_torch.traces.synthetic import zipf_trace
    rows = [zipf_trace(n, n_items=4096, alpha=0.9, seed=seed + i)
            for i in range(streams)]
    return rows[0] if streams == 1 else np.stack(rows)


def record_segment(cfg_kwargs: dict, trip: int, trace, device=None,
                   mesh=None) -> Recording:
    """Record one engine run of ``DeviceWTinyLFU(**cfg_kwargs)`` over
    ``trace`` through ``device_simulate._segment`` (the runner
    ``DeviceWTinyLFU.run`` drives), ``trip`` accesses a chunk: the static
    run's chunk, the sharded run's merge epoch or the adaptive run's climb
    epoch.  The state is made before the recording starts, as a caller's
    would be.  On the card, a run whose profiler session delivered no
    device activity at all is recorded again on a new state, at most twice
    (``Recording.redone``); R0 holds the last session's kernels to the
    launches."""
    from repro_torch.core import device_simulate as ds
    from repro_torch.kernels.sketch_step import init_step_state
    dev = _device(device)
    kw = dict(cfg_kwargs)
    if kw.get("shards", 1) > 1:
        kw["merge_every"] = trip
    cfg = ds.DeviceWTinyLFU(mesh=mesh, **kw)
    spec = cfg.spec()
    params = cfg.params(device=dev)
    lo, hi = ds._trace_lanes(np.asarray(trace), dev)
    climb = ds.ClimbSpec(epoch_len=trip)
    cvec = (torch.as_tensor(climb.resolve(cfg), device=dev) if cfg.adaptive
            else None)
    redone = 0
    while True:
        if mesh is None:
            state = init_step_state(spec, cfg.window_cap, cfg.main_cap,
                                    device=dev)
        else:
            flat = init_step_state(replace(spec, mesh_devices=0),
                                   cfg.window_cap, cfg.main_cap, device=dev)
            state = ds._to_mesh_state(spec, flat, mesh)
        ids_in = program_trace.leaf_ids(state)
        rec = record_program(lambda: ds._segment(
            cfg, spec, params, state, lo, hi, climb, cvec, None, trip)[0],
            dev)
        if not _dropped(rec) or redone == 2:
            break
        redone += 1                     # the same run again, on a new state
    rec.redone = redone
    if rec.result is not None:
        rec.boundary = (ids_in, program_trace.leaf_ids(rec.result))
    rec.result = None
    return rec


def engine_program(cfg_kwargs: dict, device=None, trips=TRIPS, trace=None,
                   expect_aliases: bool = False):
    """(runs, bounds) of a single-device engine configuration, recorded at
    each chunk length in ``trips`` over ``trace`` (default
    :func:`entry_trace`)."""
    streams = cfg_kwargs.get("streams", 1)
    trace = entry_trace(streams=streams) if trace is None else trace
    runs = [record_segment(cfg_kwargs, t, trace, device) for t in trips]
    n_leaves = len(runs[0].boundary[0]) if runs[0].boundary else 0
    return runs, LintBounds(
        access_trips=tuple(trips), accesses=np.asarray(trace).shape[-1],
        expect_aliases=n_leaves if expect_aliases else None)


MESH_CFG = dict(capacity=2048, assoc=8, shards=4)


def mesh_rank_programs(rank: int, modes, device: str) -> list:
    """On this rank of the current process group: the recorded runs of
    ``MESH_CFG`` on a ``("shard",)`` mesh, per mode in ``modes``, at each
    chunk length in ``TRIPS`` (a ``distributed.launch.run_ranks`` target)."""
    from repro_torch.distributed.mesh import make_shard_mesh
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)        # two ranks share the host's cores
    mesh = make_shard_mesh(MESH_CFG["shards"], device=dev)
    return [[record_segment(dict(MESH_CFG, mesh_exchange=mode), t,
                            entry_trace(), dev, mesh=mesh) for t in TRIPS]
            for mode in modes]


@contextlib.contextmanager
def process_group(device=None):
    """The caller's ``torch.distributed`` group if there is one; else a
    one-rank group made here (NCCL on the card, gloo on the CPU) and
    destroyed on exit."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        yield
        return
    dev = _device(device)
    with tempfile.TemporaryDirectory(prefix="lint-pg-") as work:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.FileStore(os.path.join(work, "store"), 1), rank=0,
            world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def mesh_programs(modes, device=None) -> list:
    """Per mode, rank 0's recorded runs of the mesh entries: on the
    caller's process group when there is one (chip_smoke's one-rank NCCL
    group), else on two gloo ranks on the CPU (``run_ranks``) or a
    one-rank NCCL group on the card."""
    import torch.distributed as dist
    dev = _device(device)
    if dev.type == "cpu" and not (dist.is_available()
                                  and dist.is_initialized()):
        from repro_torch.distributed.launch import run_ranks
        with tempfile.TemporaryDirectory(prefix="lint-ranks-") as work:
            return run_ranks(mesh_rank_programs, 2, work, list(modes),
                             "cpu", timeout=300.0)[0]
    with process_group(dev):
        return mesh_rank_programs(dist.get_rank(), modes, str(dev))


def mesh_bounds(mode: str) -> LintBounds:
    """The mesh entries' contracts: chunk mode gathers the delta blocks
    into the replica's counters and doorkeeper at entry (two table-shaped
    leaves) and splits them at exit; stale mode's fold gathers the two
    delta blocks once per epoch."""
    return LintBounds(access_trips=TRIPS, accesses=ACCESSES,
                      mesh_exchange=mode,
                      fold_collectives=2 if mode == "stale" else 0,
                      entry_copies=2 if mode == "chunk" else 0)


def _mesh_entry(mode: str, device):
    def build():
        return mesh_programs([mode], device)[0], mesh_bounds(mode)
    return build


def default_matrix(device=None) -> list:
    """The reference's configuration matrix: flat/assoc x static/adaptive x
    shards x streams x policy x mesh chunk/stale, one representative per
    axis value, each run on ``device`` (the card unless ``"cpu"``)."""
    def E(label, cfg, note="", donated=False, **kw):
        return MatrixEntry(label, lambda: engine_program(
            cfg, device, expect_aliases=donated), note=note, **kw)

    return [
        E("flat-static", dict(capacity=512)),
        E("assoc-static", dict(capacity=2048, assoc=8)),
        E("assoc-integrity",
          dict(capacity=2048, assoc=8, shards=4, integrity=True)),
        E("assoc-donated", dict(capacity=2048, assoc=8), donated=True,
          note="R5: every leaf comes back as the caller's own tensor"),
        E("flat-streams4", dict(capacity=512, streams=B_LANES)),
        E("assoc-streams4", dict(capacity=512, assoc=8, streams=B_LANES)),
        E("policy-s3fifo", dict(capacity=2048, assoc=8, policy="s3fifo")),
        E("policy-arc", dict(capacity=2048, assoc=8, policy="arc")),
        E("policy-lfu", dict(capacity=2048, assoc=8, policy="lfu")),
        E("assoc-shards4", dict(capacity=2048, assoc=8, shards=4)),
        E("flat-adaptive", dict(capacity=512, adaptive=True)),
        E("assoc-adaptive", dict(capacity=2048, assoc=8, adaptive=True)),
        E("assoc-adaptive-streams4",
          dict(capacity=512, assoc=8, adaptive=True, streams=B_LANES)),
        MatrixEntry("mesh-chunk", _mesh_entry("chunk", device),
                    note="two gloo ranks on the CPU"),
        MatrixEntry("mesh-stale", _mesh_entry("stale", device),
                    note="two gloo ranks on the CPU"),
    ]


def run_matrix(matrix=None, configs: str | None = None, device=None):
    """Record + lint every matrix entry; returns ``(violations, rows)``
    where rows are report dicts (label, status, violations, waived, each
    run's launches, engine ops and profiled kernels, seconds)."""
    matrix = default_matrix(device) if matrix is None else matrix
    if configs:
        matrix = [e for e in matrix if configs in e.label]
    violations: list[Violation] = []
    rows = []
    for e in matrix:
        t0 = time.monotonic()
        try:
            runs, bounds = e.build()
        except SkipEntry as exc:
            rows.append({"label": e.label, "status": "skipped",
                         "reason": str(exc)})
            continue
        v = lint_program(runs, bounds, config=e.label)
        active = [x for x in v if x.rule not in e.waive]
        waived = [x for x in v if x.rule in e.waive]
        violations += active
        rows.append({"label": e.label,
                     "status": ("fail" if active
                                else "waived" if waived else "ok"),
                     "violations": [x.to_dict() for x in active],
                     "waived": [dict(x.to_dict(), reason=e.waive[x.rule])
                                for x in waived],
                     "trips": list(bounds.access_trips),
                     "launches": [len(_launches(r.events)) for r in runs],
                     "ops": [len(_ops(r.events)) for r in runs],
                     "kernels": [r.kernels for r in runs],
                     "redone": [r.redone for r in runs],
                     "seconds": round(time.monotonic() - t0, 2)})
    return violations, rows


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="lint of the engine's recorded programs (R0-R7)")
    ap.add_argument("--configs", metavar="SUBSTR", default=None,
                    help="only lint matrix entries whose label contains "
                         "SUBSTR")
    ap.add_argument("--update", action="store_true",
                    help="re-pin the R7 fingerprint registry for this "
                         "environment (after an intentional change)")
    ap.add_argument("--report", metavar="PATH", default=None,
                    help="write a JSON report to PATH")
    ap.add_argument("--skip-fingerprints", action="store_true",
                    help="matrix rules only (R0-R6)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions; default the card")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, desc in RULES.items():
            print(f"{rid}  {desc}")
        return 0

    dev = _device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"program lint [{env_key(dev)}], {name}")

    violations, rows = run_matrix(configs=args.configs, device=dev)
    for r in rows:
        mark = {"ok": "ok", "fail": "FAIL", "skipped": "skip",
                "waived": "ok (waived)"}[r["status"]]
        extra = r.get("reason", "") or (
            f"launches {r['launches']}, ops {r['ops']}"
            + (f", kernels {r['kernels']}" if dev.type == "cuda" else "")
            + f", {r['seconds']:.1f}s")
        print(f"  {r['label']:<26} {mark:<12} {extra}")
        for rule in dict.fromkeys(w["rule"] for w in r.get("waived", [])):
            ws = [w for w in r["waived"] if w["rule"] == rule]
            print(f"      waived [{rule}] x{len(ws)}: {ws[0]['reason']}")

    fp_violations, notes = [], []
    if not args.skip_fingerprints and not args.configs:
        fp_violations, notes = check_fingerprints(update=args.update,
                                                  device=dev)
        for n in notes:
            print(f"  fingerprints: {n}")
        if not fp_violations and not args.update:
            print("  fingerprints: R7 ok (pair equality + registry "
                  "digests)")

    all_v = violations + fp_violations
    for v in all_v:
        print(f"  {v}")

    if args.report:
        Path(args.report).write_text(json.dumps({
            "env": env_key(dev),
            "configs": rows,
            "fingerprints": {
                "violations": [v.to_dict() for v in fp_violations],
                "notes": notes,
            },
            "ok": not all_v,
        }, indent=2) + "\n")
        print(f"  report -> {args.report}")

    if all_v:
        print(f"FAIL: {len(all_v)} violation(s)")
        return 1
    print("clean")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:                      # noqa: BLE001
        print(f"internal error: {exc!r}", file=sys.stderr)
        raise SystemExit(2)

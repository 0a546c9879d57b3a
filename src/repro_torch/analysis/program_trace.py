"""The engine's program, recorded as it runs: launches, folds, aten ops and
scope marks, in order.

The port's counterpart of a lowered XLA module is the sequence of work the
host dispatches for one engine run.  While a :class:`Recorder` is active
(``record``), the engine's dispatch points add events to it:

* ``sketch_step.step`` adds one ``launch`` event per call, carrying the
  instance the card launches (the build's defines and every non-pointer
  field of the kernel's argument struct); the plain version that runs
  on CPU tensors runs inside the launch, unrecorded;
* ``sketch_merge.merge_halve`` and ``merge_halve_mesh`` add a ``fold``
  event;
* ``core.device_simulate.run_chunks`` marks the chunk loop (``loop_begin``
  and ``loop_end``, with the state leaves' addresses), each chunk and each
  fold;
* every aten (and ``c10d``) op dispatched outside a launch becomes an
  ``op`` event, through a ``TorchDispatchMode``: its name, its class
  (``view``, ``write``, ``alloc``, ``host_read``, ``collective``) and its
  output shapes.  ``host_read`` is any op after which the host has waited
  for the card: a value read back (``.item()``, ``int(t)``, ``bool(t)``,
  a copy to the host), an output whose size depends on the data
  (``nonzero``, a boolean mask), or a Python scalar copied into one element
  (``t[i] = x``: the card copies it from pageable host memory and waits;
  ``t[a:b] = x`` fills instead and does not).

Both devices record the same events for the same run.  A dispatch mode does
not see ``.tolist()``, ``.numpy()`` or ``.cpu()`` on a CPU tensor; on the
card :func:`record` can also turn on ``torch.cuda.set_sync_debug_mode
("error")`` inside the chunk loop, which raises at any synchronising call.

When nothing records, :data:`active` is None and each dispatch point pays a
None check.

Spans and counters: the engine's phases and the ``DeviceTinyLFU`` facade's
steps are named by :func:`span` (``engine.run`` and its children
``engine.lanes``, ``engine.copy_in``, ``engine.state``, ``engine.probes``,
``engine.loop``, ``engine.finish``; ``facade.record``, ``facade.estimate``
and ``facade.admit`` with ``facade.lanes``, ``facade.copy_in`` and
``facade.verdict_read``), and by :func:`count` the host bytes they place
on the run's device (``bytes_in``) and the keys of a trace the engine had
to convert on the host before its copy (``keys_converted``).  Spans
record exactly while a ``torch.profiler`` records, by the profiler's own
flag, into a bounded in-memory log read by :func:`spans_between`; their
times are on the clock of the profiler's events (Unix-epoch ns,
``time.time_ns()``), so a span can be set against the profiler's window
and device operations as they are.  They are not profiler events (no
``record_function``: on the card that would mirror each onto the device's
timeline) and dispatch no aten op, so a recorded program is the same with
them on or off.  Off, a span costs one flag check and is the shared
:data:`NULL_SPAN`.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

active = None               # the Recorder of the run being recorded, if any

_LIFT = torch.ops.aten.lift_fresh.default
_COPY = torch.ops.aten.copy_.default

# ops whose output size depends on the data: on the card they wait for it
_DATA_SHAPED = ("aten.nonzero.", "aten.masked_select.", "aten._unique",
                "aten.unique_", "aten.repeat_interleave.Tensor",
                "aten.nonzero_numpy.")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def _op_class(func, args, out) -> str:
    name = str(func)
    if func.namespace == "c10d":
        return "collective"
    if not _tensors(out) and isinstance(out, (bool, int, float)):
        return "host_read"              # item(), int(t), bool(t), equal()
    if name.startswith(_DATA_SHAPED):
        return "host_read"
    if name.startswith("aten.index.Tensor") and any(
            t.dtype == torch.bool for t in _tensors(args[1:])):
        return "host_read"              # a boolean mask gathers via nonzero
    if name.startswith(("aten._to_copy.", "aten.copy_.")):
        src = args[1] if name.startswith("aten.copy_.") else args[0]
        dst = out if isinstance(out, torch.Tensor) else None
        if (isinstance(src, torch.Tensor) and dst is not None
                and src.device.type != "cpu" and dst.device.type == "cpu"):
            return "host_read"          # a device -> host copy
    schema = func._schema
    if any(a.alias_info is not None and a.alias_info.is_write
           for a in schema.arguments):
        return "write"
    if any(r.alias_info is not None for r in schema.returns):
        return "view"
    return "alloc"


class Recorder(TorchDispatchMode):
    """The events of one recorded run (``events``), each a tuple:

    * ``("op", name, class, shapes)``: ``shapes`` the output tensors' shapes;
    * ``("launch", kernel, instance)``: ``instance`` a tuple of (field,
      value) pairs;
    * ``("fold", name, fields)``;
    * ``("mark", what, payload)``: ``what`` in ``loop_begin``, ``chunk``,
      ``fold``, ``fold_end``, ``loop_end``; the loop marks' payload maps
      each state leaf to its (data pointer, storage pointer, shape).
    """

    def __init__(self, sync_debug: bool = False):
        super().__init__()
        self.events: list = []
        self.sync_debug = sync_debug
        self._sync_before = None
        self._scalar = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        cls = _op_class(func, args, out)
        if func is _COPY and args[1] is self._scalar:
            cls = "host_read"           # t[i] = x: the card's copy waits
        if func is _LIFT:
            self._scalar = out          # a Python scalar wrapped on the host
        self.events.append(("op", str(func), cls,
                            tuple(tuple(t.shape) for t in _tensors(out))))
        return out

    @contextlib.contextmanager
    def launch(self, kernel: str, instance: dict):
        """A kernel wrapper's call: one event, and the ops it dispatches
        (the plain version's on CPU tensors) are not recorded."""
        self.events.append(("launch", kernel, tuple(instance.items())))
        with _disable_current_modes():
            yield

    def fold(self, name: str, fields: dict):
        self.events.append(("fold", name, tuple(fields.items())))

    def mark(self, what: str, payload=None):
        if what == "loop_begin" and self.sync_debug:
            self._sync_before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        if what == "loop_end" and self._sync_before is not None:
            torch.cuda.set_sync_debug_mode(self._sync_before)
            self._sync_before = None
        self.events.append(("mark", what, payload))

    def release(self):
        """Undo the sync debug mode of a run that raised inside its loop."""
        if self._sync_before is not None:
            torch.cuda.set_sync_debug_mode(self._sync_before)
            self._sync_before = None


def leaf_ids(state: dict) -> tuple:
    """(key, data pointer, storage pointer, shape) of every state leaf."""
    return tuple((k, v.data_ptr(), v.untyped_storage().data_ptr(),
                  tuple(v.shape)) for k, v in state.items())


@contextlib.contextmanager
def record(sync_debug: bool = False):
    """Record the engine's events while the block runs; yields the
    :class:`Recorder`.  Not reentrant."""
    global active
    if active is not None:
        raise RuntimeError("a program is being recorded already")
    rec = Recorder(sync_debug)
    active = rec
    try:
        with rec:
            yield rec
    finally:
        rec.release()
        active = None


# ---------------------------------------------------------------------------
# spans and counters, on while a torch.profiler records
# ---------------------------------------------------------------------------

SPAN_LOG_SIZE = 4096        # spans kept: ~10 replays x 7 a window is ~70
NULL_SPAN = contextlib.nullcontext()    # what span() returns when off

_log: collections.deque = collections.deque(maxlen=SPAN_LOG_SIZE)
_runs = itertools.count(1)
_open = threading.local()   # .stack: this thread's open spans, outermost first


class Span:
    """One span, a context manager: ``name``; its ``parent``'s name (None
    for a root); ``run``, the identifier shared by a root and every span
    inside it; ``start_ns`` and ``end_ns`` on the profiler's clock;
    ``counters``, each counted inside it (its children's included).  It is
    logged when it closes."""
    __slots__ = ("name", "parent", "run", "start_ns", "end_ns", "counters")

    def __init__(self, name, parent=None, run=None, start_ns=0):
        self.name, self.parent, self.run = name, parent, run
        self.start_ns, self.end_ns, self.counters = start_ns, 0, {}

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.parent = up.name if up else None
        self.run = up.run if up else next(_runs)
        self.start_ns = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        stack = _stack()
        stack.pop()
        if stack:                   # counters roll up into the parent
            up = stack[-1].counters
            for k, v in self.counters.items():
                up[k] = up.get(k, 0) + v
        _log.append(self)
        return False


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def span(name: str):
    """A context manager naming the block ``name`` in the span log while a
    ``torch.profiler`` records (the child of the innermost open span of
    this thread, or a new run's root); otherwise :data:`NULL_SPAN`."""
    if not _profiler._is_profiler_enabled:
        return NULL_SPAN
    return Span(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of this thread's innermost open
    span, while spans record; each span's counters pass to its parent when
    it closes, so a root holds its run's totals."""
    if not _profiler._is_profiler_enabled:
        return
    stack = getattr(_open, "stack", None)
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + int(n)


def spans_between(t0_ns: int, t1_ns: int) -> list:
    """The logged spans that lie wholly within ``[t0_ns, t1_ns]``, by start
    (the log holds the last :data:`SPAN_LOG_SIZE` spans closed)."""
    return sorted((s for s in list(_log)
                   if s.start_ns >= t0_ns and s.end_ns <= t1_ns),
                  key=lambda s: s.start_ns)

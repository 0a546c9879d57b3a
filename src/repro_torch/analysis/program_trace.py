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
"""
from __future__ import annotations

import contextlib

import torch
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

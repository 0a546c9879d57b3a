"""Atomic checkpoints of trees of tensors, in the reference's format.

Counterpart of ``repro/checkpoint/store.py`` without JAX: the same
directory layout and manifest, so a checkpoint written by either package
restores in the other.

* A checkpoint is ``<dir>/step_<step:010d>/``: ``manifest.json`` (``step``,
  ``time``, ``extra``, and ``leaves`` of ``{key, file, shape, dtype}`` with
  numpy dtype strings) and one ``.npy`` file per leaf.
* A leaf's key is its path in the tree, joined by ``/``: dict keys sorted
  (as ``jax.tree_util.tree_flatten_with_path`` orders them), list and tuple
  indices in order, ``None`` no leaf.  So ``{"state": {"counters": ...}}``
  is the key ``state/counters`` in the file ``state_counters.npy``.
* A save writes ``<ckpt>.tmp``, fsyncs the manifest, then renames, so
  ``latest_step`` only ever sees complete checkpoints.
* ``AsyncCheckpointer`` copies every leaf to host memory (page-locked for
  leaves on the card) before ``save`` returns and writes to disk on a
  background thread.  The port's state is
  updated in place, so a view would race the writer: the copy is what makes
  the snapshot the state at the call.

Single process; the reference's multi-device placement (``shardings``) has
no counterpart here.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels.sketch_common import resolve_device


def _flat(tree, prefix: tuple = ()) -> list:
    """(key, leaf) pairs of ``tree`` in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [("/".join(prefix), tree)]
    out = []
    for k, sub in items:
        out.extend(_flat(sub, prefix + (str(k),)))
    return out


def _unflat(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, dict):
        got = {k: _unflat(template[k], leaves) for k in sorted(template)}
        return {k: got[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflat(v, leaves) for v in template)
    return next(leaves)


def _leaf_filename(key: str) -> str:
    return re.sub(r"[^\w\-]", "_", key) + ".npy"


def _host(x) -> np.ndarray:
    """A host copy of one leaf: tensors from any device (a copy from the
    card waits for it), numpy arrays copied, scalars as 0-d arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _ckpt(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra_meta: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the checkpoint path."""
    ckpt = _ckpt(directory, step)
    tmp = ckpt + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "time": time.time(),
                "extra": extra_meta or {}, "leaves": []}
    for key, leaf in _flat(tree):
        arr = leaf if isinstance(leaf, np.ndarray) else _host(leaf)
        fn = _leaf_filename(key)
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"key": key, "file": fn,
                                   "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    os.rename(tmp, ckpt)
    return ckpt


def _steps(directory: str) -> list[int]:
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := re.match(r"step_(\d+)$", d)))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _manifest(directory: str, step: int) -> dict:
    with open(os.path.join(_ckpt(directory, step), "manifest.json")) as f:
        return json.load(f)


def load_meta(directory: str, step: int) -> dict:
    """The ``extra_meta`` dict a checkpoint was saved with (empty if none),
    read without touching the leaf files."""
    return _manifest(directory, step).get("extra", {})


def restore_checkpoint(directory: str, step: int, template: Any,
                       device=None) -> Any:
    """Restore into the structure of ``template`` (tensors, arrays, or
    Python scalars).  Array leaves come back as tensors of the saved dtype
    on ``device`` (the card unless ``"cpu"``), scalar leaves as Python
    scalars.  A leaf missing from the checkpoint raises ``KeyError``, one
    of another shape ``ValueError``."""
    dev = resolve_device(device)
    ckpt = _ckpt(directory, step)
    by_key = {leaf["key"]: leaf
              for leaf in _manifest(directory, step)["leaves"]}
    out = []
    for key, leaf in _flat(template):
        meta = by_key.get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(ckpt, meta["file"]))
        if not hasattr(leaf, "shape"):            # python scalar leaf
            out.append(arr.item())
            continue
        want_shape = tuple(leaf.shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"{key}: saved {arr.shape} != wanted "
                             f"{want_shape}")
        out.append(torch.from_numpy(np.array(arr, order="C")).to(dev))
    return _unflat(template, iter(out))


def prune_old(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(_ckpt(directory, s), ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot on the caller's thread (every leaf copied to host memory
    before ``save`` returns), persist on a background thread.  ``wait()``
    joins the pending write and raises its error, if any; so does the next
    ``save()``.

    A leaf on the card is copied into a page-locked host buffer kept for
    its key (grown by doubling, as the hit flags grow from save to save):
    a copy from the card into pageable memory runs at a fraction of the
    rate, and the card idles while ``save`` waits for it.  A buffer is
    reused only after the write that read it has been joined."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None
        self._error: Optional[BaseException] = None
        self._pinned: dict = {}

    def _snapshot(self, key: str, x) -> np.ndarray:
        if not (isinstance(x, torch.Tensor) and x.is_cuda):
            return _host(x)
        buf, n = self._pinned.get(key), x.numel()
        if buf is None or buf.dtype != x.dtype or buf.numel() < n:
            size = max(n, 2 * buf.numel() if buf is not None else 0)
            buf = torch.empty(size, dtype=x.dtype, pin_memory=True)
            self._pinned[key] = buf
        out = buf[:n].view(x.shape)
        out.copy_(x.detach())                    # waits for the card
        return out.numpy()

    def save(self, step: int, tree: Any, extra_meta: Optional[dict] = None):
        self.wait()
        host = _unflat(tree, iter([self._snapshot(key, leaf)
                                   for key, leaf in _flat(tree)]))

        def _write():
            try:
                save_checkpoint(self.directory, step, host, extra_meta)
                prune_old(self.directory, self.keep)
                self.last_saved = step
            except BaseException as e:                 # raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

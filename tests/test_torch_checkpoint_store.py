"""The port's checkpoint store (``repro_torch.checkpoint.store``) against
the reference's (``repro.checkpoint.store``), on the CPU.

Round trips of nested trees, the atomic save (a torn ``.tmp`` is invisible
to ``latest_step``), the reference's errors on a missing leaf and a shape
mismatch, meta and pruning, the snapshot ``AsyncCheckpointer.save`` takes
of a tensor that is written in place right after it returns, a writer's
error raised on ``wait`` and on the next ``save``, and checkpoints that
cross between the packages with identical manifests (apart from ``time``).
"""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"state": {"regs": torch.arange(8, dtype=torch.int32),
                      "counters": torch.from_numpy(
                          rng.integers(-2**31, 2**31, 64, dtype=np.int64)
                          .astype(np.int32)),
                      "wtab": torch.full((4, 3), -1, dtype=torch.int32)},
            "hits": np.arange(10, dtype=np.int32) % 2,
            "pair": [torch.zeros(2, dtype=torch.int32),
                     (np.ones(3, np.float32), np.int64(7))]}


def leaves(t):
    return [(k, np.asarray(v)) for k, v in store._flat(t)]


def manifest(d, step):
    with open(os.path.join(d, f"step_{step:010d}", "manifest.json")) as f:
        m = json.load(f)
    m.pop("time")
    return m


def test_round_trip_keys_files_and_structure(tmp_path):
    d = str(tmp_path)
    t = tree()
    path = store.save_checkpoint(d, 5, t, {"cursor": 5, "f": 0.01})
    assert path.endswith("step_0000000005")
    keys = [k for k, _ in store._flat(t)]
    assert keys == ["hits", "pair/0", "pair/1/0", "pair/1/1",
                    "state/counters", "state/regs", "state/wtab"]
    m = manifest(d, 5)
    assert [leaf["file"] for leaf in m["leaves"]] == [
        "hits.npy", "pair_0.npy", "pair_1_0.npy", "pair_1_1.npy",
        "state_counters.npy", "state_regs.npy", "state_wtab.npy"]
    assert m["leaves"][2]["dtype"] == "float32"
    assert m["leaves"][4]["shape"] == [64]
    out = store.restore_checkpoint(d, 5, t, device="cpu")
    assert list(out) == list(t) and isinstance(out["pair"][1], tuple)
    for (k, a), (k2, b) in zip(leaves(t), leaves(out)):
        assert k == k2 and a.dtype == b.dtype and np.array_equal(a, b), k
    assert out["state"]["regs"].dtype == torch.int32
    assert store.load_meta(d, 5) == {"cursor": 5, "f": 0.01}
    # a Python-scalar template leaf comes back as a scalar
    back = store.restore_checkpoint(
        d, 5, {"pair": [np.zeros(2), (np.zeros(3), 0)]}, device="cpu")
    assert back["pair"][1][1] == 7 and isinstance(back["pair"][1][1], int)


def test_torn_tmp_is_invisible_and_errors(tmp_path):
    d = str(tmp_path)
    assert store.latest_step(d) is None
    assert store.latest_step(str(tmp_path / "absent")) is None
    store.save_checkpoint(d, 3, {"a": torch.ones(4, dtype=torch.int32)})
    os.makedirs(os.path.join(d, "step_0000000009.tmp"))   # a torn save
    assert store.latest_step(d) == 3
    with pytest.raises(KeyError, match="missing leaf 'b'"):
        store.restore_checkpoint(d, 3, {"b": np.zeros(4, np.int32)},
                                 device="cpu")
    with pytest.raises(ValueError, match=r"a: saved \(4,\) != wanted \(5,\)"):
        store.restore_checkpoint(d, 3, {"a": np.zeros(5, np.int32)},
                                 device="cpu")
    store.save_checkpoint(d, 9, {"a": torch.zeros(4, dtype=torch.int32)})
    assert store.latest_step(d) == 9          # the torn .tmp was replaced
    assert not os.path.exists(os.path.join(d, "step_0000000009.tmp"))


def test_prune_old_and_async_checkpointer(tmp_path):
    d = str(tmp_path)
    ck = store.AsyncCheckpointer(d)
    for s in (1, 2, 3, 4, 5):
        ck.save(s, {"x": torch.full((3,), s, dtype=torch.int32)},
                extra_meta={"cursor": s})
    ck.wait()
    assert ck.last_saved == 5
    assert sorted(os.listdir(d)) == [f"step_{s:010d}" for s in (3, 4, 5)]
    store.prune_old(d, keep=1)
    assert os.listdir(d) == ["step_0000000005"]
    store.prune_old(str(tmp_path / "absent"))
    out = store.restore_checkpoint(d, 5, {"x": np.zeros(3, np.int32)},
                                   device="cpu")
    assert out["x"].tolist() == [5, 5, 5]


def test_async_save_snapshots_a_tensor_written_in_place(tmp_path,
                                                        monkeypatch):
    """The state is updated in place: a tensor written right after save()
    returns is saved with the value it had at the call.  The writer thread
    is held until the write is done, so a snapshot that were only a view
    of the tensor would save the later value."""
    go = threading.Event()
    real = store.save_checkpoint

    def held(*args, **kw):
        go.wait(10)
        return real(*args, **kw)

    monkeypatch.setattr(store, "save_checkpoint", held)
    d = str(tmp_path)
    x = torch.arange(16, dtype=torch.int32)
    y = np.arange(4, dtype=np.int32)
    ck = store.AsyncCheckpointer(d)
    ck.save(1, {"x": x, "y": y})
    x.add_(100)                    # the next segment writes in place
    x[3] = -1
    y[:] = 9
    go.set()
    ck.wait()
    out = store.restore_checkpoint(d, 1, {"x": x, "y": y}, device="cpu")
    assert out["x"].tolist() == list(range(16))
    assert out["y"].tolist() == [0, 1, 2, 3]


def test_writer_error_is_raised_on_wait_and_next_save(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = store.AsyncCheckpointer(str(blocker))
    ck.save(1, {"x": np.zeros(2, np.int32)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                      # raised once, then clear
    ck.save(2, {"x": np.zeros(2, np.int32)})
    with pytest.raises(OSError):
        ck.save(3, {"x": np.zeros(2, np.int32)})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    """A tree saved by either package restores in the other with the same
    values, and both write identical manifests (keys, files, shapes,
    dtypes, extra) apart from the time."""
    t = {"state": {"counters": np.arange(-8, 8, dtype=np.int32),
                   "regs": np.array([3, 0, 9, 1], np.int32)},
         "carry": np.zeros(6, np.int32),
         "hits": np.array([0, 1, 1, 0], np.int32)}
    meta = {"capacity": 300, "window_frac": 0.01, "assoc": None,
            "climb": [1, 2, 3], "mesh_exchange": "chunk", "cursor": 4}
    dj, dp = str(tmp_path / "j"), str(tmp_path / "p")
    jstore.save_checkpoint(dj, 4, {k: (jnp.asarray(v) if k != "state" else
                                       {q: jnp.asarray(w)
                                        for q, w in v.items()})
                                   for k, v in t.items()}, meta)
    store.save_checkpoint(dp, 4, {k: (torch.from_numpy(v) if k != "state"
                                      else {q: torch.from_numpy(w)
                                            for q, w in v.items()})
                                  for k, v in t.items()}, meta)
    assert manifest(dj, 4) == manifest(dp, 4)
    assert sorted(os.listdir(os.path.join(dj, "step_0000000004"))) == \
        sorted(os.listdir(os.path.join(dp, "step_0000000004")))
    src = dj if writer == "jax" else dp
    if writer == "jax":
        out = store.restore_checkpoint(src, 4, t, device="cpu")
        got = {k: np.asarray(v) for k, v in store._flat(out)}
    else:
        out = jstore.restore_checkpoint(src, 4, t)
        got = {k: np.asarray(v) for k, v in jstore._flat(out)[0]}
    for k, v in store._flat(t):
        assert np.array_equal(got[k], v) and got[k].dtype == v.dtype, k
    assert (jstore.load_meta if writer == "port" else store.load_meta)(
        src, 4) == meta

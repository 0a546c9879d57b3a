"""Checkpoints of meshed runs and their elastic restore, on the CPU (the
semantics of tests/test_checkpoint_resume.py's mesh case).

A checkpoint holds the canonical single-device layout, written by rank 0,
so a run checkpointed on one mesh resumes on a mesh of another size that
divides ``shards``, or on one device, and the reverse.  Each drill runs a
checkpointed run to its end, prunes its checkpoints to the first (as a
run killed after it would leave them) and resumes elsewhere: 2 ranks -> 1
device, 1 device -> 2 ranks and 2 -> 4 ranks, in chunk mode (against the
unmeshed run, which chunk mode equals bit for bit) and stale mode (against
the uninterrupted stale run; its result does not depend on the mesh size),
static and adaptive.  Hits, every hit flag and every leaf of the final
state must be equal.  Ranks are spawned processes of a gloo group
(``distributed.launch.run_ranks``).
"""
import os
import re
import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.core import device_simulate as pds
from repro_torch.distributed.launch import run_ranks
from repro_torch.traces.synthetic import zipf_trace

import torch_mesh_ranks as ranks

torch.set_num_threads(1)

C = 150
TR = zipf_trace(1_600, n_items=600, alpha=0.9, seed=3)
CLIMB = pds.ClimbSpec(epoch_len=256)
# drill -> (mesh exchange, DeviceWTinyLFU kw, checkpoint_every)
DRILLS = {
    "chunk": ("chunk", dict(shards=4, merge_every=256), 512),
    "stale": ("stale", dict(shards=4, merge_every=256), 512),
    "chunk adaptive": ("chunk", dict(shards=4, adaptive=True, climb=CLIMB),
                       512),
    "stale adaptive": ("stale", dict(shards=4, adaptive=True, climb=CLIMB),
                       512),
}


def prune_to_first(d):
    steps = sorted(int(m.group(1)) for x in os.listdir(d)
                   if (m := re.match(r"step_(\d+)$", x)))
    assert len(steps) >= 2, steps
    for s in steps[1:]:
        shutil.rmtree(os.path.join(d, f"step_{s:010d}"))


def copy_pruned(src, dst):
    shutil.copytree(src, dst)
    prune_to_first(dst)
    return dst


@pytest.fixture(scope="module")
def drills():
    """Every drill's writes and resumes: one device here, 2 and 4 ranks
    as gloo groups."""
    tmp = tempfile.mkdtemp(prefix="mesh-ckpt-")
    out = {}
    # 1 device writes (chunk: no mesh; stale: a one-rank mesh)
    one = {name: ranks.checkpointed(0, C, TR, dict(kw, mesh=(
        None if x == "chunk" else x)), os.path.join(tmp, f"w1-{i}"), every,
        False) for i, (name, (x, kw, every)) in enumerate(DRILLS.items())}
    # 2 ranks: write, and resume the one-device checkpoints (1 -> 2)
    calls = []
    for i, (name, (x, kw, every)) in enumerate(DRILLS.items()):
        calls.append(("checkpointed", (C, TR, dict(kw, mesh=x),
                                       os.path.join(tmp, f"w2-{i}"), every,
                                       False)))
        calls.append(("checkpointed", (C, TR, dict(kw, mesh=x), copy_pruned(
            os.path.join(tmp, f"w1-{i}"), os.path.join(tmp, f"r12-{i}")),
            every, True)))
    two = run_ranks(ranks.many, 2, os.path.join(tmp, "g2"), calls,
                    timeout=240)
    # 2 -> 1 here, 2 -> 4 on 4 ranks, from the 2-rank checkpoints
    calls4 = []
    for i, (name, (x, kw, every)) in enumerate(DRILLS.items()):
        w2 = os.path.join(tmp, f"w2-{i}")
        out[(name, "2->1")] = ranks.checkpointed(
            0, C, TR, dict(kw, mesh=None if x == "chunk" else x),
            copy_pruned(w2, os.path.join(tmp, f"r21-{i}")), every, True)
        calls4.append(("checkpointed", (C, TR, dict(kw, mesh=x), copy_pruned(
            w2, os.path.join(tmp, f"r24-{i}")), every, True)))
    four = run_ranks(ranks.many, 4, os.path.join(tmp, "g4"), calls4,
                     timeout=240)
    for i, name in enumerate(DRILLS):
        out[(name, "1 device")] = one[name]
        out[(name, "2 ranks")] = two[0][2 * i]
        out[(name, "1->2")] = two[0][2 * i + 1]
        out[(name, "2->4")] = four[0][i]
        assert two[1][2 * i + 1][0] == two[0][2 * i + 1][0]   # ranks alike
        assert all(f[i][0] == four[0][i][0] for f in four)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _same(a, b):
    assert a[0] == b[0]
    assert np.array_equal(a[1], b[1])
    assert sorted(a[2]) == sorted(b[2])
    for k in a[2]:
        assert np.array_equal(a[2][k], b[2][k]), k


@pytest.mark.parametrize("how", ["2->1", "1->2", "2->4"])
@pytest.mark.parametrize("name", list(DRILLS))
def test_meshed_checkpoints_resume_elastically(drills, name, how):
    x, kw, every = DRILLS[name]
    ref = drills[(name, "2 ranks")]        # the uninterrupted meshed run
    if x == "chunk":                       # == the unmeshed run
        kw = dict(kw)
        climb = kw.pop("climb", None)
        r, st, h = pds.simulate_trace(TR, C, return_state=True,
                                      device="cpu", climb=climb, **kw)
        _same(ref, (r.hits, h.numpy(), {k: v.numpy() for k, v in st.items()},
                    None))
    _same(drills[(name, "1 device")], ref)
    got = drills[(name, how)]
    # resumed at the first checkpoint pruning kept (the saver keeps 3)
    assert got[3] == len(TR) // every * every - every
    _same(got, ref)

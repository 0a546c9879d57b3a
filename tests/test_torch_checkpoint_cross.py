"""Checkpoints that cross between the JAX engine and the port, and the
resume path's edges, on the CPU.

A checkpoint the JAX engine writes resumes in the port, and one the port
writes resumes in the JAX engine; both resumes equal the uninterrupted run
bit for bit (hit flags, every state leaf, trajectory and final quota), and
the two packages write the same leaves (keys, files, shapes, dtypes) and
the same ``extra`` meta at every step.  Also the counterparts of
tests/test_checkpoint_resume.py's edges: the resume from an empty
directory is a fresh run that checkpoints, a checkpoint of another
configuration (capacity, warmup) is refused, a cadence off the epoch is
refused, and so are lanes and a stand-in mesh that is not a ShardMesh.
"""
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro.traces import zipf_trace
from repro_torch.checkpoint.store import latest_step
from repro_torch.core import device_simulate as pds

from test_torch_checkpoint_resume import (C, EPOCH, N, SF, WARMUP,
                                          assert_same, prune_to_first, steps,
                                          trace)

torch.set_num_threads(1)


def manifests(d):
    out = {}
    for s in steps(d):
        with open(os.path.join(d, f"step_{s:010d}", "manifest.json")) as f:
            m = json.load(f)
        m.pop("time")
        out[s] = m
    return out


CROSS = [
    ("flat-static", dict(), False, 1_000),
    ("assoc-adaptive-sharded", dict(assoc=8, shards=4, merge_every=128),
     True, 512),
]


@pytest.mark.parametrize("label,kw,adaptive,every", CROSS,
                         ids=[c[0] for c in CROSS])
def test_checkpoints_resume_across_packages(label, kw, adaptive, every,
                                            tmp_path):
    tr = trace()
    jclimb = jds.ClimbSpec(epoch_len=EPOCH) if adaptive else None
    pclimb = pds.ClimbSpec(epoch_len=EPOCH) if adaptive else None
    jcfg = jds.DeviceWTinyLFU(C, sample_factor=SF, adaptive=adaptive, **kw)
    pcfg = pds.DeviceWTinyLFU(C, sample_factor=SF, adaptive=adaptive, **kw)
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jcfg.run(tr, warmup=WARMUP, climb=jclimb, checkpoint_dir=dj,
                    checkpoint_every=every, return_state=True)
    got = pcfg.run(tr, warmup=WARMUP, climb=pclimb, checkpoint_dir=dp,
                   checkpoint_every=every, return_state=True, device="cpu")
    assert_same(want, got, adaptive)
    mj, mp = manifests(dj), manifests(dp)
    assert list(mj) == list(mp) and len(mj) >= 2
    assert mj == mp                     # leaves and extra meta, every step
    for src, dst in ((dj, "jax"), (dp, "port")):
        cursor = prune_to_first(src)
        if dst == "jax":                # written by JAX, resumed here
            res = pds.resume_trace(tr, pcfg, checkpoint_dir=src,
                                   warmup=WARMUP, climb=pclimb,
                                   checkpoint_every=every,
                                   return_state=True, device="cpu")
        else:                           # written here, resumed by JAX
            rj, sj, hj = jds.resume_trace(tr, jcfg, checkpoint_dir=src,
                                          warmup=WARMUP, climb=jclimb,
                                          checkpoint_every=every,
                                          return_state=True)
            res = (rj, {k: torch.from_numpy(np.array(v))
                        for k, v in sj.items()},
                   torch.from_numpy(np.array(hj)))
        assert res[0].extra["resumed_at"] == cursor
        assert_same(want, res, adaptive)


def test_resume_from_empty_dir_runs_fresh(tmp_path):
    tr = trace(9, 1_000)
    d = str(tmp_path / "none")
    res0 = jds.simulate_trace(tr, C, sample_factor=SF, warmup=WARMUP)
    res1 = pds.resume_trace(tr, pds.DeviceWTinyLFU(C, sample_factor=SF),
                            checkpoint_dir=d, warmup=WARMUP,
                            checkpoint_every=600, device="cpu")
    assert res1.extra["resumed_at"] == 0
    assert res1.hits == res0.hits
    assert latest_step(d) == 1_000          # and it checkpointed


def test_config_fingerprint_mismatch_rejected(tmp_path):
    tr = trace(9, 1_000)
    d = str(tmp_path / "ck")
    pds.DeviceWTinyLFU(C, sample_factor=SF).run(
        tr, warmup=WARMUP, checkpoint_dir=d, checkpoint_every=600,
        device="cpu")
    shutil.rmtree(os.path.join(d, "step_0000001000"))
    with pytest.raises(ValueError, match="capacity"):
        pds.resume_trace(tr, pds.DeviceWTinyLFU(C + 50, sample_factor=SF),
                         checkpoint_dir=d, warmup=WARMUP, device="cpu")
    with pytest.raises(ValueError, match="warmup"):
        pds.resume_trace(tr, pds.DeviceWTinyLFU(C, sample_factor=SF),
                         checkpoint_dir=d, warmup=WARMUP + 1, device="cpu")
    assert latest_step(d) == 600            # nothing was run


def test_cadence_lanes_and_mesh_refused(tmp_path):
    tr = trace(1, 600)
    d = str(tmp_path / "x")
    cfg = pds.DeviceWTinyLFU(100, shards=4, merge_every=128)
    for every in (100, -128):
        with pytest.raises(ValueError, match="checkpoint_every"):
            cfg.run(tr, checkpoint_dir=d, checkpoint_every=every,
                    device="cpu")
    acfg = pds.DeviceWTinyLFU(100, adaptive=True)
    with pytest.raises(ValueError, match="climb.epoch_len = 256"):
        acfg.run(tr, climb=pds.ClimbSpec(epoch_len=256), checkpoint_dir=d,
                 checkpoint_every=384, device="cpu")
    lanes = pds.DeviceWTinyLFU(100, streams=2)
    with pytest.raises(ValueError, match="streams 2 does not combine"):
        lanes.run(np.stack([tr, tr]), checkpoint_dir=d, device="cpu")
    with pytest.raises(ValueError, match="streams 2 does not combine"):
        lanes.run(np.stack([tr, tr]), fault_hook=lambda c, s: None,
                  device="cpu")
    mesh = SimpleNamespace(axis_names=("shard",),
                           devices=SimpleNamespace(size=2))
    meshed = pds.DeviceWTinyLFU(100, shards=4, mesh=mesh)
    with pytest.raises(ValueError, match="ShardMesh"):
        meshed.run(tr, checkpoint_dir=d, device="cpu")
    assert latest_step(d) is None           # nothing was written

"""Epoch-boundary checkpoint/resume of the port's engine against the JAX
engine, on the CPU: the counterparts of tests/test_checkpoint_resume.py's
single-device cases at a short size.

In each case the port's checkpointed (segmented) run and its resume from
the earliest checkpoint that pruning kept must both equal the JAX engine's
uninterrupted run bit for bit: the hit flags, every state leaf and, when
adaptive, the trajectory and final quota.  The traces are short (1,536
accesses, C=150, W=300 so that resets fire) with small epochs (merge every
128, climb every 256); the static flat case checkpoints every 1,000
accesses, which is not a multiple of the 512-access chunk.
"""
import os
import re
import shutil

import numpy as np
import pytest
import torch

from repro.core import device_simulate as jds
from repro.traces import zipf_trace
from repro_torch.checkpoint.store import latest_step
from repro_torch.core import device_simulate as pds

torch.set_num_threads(1)

N, C, SF, WARMUP = 1_536, 150, 2, 200
EPOCH = 256


def trace(seed=4, n=N):
    return zipf_trace(n, n_items=600, alpha=0.9, seed=seed)


def steps(d):
    return sorted(int(m.group(1)) for x in os.listdir(d)
                  if (m := re.match(r"step_(\d+)$", x)))


def prune_to_first(d):
    """Delete all but the earliest checkpoint, so a resume has work."""
    s = steps(d)
    assert len(s) >= 2, f"need an intermediate checkpoint, got {s}"
    for x in s[1:]:
        shutil.rmtree(os.path.join(d, f"step_{x:010d}"))
    return s[0]


def jax_run(tr, kw, adaptive):
    climb = jds.ClimbSpec(epoch_len=EPOCH) if adaptive else None
    return jds.simulate_trace(tr, C, sample_factor=SF, warmup=WARMUP,
                              adaptive=adaptive, climb=climb,
                              return_state=True, **kw)


def assert_same(want, got, adaptive):
    (rj, sj, hj), (rp, sp, hp) = want, got
    assert np.array_equal(np.asarray(hj), hp.numpy())
    assert set(sj) == set(sp)
    for k in sj:
        assert np.array_equal(np.asarray(sj[k]), sp[k].numpy()), k
    assert rp.hits == rj.hits and rp.hit_ratio == rj.hit_ratio
    assert rp.accesses == rj.accesses
    if adaptive:
        assert rp.extra["trajectory"] == rj.extra["trajectory"]
        assert rp.extra["final_quota"] == rj.extra["final_quota"]


CASES = [
    # (label, cfg kwargs, adaptive, checkpoint_every)
    ("flat-static", dict(), False, 1_000),
    ("flat-sharded", dict(shards=4, merge_every=128), False, 512),
    ("assoc-sharded", dict(assoc=8, shards=4, merge_every=128), False, 512),
    ("flat-adaptive", dict(), True, 512),
    ("assoc-adaptive-sharded", dict(assoc=8, shards=4, merge_every=128),
     True, 512),
    ("integrity", dict(shards=4, merge_every=128, integrity=True), False,
     384),
]


@pytest.mark.parametrize("label,kw,adaptive,every", CASES,
                         ids=[c[0] for c in CASES])
def test_checkpoint_resume_equals_jax(label, kw, adaptive, every, tmp_path):
    tr = trace()
    want = jax_run(tr, kw, adaptive)
    climb = pds.ClimbSpec(epoch_len=EPOCH) if adaptive else None
    cfg = pds.DeviceWTinyLFU(C, sample_factor=SF, adaptive=adaptive, **kw)
    d = str(tmp_path / "ck")
    seen = []
    got = cfg.run(tr, warmup=WARMUP, climb=climb, checkpoint_dir=d,
                  checkpoint_every=every, return_state=True, device="cpu",
                  on_checkpoint=seen.append)
    assert_same(want, got, adaptive)
    assert got[0].extra["checkpoint_every"] == every
    assert seen == list(range(every, N, every)) + [N]
    assert "resumed_at" not in got[0].extra
    cursor = prune_to_first(d)
    assert 0 < cursor < N
    res = pds.resume_trace(tr, cfg, checkpoint_dir=d, warmup=WARMUP,
                           climb=climb, checkpoint_every=every,
                           return_state=True, device="cpu")
    assert res[0].extra["resumed_at"] == cursor
    assert_same(want, res, adaptive)
    assert latest_step(d) == N
    if kw.get("integrity"):
        assert int(res[1]["csum"][-1]) == 0         # nothing quarantined

"""The stale mesh mode's goldens on the CPU (the reference's
``MESH_STALE_SCRIPT``, tests/test_distributed.py): on a two-rank gloo mesh
with ``merge_every=512``, the Zipf golden (C=200, 60,000 accesses, warmup
10,000) within 0.01 of 0.3498 here and the scan-then-hotspot golden (C=400,
warmup 5,000) within 0.01 of 0.4837 in ``test_torch_mesh_goldens_scanhot.py``
(one golden a file, so the two run on separate workers), each also within
0.01 of the exact mode's result (the single-device sharded run, which the
chunk mode equals bit for bit (``test_torch_mesh.py``); taken from the JAX
engine here, which is faster on the CPU, while the ranks run).  Each rank is
a spawned process (``distributed.launch.run_ranks``); a rank's plain step is
~1.1 ms an access on one CPU thread, so a golden takes ~70 s."""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro.core import device_simulate as jds
from repro.traces import zipf_trace
from repro.traces.synthetic import _sample_from_probs, zipf_probs
from repro_torch.distributed.launch import run_ranks

import torch_mesh_ranks

GOLDENS = {"zipf": 0.3498, "scanhot": 0.4837}


def golden_trace(name: str):
    """(capacity, trace, warmup) of golden ``name``."""
    if name == "zipf":
        return 200, zipf_trace(60_000, n_items=50_000, alpha=0.9, seed=7), \
            10_000
    rng = np.random.default_rng(13)
    s = np.concatenate([np.arange(100_000, 125_000, dtype=np.int64),
                        _sample_from_probs(zipf_probs(2_000, 1.0), 35_000,
                                           rng).astype(np.int64)])
    return 400, s, 5_000


def check_golden(name: str, workdir: str):
    """Golden ``name`` on two gloo ranks in stale mode against its value and
    the exact mode's hit ratio."""
    C, tr, warmup = golden_trace(name)
    runs = [(C, tr, dict(shards=2, merge_every=512, warmup=warmup,
                         mesh_exchange="stale"))]
    with ThreadPoolExecutor(1) as ex:
        job = ex.submit(run_ranks, torch_mesh_ranks.many, 2,
                        os.path.join(workdir, name),
                        [("mesh_runs", (runs,))], timeout=400)
        hx = jds.simulate_trace(tr, C, warmup=warmup, shards=2,
                                merge_every=512).hit_ratio
        ranks = job.result()
    (stale,), = ranks[0]
    assert ranks[1][0][0][0] == stale[0]                 # both ranks alike
    assert stale[1]["mesh_exchange"] == "stale"
    hr = stale[0] / (len(tr) - warmup)
    assert abs(hr - GOLDENS[name]) < 0.01, hr
    assert abs(hr - hx) < 0.01, (hr, hx)


@pytest.mark.parametrize("name", ["zipf"])
def test_stale_goldens_two_ranks(name, tmp_path):
    check_golden(name, str(tmp_path))

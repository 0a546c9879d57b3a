"""This tree's step and add kernels against another copy of their sources,
on the card, in turns.

``--other DIR`` names a directory that holds other versions of
``sketch_step.cu``, ``sketch_update.cu`` and ``sketch_common.cuh``: an
earlier commit's (``git archive <commit> src/repro_torch/kernels/csrc |
tar -x --strip-components=4 -C DIR``) or an edited copy.  Both pairs are
built by the engine's loader (``repro_torch.kernels._build``, into
``build/``), all at once, and for each source the script prints both
builds' ptxas register and spill lines, in order, and whether the other's
lines all appear among this tree's.  Then,
with CUDA events around each launch:

* run F's chunks (C=65,536, assoc=8, 1.2M Zipf accesses, chunk 512)
  through each build's step kernel in turns (this, other, other, this,
  this, other): ms per chunk, and the final states' digests, which must
  be equal;
* add S's batches (F's trace in 4,096-key batches into
  ``DeviceTinyLFU(65,536)``'s sketch, no reset) through each build's add
  kernel in the same turns: ms per batch, final states equal;
* add 60 of S's batches at S's geometry with 8, 9, 13 and 20 doorkeeper
  probes through this tree's add, twice each (past 8 probes, its loop
  instance).

Run on a machine with a card, from the repository root:

    PYTHONPATH=src python tools/ab_timing.py --other DIR
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.check_runs import S_BATCH, S_BLOCKS, digest
from repro_torch.core.device_simulate import (DeviceWTinyLFU, _trace_lanes,
                                              run_chunks)
from repro_torch.kernels import _build
from repro_torch.kernels import sketch_step as ks
from repro_torch.kernels import sketch_update as su
from repro_torch.kernels.ops import make_config
from repro_torch.kernels.sketch_common import (DeviceSketchConfig,
                                               init_state, keys_to_lanes)
from repro_torch.traces.synthetic import zipf_trace

TURNS = ("this", "other", "other", "this", "this", "other")
SOURCES = ("sketch_step", "sketch_update")


def ptxas_lines(log: str) -> list[str]:
    return [ln.split("ptxas info    : ")[-1].strip()
            for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def events_ms(pairs) -> float:
    torch.cuda.synchronize()
    return statistics.mean(a.elapsed_time(b) for a, b in pairs)


def step_with(lib):
    """run_chunks' ``fn`` launching the step kernel of ``lib``, with CUDA
    events around each launch (appended to ``run.events``)."""
    def run(spec, params, state, lo, hi, n_valid=None, probes=None):
        hits = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ks._launch(spec, params, state, lo, hi, probes, n_valid, hits,
                   lib=lib)
        e1.record()
        run.events.append((e0, e1))
        return state, hits
    run.events = []
    return run


def time_f(lib, f_trace) -> tuple[float, str]:
    cfg = DeviceWTinyLFU(65_536, assoc=8)
    spec = cfg.spec()
    state = ks.init_step_state(spec, cfg.window_cap, cfg.main_cap,
                               device="cuda")
    lo, hi = _trace_lanes(f_trace, "cuda")
    fn = step_with(lib)
    run_chunks(spec, cfg.params(warmup=480_000, device="cuda"), state, lo,
               hi, 512, fn=fn)
    return events_ms(fn.events), digest(state)


def time_adds(lib, cfg, f_trace, batches: int):
    state = init_state(cfg, device="cuda")
    pairs = []
    for b in range(batches):
        lo, hi = (torch.from_numpy(x).cuda() for x in keys_to_lanes(
            np.asarray(f_trace[b * S_BATCH:(b + 1) * S_BATCH], np.uint64)))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        su._launch(cfg, state, lo, hi, lib=lib)
        e1.record()
        pairs.append((e0, e1))
    return events_ms(pairs), state


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="directory with the other sketch_step.cu, "
                         "sketch_update.cu and sketch_common.cuh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_timing: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    other_dir = args.other.resolve()
    with ThreadPoolExecutor(4) as ex:
        jobs = {(n, w): ex.submit(_build.load_library, n, (),
                                  None if w == "this" else other_dir)
                for n in SOURCES for w in ("this", "other")}
        libs = {n: {w: jobs[(n, w)].result() for w in ("this", "other")}
                for n in SOURCES}
        for n in SOURCES:
            this = ptxas_lines(_build.build_info[(n, ())]["log"])
            other = ptxas_lines(
                _build.build_info[(n, (), str(other_dir))]["log"])
            print(f"{n} ptxas, this tree:", *this, sep="\n  ")
            print(f"{n} ptxas, other:", *other, sep="\n  ")
            print(f"{n}: every line of the other's among this tree's: "
                  f"{all(this.count(x) >= other.count(x) for x in other)}")
        f_trace = zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9,
                             seed=11)
        ms = {"this": [], "other": []}
        digests = {}
        for turn in TURNS:
            m, digests[turn] = time_f(libs["sketch_step"][turn], f_trace)
            ms[turn].append(round(m, 4))
        print(f"F, step kernel ms per 512-access chunk in turns: {ms}; "
              f"digests equal {len(set(digests.values())) == 1}; {card}")
        s_cfg = make_config(S_BLOCKS)
        ms = {"this": [], "other": []}
        states = {}
        for turn in TURNS:
            m, states[turn] = time_adds(libs["sketch_update"][turn], s_cfg,
                                        f_trace, 293)
            ms[turn].append(round(m, 4))
        same = all(torch.equal(states["this"][k], states["other"][k])
                   for k in ("counters", "doorkeeper"))
        print(f"S's adds (293 batches of {S_BATCH}, no reset), ms per batch "
              f"in turns: {ms}; final states equal {same}; {card}")
        for dkp in (8, 9, 13, 20):
            cfg = DeviceSketchConfig(width=s_cfg.width, rows=s_cfg.rows,
                                     cap=s_cfg.cap, dk_bits=s_cfg.dk_bits,
                                     dk_probes=dkp)
            runs = [round(time_adds(libs["sketch_update"]["this"], cfg,
                                    f_trace, 60)[0], 4) for _ in range(2)]
            print(f"add at S's geometry, {dkp} doorkeeper probes: {runs} ms "
                  f"per 4,096-key batch (60 batches, this tree); {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

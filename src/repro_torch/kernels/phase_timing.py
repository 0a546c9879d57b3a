"""Where the step kernel's and the add kernel's time goes on the card, and
the step kernel's latency floor.

Builds ``csrc/sketch_step.cu`` three ways: as the engine builds it, with
``-DSKETCH_STEP_SKIP_ACCESS`` (the per-access table work compiled out) and
with ``-DSKETCH_STEP_SKIP_ADD`` (the sketch add compiled out).  It builds
``csrc/l2_chase.cu`` too, and starts all four nvcc runs together.  Each
build of the step kernel is timed on the same chunks, so the differences
show what each phase costs per access.  Only the full build computes the
engine's result; the other two are timing probes and their state is
discarded.

The L2 probe measures the round-trip time of one dependent load.  In the
set-associative path an access's inputs (key, set indices, probes) are
loaded while the access before it runs, so the kernel waits on 1 such
round trip per hit and at most 3 per miss, one after another:

* the window set, the key's two main sets and its sketch add's words,
  loaded together;
* on a miss that pushes a window record out, the candidate's two main sets
  and its sketch words;
* if the victim's way is occupied, the victim's sketch words.

So ``1 h + 3 (1 - h)`` round trips per access, with ``h`` the hit share of
the timed chunks, is the floor that the chain of memory round trips alone
sets (a miss that stops early needs fewer).  The time the kernel takes
above it goes to the one warp's instruction chain (reductions, shuffles,
address arithmetic).

The add kernel (``csrc/sketch_update.cu``) is built once more with
``-DSKETCH_UPDATE_CLOCKS``: thread 0 of its one CTA sums each phase's cycles
(barrier to barrier) over every tile.  Run S's batches through it, that
gives each phase's share of the kernel's time and the rounds of its label
propagation per tile.

Run on a machine with a card, from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.phase_timing
"""
from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.check_runs import ADD_TILE, S_BATCH, S_BLOCKS
from repro_torch.core.device_simulate import DeviceWTinyLFU, _trace_lanes
from repro_torch.traces.synthetic import zipf_trace
from . import _build
from . import sketch_step as ks
from . import sketch_update as su
from .ops import make_config
from .sketch_common import init_state
from .sketch_reset import reset

VARIANTS = {"full": (), "no table access": ("SKETCH_STEP_SKIP_ACCESS",),
            "no sketch add": ("SKETCH_STEP_SKIP_ADD",)}
RT_HIT, RT_MISS = 1, 3          # dependent L2 round trips per set access
ADD_CLOCKS = ("SKETCH_UPDATE_CLOCKS",)
ADD_PHASES = ("reset doorkeeper table", "first touches, doorkeeper loads",
              "gates, doorkeeper ORs", "reset nibble table",
              "nibble inserts, counter loads", "components (label rounds)",
              "counts, nibble values", "walks and applies, next lanes")


def _build_all():
    """The three step-kernel libraries, the L2 probe and the add kernel's
    phase-timing build, built at once."""
    jobs = [("sketch_step", d) for d in VARIANTS.values()] + [
        ("l2_chase", ()), ("sketch_update", ADD_CLOCKS)]
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = list(ex.map(lambda job: _build.load_library(*job), jobs))
    return dict(zip(VARIANTS, libs)), libs[-2], libs[-1]


def add_phases(lib, trace) -> tuple[list, float, float]:
    """Run S (``DeviceTinyLFU(S_BLOCKS)``'s geometry, ``S_BATCH``-key
    batches, the section 3.3 resets) through the add kernel's phase-timing
    build.  Returns (cycles per tile of each phase, label rounds per tile,
    device ms per add launch by CUDA events, the resets' time included)."""
    cfg = make_config(S_BLOCKS)
    state = init_state(cfg, device="cuda")
    lo, hi = _trace_lanes(trace, "cuda")
    fn = lib.sketch_update_phase_cycles
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    cycles = np.zeros(len(ADD_PHASES) + 1, np.uint64)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for s in range(0, len(trace), S_BATCH):
        n = min(S_BATCH, len(trace) - s)
        su._launch(cfg, state, lo[s:s + n], hi[s:s + n], lib=lib)
        state["size"] = state["size"] + n
        if int(state["size"]) >= cfg.sample_size:
            reset(cfg, state)
    e1.record()
    torch.cuda.synchronize()
    if fn(cycles.ctypes.data) != 0:
        raise RuntimeError("reading the add kernel's phase cycles failed")
    launches = -(-len(trace) // S_BATCH)
    tiles = sum(-(-min(S_BATCH, len(trace) - s) // ADD_TILE)
                for s in range(0, len(trace), S_BATCH))
    return (list(cycles[:-1] / tiles), float(cycles[-1]) / tiles,
            e0.elapsed_time(e1) / launches)


def _ms_per_chunk(lib, cfg: DeviceWTinyLFU, trace, nchunks: int,
                  chunk: int = 512) -> tuple[float, float]:
    """Mean device ms per chunk over chunks 1..nchunks-1 (chunk 0 warms),
    and the hit share of those chunks."""
    spec = cfg.spec()
    params = cfg.params(device="cuda")
    state = ks.init_step_state(spec, cfg.window_cap, cfg.main_cap,
                               device="cuda")
    lo, hi = _trace_lanes(trace[:nchunks * chunk], "cuda")
    probes = ks.precompute_probes(spec, lo, hi)
    hits = torch.empty_like(lo)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for c in range(nchunks):
        if c == 1:
            e0.record()
        s = c * chunk
        ks._launch(spec, params, state, lo[s:s + chunk], hi[s:s + chunk],
                   tuple(p[s:s + chunk] for p in probes), chunk,
                   hits[s:s + chunk], lib=lib)
    e1.record()
    torch.cuda.synchronize()
    return (e0.elapsed_time(e1) / (nchunks - 1),
            float(hits[chunk:].float().mean()))


def l2_round_trip_ns(lib, n: int = 1 << 20) -> float:
    """ns per dependent load along one cycle through a 4 MB int32 buffer
    (L2-resident after one warming pass)."""
    order = np.random.default_rng(0).permutation(n)
    nxt = np.empty(n, np.int32)
    nxt[order] = np.roll(order, -1)          # one cycle through every slot
    buf = torch.from_numpy(nxt).cuda()
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    for timed in (False, True):
        if timed:
            e0.record()
        err = lib.l2_chase_launch(buf.data_ptr(), n, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"l2_chase launch failed: CUDA error {err}")
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) * 1e6 / n


def main():
    if not torch.cuda.is_available():
        raise SystemExit("phase_timing needs a CUDA device")
    libs, chase, add_lib = _build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card or torch.cuda.get_device_name(0))
    rt = l2_round_trip_ns(chase)
    print(f"L2 round trip: {rt:.1f} ns per dependent load (4 MB chain)")
    cells = [
        ("F (C=65536, assoc=8)", DeviceWTinyLFU(65536, assoc=8),
         zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9, seed=11)),
        ("G1 (C=200, flat)", DeviceWTinyLFU(200),
         zipf_trace(60_000, n_items=50_000, alpha=0.9, seed=7)),
        ("G4 (C=1000, assoc=8)", DeviceWTinyLFU(1000, assoc=8),
         zipf_trace(60_000, n_items=50_000, alpha=0.9, seed=7)),
    ]
    for cell, cfg, trace in cells:
        for name, lib in libs.items():
            ms, h = _ms_per_chunk(lib, cfg, trace, nchunks=60)
            print(f"{cell:22s} {name:16s} {ms:.4f} ms/chunk "
                  f"{ms * 1e6 / 512:.0f} ns/access", flush=True)
            if name != "full":
                continue
            if cfg.assoc is None:
                print(f"{cell:22s} latency floor    not counted for the "
                      "flat path", flush=True)
                continue
            trips = RT_HIT * h + RT_MISS * (1 - h)
            print(f"{cell:22s} latency floor    {trips:.2f} round trips/"
                  f"access (hit share {h:.4f}) x {rt:.1f} ns = "
                  f"{trips * rt:.0f} ns/access", flush=True)
    per_tile, rounds, ms = add_phases(
        add_lib, zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9,
                            seed=11))
    total = sum(per_tile)
    print(f"add kernel, run S (phase-timing build): {ms:.4f} ms per "
          f"{S_BATCH}-key launch, {total:,.0f} cycles per {ADD_TILE}-key "
          f"tile, {rounds:.2f} label rounds per tile")
    for name, c in zip(ADD_PHASES, per_tile):
        print(f"add kernel phase {name:34s} {c:9,.0f} cycles per tile, "
              f"share {c / total:.3f}", flush=True)


if __name__ == "__main__":
    main()

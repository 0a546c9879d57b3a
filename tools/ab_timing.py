"""The step and add kernels on the card: ptxas lines by instance, the step
kernel's special instances against its plain version, and this tree's
kernels against another copy of their sources, in turns; or (``--flash-bwd``)
the flash backward kernel against another copy's.

The engine's loader (``repro_torch.kernels._build``, into ``build/``)
builds ``sketch_step.cu`` (static, adaptive and panel builds) and
``sketch_update.cu``, all at once, and the script prints every kernel
instance's ptxas register and spill lines by demangled name.

``--other DIR`` names a directory that holds other versions of
``sketch_step.cu``, ``sketch_update.cu`` and ``sketch_common.cuh``: an
earlier commit's (``git archive <commit> src/repro_torch/kernels/csrc |
tar -x --strip-components=4 -C DIR``) or an edited copy.  It is built
beside this tree's, and the script lists the other copy's instances whose
lines are not among this tree's.  Then, with CUDA events around each
launch:

* run F's chunks (C=65,536, assoc=8, 1.2M Zipf accesses, chunk 512)
  through each copy's static step kernel in turns (this, other, other,
  this, this, other): ms per chunk, and the final states' digests, which
  must be equal;
* add S's batches (F's trace in 4,096-key batches into
  ``DeviceTinyLFU(65,536)``'s sketch, no reset) through each copy's add
  kernel in the same turns: ms per batch, final states equal;
* add 60 of S's batches at S's geometry with 8, 9, 13 and 20 doorkeeper
  probes through this tree's add, twice each (past 8 probes, its loop
  instance).

``--cases`` runs every ``check_runs.STEP12_CASES`` case (the stale mesh
instances, mode 1e; the wide instances; the exact path after table
addresses put out of range) through this tree's kernel and through the
plain version on the CPU: equal state leaves and hit flags, and the
kernel's ms per launch.  ``--mesh`` runs F's trace at F4's geometry
(shards=4, epoch 4,096) through the sharded instance (``merge_halve``
after each epoch) and through the stale mesh instance of a one-rank mesh
(``merge_halve_mesh``, no process group), in turns: ns per access of the
step and ms per fold.

``--flash-bwd`` (with ``--other DIR``, a directory holding another
``flash_attention_bwd.cu`` and its headers, e.g. an earlier commit's by
the ``git archive`` line above; ``--other`` may be given more than once)
times this tree's flash backward kernel and each other copy's at TR's
attention shape (8 x 2,048 tokens, 32/8 heads of 128) in turns (with one
other copy the turns above; with more, all copies in order, then in
reverse, then in order), 10 calls a turn with CUDA events around each,
holds every call of each within ``check_runs.FB_TOL`` of the plain
version's largest, and prints the device time of each of this tree's
kernels in one call under ``torch.profiler``; it runs nothing else.  A
copy whose launch function still takes ``delta`` (before the wgmma
kernel) is called that way.

Run on a machine with a card, from the repository root:

    PYTHONPATH=src python tools/ab_timing.py [--other DIR] [--cases] [--mesh]
    PYTHONPATH=src python tools/ab_timing.py --flash-bwd --other DIR [--other DIR2 ...]
"""
from __future__ import annotations

import argparse
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from repro_torch import check_runs as cr
from repro_torch.check_runs import S_BATCH, S_BLOCKS, digest
from repro_torch.core.device_simulate import (DeviceWTinyLFU, _trace_lanes,
                                              run_chunks)
from repro_torch.distributed.mesh import make_shard_mesh
from repro_torch.kernels import _build
from repro_torch.kernels import sketch_step as ks
from repro_torch.kernels import sketch_update as su
from repro_torch.kernels.ops import make_config
from repro_torch.kernels.sketch_common import (DeviceSketchConfig,
                                               init_state, keys_to_lanes)
from repro_torch.kernels.sketch_merge import merge_halve, merge_halve_mesh
from repro_torch.traces.synthetic import zipf_trace

TURNS = ("this", "other", "other", "this", "this", "other")
BUILDS = {"step": ("sketch_step", ()),
          "step adaptive": ("sketch_step", ks.ADAPTIVE_DEFINES),
          "step panel": ("sketch_step", ks.PANEL_DEFINES),
          "add": ("sketch_update", ())}


def instance_lines(log: str) -> dict:
    """Demangled kernel name -> its ptxas register/spill lines."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            out[name].append(ln.split("ptxas info    : ")[-1].strip())
    names = list(out)
    dem = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                         capture_output=True).stdout.split("\n")
    return {(dem[i] if i < len(dem) and dem[i] else n): out[n]
            for i, n in enumerate(names)}


def canonical(name: str) -> str:
    """A step instance's name without its last template flag when that is
    false: the mesh flag, which copies older than the stale mesh step's
    instances lack."""
    return name.replace(", false>(StepArgs)", ">(StepArgs)")


def events_ms(pairs) -> float:
    torch.cuda.synchronize()
    return statistics.mean(a.elapsed_time(b) for a, b in pairs)


def step_with(lib=None):
    """run_chunks' ``fn`` launching the step kernel of ``lib`` (default:
    the build this tree's wrapper picks for the spec), with CUDA events
    around each launch (appended to ``run.events``)."""
    def run(spec, params, state, lo, hi, n_valid=None, probes=None, rank=0):
        if probes is None:
            probes = ks.precompute_probes(spec, lo, hi)
        exact = ks._needs_exact(spec, state)
        hits = torch.empty(lo.shape, dtype=torch.int32, device=lo.device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ks._launch(spec, params, state, lo, hi, probes,
                   lo.shape[-1] if n_valid is None else n_valid, hits,
                   lib=lib, rank=rank, exact=exact)
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


def print_ptxas(other):
    """Every instance's ptxas lines of this tree, and with ``other`` the
    other copy's instances whose lines are not among them."""
    for b, (src, defs) in BUILDS.items():
        this = instance_lines(_build.build_info[(src, defs)]["log"])
        for n, lines in this.items():
            print(f"[{b}] {n}: {' | '.join(lines)}")
        if other:
            oth = instance_lines(_build.build_info[
                (src, defs, str(other))]["log"])
            mine = {canonical(n): v for n, v in this.items()}
            diff = [n for n, v in oth.items() if mine.get(canonical(n)) != v]
            print(f"[{b}] other copy: {len(oth)} instances, {len(diff)} with "
                  "other lines here:", *diff, sep="\n  ")


def ab_turns(libs, f_trace, card):
    """F's chunks and S's adds through each copy in turns, then this tree's
    add past 8 doorkeeper probes."""
    ms, digests = {"this": [], "other": []}, {}
    for turn in TURNS:
        m, digests[turn] = time_f(libs[("step", turn)], f_trace)
        ms[turn].append(round(m, 4))
    print(f"F, step kernel ms per 512-access chunk in turns: {ms}; "
          f"digests equal {len(set(digests.values())) == 1}; {card}")
    s_cfg = make_config(S_BLOCKS)
    ms, states = {"this": [], "other": []}, {}
    for turn in TURNS:
        m, states[turn] = time_adds(libs[("add", turn)], s_cfg, f_trace, 293)
        ms[turn].append(round(m, 4))
    same = all(torch.equal(states["this"][k], states["other"][k])
               for k in ("counters", "doorkeeper"))
    print(f"S's adds (293 batches of {S_BATCH}, no reset), ms per batch "
          f"in turns: {ms}; final states equal {same}; {card}")
    for dkp in (8, 9, 13, 20):
        cfg = DeviceSketchConfig(width=s_cfg.width, rows=s_cfg.rows,
                                 cap=s_cfg.cap, dk_bits=s_cfg.dk_bits,
                                 dk_probes=dkp)
        runs = [round(time_adds(libs[("add", "this")], cfg, f_trace, 60)[0],
                      4) for _ in range(2)]
        print(f"add at S's geometry, {dkp} doorkeeper probes: {runs} ms "
              f"per 4,096-key batch (60 batches, this tree); {card}")


def step_cases(card) -> int:
    """Every STEP12 case through the kernel and the plain version; returns
    the number that differ."""
    bad = 0
    for case in cr.STEP12_CASES:
        fn = step_with()
        got = cr.run_step_case(case, fn, "cuda")
        want = cr.run_step_case(case, ks.step_ref, "cpu")
        same = (np.array_equal(got[1], want[1])
                and all(np.array_equal(got[0][k], want[0][k])
                        for k in want[0]))
        bad += not same
        print(f"{case[0]}: kernel == plain {same}; hits {int(got[1].sum())}; "
              f"{events_ms(fn.events):.4f} ms per launch of {case[7]} "
              f"accesses; {card}", flush=True)
    return bad


def sharded_vs_mesh(f_trace, card):
    """F4's geometry through the sharded instance and the stale mesh
    instance of a one-rank mesh, in turns."""
    mesh = make_shard_mesh(4)
    for turn in ("sharded", "mesh", "mesh", "sharded"):
        cfg = DeviceWTinyLFU(65_536, assoc=8, shards=4, merge_every=4096)
        spec = cfg.spec()
        if turn == "mesh":
            spec = replace(spec, mesh_devices=1, mesh_exchange="stale")
        params = cfg.params(warmup=480_000, device="cuda")
        state = ks.init_step_state(spec, cfg.window_cap, cfg.main_cap,
                                   device="cuda")
        lo, hi = _trace_lanes(f_trace, "cuda")
        fn, folds = step_with(), []

        def fold(sp, p, st):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            if turn == "mesh":
                merge_halve_mesh(sp, p, st, mesh)
            else:
                merge_halve(sp, p, st)
            e1.record()
            folds.append((e0, e1))
        run_chunks(spec, params, state, lo, hi, 4096, fn=fn, fold=fold)
        ms = events_ms(fn.events)
        print(f"F4 geometry, {turn}: {ms / 4096 * 1e6:.1f} ns per access, "
              f"fold {events_ms(folds):.4f} ms per epoch, hits "
              f"{int(state['regs'][ks.R_HITS])}; {card}", flush=True)


def flash_bwd_lib(other):
    """The other copy's flash backward library, and whether its launch
    function takes (work, counters) scratch or the older (delta)."""
    import ctypes
    lib = _build.load_library("flash_attention_bwd", (), other)
    new = "counters" in (other / "flash_attention_bwd.cu").read_text()
    if not new:
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    return lib, new


def flash_bwd_turns(others, card) -> int:
    """TR's attention backward through this tree's kernel and each other
    copy's in turns; returns the number of calls outside FB_TOL."""
    from repro_torch.kernels import flash_attention as fa
    B, S, Hq, Hkv, D = 8, 2048, 32, 8, 128
    names = ["this"] + [str(o) for o in others]
    with ThreadPoolExecutor(2 + len(others)) as ex:
        jobs = [ex.submit(_build.load_library, "flash_attention"),
                ex.submit(_build.load_library, "flash_attention_bwd")]
        jobs += [ex.submit(flash_bwd_lib, o) for o in others]
        libs = {"this": (jobs[1].result(), True)}
        libs.update({n: j.result() for n, j in zip(names[1:], jobs[2:])})
    for n in names:
        key = ("flash_attention_bwd", ()) + (() if n == "this" else (n,))
        for k, lines in instance_lines(_build.build_info[key]["log"]).items():
            print(f"[{n}] {k}: {' | '.join(lines)}")
    g = torch.Generator(device="cuda").manual_seed(7)
    q, do = (torch.randn((B, S, Hq, D), generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    out, lse = fa._launch_train(q, k, v, 0.0)
    ref = fa.flash_attention_bwd_ref(q, k, v, out, do, lse)

    def call(turn):
        lib, new = libs[turn]
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        if new:
            n_work, n_ctr = fa.bwd_scratch(B, S, Hq, D)
            scratch = (torch.empty(n_work, dtype=torch.float32,
                                   device="cuda"),
                       torch.empty(n_ctr, dtype=torch.int32, device="cuda"))
        else:
            scratch = (torch.empty((B, Hq, S), dtype=torch.float32,
                                   device="cuda"),)
        _build.launch("flash_attention_bwd", "flash_attention_bwd_launch", q,
                      k, v, out, do, lse, *scratch, dq, dk, dv, B, S, Hq, Hkv,
                      D, 0.0, 1.0 / D ** 0.5, lib=lib)
        return dq, dk, dv

    for n in names:
        call(n)                                   # first launch: set-up
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call("this")
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            kernel = re.search(r"(\w+_kernel)<", e.key)
            print(f"this tree's {kernel[1] if kernel else e.key[:70]}: "
                  f"{e.device_time_total / e.count / 1e3:.4f} ms; {card}")
    order = (["this", "other", "other", "this", "this", "other"]
             if len(names) == 2 else names + names[::-1] + names)
    order = [names[1] if n == "other" else n for n in order]
    bad, ms = 0, {n: [] for n in names}
    for turn in order:
        pairs, outs = [], []
        for _ in range(10):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            outs.append(call(turn))
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        ms[turn].append(round(events_ms(pairs), 4))
        for got in outs:
            for a, b in zip(got, ref):
                rel = float((a.float() - b.float()).abs().max()) / float(
                    b.float().abs().max())
                bad += rel > cr.FB_TOL
        print(f"flash backward at TR's shape, {turn}: "
              f"{ms[turn][-1]:.4f} ms a call (10 calls); {card}",
              flush=True)
    print(f"flash backward at TR's shape, ms a call in turns: {ms}; means "
          + ", ".join(f"{n} {statistics.mean(v):.4f}" for n, v in ms.items())
          + f"; calls outside FB_TOL of the plain version: {bad}; {card}")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=None,
                    help="directory with the other sketch_step.cu, "
                         "sketch_update.cu and sketch_common.cuh (with "
                         "--flash-bwd: flash_attention_bwd.cu)")
    ap.add_argument("--cases", action="store_true",
                    help="the STEP12 cases, kernel against plain")
    ap.add_argument("--mesh", action="store_true",
                    help="F4's geometry, sharded against stale mesh")
    ap.add_argument("--flash-bwd", action="store_true",
                    help="the flash backward kernel against --other's, "
                         "at TR's shape, in turns (nothing else)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_timing: no CUDA device")
    if args.flash_bwd and not args.other:
        raise SystemExit("ab_timing: --flash-bwd needs --other DIR")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    if args.flash_bwd:
        return 1 if flash_bwd_turns([o.resolve() for o in args.other],
                                    card) else 0
    if args.other and len(args.other) > 1:
        raise SystemExit("ab_timing: one --other DIR for the step and add")
    other = args.other[0].resolve() if args.other else None
    trees = ("this",) + (("other",) if other else ())
    with ThreadPoolExecutor(8) as ex:
        jobs = {(b, w): ex.submit(_build.load_library, src, defs,
                                  None if w == "this" else other)
                for b, (src, defs) in BUILDS.items() for w in trees}
        libs = {k: j.result() for k, j in jobs.items()}
    print_ptxas(other)
    f_trace = zipf_trace(1_200_000, n_items=1_000_000, alpha=0.9, seed=11)
    if other:
        ab_turns(libs, f_trace, card)
    bad = step_cases(card) if args.cases else 0
    if args.mesh:
        sharded_vs_mesh(f_trace, card)
    if args.cases:
        print(f"ab_timing: {bad} case(s) differ")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())

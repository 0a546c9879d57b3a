"""Driver of the replay cells: ``repro_torch.core.device_simulate.
simulate_trace`` replays the cell's whole trace from a fresh state, again
and again until the window closes.

Set-up makes the trace from the seed and replays it once (the build, the
card's first allocations); that replay's hit flags and final state, left
on the card, are the first replay.  Each replay of the window is compared
with it on the card, flag for flag and word for word, every lane.  After
the window the first replay is compared with the reference
(``reference/wtinylfu.py``), every lane of it; the lanes of a long trace
are spread over worker processes, one a core.
"""
from __future__ import annotations

import multiprocessing
import os
import time

import numpy as np

from tinylfu_bench import gen
from tinylfu_bench.reference import wtinylfu
from tinylfu_bench.yardstick import roofline

SPANS = ("replay",)
POOL_MIN_ACCESSES = 1_000_000     # shorter traces: no worker processes
GEOMETRY_KEYS = ("capacity", "assoc", "window_frac", "sample_factor", "rows",
                 "counter_bits", "doorkeeper")


def geometry(config: dict) -> dict:
    """The configuration's sizes that the engine and the reference take."""
    return {k: config["program"][k] for k in GEOMETRY_KEYS
            if k in config["program"]}


def reference_lane(geo_kw: dict, keys: np.ndarray, warmup: int, chunk: int,
                   work: bool, drop_every: int = 0):
    """One lane: ((the reference's hit flags, its state), the step kernel's
    per-launch (bytes, operations) when ``work``)."""
    geo = wtinylfu.Geometry(**geo_kw)
    r = wtinylfu.replay(geo, keys, warmup=warmup, drop_every=drop_every)
    w = None
    if work:
        pr = wtinylfu.probes_of(geo, keys)
        w = roofline.step_launch_work(
            pr, geo.width // 8, geo.ways, 5 + geo.rows + geo.dk_probes,
            3 + geo.rows + geo.dk_probes, chunk)
    return (r.hits, r.state), w


def _star(args):
    return reference_lane(*args)


def reference_lanes(geo_kw: dict, trace: np.ndarray, warmup: int,
                    chunk: int, work: bool, drop_every: int = 0) -> list:
    """[(the reference's (flags, state), the step work or None) a lane]:
    the reference over every lane of ``trace`` ((T,) or (B, T)) and, when
    ``work``, each lane's step work; several lanes of a long trace go to a
    pool of worker processes."""
    rows = trace[None] if trace.ndim == 1 else trace
    jobs = [(geo_kw, row, warmup, chunk, work, drop_every)
            for row in rows]
    if len(jobs) == 1 or rows.size < POOL_MIN_ACCESSES:
        return [_star(j) for j in jobs]
    n = min(len(jobs), len(os.sched_getaffinity(0)))
    with multiprocessing.get_context("spawn").Pool(n) as pool:
        out = pool.map(_star, jobs, chunksize=1)
        pool.close()
        pool.join()             # every worker has ended before the result
    return out


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 program=None):
        """``program``, when given, replays in ``simulate_trace``'s place
        and with its signature."""
        import torch
        if program is None:
            from repro_torch.core.device_simulate import \
                simulate_trace as program
        self.torch = torch
        self.simulate = program
        self.device = device
        self.trace = gen.make(traffic, seed)
        self.lanes = 1 if self.trace.ndim == 1 else self.trace.shape[0]
        self.geo_kw = geometry(config)
        self.warmup = int(traffic.get("warmup", 0))
        self.chunk = int(traffic.get("chunk", 512))
        self.accesses = int(self.trace.size)
        self.first = None
        self.flags_vs_first = 0
        self.words_vs_first = 0
        self.units_differing = 0
        self.launch_work = None

    def _replay(self):
        kw = dict(self.geo_kw)
        cap = kw.pop("capacity")
        if self.lanes > 1:
            kw["streams"] = self.lanes
        _, state, hits = self.simulate(
            self.trace, cap, warmup=self.warmup, chunk=self.chunk,
            device=self.device, return_state=True, **kw)
        return hits, state

    def warm(self) -> None:
        self.first = self._replay()
        # the window's comparison, once, so that its kernels are loaded
        copy = (self.first[0].clone(),
                {k: v.clone() for k, v in self.first[1].items()})
        _differ(self.torch, copy, self.first)

    def unit(self, span) -> tuple[float, float, int]:
        t0 = time.perf_counter()
        with span("replay"):
            hits, state = self._replay()
        t1 = time.perf_counter()
        flags, words = _differ(self.torch, (hits, state), self.first)
        self.flags_vs_first += flags
        self.words_vs_first += words
        self.units_differing += bool(flags or words)
        return t0, t1, self.accesses

    def check(self, traced: bool) -> dict:
        """The numbers compared, each (value, limit)."""
        hits = self.first[0].cpu().numpy()
        state = {k: v.cpu().numpy() for k, v in self.first[1].items()}
        self.first = None
        out = reference_lanes(self.geo_kw, self.trace, self.warmup,
                              self.chunk, traced)
        flags, words = compare_lanes(hits, state, [r for r, _ in out],
                                     self.lanes)
        if traced:                  # a launch covers every lane
            nb = sum(w[0] for _, w in out)
            ops = sum(w[1] for _, w in out)
            self.launch_work = {"sketch_step": roofline.least_s(nb, ops)}
        self.wrong_first = bool(flags or words)
        return {"flags_vs_reference": (flags, 0),
                "words_vs_reference": (words, 0),
                "flags_vs_first": (self.flags_vs_first, 0),
                "words_vs_first": (self.words_vs_first, 0)}

    def failed(self, attempted: int) -> int:
        return attempted if self.wrong_first else self.units_differing

    def unit_work(self, i: int) -> dict:
        """Least seconds by kernel of unit ``i`` of the window."""
        return self.launch_work or {}


def _differ(torch, got, first) -> tuple[int, int]:
    """(flags, state words) of replay ``got`` that differ from ``first``,
    counted on the card."""
    hits, state = got
    if hits.shape != first[0].shape:
        flags = first[0].numel()
    else:
        flags = 0 if torch.equal(hits, first[0]) else int(
            (hits != first[0]).sum())
    words = 0
    for k, v in first[1].items():
        w = state.get(k)
        if w is None or w.shape != v.shape:
            words += v.numel()
        elif not torch.equal(w, v):
            words += int((w != v).sum())
    return flags, words


def compare_lanes(hits: np.ndarray, state: dict, ref: list,
                  lanes: int) -> tuple[int, int]:
    """(hit flags, state words) of the program's replay that differ from
    the reference's (``ref``: (flags, state) a lane); a lane or leaf that
    the program lacks, or holds in another shape, counts whole."""
    flags = words = 0
    for b, (rh, rs) in enumerate(ref):
        got = hits.reshape(lanes, -1)[b] if hits.size % lanes == 0 else None
        flags += (rh.size if got is None or got.shape != rh.shape
                  else int((got != rh).sum()))
        for k, v in rs.items():
            g = state.get(k)
            g = None if g is None else (g[b] if lanes > 1 else g)
            words += (v.size if g is None or g.shape != v.shape
                      else int((g != v).sum()))
    return flags, words
